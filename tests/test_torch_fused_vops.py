"""The port's fused slot-program wrapper (repro_torch.kernels.fused_vops)
against the reference's ``fused_elementwise_call`` (one Pallas call,
interpret mode on CPU) and the oracle's numpy semantics. Inputs come from
numpy with a seed and go to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kvi.pallas_backend import \
    fused_elementwise_call as ref_fused_call
from repro_torch.kernels import checks
from repro_torch.kernels import fused_vops as fv
from repro_torch.kvi.torch_backend import KernelCache

NP_OF = {1: np.int8, 2: np.int16, 4: np.int32}
TORCH_OF = {1: torch.int8, 2: torch.int16, 4: torch.int32}


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("eb", [1, 2, 4])
def test_random_slot_programs_bit_exact_vs_pallas(eb, batched):
    """All 11 ops, full-range data (so add/sub/mul wrap), immediates that
    fit the element type (the reference kernel takes no others)."""
    rng = np.random.default_rng(10 * eb + batched)
    program, in_slots, out_slots, n_slots = checks.random_slot_program(
        rng, 4, 24, TORCH_OF[eb], wide_imm=False)
    info = np.iinfo(NP_OF[eb])
    shape = (3, 40) if batched else (40,)
    xs = [rng.integers(info.min, info.max + 1, shape).astype(NP_OF[eb])
          for _ in in_slots]
    want = ref_fused_call(program, [(s, jnp.asarray(x))
                                    for s, x in zip(in_slots, xs)],
                          out_slots, n_slots=n_slots, batched=batched,
                          interpret=True)
    got = fv.fused_elementwise_call(program,
                                    [(s, torch.from_numpy(x))
                                     for s, x in zip(in_slots, xs)],
                                    out_slots, n_slots=n_slots,
                                    batched=batched)
    assert len(got) == len(want) == len(out_slots)
    for g, w in zip(got, want):
        assert g.dtype == TORCH_OF[eb] and tuple(g.shape) == shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("batched", [False, True])
def test_uint8_slot_programs_bit_exact_vs_pallas(batched):
    """uint8 tensors, as the reference's intrinsics take them: add, sub
    and mul wrap mod 256, ksrav shifts logically (a count of 8 or more
    gives 0), the comparisons are unsigned; immediates in 0 .. 255."""
    rng = np.random.default_rng(80 + batched)
    for _ in range(4):
        program, in_slots, out_slots, n_slots = checks.random_slot_program(
            rng, 4, 24, torch.uint8, wide_imm=False)
        shape = (3, 40) if batched else (40,)
        xs = [rng.integers(0, 256, shape).astype(np.uint8) for _ in in_slots]
        want = ref_fused_call(program, [(s, jnp.asarray(x))
                                        for s, x in zip(in_slots, xs)],
                              out_slots, n_slots=n_slots, batched=batched,
                              interpret=True)
        got = fv.fused_elementwise_call(program,
                                        [(s, torch.from_numpy(x))
                                         for s, x in zip(in_slots, xs)],
                                        out_slots, n_slots=n_slots,
                                        batched=batched)
        for g, w in zip(got, want):
            assert g.dtype == torch.uint8 and tuple(g.shape) == shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_uint8_intrinsics_equal_the_reference():
    """``ops``' element-wise intrinsics and ``fused_mac_relu`` on uint8,
    against the reference's ``repro.kernels.ops`` (interpret mode)."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops
    a = np.array([0, 1, 2, 100, 128, 200, 255], np.uint8)
    b = np.array([255, 3, 1, 100, 127, 201, 0], np.uint8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    cases = [("kaddv", (b,)), ("ksubv", (b,)), ("kvmul", (b,)),
             ("kvslt", (b,)), ("krelu", ()), ("kvcp", ()),
             ("ksvaddsc", (77,)), ("ksvmulsc", (3,)), ("ksrlv", (3,)),
             ("ksrav", (3,)), ("ksrav", (9,)), ("ksrlv", (9,)),
             ("ksvslt", (128,))]
    for name, extra in cases:
        targs = [torch.from_numpy(e) if isinstance(e, np.ndarray) else e
                 for e in extra]
        jargs = [jnp.asarray(e) if isinstance(e, np.ndarray) else e
                 for e in extra]
        got = getattr(tops, name)(ta, *targs)
        want = np.asarray(getattr(jops, name)(ja, *jargs))
        assert got.dtype == torch.uint8, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    got = tops.fused_mac_relu(ta, tb, ta, 2)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.fused_mac_relu(ja, jb, ja, 2)))
    assert got.tolist() == [0, 1, 1, 29, 0, 52, 63]


def _one(op, x, imm=0, y=None):
    return fv.apply_vop(op, torch.tensor(x, dtype=torch.int8), None
                        if y is None else torch.tensor(y, dtype=torch.int8),
                        imm).tolist()


def test_out_of_range_immediates_follow_the_oracle():
    """At int8 the oracle wraps 300 to +44 and compares 200 exactly; the
    reference Pallas kernel raises on both."""
    x = [-128, -1, 0, 5, 127]
    assert _one("ksvaddsc", x, 300) == [(v + 44 + 128) % 256 - 128
                                        for v in x]
    assert _one("ksvslt", x, 200) == [1] * 5
    assert _one("ksvslt", x, -200) == [0] * 5
    assert _one("ksvmulsc", x, 257) == x               # 257 = 1 mod 256
    with pytest.raises(OverflowError):
        ref_fused_call((("ksvaddsc", 1, 0, None, 300),),
                       [(0, jnp.asarray(np.array(x, np.int8)))], [1],
                       interpret=True)


def test_shift_counts_at_or_above_the_width():
    x = [-128, -3, 0, 3, 127]
    assert _one("ksrav", x, 8) == [-1, -1, 0, 0, 0]
    assert _one("ksrav", x, 100) == [-1, -1, 0, 0, 0]
    assert _one("ksrav", x, -1) == [-1, -1, 0, 0, 0]   # huge unsigned
    assert _one("ksrlv", x, 8) == [0] * 5
    assert _one("ksrlv", x, 1) == [64, 126, 0, 1, 63]  # unsigned of int8
    assert _one("ksrav", x, 1) == [-64, -2, 0, 1, 63]


def test_wrapping_arithmetic():
    assert _one("kaddv", [127, -128], y=[1, -1]) == [-128, 127]
    assert _one("ksubv", [-128], y=[1]) == [127]
    assert _one("kvmul", [16, -128], y=[16, -1]) == [0, -128]
    assert _one("kvslt", [1, 2], y=[2, 1]) == [1, 0]
    assert _one("krelu", [-5, 5]) == [0, 5]


def test_in_place_overlap_reads_before_writes():
    """An output window overlapping an input window at another offset
    (the case the CUDA path routes through scratch) still sees every
    input as it was before the region ran."""
    rf = torch.arange(12, dtype=torch.int32).reshape(1, 12)
    record = fv.pack_program((("ksvaddsc", 1, 0, None, 100),), (0,), (1,),
                             2, torch.device("cpu"))
    win = fv.Windows([0], [2], 4)                     # [0:4) -> [2:6)
    assert win.hazard
    fv.fused_vops(record, win, rf, rf)
    assert rf[0].tolist() == [0, 1, 100, 101, 102, 103, 6, 7, 8, 9, 10, 11]
    assert not fv.Windows([0], [0], 4).hazard
    assert not fv.Windows([0], [4], 4).hazard


def test_packing_round_trip():
    prog = (("kaddv", 2, 0, 1, 0), ("ksvmulsc", 3, 2, None, -(1 << 62)),
            ("kvcp", 2, 3, None, 0))
    rec = fv.pack_program(prog, (0, 1), (2, 3), 4, torch.device("cpu"))
    words = rec.prog.tolist()
    assert (rec.n_ops, rec.n_in, rec.n_out, rec.n_slots) == (3, 2, 2, 4)
    assert words[0] == fv.OPCODES["kaddv"] | 2 << 8 | 0 << 16 | 1 << 24
    assert words[3] == -(1 << 62)
    assert words[2] >> 24 == fv.NO_SLOT
    assert words[6:] == [0, 1, 2, 3]


@pytest.mark.parametrize("bad", [
    dict(program=(("kaddv", 1, 0, None, 0),)),                 # 2nd source
    dict(program=(("kdotp", 1, 0, 0, 0),)),                    # not elemwise
    dict(program=(("ksvaddsc", 1, 0, None, 1 << 70),)),        # imm > int64
    dict(program=(("kvcp", 5, 0, None, 0),)),                  # slot range
    dict(program=(("kvcp", 1, 0, None, 0),) * 65),             # > 64 ops
    dict(in_slots=tuple(range(25)), n_slots=26),               # > 24 inputs
    dict(threads=48)])
def test_pack_program_rejects(bad):
    kw = dict(program=(("kvcp", 1, 0, None, 0),), in_slots=(0,),
              out_slots=(1,), n_slots=2, device=torch.device("cpu"))
    kw.update(bad)
    with pytest.raises(ValueError):
        fv.pack_program(**kw)


def test_wrapper_checks_windows_and_dtypes():
    rec = fv.pack_program((("kvcp", 1, 0, None, 0),), (0,), (1,), 2,
                          torch.device("cpu"))
    rf = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(IndexError):
        fv.fused_vops(rec, fv.Windows([6], [0], 4), rf, rf)
    with pytest.raises(TypeError):
        fv.fused_vops(rec, fv.Windows([0], [4], 4), rf.long(), rf.long())
    with pytest.raises(ValueError):
        fv.fused_vops(rec, fv.Windows([0, 1], [4], 4), rf, rf)
    with pytest.raises(ValueError):
        fv.fused_vops(rec, fv.Windows([0], [4], 4), rf.to("meta"),
                      rf.to("meta"))


def test_cache_builds_once_and_plain_path_counts_no_launch():
    cache = KernelCache()
    prog = (("kaddv", 2, 0, 1, 0),)
    x = torch.arange(8, dtype=torch.int16)
    before = fv.launch_count
    for _ in range(3):
        (out,) = fv.fused_elementwise_call(prog, [(0, x), (1, x)], [2],
                                           cache=cache)
    assert out.tolist() == (2 * x).tolist()
    assert cache.stats == {"hits": 2, "misses": 1, "entries": 1}
    assert fv.launch_count == before


def test_shared_check_helpers_on_cpu():
    rng = np.random.default_rng(3)
    for dt in (*TORCH_OF.values(), torch.uint8):
        assert checks.check_fused(rng, dt, 4, 16, "cpu") == 0
        assert checks.check_fused(rng, dt, 4, 16, "cpu", hazard=True) == 0
