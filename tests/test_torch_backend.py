"""TorchBackend(device="cpu") — the port's KVI backend running its
kernels' plain versions — against the reference ``oracle`` (bit for bit,
dtype included) and ``pallas`` (launch counts). The same reference
programs, with the same ``mem_init`` arrays, go through both packages by
way of ``program_from_reference``."""
import numpy as np
import pytest

from repro.kvi import KviProgramBuilder, KviWorkload, get_backend
from repro.kvi.programs import (conv2d_program, fft_program, matmul_program,
                                pipeline_demo_oracle, pipeline_demo_program)
import repro_torch.kvi as tk
from repro_torch.kvi.torch_backend import KernelCache, TorchBackend

NP_OF = {1: np.int8, 2: np.int16, 4: np.int32}
BATCH = 4


def _instances(kind, eb, rng, n=BATCH):
    """``n`` reference programs of one structure with different data
    (immediates — conv filter, resident-matmul A — are shared)."""
    lim = {1: 8, 2: 60, 4: 1000}[eb]
    filt3 = rng.integers(-4, 5, (3, 3))
    filt5 = rng.integers(-4, 5, (5, 5))
    A = rng.integers(-lim, lim, (8, 8))
    out = []
    for _ in range(n):
        if kind == "conv8_f3":
            p = conv2d_program(rng.integers(-lim, lim, (8, 8)), filt3,
                               shift=2, elem_bytes=eb)
        elif kind == "conv8_f5":
            p = conv2d_program(rng.integers(-lim, lim, (8, 8)), filt5,
                               shift=3, elem_bytes=eb)
        elif kind == "fft32":
            p = fft_program(rng.integers(-lim, lim, 32),
                            rng.integers(-lim, lim, 32), elem_bytes=eb)
        elif kind == "matmul8_streamed":
            p = matmul_program(rng.integers(-lim, lim, (8, 8)),
                               rng.integers(-lim, lim, (8, 8)),
                               resident=False, elem_bytes=eb)
        elif kind == "matmul8_streamed_shift":
            p = matmul_program(rng.integers(-lim, lim, (8, 8)),
                               rng.integers(-lim, lim, (8, 8)), shift=5,
                               resident=False, elem_bytes=eb)
        elif kind == "matmul8_resident":
            p = matmul_program(A, rng.integers(-lim, lim, (8, 8)),
                               resident=True, elem_bytes=eb)
        elif kind == "matmul8_resident_shift":
            p = matmul_program(A, rng.integers(-lim, lim, (8, 8)), shift=4,
                               resident=True, elem_bytes=eb)
        else:
            p = pipeline_demo_program(rng.integers(-100, 100, 32))
        out.append(p)
    return out


KINDS = ("conv8_f3", "conv8_f5", "fft32", "matmul8_streamed",
         "matmul8_streamed_shift", "matmul8_resident",
         "matmul8_resident_shift")


def _port(workload):
    return tk.KviWorkload(workload.name, tuple(
        tk.WorkloadEntry(tk.program_from_reference(e.program),
                         tk.HartAssignment(e.hart))
        for e in workload.entries))


def _assert_same_outputs(got, want):
    assert len(got.entry_results) == len(want.entry_results)
    for g, w in zip(got.entry_results, want.entry_results):
        assert g.outputs.keys() == w.outputs.keys()
        for name, arr in w.outputs.items():
            assert g.outputs[name].dtype == arr.dtype, name
            assert g.outputs[name].shape == arr.shape, name
            np.testing.assert_array_equal(g.outputs[name], arr, err_msg=name)


@pytest.fixture(scope="module")
def pallas():
    """One reference Pallas backend for the module, so its compile cache
    stays warm across tests."""
    return get_backend("pallas")


@pytest.mark.parametrize("eb", [1, 2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_homogeneous_batch_bit_exact_vs_oracle(kind, eb):
    rng = np.random.default_rng(abs(hash((kind, eb))) % 2**32)
    wl = KviWorkload.homogeneous(_instances(kind, eb, rng))
    got = TorchBackend(device="cpu").run_workload(_port(wl))
    _assert_same_outputs(got, get_backend("oracle").run_workload(wl))
    assert got.meta["groups"] == 1


def test_pipeline_demo_bit_exact_vs_oracle():
    rng = np.random.default_rng(5)
    progs = _instances("demo", 4, rng)
    wl = KviWorkload.homogeneous(progs)
    got = TorchBackend(device="cpu").run_workload(_port(wl))
    _assert_same_outputs(got, get_backend("oracle").run_workload(wl))
    for p, r in zip(progs, got.entry_results):
        np.testing.assert_array_equal(
            r.outputs["y"], pipeline_demo_oracle(p.mem_init[0]))


@pytest.mark.parametrize("kind", KINDS + ("demo",))
def test_launch_count_equals_pallas_calls(kind, pallas):
    rng = np.random.default_rng(11)
    wl = KviWorkload.homogeneous(_instances(kind, 4, rng))
    ref = pallas.run_workload(wl)
    got = TorchBackend(device="cpu").run_workload(_port(wl))
    assert got.kernel_launches == got.meta["kernel_launches"] \
        == ref.meta["pallas_calls"] > 0
    _assert_same_outputs(got, ref)


def test_pipeline_demo_six_launches_to_one(pallas):
    """Six stages unoptimized: each kvcp cuts the chain (6 launches); the
    default pipeline welds it into one region — on both packages."""
    p = pipeline_demo_program(np.arange(-16, 16), stages=6)
    wl = KviWorkload.single(p)
    raw = TorchBackend(device="cpu", passes=()).run_workload(_port(wl))
    opt = TorchBackend(device="cpu").run_workload(_port(wl))
    ref_raw = get_backend("pallas", passes=()).run_workload(wl)
    ref_opt = pallas.run_workload(wl)
    assert raw.kernel_launches == ref_raw.meta["pallas_calls"] == 6
    assert opt.kernel_launches == ref_opt.meta["pallas_calls"] == 1
    _assert_same_outputs(raw, opt)


def test_composite_workload(pallas):
    """conv / FFT / matmul pinned to harts 0/1/2, a batch of each: three
    structural groups, outputs bit-exact, launches as the reference's."""
    rng = np.random.default_rng(21)
    wl = KviWorkload.composite({0: _instances("conv8_f3", 4, rng),
                                1: _instances("fft32", 4, rng),
                                2: _instances("matmul8_streamed_shift", 4,
                                              rng)})
    got = TorchBackend(device="cpu").run_workload(_port(wl))
    _assert_same_outputs(got, get_backend("oracle").run_workload(wl))
    ref = pallas.run_workload(wl)
    assert got.meta["groups"] == ref.meta["groups"] == 3
    assert got.kernel_launches == ref.meta["pallas_calls"]


def _single_op_program(eb, emit, n=16):
    rng = np.random.default_rng(eb)
    info = np.iinfo(NP_OF[eb])
    b = KviProgramBuilder("edge")
    hx = b.mem_in("x", rng.integers(info.min, info.max + 1, n)
                  .astype(NP_OF[eb]), elem_bytes=eb)
    hy = b.mem_in("y", rng.integers(info.min, info.max + 1, n)
                  .astype(NP_OF[eb]), elem_bytes=eb)
    x, y = b.vreg("x", n, eb), b.vreg("y", n, eb)
    out = b.vreg("out", n, eb)
    b.kmemld(x, hx)
    b.kmemld(y, hy)
    emit(b, out, x, y)
    b.kmemstr(b.mem_out("out", n, elem_bytes=eb), out)
    return b.build()


EDGE_CASES = {
    "ksvaddsc_300": lambda b, o, x, y: b.ksvaddsc(o, x, 300),
    "ksvslt_200": lambda b, o, x, y: b.ksvslt(o, x, 200),
    "ksvmulsc_big": lambda b, o, x, y: b.ksvmulsc(o, x, 3_000_000_019),
    "ksrav_40": lambda b, o, x, y: b.ksrav(o, x, 40),
    "ksrlv_40": lambda b, o, x, y: b.ksrlv(o, x, 40),
    "kdotpps_9": lambda b, o, x, y: b.kdotpps(o[3], x, y, 9),
    "ksvaddrf_big": lambda b, o, x, y: b.ksvaddrf(o[0], x, -(1 << 40)),
    "ksvmulrf_big": lambda b, o, x, y: b.ksvmulrf(o[15], x, 2_000_000_011),
    "kvred": lambda b, o, x, y: b.kvred(o[7], x),
}


@pytest.mark.parametrize("eb", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_oracle_only_edge_cases(case, eb):
    """Out-of-range immediates, shifts past the width and wrapping
    reductions: the oracle is the reference here (the Pallas backend
    raises or wraps early on several)."""
    p = _single_op_program(eb, EDGE_CASES[case])
    want = get_backend("oracle").run(p).outputs["out"]
    got = TorchBackend(device="cpu").run(
        tk.program_from_reference(p)).outputs["out"]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_overflowing_kdotpps_follows_the_oracle():
    """64 elements, a = 2^20, b = 2^10, shift 8: the oracle shifts the
    exact 2^36 and gives 2^28; the reference Pallas kernel gives 0."""
    b = KviProgramBuilder("ovf")
    ha = b.mem_in("a", np.full(64, 1 << 20, np.int32))
    hb = b.mem_in("b", np.full(64, 1 << 10, np.int32))
    ra, rb, acc = b.vreg("a", 64), b.vreg("b", 64), b.vreg("acc", 1)
    b.kmemld(ra, ha)
    b.kmemld(rb, hb)
    b.kdotpps(acc[0], ra, rb, 8)
    b.kmemstr(b.mem_out("out", 1), acc)
    p = b.build()
    assert get_backend("oracle").run(p).outputs["out"][0] == 1 << 28
    got = TorchBackend(device="cpu").run(tk.program_from_reference(p))
    assert got.outputs["out"][0] == 1 << 28


def _random_program(rng, eb, n_items=40, L=16):
    """Random element-wise / reduction / copy traffic over overlapping
    windows of a few registers, every register stored at the end."""
    info = np.iinfo(NP_OF[eb])
    b = KviProgramBuilder("rand")
    regs = [b.vreg(f"r{k}", L, eb) for k in range(4)]
    for k in range(2):
        b.kmemld(regs[k], b.mem_in(f"in{k}", rng.integers(
            info.min, info.max + 1, L).astype(NP_OF[eb]), elem_bytes=eb))

    def win(n):
        r = regs[int(rng.integers(len(regs)))]
        off = int(rng.integers(0, L - n + 1))
        return r.view(off, n)

    ops = ("kaddv", "ksubv", "kvmul", "kvslt", "ksvaddsc", "ksvmulsc",
           "ksrlv", "ksrav", "krelu", "ksvslt", "kvcp", "kdotp", "kdotpps",
           "kvred", "ksvaddrf", "ksvmulrf")
    for _ in range(n_items):
        op = str(rng.choice(ops))
        n = int(rng.choice([4, 8, 16]))
        big = int(rng.integers(-(1 << 40), 1 << 40))
        if op in ("kaddv", "ksubv", "kvmul", "kvslt"):
            getattr(b, op)(win(n), win(n), win(n))
        elif op in ("ksvaddsc", "ksvmulsc"):
            getattr(b, op)(win(n), win(n), big)
        elif op == "ksvslt":
            b.ksvslt(win(n), win(n), int(rng.integers(-(1 << 31), 1 << 31)))
        elif op in ("ksrlv", "ksrav"):
            getattr(b, op)(win(n), win(n), int(rng.integers(0, 40)))
        elif op in ("krelu", "kvcp"):
            getattr(b, op)(win(n), win(n))
        elif op in ("kdotp", "kdotpps"):
            args = (win(1), win(n), win(n))
            b.kdotp(*args) if op == "kdotp" else b.kdotpps(
                *args, int(rng.integers(0, 70)))
        elif op == "kvred":
            b.kvred(win(1), win(n))
        else:
            getattr(b, op)(win(1), win(n), big)
        b.scalar(int(rng.integers(0, 3)))
    for k, r in enumerate(regs):
        b.kmemstr(b.mem_out(f"out{k}", L, elem_bytes=eb), r)
    return b.build()


@pytest.mark.parametrize("passes", [None, ()])
@pytest.mark.parametrize("eb", [1, 2, 4])
@pytest.mark.parametrize("seed", range(4))
def test_random_programs_bit_exact_vs_oracle(seed, eb, passes):
    rng = np.random.default_rng(1000 * seed + eb)
    progs = [_random_program(rng, eb)]
    # a second data instance of the same structure: a batch of two
    progs.append(progs[0].replace(mem_init={
        k: rng.permutation(v) for k, v in progs[0].mem_init.items()}))
    wl = KviWorkload.homogeneous(progs)
    got = TorchBackend(device="cpu", passes=passes).run_workload(_port(wl))
    _assert_same_outputs(got, get_backend("oracle").run_workload(wl))


def test_compile_cache_hits_on_the_second_run():
    rng = np.random.default_rng(2)
    wl = _port(KviWorkload.homogeneous(_instances("fft32", 4, rng)))
    cache = KernelCache()
    first = TorchBackend(device="cpu", kernel_cache=cache).run_workload(wl)
    second = TorchBackend(device="cpu", kernel_cache=cache).run_workload(wl)
    assert first.meta["compile_cache"]["misses"] > 0
    assert second.meta["compile_cache"] == {
        "hits": second.kernel_launches, "misses": 0}
    assert cache.entries == len(cache) == cache.stats["entries"] \
        == first.meta["compile_cache"]["misses"]
    _assert_same_outputs(first, second)
    cache.clear()
    assert cache.stats == {"hits": 0, "misses": 0, "entries": 0}


def test_verify_is_refused_not_skipped():
    """verify=True runs the port's static analyzer: a broken program is
    refused with the reference's KviVerificationError before anything
    runs, and a clean one gives verify=False's outputs."""
    import dataclasses

    from repro_torch.kvi.analysis import KviVerificationError
    p = tk.program_from_reference(pipeline_demo_program(np.arange(8)))
    idx, it = next((i, it) for i, it in enumerate(p.items)
                   if isinstance(it, tk.KviInstr) and it.src1 is not None
                   and it.src1.space == "vreg")
    items = list(p.items)
    items[idx] = dataclasses.replace(
        it, src1=dataclasses.replace(it.src1, offset=10 ** 6))
    bad = dataclasses.replace(p, items=tuple(items))
    be = TorchBackend(device="cpu", verify=True)
    with pytest.raises(KviVerificationError, match="KVI105"):
        be.run_workload(tk.KviWorkload.single(bad))
    assert be.fused_calls == be.reduce_calls == 0
    with pytest.raises(KviVerificationError):
        TorchBackend(device="cpu").run_workload(tk.KviWorkload.single(bad),
                                                verify=True)
    wl = tk.KviWorkload.single(p)
    _assert_same_outputs(be.run_workload(wl),
                         TorchBackend(device="cpu").run_workload(wl))


def test_registry_and_meta():
    assert set(tk.available_backends()) == {"oracle", "torch", "cyclesim"}
    be = tk.get_backend("torch", device="cpu")
    assert isinstance(be, TorchBackend) and be.device.type == "cpu"
    p = tk.program_from_reference(pipeline_demo_program(np.arange(8)))
    res = be.run_workload(tk.KviWorkload.single(p))
    assert set(res.meta) == {"groups", "kernel_launches", "compile_cache",
                             "wall_s"}
    np.testing.assert_array_equal(be.run(p).outputs["y"],
                                  pipeline_demo_oracle(np.arange(8)))
    with pytest.raises(KeyError):
        tk.get_backend("pallas")
