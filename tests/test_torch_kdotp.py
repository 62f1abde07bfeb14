"""The port's reductions (repro_torch.kernels.kdotp) against the
reference Pallas kernels (repro.kernels.kdotp, interpret mode on CPU) and
the oracle's numpy formula. Inputs come from numpy with a seed and go to
both packages. On CPU tensors the wrapper runs its plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kdotp as ref_kd
from repro.kernels import ref as ref_ops
from repro_torch.kernels import checks
from repro_torch.kernels import kdotp as kd

INT_TYPES = (np.int8, np.int16, np.int32)


def _operands(rng, dtype, n):
    info = np.iinfo(dtype)
    a = rng.integers(info.min, info.max + 1, n).astype(dtype)
    b = rng.integers(info.min, info.max + 1, n).astype(dtype)
    return a, b


@pytest.mark.parametrize("n", [256, 4096])
@pytest.mark.parametrize("dtype", INT_TYPES + (np.uint8,))
@pytest.mark.parametrize("shift", [0, 7])
def test_kdotp_family_bit_exact_vs_pallas(dtype, shift, n):
    """Full-range operands, so the int32 accumulator wraps: the public
    functions follow the reference kernel's order (wrap, then shift)."""
    rng = np.random.default_rng(n + shift)
    a, b = _operands(rng, dtype, n)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if shift:
        got = kd.kdotpps(ta, tb, shift)
        want = ref_kd.kdotpps(ja, jb, shift, interpret=True)
    else:
        got = kd.kdotp(ta, tb)
        want = ref_kd.kdotp(ja, jb, interpret=True)
    assert got.dtype == torch.int32
    assert int(got) == int(want) == int(ref_ops.kdotp_ref(ja, jb, shift))
    assert int(kd.kvred(ta)) == int(ref_kd.kvred(ja, interpret=True))


def test_uint8_widens_without_sign():
    """300 lanes of 255: kdotp 19507500 and kvred 76500 in int32, as the
    reference's astype(int32) gives them; kdotpps shifts after."""
    a = np.full(300, 255, np.uint8)
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    got = (kd.kdotp(ta, ta), kd.kvred(ta), kd.kdotpps(ta, ta, 4))
    want = (ref_kd.kdotp(ja, ja, interpret=True),
            ref_kd.kvred(ja, interpret=True),
            ref_kd.kdotpps(ja, ja, 4, interpret=True))
    assert all(g.dtype == torch.int32 for g in got)
    assert [int(g) for g in got] == [int(w) for w in want] == \
        [19507500, 76500, 19507500 >> 4]


@pytest.mark.parametrize("shift", [0, 3])
def test_float32_within_pallas_tolerance(shift):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, 2048).astype(np.float32)
    y = rng.normal(0, 1, 2048).astype(np.float32)
    got = kd.kdotpps(torch.from_numpy(x), torch.from_numpy(y), shift)
    want = ref_kd.kdotpps(jnp.asarray(x), jnp.asarray(y), shift,
                          interpret=True)
    # the tolerance tests/kernels/test_kernels.py sets for the Pallas dot
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(kd.kvred(torch.from_numpy(x))),
                               float(ref_kd.kvred(jnp.asarray(x),
                                                  interpret=True)),
                               rtol=1e-5)


def _oracle(a, b, post, s):
    """repro/core/mfu.py: exact int64 sum, post op, wrap to int32."""
    acc = (a.astype(np.int64) * (b.astype(np.int64) if b is not None
                                 else 1)).sum(axis=1, dtype=np.int64)
    if post == kd.POST_SHIFT:
        acc = acc >> s
    elif post == kd.POST_ADD:
        acc = acc + s
    elif post == kd.POST_MUL:
        acc = (a.astype(np.int64) * np.int64(s)).sum(axis=1, dtype=np.int64)
    return acc.astype(np.int32)


@pytest.mark.parametrize("dtype", INT_TYPES)
@pytest.mark.parametrize("post,scalar,dot", [
    (kd.POST_NONE, 0, True), (kd.POST_SHIFT, 9, True),
    (kd.POST_NONE, 0, False), (kd.POST_ADD, -123456789, False),
    (kd.POST_MUL, 2_000_000_011, False), (kd.POST_MUL, -77, False)])
def test_oracle_mode_matches_mfu(dtype, post, scalar, dot):
    rng = np.random.default_rng(7)
    info = np.iinfo(dtype)
    a = rng.integers(info.min, info.max + 1, (5, 96)).astype(dtype)
    b = rng.integers(info.min, info.max + 1, (5, 96)).astype(dtype) \
        if dot else None
    out = torch.empty(5, dtype=torch.int32)
    kd.reduce_rows(out, torch.from_numpy(a),
                   None if b is None else torch.from_numpy(b),
                   post=post, scalar=scalar, mode=kd.ORACLE)
    np.testing.assert_array_equal(out.numpy(), _oracle(a, b, post, scalar))


def test_overflowing_kdotpps_both_modes():
    """The exact 2^36 sum shifted by 8 is 2^28 (oracle); the reference
    Pallas kernel wraps first and gives 0."""
    checks.check_overflow_kdotpps("cpu")
    a = np.full(64, 1 << 20, np.int32)
    b = np.full(64, 1 << 10, np.int32)
    assert int(ref_kd.kdotpps(jnp.asarray(a), jnp.asarray(b), 8,
                              interpret=True)) == 0


def test_result_wraps_to_destination_width():
    out = torch.zeros(3, dtype=torch.int8)
    a = torch.full((3, 10), 100, dtype=torch.int32)
    kd.reduce_rows(out, a)                          # 1000 -> int8: -24
    assert out.tolist() == [-24] * 3


def test_strided_destination_column():
    regfile = torch.zeros((4, 5), dtype=torch.int32)
    a = torch.arange(32, dtype=torch.int32).reshape(4, 8)
    kd.reduce_rows(regfile[:, 2], a)
    assert regfile[:, 2].tolist() == a.sum(1).tolist()
    assert int(regfile[:, [0, 1, 3, 4]].abs().sum()) == 0


def test_plain_path_counts_no_launch():
    before = kd.launch_count
    kd.kvred(torch.arange(10, dtype=torch.int32))
    assert kd.launch_count == before


@pytest.mark.parametrize("bad", ["float_add", "dtype_mismatch", "out_dtype",
                                 "shape", "stride", "device"])
def test_wrapper_rejects(bad):
    a = torch.ones((2, 8), dtype=torch.int32)
    b, out = a.clone(), torch.empty(2, dtype=torch.int32)
    kw = {}
    if bad == "float_add":
        a, b, out = a.float(), b.float(), out.float()
        kw = dict(post=kd.POST_ADD, scalar=1)
    elif bad == "dtype_mismatch":
        b = b.to(torch.int16)
    elif bad == "out_dtype":
        out = out.float()
    elif bad == "shape":
        out = torch.empty(3, dtype=torch.int32)
    elif bad == "stride":
        a = torch.ones((8, 2), dtype=torch.int32).t()
    elif bad == "device":
        a, b, out = (t.to("meta") for t in (a, b, out))
    with pytest.raises((TypeError, ValueError)):
        kd.reduce_rows(out, a, b, **kw)
