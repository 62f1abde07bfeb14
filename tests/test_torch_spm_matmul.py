"""The port's tiled matmul (repro_torch.kernels.spm_matmul) against the
reference Pallas kernel (repro.kernels.spm_matmul, interpret mode on the
CPU) and the reference oracle. Inputs come from numpy with a seed and go
to both packages; bf16 crosses bit for bit through
``array_from_reference``. On CPU tensors the wrapper runs its plain
version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.spm_matmul import spm_matmul as pallas_matmul
from repro_torch.kernels import checks
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spm_matmul as sm
from repro_torch.kvi import array_from_reference

SHAPES = [(64, 64, 64), (33, 65, 17), (128, 96, 160)]
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "int8": torch.int8, "int32": torch.int32, "float16": torch.float16,
         "int16": torch.int16, "uint8": torch.uint8}
#: integer operands of the float32-accumulating types: sums below 2^24,
#: so exact in any order; int16 and uint8 outputs saturate
INT_RANGE = {"int8": (-128, 128), "int16": (-100, 100),
             "int32": (-100, 100), "uint8": (0, 16)}


def _operands(rng, M, K, N, dtype):
    if dtype in INT_RANGE:
        lo, hi = INT_RANGE[dtype]
        return (jnp.asarray(rng.integers(lo, hi, (M, K)), dtype),
                jnp.asarray(rng.integers(lo, hi, (K, N)), dtype))
    return (jnp.asarray(rng.normal(0, 1, (M, K)), dtype),
            jnp.asarray(rng.normal(0, 1, (K, N)), dtype))


@pytest.mark.parametrize("dtype,out_dtype,want_dtype,tol", [
    ("float32", None, "float32", 1e-4),
    ("bfloat16", None, "bfloat16", 3e-2),        # the JAX test's
    ("bfloat16", "float32", "float32", 1e-4),
    ("int8", None, "int32", 0),
    # the rest of the reference's domain: float16, int16, int32, uint8
    # (float32 sums cast back), int8 into other out_dtypes (the int32
    # sum cast: floats through float32, narrower ints wrapped)
    ("float16", None, "float16", 3e-2),
    ("int16", None, "int16", 0),
    ("int32", None, "int32", 0),
    ("uint8", None, "uint8", 0),
    ("int16", "float32", "float32", 0),
    ("int8", "float32", "float32", 0),
    ("int8", "bfloat16", "bfloat16", 0),
    ("int8", "float16", "float16", 0),
    ("int8", "int16", "int16", 0),
    ("int8", "uint8", "uint8", 0)])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_vs_pallas(shape, dtype, out_dtype, want_dtype, tol):
    rng = np.random.default_rng(sum(shape))
    ja, jb = _operands(rng, *shape, dtype)
    want = np.asarray(pallas_matmul(
        ja, jb, out_dtype=None if out_dtype is None else jnp.dtype(out_dtype),
        interpret=True))
    got = sm.spm_matmul(array_from_reference(ja), array_from_reference(jb),
                        out_dtype=out_dtype and TORCH[out_dtype])
    assert got.dtype == TORCH[want_dtype] and tuple(got.shape) == want.shape
    if tol == 0:
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))
    else:
        np.testing.assert_allclose(got.float().numpy(),
                                   want.astype(np.float32), rtol=tol,
                                   atol=tol)


def test_int8_sum_wraps_like_the_int32_accumulator():
    """K = 140000 terms of (-128)(-128): the exact sum 2,293,760,000
    passes 2^31; the reference's int32 accumulator wraps it."""
    K = 140_000
    a = np.full((1, K), -128, np.int8)
    b = np.full((K, 2), -128, np.int8)
    want = np.asarray(pallas_matmul(jnp.asarray(a), jnp.asarray(b),
                                    interpret=True))
    got = sm.spm_matmul(torch.from_numpy(a), torch.from_numpy(b))
    wrapped = (K * 16384 + (1 << 31)) % (1 << 32) - (1 << 31)
    assert got.tolist() == want.tolist() == [[wrapped, wrapped]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_oracle_matches_the_reference_oracle(dtype):
    ja, jb = _operands(np.random.default_rng(3), 20, 30, 10, dtype)
    want = np.asarray(jref.matmul_ref(ja, jb))
    got = tref.matmul_ref(array_from_reference(ja), array_from_reference(jb))
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(33, 65, 17), (64, 64, 64),
                                   (32, 1024, 32), (64, 2048, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_float32_check_rejects_a_tf32_product(shape):
    """The float32 tolerance of the card checks (checks.compare_matmul,
    also the composite's matmul) passes the port's product and fails one
    with TF32-rounded inputs, at the K of the card checks."""
    a, b = checks.matmul_operands(np.random.default_rng(9), *shape,
                                  torch.float32, "cpu")
    assert checks.compare_matmul(sm.spm_matmul(a, b), a, b) >= 0
    out = checks.reject_tf32(checks.tf32_product(a, b), a, b)
    assert out["max_err_over_tol"] > 1 and out["share_outside"] > 0


def test_rejects_what_the_kernel_does_not_take():
    """What the reference refuses too: mismatched shapes and dtypes, and
    64-bit types (the reference without jax's x64 mode holds none).
    float16, int16 and int8 into float32 are taken
    (test_vs_pallas, test_the_probes_of_the_float32_accumulator)."""
    a8 = torch.zeros((2, 3), dtype=torch.int8)
    for dt in (torch.int64, torch.float64):
        with pytest.raises(TypeError):
            sm.spm_matmul(a8.to(dt), torch.zeros((3, 2), dtype=dt))
    with pytest.raises(TypeError):
        sm.spm_matmul(a8, a8.t(), out_dtype=torch.int64)
    with pytest.raises(ValueError):
        sm.spm_matmul(a8, torch.zeros((4, 2), dtype=torch.int8))
    with pytest.raises(ValueError):
        sm.spm_matmul(a8, torch.zeros((3, 2), dtype=torch.int16))


PROBES = {
    # (1 << 24) + 1 rounds to 2^24 as it is converted to float32
    "int32_rounds": (np.array([[(1 << 24) + 1]], np.int32),
                     np.array([[1]], np.int32), None, [[16777216]]),
    # 128 x 2^20 x 2^10 = 2^37: the cast back saturates, either sign
    "int32_saturates": (np.full((1, 128), 1 << 20, np.int32),
                        np.array([[1 << 10, -(1 << 10)]] * 128, np.int32),
                        None, [[2147483647, -2147483648]]),
    "uint8_stays_uint8": (np.array([[200, 3]], np.uint8),
                          np.array([[2], [1]], np.uint8), None, [[255]]),
    "int16_saturates": (np.array([[-200]], np.int16),
                        np.array([[300]], np.int16), None, [[-32768]]),
    "float16_into_int32": (np.array([[1.5]], np.float16),
                           np.array([[3]], np.float16), "int32", [[4]]),
    "nan_into_int32": (np.array([[np.nan, 1]], np.float32),
                       np.array([[1], [1]], np.float32), "int32", [[0]]),
    "int8_into_float32": (np.full((1, 130), 127, np.int8),
                          np.full((130, 1), 127, np.int8), "float32",
                          [[2096770.0]]),
    "int8_into_float16": (np.full((1, 130), 127, np.int8),
                          np.full((130, 1), 127, np.int8), "float16",
                          [[np.inf]]),
}


@pytest.mark.parametrize("name", sorted(PROBES))
def test_the_probes_of_the_float32_accumulator(name):
    """The reference's results at the edges of its casts, bit for bit:
    the Pallas kernel in interpret mode, the port's plain version, and
    the values the reference gives."""
    a, b, od, value = PROBES[name]
    want = np.asarray(pallas_matmul(
        jnp.asarray(a), jnp.asarray(b), interpret=True,
        out_dtype=None if od is None else jnp.dtype(od)))
    got = sm.spm_matmul(torch.from_numpy(a), torch.from_numpy(b),
                        out_dtype=od and TORCH[od])
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    np.testing.assert_array_equal(want.astype(np.float64),
                                  np.asarray(value, np.float64))


TC_SHAPES = [(256, 512, 384), (1, 1, 1), (33, 65, 17), (129, 257, 63),
             (70, 5, 200)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("shape", TC_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_tensor_core_operands_keep_the_product(shape, dtype):
    """``tc_operands`` (the tensor-core kernel's glue) pads K, and a bf16
    b's N, with zeros to whole 16-byte rows, and hands an int8 b over as
    b^T [N, Kp]: the product of what it returns is exactly ``a @ b`` —
    int8 through the plain version, bf16 in float64 (exact for these
    sums) and through the plain version. Aligned operands pass as they
    are, without a copy."""
    M, K, N = shape
    a, b = checks.matmul_operands(np.random.default_rng(sum(shape)), M, K,
                                  N, dtype, "cpu")
    ak, bk = sm.tc_operands(a, b)
    Kp = ak.shape[1]
    assert ak.is_contiguous() and bk.is_contiguous()
    assert ak.shape[0] == M and 0 <= Kp - K < 16 // a.element_size()
    assert Kp * a.element_size() % 16 == 0
    assert not ak[:, K:].any()
    want = sm.spm_matmul_plain(a, b)
    if dtype == torch.int8:
        assert tuple(bk.shape) == (N, Kp) and not bk[:, K:].any()
        assert torch.equal(sm.spm_matmul_plain(ak, bk.t()), want)
        return
    Np = bk.shape[1]
    assert bk.shape[0] == Kp and 0 <= Np - N < 8 and Np % 8 == 0
    assert not bk[K:].any() and not bk[:, N:].any()
    assert torch.equal((ak.double() @ bk.double())[:, :N],
                       a.double() @ b.double())
    assert torch.equal(sm.spm_matmul_plain(ak, bk)[:, :N], want)
    if (K, N) == (Kp, Np):
        assert ak.data_ptr() == a.data_ptr() and bk.data_ptr() == b.data_ptr()


def test_int8_wrap_check():
    """The card check of the tensor cores' wrapping s32 sum holds for
    the plain version: 65 x (2^17 + 4096) x 17 of -128 gives
    (K 16384 mod 2^32) as int32 everywhere."""
    assert checks.check_int8_wrap("cpu") == -2080374784


def test_bf16_and_int8_take_the_tensor_cores_and_float32_the_cuda_cores():
    for dt in (torch.bfloat16, torch.float16, torch.int8):
        assert sm.uses_tensor_cores(dt)
    for dt in (torch.float32, torch.int32, torch.int16, torch.uint8):
        assert not sm.uses_tensor_cores(dt)
    assert checks.case_paths("spm_matmul") == {"tensor_cores": 3,
                                               "cuda_cores": 1}
