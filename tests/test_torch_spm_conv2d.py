"""The port's same-size conv2d (repro_torch.kernels.spm_conv2d) against
the reference Pallas kernel (repro.kernels.ops.conv2d_op, interpret mode
on the CPU) and the reference oracle: int32 bit for bit (also where the
sums overflow int32, and with shifts 0, 4 and 31), float32 within 1e-5,
bf16 within 2 ulp. Inputs come from numpy with a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spm_conv2d as sc
from repro_torch.kvi import array_from_reference

SHAPES = [(32, 32, 3), (64, 48, 5), (16, 16, 7), (33, 31, 3),
          (17, 23, 4)]                       # F = 4: the asymmetric pad


def _port(img, filt, shift=0):
    return sc.spm_conv2d(array_from_reference(img),
                         array_from_reference(filt), shift=shift)


@pytest.mark.parametrize("H,W,F", SHAPES)
def test_int32_exact(H, W, F):
    """The JAX test's ranges and shift."""
    rng = np.random.default_rng(H * W + F)
    img = jnp.asarray(rng.integers(-128, 128, (H, W)), jnp.int32)
    filt = jnp.asarray(rng.integers(-8, 8, (F, F)), jnp.int32)
    want = np.asarray(jops.conv2d_op(img, filt, shift=4))
    got = _port(img, filt, shift=4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shift", [0, 4, 31])
@pytest.mark.parametrize("H,W,F", [(33, 31, 3), (17, 23, 4), (16, 16, 7)])
def test_int32_overflow_wraps_then_shifts(H, W, F, shift):
    """|img| < 2^20 and |filt| < 2^10: the sums pass 2^31; the wrapped
    int32 is shifted, as the reference does."""
    rng = np.random.default_rng(F + shift)
    img = jnp.asarray(rng.integers(-(1 << 20), 1 << 20, (H, W)), jnp.int32)
    filt = jnp.asarray(rng.integers(-(1 << 10), 1 << 10, (F, F)), jnp.int32)
    want = np.asarray(jops.conv2d_op(img, filt, shift=shift))
    np.testing.assert_array_equal(_port(img, filt, shift).numpy(), want)
    np.testing.assert_array_equal(
        tref.conv2d_ref(array_from_reference(img), array_from_reference(filt),
                        shift=shift).numpy(),
        np.asarray(jref.conv2d_ref(img, filt, shift=shift)))


@pytest.mark.parametrize("H,W,F", [(64, 64, 3), (17, 23, 4), (33, 31, 5)])
def test_float32_within_1e_5(H, W, F):
    rng = np.random.default_rng(F)
    img = jnp.asarray(rng.normal(0, 1, (H, W)), jnp.float32)
    filt = jnp.asarray(rng.normal(0, 1, (F, F)), jnp.float32)
    want = np.asarray(jops.conv2d_op(img, filt, shift=3))   # shift ignored
    got = _port(img, filt, shift=3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _ulp_bf16(x):
    """The spacing of bf16 at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("H,W,F", [(32, 32, 3), (17, 23, 4)])
def test_bfloat16_within_2_ulp(H, W, F):
    rng = np.random.default_rng(F + 1)
    img = jnp.asarray(rng.normal(0, 1, (H, W)), jnp.bfloat16)
    filt = jnp.asarray(rng.normal(0, 1, (F, F)), jnp.bfloat16)
    want = np.asarray(jops.conv2d_op(img, filt)).astype(np.float64)
    got = _port(img, filt)
    assert got.dtype == torch.bfloat16
    assert np.all(np.abs(got.double().numpy() - want) <= 2 * _ulp_bf16(want))


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.float16,
                                   torch.int64])
def test_other_dtypes_raise(dtype):
    with pytest.raises(TypeError):
        sc.spm_conv2d(torch.zeros((4, 4), dtype=dtype),
                      torch.zeros((3, 3), dtype=dtype))


def test_rejects_bad_filters():
    img = torch.zeros((8, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        sc.spm_conv2d(img, torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="shared memory"):
        sc.spm_conv2d(img, torch.zeros((300, 300), dtype=torch.int32))
