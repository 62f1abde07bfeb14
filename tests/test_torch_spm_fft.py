"""The port's batched FFT (repro_torch.kernels.spm_fft) against the
reference Pallas kernel (repro.kernels.ops.fft_op, interpret mode on the
CPU) and the oracles, at rtol 1e-3 and atol 1e-3 n (the JAX test's).
Run with ``-s`` to see the largest error observed at each shape."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.spm_fft import _bitrev as ref_bitrev
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spm_fft as sf

SHAPES = [(8, 256), (3, 64), (1, 1024), (4, 2), (2, 1)]


@pytest.mark.parametrize("B,n", SHAPES)
def test_vs_pallas(B, n):
    rng = np.random.default_rng(B * n)
    re = rng.normal(0, 1, (B, n)).astype(np.float32)
    im = rng.normal(0, 1, (B, n)).astype(np.float32)
    wre, wim = (np.asarray(x) for x in jops.fft_op(jnp.asarray(re),
                                                   jnp.asarray(im)))
    gre, gim = sf.spm_fft(torch.from_numpy(re), torch.from_numpy(im))
    assert gre.dtype == gim.dtype == torch.float32
    for got, want in ((gre.numpy(), wre), (gim.numpy(), wim)):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * n)
    ore, oim = (np.asarray(x) for x in jref.fft_ref(jnp.asarray(re),
                                                    jnp.asarray(im)))
    tre, tim = tref.fft_ref(torch.from_numpy(re), torch.from_numpy(im))
    np.testing.assert_allclose(tre.numpy(), ore, rtol=1e-5, atol=1e-5 * n)
    np.testing.assert_allclose(tim.numpy(), oim, rtol=1e-5, atol=1e-5 * n)
    err = max(np.abs(gre.numpy() - wre).max(), np.abs(gim.numpy() - wim).max())
    print(f"spm_fft ({B}, {n}): max |port - pallas| = {err:.3e}")


def test_bitrev_and_twiddles_follow_the_reference():
    for n in (1, 2, 8, 1024):
        np.testing.assert_array_equal(sf._bitrev(n), ref_bitrev(n))
    tw = sf.twiddles(256, "cpu").numpy()
    h = 1
    while h < 256:
        k = jnp.arange(h, dtype=jnp.float32)
        ang = -2.0 * np.pi * k / (2 * h)        # the reference kernel's
        np.testing.assert_allclose(tw[0, h - 1:2 * h - 1], np.cos(ang),
                                   atol=2e-7)
        np.testing.assert_allclose(tw[1, h - 1:2 * h - 1], np.sin(ang),
                                   atol=2e-7)
        h *= 2


def test_integer_planes_are_taken_as_float32():
    re = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    gre, gim = sf.spm_fft(re, torch.zeros_like(re))
    want = np.fft.fft(re.numpy().astype(np.float64))
    np.testing.assert_allclose(gre.numpy(), want.real, atol=1e-4)
    np.testing.assert_allclose(gim.numpy(), want.imag, atol=1e-4)


@pytest.mark.parametrize("n", [3, 12, 32768])
def test_rejects_unsupported_lengths(n):
    x = torch.zeros((1, n))
    with pytest.raises(ValueError):
        sf.spm_fft(x, x)
