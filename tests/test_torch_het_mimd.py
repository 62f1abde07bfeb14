"""The port's het-MIMD composite (repro_torch.kernels.het_mimd) against
the reference Pallas kernel (repro.kernels.het_mimd, interpret mode on
the CPU): the JAX test's case, the paper's composite sizes
(examples/composite_workload.py) and an even filter, at the JAX test's
tolerances (matmul 1e-4, FFT rtol 1e-3 / atol 0.2, conv 1e-3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.het_mimd import het_mimd_composite as pallas_composite
from repro_torch.kernels import het_mimd as hm
from repro_torch.kvi import array_from_reference


def _case(rng, H, W, F, nb, n, m, k, p, padded_zero):
    if padded_zero:           # the JAX test: a zero-padded inner image
        inner = rng.normal(0, 1, (H, W)).astype(np.float32)
        img = np.pad(inner, ((F // 2, F - 1 - F // 2),) * 2)
    else:                     # the example: a random pre-padded image
        img = rng.normal(0, 1, (H + F - 1, W + F - 1)).astype(np.float32)
    shapes = [(F, F), (nb, n), (nb, n), (m, k), (k, p)]
    return [img] + [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("case", [
    dict(H=32, W=32, F=3, nb=4, n=128, m=32, k=48, p=16, padded_zero=True),
    dict(H=32, W=32, F=3, nb=4, n=256, m=64, k=64, p=64, padded_zero=False),
    dict(H=21, W=13, F=4, nb=3, n=32, m=7, k=9, p=11, padded_zero=True)],
    ids=["jax_test", "paper", "even_filter"])
def test_vs_pallas(case):
    ops = _case(np.random.default_rng(7), **case)
    want = [np.asarray(x) for x in pallas_composite(
        *[jnp.asarray(x) for x in ops], interpret=True)]
    got = hm.het_mimd_composite(*[array_from_reference(x) for x in ops])
    assert len(got) == 4 and all(g.dtype == torch.float32 for g in got)
    conv, ore, oim, mm = (g.numpy() for g in got)
    np.testing.assert_allclose(mm, want[3], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ore, want[1], rtol=1e-3, atol=0.2)
    np.testing.assert_allclose(oim, want[2], rtol=1e-3, atol=0.2)
    np.testing.assert_allclose(conv, want[0], rtol=1e-3, atol=1e-3)
    # and each part against the reference oracles
    np.testing.assert_allclose(mm, ops[4] @ ops[5], rtol=1e-4,
                               atol=1e-4)
    wre, _ = jref.fft_ref(jnp.asarray(ops[2]), jnp.asarray(ops[3]))
    np.testing.assert_allclose(ore, np.asarray(wre), rtol=1e-3, atol=0.2)
    if case["padded_zero"]:
        F = case["F"]
        inner = ops[0][F // 2:F // 2 + case["H"], F // 2:F // 2 + case["W"]]
        np.testing.assert_allclose(
            conv, np.asarray(jref.conv2d_ref(jnp.asarray(inner),
                                             jnp.asarray(ops[1]))),
            rtol=1e-3, atol=1e-3)


def test_operands_of_other_dtypes_give_float32():
    rng = np.random.default_rng(8)
    ops = _case(rng, 8, 8, 3, 2, 16, 8, 8, 8, padded_zero=True)
    ops[4], ops[5] = (jnp.asarray(ops[4], jnp.bfloat16),
                      jnp.asarray(ops[5], jnp.bfloat16))
    want = pallas_composite(*[jnp.asarray(x) for x in ops], interpret=True)
    got = hm.het_mimd_composite(*[array_from_reference(x) for x in ops])
    assert got[3].dtype == torch.float32
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-4, atol=1e-4)


def test_rejects_bad_operands():
    z = torch.zeros
    with pytest.raises(ValueError):              # image smaller than filter
        hm.het_mimd_composite(z(2, 2), z(3, 3), z(1, 4), z(1, 4), z(2, 2),
                              z(2, 2))
    with pytest.raises(ValueError):              # n not a power of two
        hm.het_mimd_composite(z(5, 5), z(3, 3), z(1, 6), z(1, 6), z(2, 2),
                              z(2, 2))
    with pytest.raises(ValueError):              # A @ B mismatch
        hm.het_mimd_composite(z(5, 5), z(3, 3), z(1, 4), z(1, 4), z(2, 3),
                              z(2, 2))


def test_rejects_a_filter_the_conv_tile_cannot_stage():
    """The conv hart stages a (31 + F)^2 window and the filter in shared
    memory: F = 155 no longer fits (232 448 bytes a block)."""
    z = torch.zeros
    assert hm.check_tile_filter(z(154, 154), z(160, 160)) == 154
    with pytest.raises(ValueError, match="shared memory"):
        hm.het_mimd_composite(z(160, 160), z(155, 155), z(1, 4), z(1, 4),
                              z(2, 2), z(2, 2))
