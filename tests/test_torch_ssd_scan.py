"""The port's SSD chunk scan (repro_torch.kernels.ssd_scan, through
``ops.ssd_scan_op``) against the reference Pallas kernel
(``repro.kernels.ops.ssd_scan_op`` and ``repro.kernels.ssd_scan`` in
interpret mode on the CPU), the reference oracle ``ssd_scan_ref`` (state
[Bz, H, N, P]) and the model path ``ssd_chunked`` (state [Bz, H, P, N]).
Inputs come from numpy with a seed, as ``TestSsdScan`` makes them. On CPU
tensors the wrapper runs its plain version.

Tolerance: the JAX test's rtol = atol = 3e-3
(``tests/kernels/test_kernels.py:113-115``); a bf16 y adds one bf16
step (2^-7 relative) for the output's rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models import ssm as jssm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kvi import array_from_reference

TOL = 3e-3
BF16_STEP = 2.0 ** -7


def _inputs(rng, Bz, S, H, P, N, G, xdtype=jnp.float32):
    x = jnp.asarray(rng.normal(0, 1, (Bz, S, H, P)), xdtype)
    dt = jnp.asarray(rng.uniform(0.001, 0.1, (Bz, S, H)), jnp.float32)
    A = -jnp.exp(jnp.asarray(rng.normal(0, 0.5, (H,)), jnp.float32))
    Bm = jnp.asarray(rng.normal(0, 1, (Bz, S, G, N)), jnp.float32)
    Cm = jnp.asarray(rng.normal(0, 1, (Bz, S, G, N)), jnp.float32)
    return x, dt, A, Bm, Cm


def _close(got: torch.Tensor, want, bf16: bool = False):
    want = np.asarray(want).astype(np.float32)
    tol = TOL + TOL * np.abs(want)
    if bf16:
        tol = tol + BF16_STEP * np.abs(want)
    assert tuple(got.shape) == want.shape
    err = np.abs(got.float().numpy() - want)
    assert np.all(err <= tol), f"max error {err.max()}"


def _port(args):
    return [array_from_reference(a) for a in args]


# TestSsdScan's three (S, chunk) cases, then chunk > S
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("S,chunk", [(128, 32), (256, 256), (64, 16),
                                     (48, 256)])
def test_vs_pallas_and_the_oracle(S, chunk, G):
    Bz, H, P, N = 2, 4, 16, 8
    args = _inputs(np.random.default_rng(S + chunk + G), Bz, S, H, P, N, G)
    y_p, s_p = jops.ssd_scan_op(*args, chunk=chunk, interpret=True)
    y, state = ops.ssd_scan_op(*_port(args), chunk=chunk)
    assert y.dtype == torch.float32 and state.dtype == torch.float32
    _close(y, y_p)
    _close(state, s_p)
    x, dt, A, Bm, Cm = args
    rep = H // G
    y_r, s_r = jref.ssd_scan_ref(x, dt * A[None, None], dt,
                                 jnp.repeat(Bm, rep, axis=2),
                                 jnp.repeat(Cm, rep, axis=2))
    _close(y, y_r)
    _close(state, s_r)                         # [Bz, H, N, P]


def test_bf16_x_gives_bf16_y():
    args = _inputs(np.random.default_rng(4), 2, 64, 4, 16, 8, 2,
                   jnp.bfloat16)
    y_p, s_p = jops.ssd_scan_op(*args, chunk=16, interpret=True)
    y, state = ops.ssd_scan_op(*_port(args), chunk=16)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    _close(y, y_p, bf16=True)
    _close(state, s_p)


def test_kernel_signature_vs_pallas_kernel():
    """``ssd_scan`` itself (da = dt A and head-broadcast B / C given)."""
    Bz, S, H, P, N = 1, 96, 3, 8, 4
    x, dt, A, Bm, Cm = _inputs(np.random.default_rng(5), Bz, S, H, P, N, 1)
    da = dt * A[None, None]
    Bh, Ch = jnp.repeat(Bm, H, axis=2), jnp.repeat(Cm, H, axis=2)
    y_p, s_p = pallas_ssd_scan(x, da, dt, Bh, Ch, chunk=32, interpret=True)
    y, state = ss.ssd_scan(*_port((x, da, dt, Bh, Ch)), chunk=32)
    _close(y, y_p)
    _close(state, s_p)


def test_state_layouts_against_ssd_chunked():
    """The model path's state is [Bz, H, P, N]; the kernel's is its
    transpose."""
    Bz, S, H, P, N, G = 1, 64, 4, 8, 6, 2
    args = _inputs(np.random.default_rng(6), Bz, S, H, P, N, G)
    y_m, s_m = jssm.ssd_chunked(*args, chunk=16)
    y, state = ops.ssd_scan_op(*_port(args), chunk=16)
    assert tuple(state.shape) == (Bz, H, N, P)
    assert tuple(s_m.shape) == (Bz, H, P, N)
    _close(y, y_m)
    _close(state.transpose(-1, -2), s_m)


def test_port_oracle_matches_the_reference_oracle():
    Bz, S, H, P, N = 2, 40, 2, 4, 3
    x, dt, A, Bm, Cm = _inputs(np.random.default_rng(7), Bz, S, H, P, N, 1)
    da = dt * A[None, None]
    Bh, Ch = jnp.repeat(Bm, H, axis=2), jnp.repeat(Cm, H, axis=2)
    y_r, s_r = jref.ssd_scan_ref(x, da, dt, Bh, Ch)
    y, state = tref.ssd_scan_ref(*_port((x, da, dt, Bh, Ch)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(s_r), rtol=1e-5,
                               atol=1e-5)


def test_sequence_not_a_multiple_of_the_chunk_raises():
    x, dt, A, Bm, Cm = _port(_inputs(np.random.default_rng(8), 1, 100, 2,
                                     4, 4, 2))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan_op(x, dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ss.ssd_scan_plain(x, dt * A, dt, Bm, Cm, chunk=32)


def test_shared_memory_of_the_mamba2_row():
    """The kernel's shared memory at the mamba2-1.3b row (N 128, P 64,
    chunk 256) fits a block's 227 KB; a wider state does not."""
    assert ss.smem_bytes(128, 64, 256) == 183040 <= ss.MAX_SMEM
    assert ss.smem_bytes(256, 128, 256) > ss.MAX_SMEM
