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
from repro_torch.kernels import checks, micro, ops
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


def test_float16_x_gives_float16_y():
    """float16 x, as the reference takes it: y in float16 (one float16
    step, 2^-10, on top of the JAX test's tolerance), the state float32."""
    args = _inputs(np.random.default_rng(5), 2, 64, 4, 16, 8, 2,
                   jnp.float16)
    y_p, s_p = jops.ssd_scan_op(*args, chunk=16, interpret=True)
    y, state = ops.ssd_scan_op(*_port(args), chunk=16)
    assert y.dtype == torch.float16 and state.dtype == torch.float32
    want = np.asarray(y_p).astype(np.float32)
    err = np.abs(y.float().numpy() - want)
    assert np.all(err <= TOL + (TOL + 2.0 ** -10) * np.abs(want))
    _close(state, s_p)


def test_wide_state_vs_pallas():
    """N past the old card limit of 608 (N 640, chunk 64 here; the card
    runs N 1024 at chunk 256), against the Pallas kernel."""
    args = _inputs(np.random.default_rng(6), 1, 128, 2, 8, 640, 1)
    y_p, s_p = jops.ssd_scan_op(*args, chunk=64, interpret=True)
    y, state = ops.ssd_scan_op(*_port(args), chunk=64)
    _close(y, y_p)
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
    """The kernels' shared memory at the mamba2-1.3b row (chunk 256): each
    at most 110 KB, so two blocks fit an SM's 228 KB. N and P take none
    (they are tiled in the grid), so any state width runs; the chunk
    state's per-step vectors set the chunk's limit, 16469 steps."""
    row = ss.smem_bytes(256)
    assert row == {"ssd_scores": 34816, "ssd_chunk_state": 37888,
                   "ssd_state_pass": 0, "ssd_train_scan": 36864}
    assert set(row) == set(ss.PARTS)
    assert 2 * max(row.values()) <= 228 * 1024
    assert ss.smem_bytes(64)["ssd_chunk_state"] < row["ssd_chunk_state"]
    assert max(ss.smem_bytes(16469).values()) <= ss.MAX_SMEM
    assert ss.smem_bytes(16470)["ssd_chunk_state"] > ss.MAX_SMEM
    assert ss.smem_bytes(16470)["ssd_train_scan"] <= ss.MAX_SMEM


@pytest.mark.parametrize("S,chunk", [(64, 64), (160, 32)],
                         ids=["one_chunk", "five_chunks"])
def test_three_plain_steps_vs_the_reference(S, chunk):
    """The chunk states, the scan over chunks and the chunk scan, composed
    by hand, against the Pallas kernel (interpret mode) and
    ``ssd_chunked`` at S / cs = 1 and 5."""
    Bz, H, P, N, G = 2, 4, 16, 8, 2
    args = _inputs(np.random.default_rng(S + 9), Bz, S, H, P, N, G)
    y_p, s_p = jops.ssd_scan_op(*args, chunk=chunk, interpret=True)
    y_m, s_m = jssm.ssd_chunked(*args, chunk=chunk)
    x, dt, A, Bm, Cm = _port(args)
    da = dt * A[None, None]
    cs = ss.chunk_size(S, chunk)
    states, cum = ss.chunk_state_plain(x, da, dt, Bm, cs)
    assert tuple(states.shape) == (Bz, H, S // cs, N, P)
    assert tuple(cum.shape) == (Bz, H, S)
    h_in, state = ss.state_pass_plain(states, cum, cs)
    assert h_in is states and torch.all(h_in[:, :, 0] == 0)
    y = ss.chunk_scan_plain(x, dt, Bm, Cm, cum, h_in, cs)
    for got_y, got_s in ((y, state), ss.ssd_scan(x, da, dt, Bm, Cm,
                                                  chunk=chunk)):
        _close(got_y, y_p)
        _close(got_s, s_p)
        _close(got_y, y_m)
        _close(got_s.transpose(-1, -2), s_m)


def test_kernel_wrappers_on_cpu_run_their_plain_versions():
    """On CPU tensors each of the four wrappers is its plain version and
    counts no launch."""
    x, dt, A, Bm, Cm = _port(_inputs(np.random.default_rng(10), 1, 96, 2, 8,
                                     6, 1, jnp.bfloat16))
    da = dt * A[None, None]
    before = (ss.launch_count, dict(ss.part_launches))
    sc = ss.scores(Bm, Cm, 32)
    assert tuple(sc.shape) == (1, 1, 3, 32, 32)
    assert torch.equal(sc, ss.scores_plain(Bm, Cm, 32))
    states, cum = ss.chunk_state(x, da, dt, Bm, 32)
    want_states, want_cum = ss.chunk_state_plain(x, da, dt, Bm, 32)
    assert torch.equal(states, want_states) and torch.equal(cum, want_cum)
    h_in, state = ss.state_pass(states.clone(), cum, 32)
    want_h, want_state = ss.state_pass_plain(states.clone(), cum, 32)
    assert torch.equal(h_in, want_h) and torch.equal(state, want_state)
    y = ss.train_scan(x, dt, Cm, cum, h_in, sc, 32)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, ss.train_scan_plain(x, dt, Cm, cum, h_in, sc, 32))
    assert torch.equal(y, ss.chunk_scan_plain(x, dt, Bm, Cm, cum, h_in, 32))
    assert (ss.launch_count, ss.part_launches) == before
    assert ss.LAUNCHES_PER_CALL == len(ss.PARTS) == 4


@pytest.mark.parametrize("Bz,S,H,P,N,G,chunk", [
    (2, 128, 4, 16, 8, 1, 32), (1, 96, 6, 8, 5, 2, 32),
    (2, 64, 3, 12, 4, 3, 16), (1, 48, 2, 24, 40, 1, 48)],
    ids=["G1", "G2_of_6", "G_eq_H", "S_eq_chunk"])
def test_op_equals_the_training_forward(Bz, S, H, P, N, G, chunk):
    """The op and the training scan share one forward: on the CPU in
    float32, ``ssd_scan(x, dt A, dt, B, C)`` gives ``ssd_train``'s y and
    final state bit for bit, B and C per group."""
    x, dt, A, Bm, Cm = _port(_inputs(np.random.default_rng(S + G), Bz, S, H,
                                     P, N, G))
    y, state = ss.ssd_scan(x, dt * A[None, None, :], dt, Bm, Cm, chunk=chunk)
    y_t, final = ss.ssd_train(x, dt, A, Bm, Cm, chunk=chunk)
    assert y.dtype == y_t.dtype == torch.float32
    assert torch.equal(y, y_t)
    assert torch.equal(state, final.transpose(-1, -2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_part_checks_rehearsed_on_the_cpu(dtype):
    """``checks.check_ssd_parts`` at its odd shapes on the CPU, where
    both sides are the plain versions: every difference is 0."""
    for shape in checks.ssd_part_cases()[:4]:
        err = checks.check_ssd_parts(np.random.default_rng(1), device="cpu",
                                     dtype=dtype, **shape)
        assert err == dict.fromkeys(ss.PARTS, 0.0)


def test_kernel_costs_split_the_function():
    """The scores, the chunk states and y split the function's products
    (``micro.cost``); the scan over chunks moves the workspace twice. The
    backward's launches (``ssd_train``) are costed beside them."""
    w = next(w for w in micro.CARD if w.name == "ssd_mamba2-1.3b_4096")
    parts = micro.ssd_part_costs(w.shape)
    assert set(parts) == set(ss.PARTS + ss.BWD_PARTS)
    nbytes, ops_terms = micro.cost(w)
    assert sum(parts[k][1][0][0] for k in ("ssd_scores", "ssd_chunk_state",
                                           "ssd_train_scan")) == \
        ops_terms[0][0]
    states = 2 * 64 * 16 * 128 * 64 * 4
    assert parts["ssd_state_pass"][0] == 2 * states + 2 * 64 * 16 * 4 \
        + 2 * 64 * 128 * 64 * 4
    assert micro.bound(*parts["ssd_state_pass"])["bound_by"] == "bytes"
    assert micro.bound(*parts["ssd_train_scan"])["bound_by"] == "operations"
