"""The port's model modules (repro_torch.models.layers and .ssm) against
the reference's (repro.models.layers and .ssm), function by function, at
small sizes. Inputs come from numpy with a seed and go to both packages.
float32 results agree to 1e-5 (both run the same float32 formulas in
different libraries), the chunked attention and SSD to the JAX kernel
tests' 2e-3 and 3e-3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models import ssm as jssm
from repro_torch import models as tmodels
from repro_torch.models import layers as tl
from repro_torch.models import ssm as tssm
from repro_torch.kvi import array_from_reference

T = array_from_reference


def _close(got, want, tol=1e-5):
    want = np.asarray(want).astype(np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def _normal(rng, shape, dtype=np.float32):
    return rng.normal(0, 1, shape).astype(dtype)


def test_models_package_holds_layers_and_ssm_only():
    assert tmodels.layers is tl and tmodels.ssm is tssm
    assert {m for m in ("layers", "ssm", "sharding", "params", "moe",
                        "model_zoo", "steps", "pipeline")
            if hasattr(tmodels, m)} == {"layers", "ssm", "sharding",
                                        "params", "moe", "model_zoo",
                                        "steps", "pipeline"}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(_normal(rng, (3, 5, 16)), dtype)
    w = jnp.asarray(_normal(rng, (16,)) * 0.1, jnp.float32)
    want = jl.rms_norm(x, w)
    got = tl.rms_norm(T(x), T(w))
    assert str(got.dtype).endswith(jnp.dtype(dtype).name)
    _close(got, want, 1e-5 if dtype == jnp.float32 else 2 ** -7)


def test_swiglu():
    rng = np.random.default_rng(1)
    x, wg, wu, wd = (_normal(rng, s) for s in ((2, 3, 8), (8, 12), (8, 12),
                                               (12, 8)))
    _close(tl.swiglu(*map(torch.from_numpy, (x, wg, wu, wd))),
           jl.swiglu(*map(jnp.asarray, (x, wg, wu, wd))), 1e-4)


def test_rope():
    np.testing.assert_array_equal(tl.rope_freqs(16, 10000.0),
                                  jl.rope_freqs(16, 10000.0))
    rng = np.random.default_rng(2)
    x = _normal(rng, (2, 7, 3, 16))
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), 1e-4)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5),
                                           (False, 5)])
def test_block_mask(causal, window):
    q_pos, k_pos = np.arange(10, 22), np.arange(0, 30)
    want = jl._block_mask(jnp.asarray(q_pos), jnp.asarray(k_pos), causal,
                          window)
    got = tl._block_mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                         causal, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (Sq, Skv, H, KV, causal, window, q_offset, q_block, kv_block, skip, rep)
XLA_CASES = [
    (64, 64, 4, 2, True, 0, 0, 16, 32, False, False),
    (48, 48, 5, 1, False, 0, 0, 48, 16, False, False),
    (64, 64, 4, 2, True, 12, 0, 16, 16, True, False),
    (32, 96, 4, 2, True, 20, 64, 16, 32, False, True),
    (32, 96, 6, 2, True, 0, 64, 32, 32, False, False),
]


@pytest.mark.parametrize("case", XLA_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_xla(case):
    Sq, Skv, H, KV, causal, window, off, qb, kb, skip, rep = case
    rng = np.random.default_rng(Sq + Skv + H)
    q = _normal(rng, (2, Sq, H, 16))
    k, v = _normal(rng, (2, Skv, KV, 16)), _normal(rng, (2, Skv, KV, 16))
    kw = dict(causal=causal, window=window, q_block=qb, kv_block=kb,
              q_offset=off, swa_block_skip=skip, repeat_kv=rep)
    want = jl.flash_attention_xla(*map(jnp.asarray, (q, k, v)), **kw)
    got = tl.flash_attention_xla(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(got, want, 2e-3)
    ref = tl.attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                           window=window, q_offset=off)
    _close(ref, jl.attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 window=window, q_offset=off))
    _close(got, ref.numpy(), 2e-3)             # every row sees a key here


def test_flash_attention_xla_bf16():
    rng = np.random.default_rng(3)
    q = jnp.asarray(_normal(rng, (1, 64, 4, 32)), jnp.bfloat16)
    k = jnp.asarray(_normal(rng, (1, 64, 2, 32)), jnp.bfloat16)
    v = jnp.asarray(_normal(rng, (1, 64, 2, 32)), jnp.bfloat16)
    want = np.asarray(jl.flash_attention_xla(q, k, v, q_block=16,
                                             kv_block=16)).astype(np.float32)
    got = tl.flash_attention_xla(T(q), T(k), T(v), q_block=16, kv_block=16)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert np.all(err <= 2e-3 * (1 + np.abs(want)) + 2 ** -7 * np.abs(want))


def test_flash_attention_xla_rejects_blocks_that_do_not_divide():
    x = torch.zeros((1, 48, 2, 8))
    with pytest.raises(ValueError):
        tl.flash_attention_xla(x, x, x, q_block=32)


@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention_and_cache_update_over_a_ring(window):
    """Ten decode steps of two sequences at different depths into a ring
    cache (window 6) or a full cache: every step's cache and output
    agree with the reference's."""
    rng = np.random.default_rng(4 + window)
    B, S, H, KV, hd = 2, 6 if window else 16, 4, 2, 8
    jk = jnp.zeros((B, S, KV, hd), jnp.float32)
    jv = jnp.zeros((B, S, KV, hd), jnp.float32)
    jpos = jnp.full((B, S), -1, jnp.int32)
    tk, tv, tpos = T(jk), T(jv), T(jpos)
    pos = np.array([0, 3], np.int32)
    for _ in range(10):
        q = _normal(rng, (B, 1, H, hd))
        kn, vn = _normal(rng, (B, 1, KV, hd)), _normal(rng, (B, 1, KV, hd))
        jk, jv, jpos = jl.cache_update(jk, jv, jpos, jnp.asarray(kn),
                                       jnp.asarray(vn), jnp.asarray(pos),
                                       window=window)
        before = tk.clone()
        tk, tv, tpos = tl.cache_update(tk, tv, tpos, torch.from_numpy(kn),
                                       torch.from_numpy(vn),
                                       torch.from_numpy(pos), window=window)
        assert not torch.equal(before, tk)       # a new tensor, inputs kept
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        want = jl.decode_attention(jnp.asarray(q), jk, jv, jpos,
                                   jnp.asarray(pos), window=window)
        got = tl.decode_attention(torch.from_numpy(q), tk, tv, tpos,
                                  torch.from_numpy(pos), window=window)
        _close(got, want)
        pos = pos + 1


def test_segsum_decay():
    a = -np.random.default_rng(5).uniform(0, 2, (3, 9)).astype(np.float32)
    _close(tssm._segsum_decay(torch.from_numpy(a)),
           jssm._segsum_decay(jnp.asarray(a)))


def _ssd_inputs(rng, Bz, S, H, P, N, G):
    return (_normal(rng, (Bz, S, H, P)),
            rng.uniform(0.001, 0.1, (Bz, S, H)).astype(np.float32),
            -np.exp(rng.normal(0, 0.5, (H,))).astype(np.float32),
            _normal(rng, (Bz, S, G, N)), _normal(rng, (Bz, S, G, N)))


@pytest.mark.parametrize("S,chunk,G,init", [(64, 16, 1, False),
                                            (50, 16, 2, False),
                                            (37, 8, 2, True),
                                            (20, 32, 1, True)])
def test_ssd_chunked_ref_and_decode(S, chunk, G, init):
    """Padding of S to a chunk multiple, an initial state, groups; the
    chunked path against the reference's and against the port's
    recurrence (``ssd_ref`` over ``ssd_decode_step``)."""
    rng = np.random.default_rng(S + chunk)
    Bz, H, P, N = 2, 4, 8, 6
    args = _ssd_inputs(rng, Bz, S, H, P, N, G)
    h0 = _normal(rng, (Bz, H, P, N)) if init else None
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else torch.from_numpy(h0)
    y_j, s_j = jssm.ssd_chunked(*jargs, chunk=chunk, initial_state=jh0)
    y_t, s_t = tssm.ssd_chunked(*targs, chunk=chunk, initial_state=th0)
    _close(y_t, y_j, 3e-3)
    _close(s_t, s_j, 3e-3)
    yr_j, sr_j = jssm.ssd_ref(*jargs, initial_state=jh0)
    yr_t, sr_t = tssm.ssd_ref(*targs, initial_state=th0)
    _close(yr_t, yr_j)
    _close(sr_t, sr_j)
    _close(y_t, yr_t.numpy(), 3e-3)
    _close(s_t, sr_t.numpy(), 3e-3)


def test_ssd_decode_step():
    rng = np.random.default_rng(6)
    state = _normal(rng, (2, 4, 8, 6))
    x, dt, A, B, C = _ssd_inputs(rng, 2, 1, 4, 8, 6, 2)
    args = (state, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
    y_j, s_j = jssm.ssd_decode_step(*map(jnp.asarray, args))
    y_t, s_t = tssm.ssd_decode_step(*map(torch.from_numpy, args))
    _close(y_t, y_j)
    _close(s_t, s_j)


@pytest.mark.parametrize("K,with_state", [(4, False), (4, True),
                                          (1, False)])
def test_causal_conv(K, with_state):
    rng = np.random.default_rng(7 + K)
    x, w = _normal(rng, (2, 9, 5)), _normal(rng, (K, 5))
    st = _normal(rng, (2, K - 1, 5)) if with_state else None
    jst = None if st is None else jnp.asarray(st)
    tst = None if st is None else torch.from_numpy(st)
    y_j, n_j = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w), jst)
    y_t, n_t = tssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w), tst)
    _close(y_t, y_j)
    _close(n_t, n_j)
