"""The port's flash attention (repro_torch.kernels.flash_attention, through
``ops.attention_op``) against the reference Pallas kernel
(``repro.kernels.ops.attention_op`` in interpret mode on the CPU) and the
reference oracles. Inputs come from numpy with a seed and go to both
packages; bf16 crosses bit for bit through ``array_from_reference``. On
CPU tensors the wrapper runs its plain version.

Tolerance: the JAX test's rtol = atol = 2e-3
(``tests/kernels/test_kernels.py:80``); a bf16 output adds one bf16 step
(2^-7 relative), since the two float32 results may round to neighbouring
bf16 values."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kvi import array_from_reference

TOL = 2e-3
BF16_STEP = 2.0 ** -7

# (B, H, KV, Sq, Skv, hd, causal, window, q_offset): G = H / KV in
# {1, 2, 5}; no length a multiple of 64; Sq < Skv continues a prefill
CASES = [
    (2, 4, 4, 100, 100, 16, True, 0, 0),
    (1, 4, 2, 100, 100, 32, False, 0, 0),
    (1, 10, 2, 90, 90, 96, True, 24, 0),
    (1, 4, 2, 40, 120, 32, True, 0, 80),
    (1, 5, 1, 33, 70, 16, True, 16, 37),
    (1, 2, 1, 300, 300, 16, True, 0, 0),      # more than PLAIN_ROWS rows
]


def _ids(c):
    B, H, KV, Sq, Skv, hd, causal, window, off = c
    return (f"G{H // KV}-Sq{Sq}-Skv{Skv}-hd{hd}-"
            f"{'causal' if causal else 'full'}-w{window}-off{off}")


def _qkv(rng, B, H, KV, Sq, Skv, hd, dtype):
    return (jnp.asarray(rng.normal(0, 1, (B, H, Sq, hd)), dtype),
            jnp.asarray(rng.normal(0, 1, (B, KV, Skv, hd)), dtype),
            jnp.asarray(rng.normal(0, 1, (B, KV, Skv, hd)), dtype))


def _close(got: torch.Tensor, want, bf16: bool):
    want = np.asarray(want).astype(np.float32)
    tol = TOL + TOL * np.abs(want)
    if bf16:
        tol = tol + BF16_STEP * np.abs(want)
    err = np.abs(got.float().numpy() - want)
    assert np.all(err <= tol), f"max error {err.max()}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_vs_pallas(case, dtype):
    B, H, KV, Sq, Skv, hd, causal, window, off = case
    rng = np.random.default_rng(Sq * hd + H)
    q, k, v = _qkv(rng, B, H, KV, Sq, Skv, hd, jnp.dtype(dtype))
    want = jops.attention_op(q, k, v, causal=causal, window=window,
                             q_offset=off, interpret=True)
    tq, tk, tv = (array_from_reference(a) for a in (q, k, v))
    got = ops.attention_op(tq, tk, tv, causal=causal, window=window,
                           q_offset=off)
    assert got.dtype == tq.dtype and tuple(got.shape) == want.shape
    _close(got, want, dtype == "bfloat16")


@pytest.mark.parametrize("case", CASES[:5], ids=_ids)
def test_oracle_matches_the_reference_oracle(case):
    B, H, KV, Sq, Skv, hd, causal, window, off = case
    q, k, v = _qkv(np.random.default_rng(1), B, H, KV, Sq, Skv, hd,
                   jnp.float32)
    want = jref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    q_offset=off)
    got = tref.flash_attention_ref(*(array_from_reference(a)
                                     for a in (q, k, v)),
                                   causal=causal, window=window,
                                   q_offset=off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rows_that_see_no_key_give_zero_and_the_oracle_the_mean_of_v():
    """q_offset 80 and window 8 over 64 keys: no query row sees a key.
    The Pallas kernel, and so the port's kernel path, give 0; the
    quadratic oracle (the reference's and the port's copy) gives a
    uniform softmax, the mean of v over the keys."""
    B, H, KV, Sq, Skv, hd = 1, 4, 2, 32, 64, 16
    q, k, v = _qkv(np.random.default_rng(2), B, H, KV, Sq, Skv, hd,
                   jnp.float32)
    kw = dict(causal=True, window=8, q_offset=80)
    pallas = np.asarray(jops.attention_op(q, k, v, interpret=True, **kw))
    tq, tk, tv = (array_from_reference(a) for a in (q, k, v))
    got = ops.attention_op(tq, tk, tv, **kw)
    assert np.abs(pallas).max() == 0.0
    assert got.abs().max().item() == 0.0
    plain = fa.flash_attention_plain(tq, tk, tv, **kw)
    assert plain.abs().max().item() == 0.0
    want_ref = np.asarray(jref.flash_attention_ref(q, k, v, **kw))
    got_ref = tref.flash_attention_ref(tq, tk, tv, **kw).numpy()
    mean_v = np.repeat(np.asarray(v).mean(axis=2, keepdims=True), H // KV,
                       axis=1)
    np.testing.assert_allclose(got_ref, want_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_ref, np.broadcast_to(mean_v, got_ref.shape),
                               rtol=1e-5, atol=1e-6)
    assert np.abs(got_ref).max() > 0.1


def test_visible_pairs_counts_the_mask():
    for case in CASES:
        _, _, _, Sq, Skv, _, causal, window, off = case
        mask = fa.visible(off + torch.arange(Sq), torch.arange(Skv), causal,
                          window)
        assert fa.visible_pairs(Sq, Skv, causal, window, off) == \
            int(mask.sum())


def test_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, 2, 8, 129))
    with pytest.raises(ValueError, match="exceeds 128"):
        fa.flash_attention(q, q[:, :1], q[:, :1])
    q = torch.zeros((1, 3, 8, 16))
    with pytest.raises(ValueError, match="multiple of KV"):
        fa.flash_attention(q, q[:, :2], q[:, :2])
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q, q, window=-1)
