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
from repro_torch.kernels import checks
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


# ---------------------------------------------------------------------------
# the numerics of the tensor-core kernel (bf16), held on the CPU
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
CARD_CASES = [s for k, s in checks.compute_kernel_cases()
              if k == "flash_attention"]


def _shape_id(shape):
    return "-".join(f"{k}{v}" for k, v in shape.items())


def tensor_core_design(q, k, v, causal, window, q_offset, split=True, bk=64):
    """``csrc/flash_attention.cu``'s bf16 kernel, step for step in float32
    on the CPU: float32 scores, an online softmax over 64-key tiles (exp2
    of the log2e-scaled difference, masked scores -inf, m from -1e30),
    and P v from P split into bf16 P_hi + P_lo, each times v (exact in
    bf16) in float32; ``split=False`` rounds P to bf16 once instead."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // KV, 1)
    vf = v.float().repeat_interleave(H // KV, 1)
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, hd))
    q_pos = q_offset + torch.arange(Sq)
    for k0 in range(0, Skv, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = (q.float() @ kt.transpose(-1, -2)) * fa.scale_of(hd)
        vis = fa.visible(q_pos, torch.arange(k0, min(k0 + bk, Skv)), causal,
                         window)
        s = torch.where(vis, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((s - m_new) * LOG2E)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vt
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp(min=1e-30)).to(q.dtype)


def _card_case(shape, seed):
    B, H, KV, Sq, Skv, hd = (shape[c] for c in ("B", "H", "KV", "Sq", "Skv",
                                                 "hd"))
    masks = dict(causal=shape.get("causal", True),
                 window=shape.get("window", 0),
                 q_offset=shape.get("q_offset", 0))
    q, k, v = _qkv(np.random.default_rng(seed), B, H, KV, Sq, Skv, hd,
                   jnp.bfloat16)
    want = array_from_reference(jops.attention_op(q, k, v, interpret=True,
                                                  **masks))
    tq, tk, tv = (array_from_reference(a) for a in (q, k, v))
    rel, terms = checks.attention_tolerance(tq, tk, tv, **masks)
    return tq, tk, tv, masks, want, rel, terms


@pytest.mark.parametrize("shape", CARD_CASES, ids=_shape_id)
def test_split_p_design_stays_inside_the_card_tolerance(shape):
    """The bf16 kernel's numerics against the Pallas kernel (interpret
    mode), within the card check's bound (``attention_tolerance``,
    capped at 2e-3, plus one bf16 step) at the odd shapes the card check
    runs."""
    tq, tk, tv, masks, want, rel, terms = _card_case(shape, 11)
    got = tensor_core_design(tq, tk, tv, **masks)
    checks._capped("split-P design", got, want, rel, terms,
                   checks.ATTENTION_TOL)


@pytest.mark.parametrize("shape", CARD_CASES[:3], ids=_shape_id)
def test_one_bf16_p_fails_the_card_tolerance(shape):
    """The control: rounding P once to bf16 (an error up to 2^-9 of
    sum p |v|) leaves the same bound, which is why the kernel splits P."""
    tq, tk, tv, masks, want, rel, terms = _card_case(shape, 11)
    got = tensor_core_design(tq, tk, tv, split=False, **masks)
    with pytest.raises(AssertionError, match="differs"):
        checks._capped("one-P design", got, want, rel, terms,
                       checks.ATTENTION_TOL)


def test_bf16_takes_the_tensor_cores_and_float32_the_cuda_cores():
    assert fa.uses_tensor_cores(torch.bfloat16)
    assert not fa.uses_tensor_cores(torch.float32)
    assert checks.case_paths("flash_attention") == {"tensor_cores": 1,
                                                    "cuda_cores": 1}
