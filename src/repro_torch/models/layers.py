"""Core NN layers, the port of the reference's ``repro/models/layers.py``:
RMSNorm, RoPE, chunked (flash-style) attention in plain PyTorch, decode
attention over full / ring (sliding-window) KV caches, SwiGLU.

The chunked attention here is the semantics shared with the port's
``flash_attention`` kernel (kernels/flash_attention.py): online softmax
over KV blocks, f32 accumulators, optional causal & sliding-window
masking, and 0 for a query row with no visible key. ``attention_ref`` is
the quadratic oracle; like the reference's, it gives such a row the mean
of v (a softmax over a row that is all ``NEG_INF`` is uniform).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.compat import DTensor
from repro_torch.models.sharding import (grad_whole_unless_divides,
                                         whole_unless_divides)

# finite, never -inf: exp(-inf - -inf) is NaN on a fully masked block
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x@Wg) * (x@Wu) @ Wd; weights cast to x's dtype."""
    dtype = x.dtype
    g = x @ w_gate.to(dtype)
    u = x @ w_up.to(dtype)
    return (F.silu(g) * u) @ w_down.to(dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] integer."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    angles = positions[..., :, None].float()[..., None, :] * freqs
    # angles: [..., S, 1, hd/2] broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# chunked flash-style attention (plain path / kernel oracle)
# ---------------------------------------------------------------------------

def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                window: int, meta: int = 0) -> torch.Tensor:
    """[Qb, Kb] bool valid mask from absolute positions; the first
    ``meta`` keys stay visible outside the window."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window:
        m &= (q_pos[:, None] - k_pos[None, :] < window) | \
            (k_pos[None, :] < meta)
    return m


def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_block: int = 1024, kv_block: int = 1024,
                        q_offset: int = 0, swa_block_skip: bool = False,
                        repeat_kv: bool = False,
                        meta: int = 0) -> torch.Tensor:
    """Online-softmax attention, chunked over Q and KV blocks.

    q, k: [B, Sq|Skv, H|KV, hd]; v: [B, Skv, KV, vd] with H = KV * G
    (GQA). Returns [B, Sq, H, vd]. All softmax state in f32.
    ``q_offset``: absolute position of q[0] (prefill continuation).
    ``meta``: the first keys that every query sees, its window aside
    (hymba's meta tokens).

    ``swa_block_skip``: with a sliding window, each query block only
    attends to the last ``window + q_block`` keys — slice that range per
    query block instead of scanning the full sequence (exact: masking
    still applies). ``repeat_kv`` materialises K/V at H heads (the
    reference's sharding knob; the same function here).
    """
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    vd = v.shape[-1]
    G = H // KV
    if repeat_kv and G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
        KV, G = H, 1
    q = whole_unless_divides(q, 2, KV)
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Skv)
    if Sq % q_block or Skv % kv_block:
        raise ValueError(f"q_block {q_block} and kv_block {kv_block} must "
                         f"divide Sq {Sq} and Skv {Skv}")
    nq, nk = Sq // q_block, Skv // kv_block
    scale = 1.0 / np.sqrt(hd)
    dev = q.device

    skip = bool(swa_block_skip and window and causal and not meta and
                window + q_block < Skv)
    if skip:
        span = int(np.ceil((window + q_block) / kv_block)) * kv_block
        nk_eff = span // kv_block
    else:
        nk_eff = nk

    kf, vf = k.float(), v.float()
    # the query blocks' outputs, concatenated along the sequence at the
    # end (on a mesh a DTensor block cannot be copied into a plain tensor)
    out = []
    for qi in range(nq):
        q_tile = q[:, qi * q_block:(qi + 1) * q_block].float().reshape(
            B, q_block, KV, G, hd)
        q_pos = q_offset + qi * q_block + torch.arange(q_block, device=dev)
        pos0 = (min(max(qi * q_block + q_block - span, 0), Skv - span)
                if skip else 0)
        m = torch.full((B, KV, G, q_block), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, q_block), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((B, KV, G, q_block, vd), dtype=torch.float32,
                          device=dev)
        for ki in range(nk_eff):
            lo = pos0 + ki * kv_block
            k_tile, v_tile = kf[:, lo:lo + kv_block], vf[:, lo:lo + kv_block]
            k_pos = lo + torch.arange(kv_block, device=dev)
            s = torch.einsum("bqkgh,bckh->bkgqc", q_tile, k_tile) * scale
            mask = _block_mask(q_pos, k_pos, causal, window, meta)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked blocks: exp(NEG_INF - NEG_INF) would be 1
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqc,bckh->bkgqh",
                                                       p, v_tile)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]    # [B,KV,G,Qb,vd]
        out.append(o.permute(0, 3, 1, 2, 4).reshape(B, q_block, H, vd)
                   .to(q.dtype))
    out = out[0] if nq == 1 else torch.cat(out, dim=1)
    # the merge of (KV, G) into H splits the gradient back in the backward
    return grad_whole_unless_divides(out, 2, KV)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: int = 0, meta: int = 0) -> torch.Tensor:
    """Quadratic reference (small shapes only) — oracle for tests. A row
    with no visible key gets the mean of v, as the reference's does."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    vd = v.shape[-1]
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqkgh,bckh->bkgqc", qr, k.float()) / math.sqrt(hd)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    mask = _block_mask(q_pos, k_pos, causal, window, meta)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckh->bqkgh", p, v.float())
    return out.reshape(B, Sq, H, vd).to(q.dtype)


# ---------------------------------------------------------------------------
# decode attention (one new token against a cache)
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_positions: torch.Tensor,
                     pos: torch.Tensor, *, window: int = 0,
                     meta: int = 0) -> torch.Tensor:
    """q: [B, 1, H, hd]; caches: [B, S, KV, hd|vd];
    cache_positions: [B, S] integer absolute token position per slot (-1 =
    empty); pos: [B] per-sequence current position. Works for both full
    caches (slot i holds position i) and ring buffers (slot = pos %
    window; with ``meta`` always-visible leading positions, those in the
    first slots and the ring after them)."""
    B, _, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    vd = v_cache.shape[-1]
    G = H // KV
    qr = whole_unless_divides(q, 2, KV).reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qr, k_cache.float()) / math.sqrt(hd)
    valid = (cache_positions >= 0) & (cache_positions <= pos[:, None])
    if window:
        valid &= (cache_positions > (pos[:, None] - window)) | \
            (cache_positions < meta)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return out.reshape(B, 1, H, vd).to(q.dtype)


def cache_update(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cache_positions: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, pos: torch.Tensor, *, window: int = 0,
                 meta: int = 0):
    """Insert one token's K/V per sequence at that sequence's slot.
    pos: [B]. Full cache: slot = pos. Ring (SWA): slot = pos % window;
    after ``meta`` leading slots (the positions below ``meta``), slot =
    meta + (pos - meta) % window. Returns new tensors; the inputs are
    not modified (the reference's functional update)."""
    B, S = k_cache.shape[:2]
    if window and meta:
        slot = torch.where(pos < meta, pos, meta + (pos - meta) % window)
    else:
        slot = (pos % window) if window else pos
    slot = torch.clamp(slot.long(), 0, S - 1)
    if isinstance(k_cache, DTensor):
        # on a mesh DTensor has no in-place index_put for a cache split
        # over batch and heads (or slots): each slot chosen by a mask,
        # elementwise on every rank's block
        hit = torch.arange(S, device=slot.device)[None, :] == slot[:, None]
        return (torch.where(hit[..., None, None],
                            k_new.to(k_cache.dtype), k_cache),
                torch.where(hit[..., None, None],
                            v_new.to(v_cache.dtype), v_cache),
                torch.where(hit, pos[:, None].to(cache_positions.dtype),
                            cache_positions))
    b_ix = torch.arange(B, device=k_cache.device)
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    cache_positions = cache_positions.clone()
    k_cache[b_ix, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[b_ix, slot] = v_new[:, 0].to(v_cache.dtype)
    cache_positions[b_ix, slot] = pos.to(cache_positions.dtype)
    return k_cache, v_cache, cache_positions
