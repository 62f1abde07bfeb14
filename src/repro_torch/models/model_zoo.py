"""Model zoo, the port of the reference's ``repro/models/model_zoo.py``:
parameter templates + forward passes for all assigned families.

Families: dense (llama/deepseek/stablelm/phi3), moe (mixtral/grok),
ssm (mamba2), hybrid (hymba: parallel attn+SSM heads), audio (enc-dec,
frame-embedding stub frontend), vlm (decoder + patch-embedding stub).

All decoders share one block loop; the per-family block bodies
dispatch on cfg.family. Layers are stacked along a leading "layers" axis,
as the reference's (so a reference tree maps 1:1), and the reference's
``lax.scan`` over them is a loop over ``l``. Like the reference's, the
zoo calls the plain layers (``flash_attention_xla``, ``decode_attention``,
``ssd_chunked``), not the kernels, with one exception: on the card
``ssd_chunked`` itself runs the SSD's training kernels
(``kernels.ssd_scan.ssd_train``), so the zoo's training and prefill SSD
take them, while the reference's zoo differentiates its plain layer. ``par.remat`` ("block" or "full")
recomputes each block body in the backward, as the reference's
``jax.checkpoint`` does: ``torch.utils.checkpoint`` around the body, only
where autograd records (serving runs none, so remat leaves it as is).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, Parallelism
from repro_torch.kvi.obs import spans
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_rope, cache_update,
                                       decode_attention, flash_attention_xla,
                                       rms_norm, swiglu)
from repro_torch.models.params import P, count_params, torch_dtype, tree_map
from repro_torch.models.sharding import (Rules, grad_whole_unless_divides,
                                         whole_unless_divides)

VOCAB_PAD = 256


def padded_vocab(v: int) -> int:
    return ((v + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


# ---------------------------------------------------------------------------
# parameter templates
# ---------------------------------------------------------------------------

def _attn_template(cfg: ModelConfig, L: int, prefix_dims=()) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lay = ("layers",) + tuple(None for _ in prefix_dims[1:])
    pd = (L,) + tuple(prefix_dims[1:])
    t = {"wq": P(pd + (D, H, hd), lay + ("embed", "heads", "head_dim"),
                 "fanin", fan_in=D)}
    if not cfg.per_layer_attention:
        t.update(_kv_template(cfg, L))
    if cfg.hybrid_merge == "per_path":
        t["wo"] = P(pd + (H, hd, D), lay + ("heads", "head_dim", "embed"),
                    "fanin", fan_in=H * hd)
    return t


def _kv_template(cfg: ModelConfig, n: int) -> dict:
    """K and V projections of ``n`` layers (every layer, or with
    per-layer attention the producing layers alone, stacked)."""
    D, KV = cfg.d_model, cfg.num_kv_heads
    return {
        "wk": P((n, D, KV, cfg.head_dim),
                ("layers", "embed", "kv_heads", "head_dim"), "fanin",
                fan_in=D),
        "wv": P((n, D, KV, cfg.value_dim),
                ("layers", "embed", "kv_heads", "head_dim"), "fanin",
                fan_in=D),
    }


def _ffn_template(cfg: ModelConfig, L: int) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "w_gate": P((L, D, Fd), ("layers", "embed", "mlp"), "fanin",
                    fan_in=D),
        "w_up": P((L, D, Fd), ("layers", "embed", "mlp"), "fanin", fan_in=D),
        "w_down": P((L, Fd, D), ("layers", "mlp", "embed"), "fanin",
                    fan_in=Fd),
    }


def _moe_template(cfg: ModelConfig, L: int) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": P((L, D, E), ("layers", "embed", None), "fanin", fan_in=D),
        "w_gate": P((L, E, D, Fd), ("layers", "experts", "embed", "mlp"),
                    "fanin", fan_in=D),
        "w_up": P((L, E, D, Fd), ("layers", "experts", "embed", "mlp"),
                  "fanin", fan_in=D),
        "w_down": P((L, E, Fd, D), ("layers", "experts", "mlp", "embed"),
                    "fanin", fan_in=Fd),
    }


def _ssm_template(cfg: ModelConfig, L: int) -> dict:
    D, di = cfg.d_model, cfg.d_inner
    H, N, G, K = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_conv
    gn = G * N
    return {
        "w_z": P((L, D, di), ("layers", "embed", "ssm_dim"), "fanin", fan_in=D),
        "w_x": P((L, D, di), ("layers", "embed", "ssm_dim"), "fanin", fan_in=D),
        "w_B": P((L, D, gn), ("layers", "embed", None), "fanin", fan_in=D),
        "w_C": P((L, D, gn), ("layers", "embed", None), "fanin", fan_in=D),
        "w_dt": P((L, D, H), ("layers", "embed", "ssm_heads"), "fanin",
                  fan_in=D),
        "conv_x": P((L, K, di), ("layers", "conv", "ssm_dim"), "normal"),
        "conv_B": P((L, K, gn), ("layers", "conv", None), "normal"),
        "conv_C": P((L, K, gn), ("layers", "conv", None), "normal"),
        "A_log": P((L, H), ("layers", "ssm_heads"), "ssm_a"),
        "dt_bias": P((L, H), ("layers", "ssm_heads"), "ssm_dt"),
        "D_skip": P((L, H), ("layers", "ssm_heads"), "ones"),
        "gate_norm": P((L, di), ("layers", "ssm_dim"), "zeros"),
        "w_out": P((L, di, D), ("layers", "ssm_dim", "embed"), "fanin"),
    }


def _mamba1_template(cfg: ModelConfig, L: int) -> dict:
    """Mamba-1's mixer as hymba publishes it: x and z projections, a
    depthwise conv with bias, x_proj to dt's rank, B and C, RMS norms on
    the three, dt_proj, A per (channel, state), D per channel."""
    D, di, N, K, R = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv,
                      cfg.ssm_dt_rank)
    return {
        "w_x": P((L, D, di), ("layers", "embed", "ssm_dim"), "fanin",
                 fan_in=D),
        "w_z": P((L, D, di), ("layers", "embed", "ssm_dim"), "fanin",
                 fan_in=D),
        "conv_x": P((L, K, di), ("layers", "conv", "ssm_dim"), "normal"),
        "conv_bias": P((L, di), ("layers", "ssm_dim"), "zeros"),
        "x_proj": P((L, di, R + 2 * N), ("layers", "ssm_dim", None),
                    "fanin", fan_in=di),
        "dt_norm": P((L, R), ("layers", None), "zeros"),
        "B_norm": P((L, N), ("layers", "ssm_state"), "zeros"),
        "C_norm": P((L, N), ("layers", "ssm_state"), "zeros"),
        "w_dt": P((L, R, di), ("layers", None, "ssm_dim"), "fanin",
                  fan_in=R),
        "dt_bias": P((L, di), ("layers", "ssm_dim"), "ssm_dt"),
        "A_log": P((L, di, N), ("layers", "ssm_dim", "ssm_state"), "ssm_a"),
        "D_skip": P((L, di), ("layers", "ssm_dim"), "ones"),
    }


def block_template(cfg: ModelConfig, L: Optional[int] = None) -> dict:
    L = cfg.num_layers if L is None else L
    D = cfg.d_model
    t = {"ln1": P((L, D), ("layers", None), "zeros")}
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        t["attn"] = _attn_template(cfg, L, (L,))
        t["ln2"] = P((L, D), ("layers", None), "zeros")
        t["ffn" if fam != "moe" else "moe"] = (
            _moe_template(cfg, L) if fam == "moe" else _ffn_template(cfg, L))
    elif fam == "ssm":
        t["ssm"] = _ssm_template(cfg, L)
    elif fam == "hybrid":
        t["attn"] = _attn_template(cfg, L, (L,))
        t["ssm"] = (_mamba1_template(cfg, L) if cfg.ssm_kind == "mamba1"
                    else _ssm_template(cfg, L))
        if cfg.hybrid_merge == "out_proj":
            di = cfg.d_inner
            t["attn_norm"] = P((L, di), ("layers", "ssm_dim"), "zeros")
            t["ssm_norm"] = P((L, di), ("layers", "ssm_dim"), "zeros")
            t["w_out"] = P((L, di, D), ("layers", "ssm_dim", "embed"),
                           "fanin", fan_in=di)
        else:
            t["attn_scale"] = P((L, D), ("layers", None), "zeros")
            t["ssm_scale"] = P((L, D), ("layers", None), "zeros")
        t["ln2"] = P((L, D), ("layers", None), "zeros")
        t["ffn"] = _ffn_template(cfg, L)
    else:
        raise ValueError(fam)
    return t


def encdec_block_template(cfg: ModelConfig) -> dict:
    """Decoder block with cross-attention (audio family)."""
    L, D = cfg.num_layers, cfg.d_model
    return {
        "ln1": P((L, D), ("layers", None), "zeros"),
        "attn": _attn_template(cfg, L, (L,)),
        "ln_x": P((L, D), ("layers", None), "zeros"),
        "xattn": _attn_template(cfg, L, (L,)),
        "ln2": P((L, D), ("layers", None), "zeros"),
        "ffn": _ffn_template(cfg, L),
    }


def _apply_param_dtype(t, dtype: str):
    """Templates default to f32; serving cells store bf16 weights."""
    if dtype == "float32":
        return t
    return tree_map(lambda p: P(p.shape, p.axes, p.init, dtype, p.fan_in)
                    if p.dtype == "float32" else p, t)


def param_template(cfg: ModelConfig) -> dict:
    D, Vp = cfg.d_model, padded_vocab(cfg.vocab_size)
    t = {"embed": P((Vp, D), ("vocab", "embed"), "embed"),
         "final_norm": P((D,), (None,), "zeros")}
    if cfg.family == "audio":
        t["frontend_adapter"] = P((D, D), ("embed", None), "fanin")
        enc = {
            "ln1": P((cfg.encoder_layers, D), ("layers", None), "zeros"),
            "attn": _attn_template(cfg, cfg.encoder_layers,
                                   (cfg.encoder_layers,)),
            "ln2": P((cfg.encoder_layers, D), ("layers", None), "zeros"),
            "ffn": {k: P((cfg.encoder_layers,) + v.shape[1:], v.axes, v.init,
                         v.dtype, v.fan_in)
                    for k, v in _ffn_template(cfg, cfg.encoder_layers).items()},
        }
        t["enc_blocks"] = enc
        t["enc_norm"] = P((D,), (None,), "zeros")
        t["blocks"] = encdec_block_template(cfg)
    else:
        t["blocks"] = block_template(cfg)
        if cfg.per_layer_attention:
            t["kv"] = _kv_template(cfg, len(cfg.kv_producers))
        if cfg.meta_tokens:
            t["meta"] = P((cfg.meta_tokens, D), (None, "embed"), "embed")
        if cfg.family == "vlm":
            t["patch_adapter"] = P((D, D), ("embed", None), "fanin")
    if not cfg.tie_embeddings:
        t["unembed"] = P((D, Vp), ("embed", "vocab"), "fanin")
    return _apply_param_dtype(t, cfg.param_dtype)


def param_count(cfg: ModelConfig) -> int:
    return count_params(param_template(cfg))


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top-k of E experts)."""
    n = param_count(cfg)
    if cfg.num_experts:
        expert = 3 * cfg.d_model * cfg.d_ff * cfg.num_layers
        n -= (cfg.num_experts - cfg.num_experts_per_tok) * expert
    return n


# ---------------------------------------------------------------------------
# block forward bodies
# ---------------------------------------------------------------------------

def _layer(tree, l: int):
    """Layer ``l`` of a tree stacked along its leading "layers" axis."""
    return tree_map(lambda x: x[l], tree,
                    is_leaf=lambda x: not isinstance(x, dict))


def _layers(tree, n: int) -> list:
    """The ``n`` per-layer trees of a tree stacked along its leading
    "layers" axis, one ``unbind`` a leaf: under autograd its backward is
    one stack, where indexing each layer (``_layer``) would add ``n``
    gradients of the whole stacked leaf."""
    per_leaf = tree_map(lambda x: x.unbind(0), tree,
                        is_leaf=lambda x: not isinstance(x, dict))
    return [tree_map(lambda t: t[l], per_leaf,
                     is_leaf=lambda x: isinstance(x, tuple))
            for l in range(n)]


def _stack(trees: list):
    """The per-layer trees stacked along a new leading axis (the
    reference scan's stacked outputs)."""
    if not trees or not trees[0]:
        return {}
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _heads_proj(x, w, dtype):
    """x [B,S,D] @ w [D,H,hd] -> [B,S,H,hd] as one product over the
    flattened heads, then split back: on a mesh DTensor may split the
    product's H*hd columns over "model", and the split into (H, hd)
    needs H to divide that (the heads made whole first when it does
    not: GQA's KV heads fewer than the model axis; the weight's gradient,
    split back in the backward, likewise)."""
    D, H, hd = w.shape
    w2 = grad_whole_unless_divides(w.to(dtype).reshape(D, H * hd), 1, H)
    y = torch.einsum("bsd,de->bse", x, w2)
    return whole_unless_divides(y, -1, H).unflatten(-1, (H, hd))


def _attn_forward(lp, x, positions, cfg: ModelConfig, rules: Rules, par,
                  *, causal=True, window=0, kv_override=None,
                  kv_shared=None, bracket=None):
    """Full-sequence attention (train/prefill). Returns (out, (k, v)).
    ``kv_shared``: the (roped) k, v of the layer this one reuses them
    from. Without ``wo`` (hymba's merge) the heads' values come out side
    by side, [B,S,H*vd]. ``bracket(fn, q, k, v)``, if given, runs what
    follows the projections (RoPE, the attention, ``wo``): the span
    ``attention`` takes it, so that each of its inputs has one use and
    a traced backward sums every gradient as an untraced one does."""
    dtype = x.dtype
    q = _heads_proj(x, lp["wq"], dtype)
    rope_k = kv_shared is None and kv_override is None
    if kv_shared is not None:
        k, v = kv_shared
    elif kv_override is None:
        k = _heads_proj(x, lp["wk"], dtype)
        v = _heads_proj(x, lp["wv"], dtype)
    else:  # cross-attention: kv computed from encoder output
        enc = kv_override
        k = _heads_proj(enc, lp["wk"], dtype)
        v = _heads_proj(enc, lp["wv"], dtype)

    def attend(q, k, v):
        if rope_k:
            k = apply_rope(k, positions, cfg.rope_theta)
        if kv_override is None:
            q = apply_rope(q, positions, cfg.rope_theta)
        q = rules.constrain(q, "batch", "seq", "heads", "head_dim")
        k = rules.constrain(k, "batch", "seq", "kv_heads", "head_dim")
        out = flash_attention_xla(
            q, k, v, causal=causal, window=window,
            q_block=par.attn_q_block, kv_block=par.attn_kv_block,
            swa_block_skip=par.swa_block_skip, repeat_kv=par.attn_repeat_kv,
            meta=cfg.meta_tokens)
        if "wo" in lp:
            out = torch.einsum("bshk,hkd->bsd", out, lp["wo"].to(dtype))
        else:
            out = out.flatten(2)
        return out, (k, v)

    return attend(q, k, v) if bracket is None else bracket(attend, q, k, v)


def _ffn_forward(lp, x, cfg, rules):
    return swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])


def _ssm_forward(lp, x, cfg: ModelConfig, rules: Rules, conv_state=None,
                 ssm_state=None, decode=False):
    """Full mamba2 mixer. x: [B,S,D]. Returns (y, (conv_state, ssm_state))."""
    dtype = x.dtype
    B_, S, D = x.shape
    H, Pd, N, G = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups
    z = torch.einsum("bsd,de->bse", x, lp["w_z"].to(dtype))
    xin = torch.einsum("bsd,de->bse", x, lp["w_x"].to(dtype))
    Bp = torch.einsum("bsd,de->bse", x, lp["w_B"].to(dtype))
    Cp = torch.einsum("bsd,de->bse", x, lp["w_C"].to(dtype))
    dt = torch.einsum("bsd,dh->bsh", x, lp["w_dt"].to(dtype))
    dt = F.softplus(dt.float() + lp["dt_bias"].float())

    cs_x = cs_B = cs_C = None
    if conv_state is not None:
        di, gn = cfg.d_inner, G * N
        cs_x, cs_B, cs_C = (conv_state[..., :di], conv_state[..., di:di + gn],
                            conv_state[..., di + gn:])
    xin, ns_x = ssm_lib.causal_conv(xin, lp["conv_x"], cs_x)
    Bp, ns_B = ssm_lib.causal_conv(Bp, lp["conv_B"], cs_B)
    Cp, ns_C = ssm_lib.causal_conv(Cp, lp["conv_C"], cs_C)
    xin, Bp, Cp = F.silu(xin), F.silu(Bp), F.silu(Cp)
    new_conv = torch.cat([ns_x, ns_B, ns_C], dim=-1)

    # (the ssm_dim split into heads: whole first if H does not divide
    # the model axis, as hymba's 50 heads on 16)
    xh = whole_unless_divides(xin, -1, H).reshape(B_, S, H, Pd)
    xh = rules.constrain(xh, "batch", "seq", "ssm_heads", None)
    Bh = Bp.reshape(B_, S, G, N)
    Ch = Cp.reshape(B_, S, G, N)
    A = -torch.exp(lp["A_log"].float())

    if decode:
        y, new_state = ssm_lib.ssd_decode_step(
            ssm_state, xh[:, 0], dt[:, 0], A, Bh[:, 0], Ch[:, 0])
        y = y[:, None]
    else:
        # the "ssd" span, its backward bracketed (a traced train step);
        # its arg path says whether the card's kernels ran
        y, new_state = spans.bracketed(
            "ssd", ssm_lib.ssd_chunked, xh, dt, A, Bh, Ch,
            span_args={"path": ssm_lib.ssd_path(xh)},
            chunk=min(cfg.ssm_chunk, S), initial_state=ssm_state)
    y = y + xh * lp["D_skip"].float()[None, None, :, None].to(dtype)
    # (and the heads merged back: the gradient split the same way)
    y = grad_whole_unless_divides(y, 2, H).reshape(B_, S, cfg.d_inner)
    y = rms_norm(y * F.silu(z.float()).to(dtype), lp["gate_norm"],
                 cfg.norm_eps)
    y = torch.einsum("bse,ed->bsd", y, lp["w_out"].to(dtype))
    return y, (new_conv.to(x.dtype), new_state)


def _mamba1_forward(lp, x, cfg: ModelConfig, rules: Rules, conv_state=None,
                    ssm_state=None, decode=False):
    """Mamba-1's mixer (hymba's SSM heads), before any output projection:
    u = silu(conv(x W_x) + b), [dt, B, C] = u W_xproj each RMS-normed,
    dt = softplus(dt W_dt + b_dt), the selective scan with D u, gated by
    silu(x W_z). x: [B,S,D]. Returns (m [B,S,d_inner], (conv_state,
    ssm_state))."""
    dtype = x.dtype
    R, N, eps = cfg.ssm_dt_rank, cfg.ssm_state, cfg.norm_eps
    xin = torch.einsum("bsd,de->bse", x, lp["w_x"].to(dtype))
    z = torch.einsum("bsd,de->bse", x, lp["w_z"].to(dtype))
    u, new_conv = ssm_lib.causal_conv(xin, lp["conv_x"], conv_state)
    u = F.silu(u + lp["conv_bias"].to(dtype))
    dbc = torch.einsum("bse,ef->bsf", u, lp["x_proj"].to(dtype))
    d_low, Bm, Cm = dbc.split([R, N, N], dim=-1)
    d_low = rms_norm(d_low, lp["dt_norm"], eps)
    Bm, Cm = rms_norm(Bm, lp["B_norm"], eps), rms_norm(Cm, lp["C_norm"], eps)
    dt = torch.einsum("bsr,re->bse", d_low, lp["w_dt"].to(dtype))
    dt = F.softplus(dt.float() + lp["dt_bias"].float())
    A = -torch.exp(lp["A_log"].float())
    if decode:
        y, new_state = ssm_lib.selective_scan_step(
            ssm_state, u[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
        y = y[:, None]
    else:
        # the "selective_scan" span, its backward bracketed; its arg path
        # says whether the card's kernels ran
        y, new_state = spans.bracketed(
            "selective_scan", ssm_lib.selective_scan, u, dt, A, Bm, Cm,
            span_args={"path": ssm_lib.selective_scan_path(u)},
            chunk=cfg.ssm_chunk,
            initial_state=ssm_state)
    y = (y + u.float() * lp["D_skip"].float()).to(dtype)
    return y * F.silu(z.float()).to(dtype), (new_conv.to(dtype), new_state)


def _self_attn_decode(lp, h, positions, cfg, cache_in, window=0,
                      kv_shared=None):
    """One token's self-attention against the cache. Returns (out,
    cache_out). ``kv_shared``: the producing layer's cache after this
    token's update (the layer keeps none of its own, and returns
    ``{}``)."""
    dtype = h.dtype
    M = cfg.meta_tokens
    q = _heads_proj(h, lp["wq"], dtype)
    pos = positions[:, 0]                              # [B] per-slot position
    q = apply_rope(q, positions, cfg.rope_theta)
    if kv_shared is None:
        k = _heads_proj(h, lp["wk"], dtype)
        v = _heads_proj(h, lp["wv"], dtype)
        k = apply_rope(k, positions, cfg.rope_theta)
        kc, vc, cpos = cache_update(cache_in["k"], cache_in["v"],
                                    cache_in["cpos"], k, v, pos,
                                    window=window, meta=M)
        cache_out = {"k": kc, "v": vc, "cpos": cpos}
    else:
        kc, vc, cpos = kv_shared["k"], kv_shared["v"], kv_shared["cpos"]
        cache_out = {}
    att = decode_attention(q, kc, vc, cpos, pos, window=window, meta=M)
    if "wo" in lp:
        out = torch.einsum("bshk,hkd->bsd", att, lp["wo"].to(dtype))
    else:
        out = att.flatten(2)
    return out, cache_out


def _prefill_meta_ring(k, v, like: dict, meta: int, window: int) -> dict:
    """:func:`_prefill_cache` of a ring after ``meta`` leading slots: the
    first ``meta`` positions in those, the last ``window`` of the rest at
    slot meta + (p - meta) % window."""
    B, S = k.shape[:2]
    dev = k.device
    slots = like["k"].shape[1]
    pos = torch.arange(S, device=dev)
    keep = pos[(pos < meta) | (pos >= max(meta, S - window))]
    slot = torch.where(keep < meta, keep, meta + (keep - meta) % window)
    kk = torch.zeros((B, slots) + k.shape[2:], dtype=like["k"].dtype,
                     device=dev)
    vv = torch.zeros((B, slots) + v.shape[2:], dtype=like["v"].dtype,
                     device=dev)
    cpos = torch.full((B, slots), -1, dtype=torch.int32, device=dev)
    kk[:, slot] = k[:, keep].to(kk.dtype)
    vv[:, slot] = v[:, keep].to(vv.dtype)
    cpos[:, slot] = keep.to(torch.int32)
    return {"k": kk, "v": vv, "cpos": cpos}


def _prefill_cache(k, v, like: dict, meta: int = 0, window: int = 0) -> dict:
    """Prefill: the cache lines of k, v [B,S,KV,hd] — the last slots'
    tokens of a ring (SWA) cache, or every token and empty headroom slots
    of a full one — in the dtypes of ``like``'s lines. With ``meta``
    leading positions and a ``window``, the ring after them."""
    if meta and window:
        return _prefill_meta_ring(k, v, like, meta, window)
    S_slots = like["k"].shape[1]
    B, S = k.shape[:2]
    dev = k.device
    if S_slots <= S:               # ring (SWA) cache: keep the tail,
        # placed so that position p sits at slot p % W (the decode
        # eviction invariant; matters when W does not divide S)
        shift = (S - S_slots) % S_slots
        kk = torch.roll(k[:, -S_slots:], shift, dims=1)
        vv = torch.roll(v[:, -S_slots:], shift, dims=1)
        cpos = torch.roll(torch.arange(S, dtype=torch.int32, device=dev)
                          [-S_slots:], shift).expand(B, S_slots)
    else:                          # full cache with generation headroom
        pad = S_slots - S
        kk = F.pad(k, (0, 0, 0, 0, 0, pad))
        vv = F.pad(v, (0, 0, 0, 0, 0, pad))
        cpos = torch.cat([torch.arange(S, dtype=torch.int32, device=dev),
                          torch.full((pad,), -1, dtype=torch.int32,
                                     device=dev)]).expand(B, S_slots)
    return {"k": kk.to(like["k"].dtype), "v": vv.to(like["v"].dtype),
            "cpos": cpos.contiguous()}


# ---------------------------------------------------------------------------
# decoder forward (train / prefill / decode) for non-encdec families
# ---------------------------------------------------------------------------

def _block_input(x, w, cfg, rules):
    """A block's (or the final) normed input, its sequence whole on every
    rank: with sequence parallelism the residual stream is split along
    the sequence on "model", and the products take the whole sequence
    (Megatron's all-gather before the block; XLA's partitioner places
    the same one). Without a mesh, ``rms_norm``."""
    return rules.constrain(rms_norm(x, w, cfg.norm_eps), "batch", "seq",
                           None)


def _decoder_block(lp, x, positions, cfg, rules, par, cache_in=None,
                   decode=False, layer=None, kv_shared=None):
    """One block. Returns (x, cache_out, aux, kv): ``kv`` the layer's
    attention K/V (the (k, v) tensors a later layer may reuse; in decode
    its updated cache lines), None without attention. ``kv_shared``: the
    producing layer's, for a layer that reuses them. In a traced train
    step the body is the span "block" (arg ``layer``; phase ``forward``,
    or ``recompute`` when remat runs it again in the backward)."""
    with spans.phased("block", layer=layer):
        return _decoder_block_body(lp, x, positions, cfg, rules, par,
                                   cache_in, decode, layer, kv_shared)


def _attention(lp, h, positions, cfg, rules, par, window, kv_shared):
    """A block's full-sequence self-attention, the part after the
    projections as the span "attention" (args ``window``: global or
    sliding, ``kv``: own or shared), its backward bracketed. Returns
    (out, (k, v))."""
    if kv_shared is not None:
        spans.count("kv_shared_layers")
    args = {"window": "sliding" if window else "global",
            "kv": "own" if kv_shared is None else "shared"}
    return _attn_forward(
        lp, h, positions, cfg, rules, par, causal=True, window=window,
        kv_shared=kv_shared,
        bracket=lambda fn, *qkv: spans.bracketed("attention", fn, *qkv,
                                                 span_args=args))


def _decoder_block_body(lp, x, positions, cfg, rules, par, cache_in,
                        decode, layer=None, kv_shared=None):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    window = cfg.layer_window(layer)
    cache_out = {}
    h = _block_input(x, lp["ln1"], cfg, rules)

    if cfg.family == "ssm":
        y, (conv_s, ssd_s) = _ssm_forward(
            lp["ssm"], h, cfg, rules,
            conv_state=None if cache_in is None else cache_in["conv"],
            ssm_state=None if cache_in is None else cache_in["state"],
            decode=decode)
        x = x + y
        cache_out = {"conv": conv_s, "state": ssd_s}
        x = rules.constrain(x, "batch", "seq_sp", None)
        return x, cache_out, aux, None

    # --- attention path (dense / moe / vlm / hybrid) ---
    if decode:
        attn_out, cache_out = _self_attn_decode(lp["attn"], h, positions,
                                                cfg, cache_in, window,
                                                kv_shared)
        kv = cache_out or None
    else:
        attn_out, kv = _attention(lp["attn"], h, positions, cfg, rules, par,
                                  window, kv_shared)

    if cfg.family == "hybrid":
        mixer = _mamba1_forward if cfg.ssm_kind == "mamba1" else \
            _ssm_forward
        y_ssm, (conv_s, ssd_s) = mixer(
            lp["ssm"], h, cfg, rules,
            conv_state=None if cache_in is None else cache_in["conv"],
            ssm_state=None if cache_in is None else cache_in["state"],
            decode=decode)
        if cfg.hybrid_merge == "out_proj":
            # hymba: both d_inner-wide paths normed, averaged, projected
            y = 0.5 * (rms_norm(attn_out, lp["attn_norm"], cfg.norm_eps) +
                       rms_norm(y_ssm, lp["ssm_norm"], cfg.norm_eps))
            y = torch.einsum("bse,ed->bsd", y, lp["w_out"].to(y.dtype))
        else:
            # parallel heads: average of per-path normalized outputs
            y = 0.5 * (rms_norm(attn_out, lp["attn_scale"], cfg.norm_eps) +
                       rms_norm(y_ssm, lp["ssm_scale"], cfg.norm_eps))
        cache_out.update({"conv": conv_s, "state": ssd_s})
    else:
        y = attn_out

    x = x + y
    x = rules.constrain(x, "batch", "seq_sp", None)
    h2 = _block_input(x, lp["ln2"], cfg, rules)
    if cfg.family == "moe":
        ff, aux = moe_lib.moe_ffn(
            h2, lp["moe"], num_experts=cfg.num_experts,
            top_k=cfg.num_experts_per_tok, cap_factor=cfg.capacity_factor,
            rules=rules, whole_batch_group=par.moe_decode_group and decode)
    else:
        ff = _ffn_forward(lp["ffn"], h2, cfg, rules)
    x = x + ff
    x = rules.constrain(x, "batch", "seq_sp", None)

    if not decode and kv_shared is None and cache_in is not None:
        cache_out.update(_prefill_cache(*kv, cache_in, cfg.meta_tokens,
                                        window))
    return x, cache_out, aux, kv


def _remat(body, par: Parallelism):
    """``body`` recomputed in the backward when ``par.remat`` asks for it
    ("block" or "full": the reference's ``jax.checkpoint`` with its
    default policy or saving nothing, both a recompute of the whole body
    here) and autograd is recording."""
    if par.remat in ("block", "full") and torch.is_grad_enabled():
        return lambda *args, **kw: checkpoint(body, *args,
                                              use_reentrant=False, **kw)
    return body


# the cache lines of the producing layers of each kind, by key suffix:
# windowed (a ring, after the meta tokens' slots) and global (full)
_KV_KINDS = (("", False), ("_global", True))


def _layer_caches(cfg: ModelConfig, layers: dict) -> list:
    """Per-layer cache trees of a cache whose attention lines are
    stacked over the producing layers of each kind (per-layer attention):
    a layer that reuses K/V gets none."""
    n = cfg.num_layers
    out = [{k: layers[k][l] for k in ("conv", "state") if k in layers}
           for l in range(n)]
    for suffix, glob in _KV_KINDS:
        prods = [l for l in cfg.kv_producers
                 if (l in cfg.global_layers) == glob]
        for i, l in enumerate(prods):
            out[l].update({k: layers[k + suffix][i]
                           for k in ("k", "v", "cpos")})
    return out


def _stack_caches(cfg: ModelConfig, outs: list) -> dict:
    """The inverse of :func:`_layer_caches`."""
    stacked = _stack([{k: o[k] for k in ("conv", "state") if k in o}
                      for o in outs])
    for suffix, glob in _KV_KINDS:
        prods = [l for l in cfg.kv_producers
                 if (l in cfg.global_layers) == glob]
        if prods and "k" in outs[prods[0]]:
            for k in ("k", "v", "cpos"):
                stacked[k + suffix] = torch.stack([outs[l][k]
                                                   for l in prods])
    return stacked


def _with_kv(params, cfg: ModelConfig, layers: list) -> list:
    """The per-layer trees with each producing layer's K and V weights
    (stacked over the producers under ``params["kv"]``) in its ``attn``."""
    if not cfg.per_layer_attention:
        return layers
    kv = _layers(params["kv"], len(cfg.kv_producers))
    layers = list(layers)
    for i, l in enumerate(cfg.kv_producers):
        layers[l] = dict(layers[l], attn=dict(layers[l]["attn"], **kv[i]))
    return layers


def decoder_forward(params, cfg: ModelConfig, rules: Rules, par: Parallelism,
                    x, positions, cache=None, decode=False):
    """x: [B,S,D] embedded input. Returns (hidden, new_layer_cache, aux).
    With meta tokens (outside decode, where the cache holds them) the
    learned rows go before x, the positions run over both, and the
    hidden states come back without them, after the final norm."""
    blocks = params["blocks"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    M = cfg.meta_tokens if not decode else 0
    if M:
        B = x.shape[0]
        x = torch.cat([params["meta"].to(x.dtype).expand(B, M, -1), x], 1)
        positions = _positions(B, x.shape[1], x.device)
    outs, kv_of = [], {}
    block = _remat(_decoder_block, par)
    layers = _with_kv(params, cfg, _layers(blocks, cfg.num_layers))
    caches = (None if cache is None else
              _layer_caches(cfg, cache["layers"]) if cfg.per_layer_attention
              else [_layer(cache["layers"], l)
                    for l in range(cfg.num_layers)])
    for l, lp in enumerate(layers):
        src = cfg.kv_source(l)
        x, cache_out, a, kv = block(
            lp, x, positions, cfg, rules, par,
            cache_in=None if caches is None else caches[l], decode=decode,
            layer=l, kv_shared=kv_of.get(src) if src != l else None)
        if src == l and cfg.per_layer_attention:
            kv_of[l] = kv
        aux = aux + a
        outs.append(cache_out)
    x = _block_input(x, params["final_norm"], cfg, rules)
    new_cache = (_stack_caches(cfg, outs) if cfg.per_layer_attention
                 else _stack(outs))
    return x[:, M:], new_cache, aux


# ---------------------------------------------------------------------------
# encoder-decoder forward (audio family)
# ---------------------------------------------------------------------------

def encoder_forward(params, cfg, rules, par, frames):
    """frames: [B, S_enc, D] stub embeddings -> encoder hidden states."""
    dtype = torch_dtype(cfg.dtype)
    x = torch.einsum("bsd,de->bse", frames.to(dtype),
                     params["frontend_adapter"].to(dtype))
    positions = _positions(frames.shape[0], frames.shape[1], frames.device)
    block = _remat(_encoder_block, par)
    for lp in _layers(params["enc_blocks"], cfg.encoder_layers):
        x = block(lp, x, positions, cfg, rules, par)
    return _block_input(x, params["enc_norm"], cfg, rules)


def _encoder_block(lp, x, positions, cfg, rules, par):
    h = _block_input(x, lp["ln1"], cfg, rules)
    att, _ = _attn_forward(lp["attn"], h, positions, cfg, rules, par,
                           causal=False)
    x = x + att
    h2 = _block_input(x, lp["ln2"], cfg, rules)
    x = x + _ffn_forward(lp["ffn"], h2, cfg, rules)
    return rules.constrain(x, "batch", "seq_sp", None)


def _encdec_block(lp, x, positions, cfg, rules, par, enc_out, cache_l,
                  decode):
    """One decoder block with self + cross attention. Returns (x,
    cache_out)."""
    cache_out = {}
    h = _block_input(x, lp["ln1"], cfg, rules)
    if decode:
        dtype = h.dtype
        att, cache_out = _self_attn_decode(lp["attn"], h, positions, cfg,
                                           cache_l)
        x = x + att
        # cross-attention against cached encoder K/V
        hx = _block_input(x, lp["ln_x"], cfg, rules)
        qx = _heads_proj(hx, lp["xattn"]["wq"], dtype)
        B_, n_enc = qx.shape[0], cache_l["xk"].shape[1]
        xpos = _positions(B_, n_enc, x.device)
        attx = decode_attention(qx, cache_l["xk"], cache_l["xv"], xpos,
                                torch.full((B_,), n_enc, dtype=torch.int32,
                                           device=x.device))
        attx = torch.einsum("bshk,hkd->bsd", attx,
                            lp["xattn"]["wo"].to(dtype))
        cache_out.update({"xk": cache_l["xk"], "xv": cache_l["xv"]})
        x = x + attx
    else:
        att, kv = _attn_forward(lp["attn"], h, positions, cfg, rules, par,
                                causal=True)
        x = x + att
        hx = _block_input(x, lp["ln_x"], cfg, rules)
        attx, xkv = _attn_forward(lp["xattn"], hx, positions, cfg, rules,
                                  par, causal=False, kv_override=enc_out)
        x = x + attx
        if cache_l is not None:
            cache_out.update(_prefill_cache(*kv, cache_l))
            cache_out.update({"xk": xkv[0].to(cache_l["xk"].dtype),
                              "xv": xkv[1].to(cache_l["xv"].dtype)})
    h2 = _block_input(x, lp["ln2"], cfg, rules)
    x = x + _ffn_forward(lp["ffn"], h2, cfg, rules)
    x = rules.constrain(x, "batch", "seq_sp", None)
    return x, cache_out


def encdec_decoder_forward(params, cfg, rules, par, x, positions, enc_out,
                           cache=None, decode=False):
    """Decoder with self + cross attention. enc_out: [B,S_enc,D] (train) or
    None (decode: cross K/V live in the cache)."""
    outs = []
    block = _remat(_encdec_block, par)
    for l, lp in enumerate(_layers(params["blocks"], cfg.num_layers)):
        cache_l = None if cache is None else _layer(cache["layers"], l)
        x, cache_out = block(lp, x, positions, cfg, rules, par, enc_out,
                             cache_l, decode)
        outs.append(cache_out)
    x = _block_input(x, params["final_norm"], cfg, rules)
    return x, _stack(outs), torch.zeros((), dtype=torch.float32,
                                        device=x.device)


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg, tokens):
    # gather, then cast: the reference casts the whole table first, which
    # gives the same values (the cast is elementwise) at the cost of a
    # copy of the table per call
    return params["embed"][tokens.long()].to(torch_dtype(cfg.dtype))


def logits_fn(params, cfg, hidden):
    dtype = torch_dtype(cfg.dtype)
    if cfg.tie_embeddings:
        w = params["embed"].to(dtype)
        logits = torch.einsum("bsd,vd->bsv", hidden, w)
    else:
        logits = torch.einsum("bsd,dv->bsv", hidden,
                              params["unembed"].to(dtype))
    Vp, V = padded_vocab(cfg.vocab_size), cfg.vocab_size
    if Vp != V:
        mask = torch.arange(Vp, device=logits.device) < V
        logits = torch.where(mask[None, None], logits, -1e30)
    return logits
