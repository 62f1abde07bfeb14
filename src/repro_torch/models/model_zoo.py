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
    return {
        "wq": P(pd + (D, H, hd), lay + ("embed", "heads", "head_dim"),
                "fanin", fan_in=D),
        "wk": P(pd + (D, KV, hd), lay + ("embed", "kv_heads", "head_dim"),
                "fanin", fan_in=D),
        "wv": P(pd + (D, KV, hd), lay + ("embed", "kv_heads", "head_dim"),
                "fanin", fan_in=D),
        "wo": P(pd + (H, hd, D), lay + ("heads", "head_dim", "embed"),
                "fanin", fan_in=H * hd),
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
        t["ssm"] = _ssm_template(cfg, L)
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
                  *, causal=True, window=0, kv_override=None):
    """Full-sequence attention (train/prefill). Returns (out, (k, v))."""
    dtype = x.dtype
    q = _heads_proj(x, lp["wq"], dtype)
    if kv_override is None:
        k = _heads_proj(x, lp["wk"], dtype)
        v = _heads_proj(x, lp["wv"], dtype)
        k = apply_rope(k, positions, cfg.rope_theta)
    else:  # cross-attention: kv computed from encoder output
        enc = kv_override
        k = _heads_proj(enc, lp["wk"], dtype)
        v = _heads_proj(enc, lp["wv"], dtype)
    q = apply_rope(q, positions, cfg.rope_theta) if kv_override is None else q
    q = rules.constrain(q, "batch", "seq", "heads", "head_dim")
    k = rules.constrain(k, "batch", "seq", "kv_heads", "head_dim")
    out = flash_attention_xla(
        q, k, v, causal=causal, window=window,
        q_block=par.attn_q_block, kv_block=par.attn_kv_block,
        swa_block_skip=par.swa_block_skip, repeat_kv=par.attn_repeat_kv)
    out = torch.einsum("bshk,hkd->bsd", out, lp["wo"].to(dtype))
    return out, (k, v)


def _ffn_forward(lp, x, cfg, rules):
    return swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])


def _ssm_forward(lp, x, cfg: ModelConfig, rules: Rules, conv_state=None,
                 ssd_state=None, decode=False):
    """Full mamba2 mixer. x: [B,S,D]. Returns (y, (conv_state, ssd_state))."""
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
            ssd_state, xh[:, 0], dt[:, 0], A, Bh[:, 0], Ch[:, 0])
        y = y[:, None]
    else:
        # the "ssd" span, its backward bracketed (a traced train step);
        # its arg path says whether the card's kernels ran
        y, new_state = spans.bracketed(
            "ssd", ssm_lib.ssd_chunked, xh, dt, A, Bh, Ch,
            span_args={"path": ssm_lib.ssd_path(xh)},
            chunk=min(cfg.ssm_chunk, S), initial_state=ssd_state)
    y = y + xh * lp["D_skip"].float()[None, None, :, None].to(dtype)
    # (and the heads merged back: the gradient split the same way)
    y = grad_whole_unless_divides(y, 2, H).reshape(B_, S, cfg.d_inner)
    y = rms_norm(y * F.silu(z.float()).to(dtype), lp["gate_norm"],
                 cfg.norm_eps)
    y = torch.einsum("bse,ed->bsd", y, lp["w_out"].to(dtype))
    return y, (new_conv.to(x.dtype), new_state)


def _self_attn_decode(lp, h, positions, cfg, cache_in, window=0):
    """One token's self-attention against the cache. Returns (out,
    cache_out)."""
    dtype = h.dtype
    q = _heads_proj(h, lp["wq"], dtype)
    k = _heads_proj(h, lp["wk"], dtype)
    v = _heads_proj(h, lp["wv"], dtype)
    pos = positions[:, 0]                              # [B] per-slot position
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kc, vc, cpos = cache_update(cache_in["k"], cache_in["v"],
                                cache_in["cpos"], k, v, pos, window=window)
    att = decode_attention(q, kc, vc, cpos, pos, window=window)
    out = torch.einsum("bshk,hkd->bsd", att, lp["wo"].to(dtype))
    return out, {"k": kc, "v": vc, "cpos": cpos}


def _prefill_cache(k, v, like: dict) -> dict:
    """Prefill: the cache lines of k, v [B,S,KV,hd] — the last slots'
    tokens of a ring (SWA) cache, or every token and empty headroom slots
    of a full one — in the dtypes of ``like``'s lines."""
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
                   decode=False, layer=None):
    """One block. Returns (x, cache_out, aux). In a traced train step the
    body is the span "block" (arg ``layer``; phase ``forward``, or
    ``recompute`` when remat runs it again in the backward)."""
    with spans.phased("block", layer=layer):
        return _decoder_block_body(lp, x, positions, cfg, rules, par,
                                   cache_in, decode)


def _decoder_block_body(lp, x, positions, cfg, rules, par, cache_in,
                        decode):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    window = cfg.sliding_window
    cache_out = {}
    h = _block_input(x, lp["ln1"], cfg, rules)

    if cfg.family == "ssm":
        y, (conv_s, ssd_s) = _ssm_forward(
            lp["ssm"], h, cfg, rules,
            conv_state=None if cache_in is None else cache_in["conv"],
            ssd_state=None if cache_in is None else cache_in["state"],
            decode=decode)
        x = x + y
        cache_out = {"conv": conv_s, "state": ssd_s}
        x = rules.constrain(x, "batch", "seq_sp", None)
        return x, cache_out, aux

    # --- attention path (dense / moe / vlm / hybrid) ---
    if decode:
        attn_out, cache_out = _self_attn_decode(lp["attn"], h, positions,
                                                cfg, cache_in, window)
        kv = None
    else:
        with spans.span("attention"):
            attn_out, kv = _attn_forward(lp["attn"], h, positions, cfg,
                                         rules, par, causal=True,
                                         window=window)

    if cfg.family == "hybrid":
        y_ssm, (conv_s, ssd_s) = _ssm_forward(
            lp["ssm"], h, cfg, rules,
            conv_state=None if cache_in is None else cache_in["conv"],
            ssd_state=None if cache_in is None else cache_in["state"],
            decode=decode)
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

    if not decode and kv is not None and cache_in is not None:
        cache_out.update(_prefill_cache(*kv, cache_in))
    return x, cache_out, aux


def _remat(body, par: Parallelism):
    """``body`` recomputed in the backward when ``par.remat`` asks for it
    ("block" or "full": the reference's ``jax.checkpoint`` with its
    default policy or saving nothing, both a recompute of the whole body
    here) and autograd is recording."""
    if par.remat in ("block", "full") and torch.is_grad_enabled():
        return lambda *args, **kw: checkpoint(body, *args,
                                              use_reentrant=False, **kw)
    return body


def decoder_forward(params, cfg: ModelConfig, rules: Rules, par: Parallelism,
                    x, positions, cache=None, decode=False):
    """x: [B,S,D] embedded input. Returns (hidden, new_layer_cache, aux)."""
    blocks = params["blocks"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    outs = []
    block = _remat(_decoder_block, par)
    for l, lp in enumerate(_layers(blocks, cfg.num_layers)):
        cache_l = None if cache is None else _layer(cache["layers"], l)
        x, cache_out, a = block(
            lp, x, positions, cfg, rules, par,
            cache_in=cache_l, decode=decode, layer=l)
        aux = aux + a
        outs.append(cache_out)
    x = _block_input(x, params["final_norm"], cfg, rules)
    return x, _stack(outs), aux


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
