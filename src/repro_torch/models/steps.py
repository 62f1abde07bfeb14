"""Step functions (train / prefill / decode) + cache & input templates,
the port of the reference's ``repro/models/steps.py``.

Everything here is shape-polymorphic over (arch, shape) cells; shardings
come from the logical-axis Rules, which on one device constrain nothing.
The steps run eagerly on the device of the params they are given: prefill
and decode under ``torch.inference_mode()`` (``no_grad`` on a mesh), the
train step under autograd (gradients through the plain layers, then the
reference's AdamW from ``repro_torch.optim``).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.compat import implicit_replication
from repro_torch.kvi.obs import spans
from repro_torch.configs.base import ModelConfig, Parallelism, ShapeConfig
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import model_zoo as zoo
from repro_torch.models.params import (P, _unflatten, torch_dtype,
                                       tree_leaves, tree_map)
from repro_torch.models.sharding import Rules, take_along
from repro_torch.optim.optimizer import OptimizerConfig, adamw_update

LABEL_IGNORE = -100


# ---------------------------------------------------------------------------
# cache templates
# ---------------------------------------------------------------------------

DECODE_HEADROOM = 64    # extra slots a prefill leaves for generation


def cache_slots(cfg: ModelConfig, shape: ShapeConfig,
                extra_slots: int = 0, window: int = None) -> int:
    """KV slots: full seq (+headroom) for dense attention, window for SWA
    (ring buffers never overflow — eviction handles capacity). With meta
    tokens, their slots first: then a ring of the whole window, or the
    full sequence after them."""
    window = cfg.sliding_window if window is None else window
    M = cfg.meta_tokens
    if M:
        return M + (window if window else shape.seq_len + extra_slots)
    if window:
        return min(shape.seq_len, window)
    return shape.seq_len + extra_slots


def _kv_cache_template(cfg: ModelConfig, n: int, B: int, S: int) -> dict:
    KV = cfg.num_kv_heads
    axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    return {"k": P((n, B, S, KV, cfg.head_dim), axes, "zeros", cfg.dtype),
            "v": P((n, B, S, KV, cfg.value_dim), axes, "zeros", cfg.dtype),
            "cpos": P((n, B, S), ("layers", "batch", "cache_seq"), "neg1",
                      "int32")}


def cache_template(cfg: ModelConfig, shape: ShapeConfig,
                   extra_slots: int = 0) -> dict:
    """P-spec tree for the decode cache of one (arch, shape)."""
    L, B = cfg.num_layers, shape.global_batch
    layers = {}
    if cfg.family == "audio":
        S_self = shape.seq_len // 2 + extra_slots
        S_cross = shape.seq_len // 2
        KV, hd = cfg.num_kv_heads, cfg.head_dim
        layers = {
            "k": P((L, B, S_self, KV, hd),
                   ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
                   "zeros", cfg.dtype),
            "v": P((L, B, S_self, KV, hd),
                   ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
                   "zeros", cfg.dtype),
            "cpos": P((L, B, S_self), ("layers", "batch", "cache_seq"),
                      "neg1", "int32"),
            "xk": P((L, B, S_cross, KV, hd),
                    ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
                    "zeros", cfg.dtype),
            "xv": P((L, B, S_cross, KV, hd),
                    ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
                    "zeros", cfg.dtype),
        }
    else:
        if cfg.num_heads and cfg.per_layer_attention:
            # the producing layers' lines alone, windowed and global apart
            for suffix, glob in zoo._KV_KINDS:
                n = sum((l in cfg.global_layers) == glob
                        for l in cfg.kv_producers)
                if n:
                    S = cache_slots(cfg, shape, extra_slots,
                                    0 if glob else cfg.sliding_window)
                    layers.update({k + suffix: p for k, p in
                                   _kv_cache_template(cfg, n, B, S).items()})
        elif cfg.num_heads:  # attention caches (dense/moe/vlm/hybrid)
            S = cache_slots(cfg, shape, extra_slots)
            KV, hd = cfg.num_kv_heads, cfg.head_dim
            layers.update({
                "k": P((L, B, S, KV, hd),
                       ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
                       "zeros", cfg.dtype),
                "v": P((L, B, S, KV, hd),
                       ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
                       "zeros", cfg.dtype),
                "cpos": P((L, B, S), ("layers", "batch", "cache_seq"),
                          "neg1", "int32"),
            })
        if cfg.ssm_kind == "mamba1":  # hymba's conv and scan states
            layers.update({
                "conv": P((L, B, cfg.ssm_conv - 1, cfg.d_inner),
                          ("layers", "batch", None, "ssm_dim"), "zeros",
                          cfg.dtype),
                "state": P((L, B, cfg.d_inner, cfg.ssm_state),
                           ("layers", "batch", "ssm_dim", "ssm_state"),
                           "zeros", "float32"),
            })
        elif cfg.ssm_state:  # ssm caches (ssm/hybrid)
            C = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            layers.update({
                "conv": P((L, B, cfg.ssm_conv - 1, C),
                          ("layers", "batch", None, None), "zeros", cfg.dtype),
                "state": P((L, B, cfg.ssm_heads, cfg.ssm_headdim,
                            cfg.ssm_state),
                           ("layers", "batch", "ssm_heads", None, None),
                           "zeros", "float32"),
            })
    return {"layers": layers,
            "pos": P((B,), ("batch",), "zeros", "int32")}


# ---------------------------------------------------------------------------
# input specs (the data templates)
# ---------------------------------------------------------------------------

def batch_template(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """P-spec tree for one step's data batch."""
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    if cfg.family == "audio":
        Se = Sd = S // 2
        if kind == "train":
            return {"frames": P((B, Se, cfg.d_model), ("batch", "seq", None),
                                "normal", cfg.dtype),
                    "tokens": P((B, Sd), ("batch", "seq"), "zeros", "int32"),
                    "labels": P((B, Sd), ("batch", "seq"), "zeros", "int32")}
        if kind == "prefill":
            return {"frames": P((B, Se, cfg.d_model), ("batch", "seq", None),
                                "normal", cfg.dtype),
                    "tokens": P((B, Sd), ("batch", "seq"), "zeros", "int32")}
        return {"tokens": P((B, 1), ("batch", None), "zeros", "int32")}
    if cfg.family == "vlm":
        Fl = cfg.frontend_len
        if kind == "train":
            return {"patch_embeds": P((B, Fl, cfg.d_model),
                                      ("batch", "seq", None), "normal",
                                      cfg.dtype),
                    "tokens": P((B, S - Fl), ("batch", "seq"), "zeros",
                                "int32"),
                    "labels": P((B, S), ("batch", "seq"), "zeros", "int32")}
        if kind == "prefill":
            return {"patch_embeds": P((B, Fl, cfg.d_model),
                                      ("batch", "seq", None), "normal",
                                      cfg.dtype),
                    "tokens": P((B, S - Fl), ("batch", "seq"), "zeros",
                                "int32")}
        return {"tokens": P((B, 1), ("batch", None), "zeros", "int32")}
    # plain decoder families
    if kind == "train":
        return {"tokens": P((B, S), ("batch", "seq"), "zeros", "int32"),
                "labels": P((B, S), ("batch", "seq"), "zeros", "int32")}
    if kind == "prefill":
        return {"tokens": P((B, S), ("batch", "seq"), "zeros", "int32")}
    return {"tokens": P((B, 1), ("batch", None), "zeros", "int32")}


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def softmax_xent(logits, labels, vocab_size: int):
    """logits [B,S,Vp] (any float dtype), labels [B,S] int32 with
    LABEL_IGNORE masked. Returns (mean_nll, z_loss_term)."""
    logits = logits.float()
    mask = (labels != LABEL_IGNORE) & (labels >= 0) & (labels < vocab_size)
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = take_along(logits, safe[..., None], -1)[..., 0]
    nll = (lse - picked) * mask
    denom = torch.clamp(mask.sum(), min=1)
    z_loss = torch.sum(torch.square(lse) * mask) / denom
    return nll.sum() / denom, z_loss


# ---------------------------------------------------------------------------
# forward dispatch
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg: ModelConfig, rules: Rules, batch, kind: str):
    """Returns (x [B,S,D], positions [B,S])."""
    dtype = torch_dtype(cfg.dtype)
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        patches = torch.einsum("bsd,de->bse",
                               batch["patch_embeds"].to(dtype),
                               params["patch_adapter"].to(dtype))
        toks = zoo.embed_tokens(params, cfg, batch["tokens"])
        x = torch.cat([patches, toks], dim=1)
    else:
        x = zoo.embed_tokens(params, cfg, batch["tokens"])
    B, S = x.shape[:2]
    positions = zoo._positions(B, S, x.device)
    x = rules.constrain(x, "batch", "seq_sp", None)
    return x, positions


def forward_train(params, cfg, rules, par, batch):
    """The training forward. Returns (logits, labels, aux)."""
    if cfg.family == "audio":
        enc = zoo.encoder_forward(params, cfg, rules, par, batch["frames"])
        x = zoo.embed_tokens(params, cfg, batch["tokens"])
        B, Sd = batch["tokens"].shape
        pos = zoo._positions(B, Sd, x.device)
        hid, _, aux = zoo.encdec_decoder_forward(params, cfg, rules, par, x,
                                                 pos, enc)
    else:
        x, pos = _embed_inputs(params, cfg, rules, batch, "train")
        hid, _, aux = zoo.decoder_forward(params, cfg, rules, par, x, pos)
    logits = zoo.logits_fn(params, cfg, hid)
    return logits, batch["labels"], aux


def make_loss_fn(cfg: ModelConfig, rules: Rules, par: Parallelism):
    def loss_fn(params, batch):
        logits, labels, aux = forward_train(params, cfg, rules, par, batch)
        nll, z = softmax_xent(logits, labels, cfg.vocab_size)
        loss = nll + 1e-4 * z + 1e-2 * aux
        return loss, {"loss": nll, "z_loss": z, "aux_loss": aux}
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)`` through
    ``torch.autograd``: the reference's ``jax.value_and_grad(...,
    has_aux=True)``. Grads have the params' dtypes (zeros where a leaf
    does not reach the loss); nothing is left attached to a graph."""
    names = [name for name, x in tree_leaves(params)
             if x.is_floating_point()]
    flat = dict(tree_leaves(params))
    leaves = {name: flat[name].detach().requires_grad_(True)
              for name in names}
    diff = _unflatten(params, {**flat, **leaves})
    with torch.enable_grad():
        with spans.span("forward"):
            loss, metrics = loss_fn(diff, batch)
        with spans.span("backward"):
            grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                        allow_unused=True)
    g = {n: torch.zeros_like(leaves[n]) if x is None else x
         for n, x in zip(names, grads)}
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            _unflatten(params, {**flat, **g}))


def _cast_floating(tree, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree, is_leaf=lambda x: not isinstance(x, dict))


def _add(a, b):
    if isinstance(a, dict):
        return {k: _add(a[k], b[k]) for k in a}
    return a + b


# ---------------------------------------------------------------------------
# step factories
# ---------------------------------------------------------------------------

def _wrap_step(step, rules: Rules, *, serving: bool = False):
    """``step`` as it runs: a serving step under ``inference_mode`` (on a
    mesh ``no_grad``: DTensor cannot make inference tensors); on a
    ``DeviceMesh`` the plain tensors that a step makes itself
    (positions, masks, the zeros of an online softmax's state: the same
    values on every rank) enter DTensor ops as replicated."""
    if rules.mesh is None or isinstance(rules.mesh, AbstractMesh):
        return torch.inference_mode()(step) if serving else step

    @functools.wraps(step)
    def run(*args):
        with implicit_replication(), torch.set_grad_enabled(not serving):
            return step(*args)
    return run


def make_train_step(cfg: ModelConfig, rules: Rules, par: Parallelism,
                    opt_cfg: OptimizerConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients through autograd (eagerly,
    outside ``inference_mode``), then ``adamw_update``. Functional: the
    arguments are left as they are. Traced (``kvi.obs.spans``) when a
    profiler session or an activated bundle asks: one ``train_step``
    span a call over ``forward`` and ``backward`` (one each a
    micro-batch) and ``optimizer``."""
    loss_fn = make_loss_fn(cfg, rules, par)

    if par.mixed_precision:
        # bf16 compute params (their cotangents run in bf16); the f32
        # params stay the master copy updated by AdamW
        base_loss_fn = loss_fn

        def loss_fn(params, batch):  # noqa: F811 — deliberate wrap
            return base_loss_fn(_cast_floating(params, torch.bfloat16),
                                batch)

    def train_step(params, opt_state, batch):
        with spans.step(batch):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        if par.grad_accum > 1:
            # the reference's lax.scan over micro-batches as a loop: loss
            # and grads summed in float32, then averaged; the metrics are
            # the last micro-batch's
            B = next(iter(batch.values())).shape[0]
            micro = B // par.grad_accum
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(batch.values())).device)
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device),
                             params, is_leaf=lambda x: not isinstance(x,
                                                                      dict))
            for i in range(par.grad_accum):
                mb = {k: v[i * micro:(i + 1) * micro]
                      for k, v in batch.items()}
                (l, metrics), g = value_and_grad(loss_fn, params, mb)
                grads = _add(grads, g)
                loss = loss + l
            loss = loss / par.grad_accum
            grads = tree_map(lambda g: g / par.grad_accum, grads,
                             is_leaf=lambda x: not isinstance(x, dict))
        else:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        with spans.span("optimizer"):
            params, opt_state, opt_metrics = adamw_update(grads, opt_state,
                                                          params, opt_cfg)
        metrics = dict(metrics, total_loss=loss, **opt_metrics)
        return params, opt_state, metrics

    return _wrap_step(train_step, rules)


def _zeros(template, device):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch_dtype(p.dtype),
                                          device=device), template)


def meta_cache(params, cfg: ModelConfig, rules: Rules, par: Parallelism,
               shape: ShapeConfig) -> dict:
    """The cache of one sequence after the meta tokens alone, the lines
    of ``cache_template(cfg, shape)`` at batch 1: where every serving
    slot starts (the meta tokens are prefilled once)."""
    dev = params["embed"].device
    t = cache_template(cfg, shape.replace(global_batch=1))
    with torch.inference_mode():
        x = zoo.embed_tokens(params, cfg,
                             torch.zeros((1, 0), dtype=torch.int32,
                                         device=dev))
        _, layers, _ = zoo.decoder_forward(
            params, cfg, rules, par, x, zoo._positions(1, 0, dev),
            cache={"layers": _zeros(t["layers"], dev)})
    return {"layers": layers,
            "pos": torch.full((1,), cfg.meta_tokens, dtype=torch.int32,
                              device=dev)}


def make_prefill_step(cfg: ModelConfig, rules: Rules, par: Parallelism,
                      shape: ShapeConfig):
    # leave generation headroom so decode never overwrites live slots
    cache_t = cache_template(cfg, shape, extra_slots=DECODE_HEADROOM)

    def prefill_step(params, batch):
        cache0 = _zeros(cache_t["layers"], params["embed"].device)
        if cfg.family == "audio":
            enc = zoo.encoder_forward(params, cfg, rules, par, batch["frames"])
            x = zoo.embed_tokens(params, cfg, batch["tokens"])
            B, Sd = batch["tokens"].shape
            pos = zoo._positions(B, Sd, x.device)
            hid, layer_cache, _ = zoo.encdec_decoder_forward(
                params, cfg, rules, par, x, pos, enc,
                cache={"layers": cache0}, decode=False)
            S_total = Sd
        else:
            x, pos = _embed_inputs(params, cfg, rules, batch, "prefill")
            hid, layer_cache, _ = zoo.decoder_forward(
                params, cfg, rules, par, x, pos,
                cache={"layers": cache0}, decode=False)
            S_total = x.shape[1] + cfg.meta_tokens
        logits = zoo.logits_fn(params, cfg, hid[:, -1:])
        B = hid.shape[0]
        cache = {"layers": layer_cache,
                 "pos": torch.full((B,), S_total, dtype=torch.int32,
                                   device=hid.device)}
        return logits, cache

    return _wrap_step(prefill_step, rules, serving=True)


def make_decode_step(cfg: ModelConfig, rules: Rules, par: Parallelism,
                     shape: ShapeConfig):
    def decode_step(params, cache, batch):
        tokens = batch["tokens"]                       # [B, 1]
        x = zoo.embed_tokens(params, cfg, tokens)
        pos = cache["pos"][:, None]                    # [B, 1] per-slot
        if cfg.family == "audio":
            hid, layer_cache, _ = zoo.encdec_decoder_forward(
                params, cfg, rules, par, x, pos, None, cache=cache,
                decode=True)
        else:
            hid, layer_cache, _ = zoo.decoder_forward(
                params, cfg, rules, par, x, pos, cache=cache, decode=True)
        logits = zoo.logits_fn(params, cfg, hid)
        new_cache = {"layers": layer_cache, "pos": cache["pos"] + 1}
        return logits, new_cache

    return _wrap_step(decode_step, rules, serving=True)


def make_step(cfg, rules, par, shape,
              opt_cfg: Optional[OptimizerConfig] = None):
    if shape.kind == "train":
        return make_train_step(cfg, rules, par, opt_cfg or OptimizerConfig(
            moment_dtype=par.moment_dtype))
    if shape.kind == "prefill":
        return make_prefill_step(cfg, rules, par, shape)
    return make_decode_step(cfg, rules, par, shape)
