"""AdamW with optional int8-quantized moment storage, the port of the
reference's ``repro/optim/optimizer.py``.

Moment quantization (per-row absmax scales) is the memory trick that lets the
314B grok arch train on 256 x 16 GiB chips: fp32 m+v would be 2.5 TB; int8
(+f32 scales) is ~0.63 TB. Quantization error behaves like a tiny amount of
moment noise; we validate convergence parity on small models in tests.

Trees are the port's parameter trees (nested dicts of tensors, as
``models/params.py`` makes them); the arithmetic is the reference's, step
for step, in float32 (not ``torch.optim.AdamW``, which keeps no int8
moments and applies the decay in another order). ``adamw_update`` is
functional: it returns new tensors and leaves its arguments as they are.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.compat import DTensor, Replicate, distribute_tensor


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"    # float32 | bfloat16 | int8


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), in float32:
    linear warm-up, then a cosine down to a tenth of ``cfg.lr``."""
    step = _f32(step)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


# ---------------------------------------------------------------------------
# int8 moment codec (per-row absmax)
# ---------------------------------------------------------------------------

def _q_scale_shape(shape):
    return tuple(shape[:-1]) + (1,) if len(shape) >= 1 else tuple(shape)


def quantize_i8(x: torch.Tensor) -> dict:
    """``{"q": int8, "s": float32 scales}``: per-row (last axis) absmax
    over 127, rounded half to even and clamped to +-127 (a scalar is not
    clamped, as the reference's)."""
    if x.dim() == 0:
        scale = torch.clamp(x.abs(), min=1e-12) / 127.0
        return {"q": torch.round(x / scale).to(torch.int8), "s": scale}
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.float()}


def dequantize_i8(qs: dict) -> torch.Tensor:
    return qs["q"].float() * qs["s"]


def _is_moment(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def _moment_zeros(leaf: torch.Tensor, dtype: str):
    """A moment of ``leaf``: placed like it when it is a DTensor (an int8
    moment's scales like it with the last dim whole, as the reference's
    ``launch/compile.py`` shards them)."""
    if dtype == "int8":
        s = torch.ones(_q_scale_shape(leaf.shape), dtype=torch.float32,
                       device=leaf.device)
        if isinstance(leaf, DTensor):
            s = distribute_tensor(s, leaf.device_mesh,
                                  scale_placements(leaf.placements, s.dim()),
                                  src_data_rank=None)
        return {"q": torch.zeros_like(leaf, dtype=torch.int8), "s": s}
    return torch.zeros_like(leaf, dtype=_dtype(dtype))


def scale_placements(placements, ndim: int) -> tuple:
    """The placements of an int8 moment's scales [..., 1] from its
    parameter's: the last dim replicated."""
    return tuple(Replicate() if p.is_shard() and p.dim == ndim - 1 else p
                 for p in placements)


def _moment_read(m, dtype: str) -> torch.Tensor:
    return dequantize_i8(m) if dtype == "int8" else m.float()


def _moment_write(x: torch.Tensor, dtype: str):
    return quantize_i8(x) if dtype == "int8" else x.to(_dtype(dtype))


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _map(fn, *trees):
    """``fn`` over matching leaves of ``trees`` (nested dicts; the first
    tree's structure; an int8 moment ``{"q", "s"}`` is one leaf)."""
    head = trees[0]
    if isinstance(head, dict) and not _is_moment(head):
        return {k: _map(fn, *(t[k] for t in trees)) for k in head}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params, cfg: OptimizerConfig) -> dict:
    dt = cfg.moment_dtype
    device = next(_leaves(params)).device
    return {
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "m": _map(lambda p: _moment_zeros(p, dt), params),
        "v": _map(lambda p: _moment_zeros(p, dt), params),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (the leaves'
    sums added in the reference's order: sorted keys)."""
    total = None
    for x in _leaves(tree):
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: OptimizerConfig):
    """Returns (new_params, new_opt_state, metrics)."""
    dt = cfg.moment_dtype
    count = opt_state["count"] + 1
    lr = lr_schedule(cfg, opt_state["count"])
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                       max=1.0) if cfg.clip_norm else 1.0

    bc1 = 1 - torch.pow(_f32(cfg.b1, count.device), count.float())
    bc2 = 1 - torch.pow(_f32(cfg.b2, count.device), count.float())

    def upd(p, g, m, v):
        g = g.float() * clip
        m_f = cfg.b1 * _moment_read(m, dt) + (1 - cfg.b1) * g
        v_f = cfg.b2 * _moment_read(v, dt) + (1 - cfg.b2) * torch.square(g)
        step = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
        decay = cfg.weight_decay * p.float() if p.dim() >= 2 else 0.0
        new_p = (p.float() - lr * (step + decay)).to(p.dtype)
        return (_placed_like(new_p, p), _placed_like(_moment_write(m_f, dt), m),
                _placed_like(_moment_write(v_f, dt), v))

    out = _map(upd, params, grads, opt_state["m"], opt_state["v"])
    new_state = {"count": count, "m": _pick(out, 1), "v": _pick(out, 2)}
    metrics = {"grad_norm": gnorm, "lr": lr}
    return _pick(out, 0), new_state, metrics


def _placed_like(new, old):
    """``new`` (a leaf or an int8 moment) with ``old``'s placements: on a
    mesh the state keeps its sharding from step to step (DTensor places
    an update by what its inputs cost to move, and a gradient may arrive
    placed otherwise)."""
    if isinstance(new, dict):
        return {k: _placed_like(new[k], old[k]) for k in new}
    if isinstance(old, DTensor) and tuple(new.placements) != \
            tuple(old.placements):
        return new.redistribute(old.device_mesh, old.placements)
    return new


def _pick(tree, i: int):
    """Member ``i`` of every ``(param, m, v)`` leaf of ``upd``'s tree."""
    if isinstance(tree, tuple):
        return tree[i]
    return {k: _pick(v, i) for k, v in tree.items()}
