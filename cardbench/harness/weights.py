"""The benchmark's weights, made on the device from the seed in a few
large calls: one ``randn`` over every random leaf, one ``rand`` over the
Mamba-2 leaves drawn from ranges, each leaf a view of those buffers."""
from __future__ import annotations

import math

import torch

SEED_MASK = 2 ** 64 - 1


def make(specs: list, seed: int, device) -> dict:
    """Float32 weights by path from ``(path, shape, law, scale)`` specs
    (``reference.lm.param_specs``). The same seed gives the same weights
    on one kind of device.

    Laws: ``randn`` a standard normal times ``scale``; ``zeros``;
    ``ones``; ``a_log`` log A with A uniform in [1, 16); ``dt_bias`` the
    inverse softplus of a dt log-uniform in [1e-3, 1e-1) (Mamba-2's
    initialisation)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    numel = {p: math.prod(shape) for p, shape, _, _ in specs}
    n_normal = sum(numel[p] for p, _, law, _ in specs if law == "randn")
    n_unif = sum(numel[p] for p, _, law, _ in specs
                 if law in ("a_log", "dt_bias"))
    normal = torch.randn(n_normal, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device)
    out, i, j = {}, 0, 0
    for path, shape, law, scale in specs:
        n = numel[path]
        if law == "randn":
            out[path] = normal[i:i + n].view(shape).mul_(scale)
            i += n
        elif law in ("a_log", "dt_bias"):
            u = unif[j:j + n].view(shape)
            j += n
            if law == "a_log":
                out[path] = u.mul_(15.0).add_(1.0).log_()
            else:
                dt = u.mul_(math.log(100.0)).add_(math.log(1e-3)).exp_()
                out[path] = dt + torch.log(-torch.expm1(-dt))
        elif law == "zeros":
            out[path] = torch.zeros(shape, device=device)
        elif law == "ones":
            out[path] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown law {law!r} for {path}")
    return out


def nest(flat: dict) -> dict:
    """A flat dict by path as the nested tree the program takes."""
    out = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def flatten(tree: dict, path: str = "") -> dict:
    if not isinstance(tree, dict):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{path}/{k}" if path else k))
    return out
