"""int8 error-feedback gradient compression for cross-pod reduction, the
port of the reference's ``repro/optim/grad_compress.py``.

At 2 pods x 256 chips the pod-to-pod links are the scarcest bandwidth; the
classic trick is to all-reduce 8-bit gradients with an error-feedback
buffer so the quantization error is re-injected next step (convergence
neutral to first order).

The codec (``quantize_block``, ``dequantize_block``, ``compress_residual``)
and the one-device reduction are here; the reduction over a mesh's
``pod`` axis waits for the port's mesh (ROADMAP.md queue 1 item 7).
"""
from __future__ import annotations

import torch


def quantize_block(x: torch.Tensor, *, axis: int = -1):
    amax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_block(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_residual(g: torch.Tensor, err: torch.Tensor):
    """(quantized, scale, new_error) with error feedback."""
    x = g.float() + err
    q, s = quantize_block(x)
    new_err = x - dequantize_block(q, s)
    return q, s, new_err


def cross_pod_mean(grads, errors, mesh=None, axis_name: str = "pod"):
    """Mean of a gradient tree across the pod axis with an int8 wire
    format and error feedback: ``(mean, new_errors)``, trees of float32.

    On one device (``mesh=None``) the pod axis holds one member: the mean
    is the one gradient as the wire carries it (its int8 codes times
    their scales), the error the rest. A mesh raises."""
    if mesh is not None:
        raise NotImplementedError(
            "cross_pod_mean over a mesh waits for the port's DeviceMesh "
            "(ROADMAP.md queue 1 item 7)")

    def leaf(g, e):
        if isinstance(g, dict):
            pairs = {k: leaf(g[k], e[k]) for k in g}
            return ({k: p[0] for k, p in pairs.items()},
                    {k: p[1] for k, p in pairs.items()})
        q, s, new_e = compress_residual(g, e)
        return dequantize_block(q, s), new_e

    return leaf(grads, errors)
