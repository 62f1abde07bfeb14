"""Shared kernel utilities: block arithmetic (copied from the reference's
``repro.kernels.common``) and the port's device rule."""
from __future__ import annotations

from typing import Optional, Union

import torch


def xla_convert(acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An accumulator (float32, or an int32 sum) in ``dtype``, as XLA
    converts: into a float type to nearest even (an int32 through
    float32 first); a float into an integer type truncated toward zero
    and saturated, NaN giving 0 (clamped in float64, where the int32
    bounds are exact); an int32 into an integer type wrapped."""
    if dtype.is_floating_point:
        return acc.float().to(dtype)
    if not acc.dtype.is_floating_point:
        return acc.to(dtype)
    info = torch.iinfo(dtype)
    return acc.double().nan_to_num(0.0).clamp(info.min, info.max).trunc() \
        .to(dtype)


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pick_block(dim: int, preferred: int, align: int = 128) -> int:
    """Largest aligned block <= preferred that divides dim, or dim itself
    when it is small/unaligned."""
    if dim <= preferred:
        return dim
    b = preferred
    while b >= align:
        if dim % b == 0:
            return b
        b -= align
    return dim


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on. ``None`` means the card; there
    is no silent CPU fallback — a caller that wants the plain PyTorch
    path asks for ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
