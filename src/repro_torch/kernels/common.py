"""Shared kernel utilities: block arithmetic (copied from the reference's
``repro.kernels.common``) and the port's device rule."""
from __future__ import annotations

from typing import Optional, Union

import torch


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
