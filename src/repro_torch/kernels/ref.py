"""Plain-torch oracles of the compute kernels and intrinsics, the port's
copy of the reference's ``repro/kernels/ref.py``.

Each is the direct formula, written apart from the kernels' plain
versions, and runs on the CPU (the integer matmul needs PyTorch's CPU
integer product). ``flash_attention_ref`` and ``ssd_scan_ref`` come with
the port of ``models/`` (attention and SSD), whose math they share.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.fused_vops import SlotOp, apply_vop


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """int8: the int32 product (wrapping); floats: the float32 product
    cast to ``out_dtype`` or the input's dtype."""
    if a.dtype == torch.int8:
        return (a.long() @ b.long()).to(torch.int32)
    return (a.float() @ b.float()).to(out_dtype or a.dtype)


def conv2d_ref(img: torch.Tensor, filt: torch.Tensor, *,
               shift: int = 0) -> torch.Tensor:
    """Zero-padded same-size correlation: int32 wraps, then shifts;
    other dtypes accumulate in float32 and cast back."""
    H, W = img.shape
    F = filt.shape[0]
    pad = F // 2
    is_int = img.dtype == torch.int32
    padded = torch.zeros((H + F - 1, W + F - 1), dtype=torch.int64 if is_int
                         else torch.float32)
    padded[pad:pad + H, pad:pad + W] = img
    w = filt.to(torch.int32).long() if is_int else filt.float()
    acc = torch.zeros((H, W), dtype=padded.dtype)
    for fr in range(F):
        for fc in range(F):
            acc = acc + padded[fr:fr + H, fc:fc + W] * w[fr, fc]
    if is_int:
        acc = (acc & 0xFFFFFFFF).to(torch.int32)
        return acc >> shift if shift else acc
    return acc.to(img.dtype)


def fft_ref(re: torch.Tensor, im: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.fft.fft`` of the complex64 rows."""
    y = torch.fft.fft(torch.complex(re.float(), im.float()), dim=-1)
    return y.real.float(), y.imag.float()


def vops_ref(program: Sequence[SlotOp], inputs: Sequence[torch.Tensor],
             out_slot: Optional[int] = None,
             n_slots: Optional[int] = None) -> torch.Tensor:
    """Interpret a slot program op by op; inputs fill slots 0..n-1."""
    program = tuple(program)
    if n_slots is None:
        n_slots = max([len(inputs)] + [o[1] + 1 for o in program])
    if out_slot is None:
        out_slot = program[-1][1]
    slots = [None] * n_slots
    for i, x in enumerate(inputs):
        slots[i] = x
    for op, dst, s1, s2, imm in program:
        slots[dst] = apply_vop(op, slots[s1],
                               slots[s2] if s2 is not None else None, imm)
    return slots[out_slot]


def kdotp_ref(a: torch.Tensor, b: torch.Tensor,
              shift: int = 0) -> torch.Tensor:
    """Integers: the int32 (wrapped) sum of products, then ``>> shift``;
    floats: the float32 sum divided by ``2**shift``."""
    if not a.dtype.is_floating_point:
        s = (a.long() * b.long()).sum().to(torch.int32)
        return s >> shift if shift else s
    s = (a.float() * b.float()).sum()
    return s / (2.0 ** shift) if shift else s


def kvred_ref(a: torch.Tensor) -> torch.Tensor:
    """The int32 (wrapped) or float32 sum."""
    if not a.dtype.is_floating_point:
        return a.long().sum().to(torch.int32)
    return a.float().sum()
