"""Plain-torch oracles of the compute kernels and intrinsics, the port's
copy of the reference's ``repro/kernels/ref.py``.

Each is the direct formula, written apart from the kernels' plain
versions, and runs on the CPU (the integer matmul needs PyTorch's CPU
integer product). Where the model modules already define the math
(attention, SSD), the oracle delegates to them:
``flash_attention_ref`` to :func:`repro_torch.models.layers.attention_ref`
and ``ssd_scan_ref`` to the per-step recurrence of
:mod:`repro_torch.models.ssm`.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.fused_vops import SlotOp, apply_vop
from repro_torch.models.layers import attention_ref


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """Kernel layout [B, H, S, hd] -> delegates to the models.layers
    oracle (a row with no visible key: the mean of v)."""
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        q_offset=q_offset)
    return out.transpose(1, 2)


def ssd_scan_ref(x: torch.Tensor, da: torch.Tensor, dt: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel signature (head-broadcast B/C, da = dt*A) -> the models.ssm
    recurrence, one step at a time. Returns (y, state [Bz,H,N,P])."""
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    state = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(da[:, t].float())                          # [Bz,H]
        upd = (dt[:, t].float()[..., None] * x[:, t].float()
               )[..., None] * B[:, t].float()[:, :, None, :]
        state = state * a[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, C[:, t].float()))
    y = torch.stack(ys, dim=1).to(x.dtype)                       # [Bz,S,H,P]
    return y, state.transpose(-1, -2).contiguous()               # [Bz,H,N,P]


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
