"""Functional execution of KVI instructions over an SpmSpace (+ main
memory); the port's copy of ``repro.core.mfu``. int32 two's-complement
fixed-point semantics, matching the paper's 32-bit fixed-point kernels;
kdotpps applies the post-scaling right-shift that keeps Q-format products
in range.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.isa import Instr
from repro_torch.core.spm import SpmSpace


def _mul32(a: np.ndarray, b) -> np.ndarray:
    """64-bit product wrapped to int32 (hardware multiplier low word)."""
    return (a.astype(np.int64) * np.int64(b) if np.isscalar(b) or b.ndim == 0
            else a.astype(np.int64) * b.astype(np.int64))


class Mfu:
    """Executes one instruction; register file results returned to caller."""

    def __init__(self, spm: SpmSpace, main_memory: Optional[Dict[int, np.ndarray]] = None):
        self.spm = spm
        self.mem: Dict[int, np.ndarray] = main_memory if main_memory is not None else {}

    def execute(self, i: Instr) -> Optional[int]:
        s = self.spm
        eb = i.elem_bytes
        if i.op == "kmemld":
            # src1 = main-memory handle (key into self.mem), dst = SPM addr
            s.write(i.dst, self.mem[i.src1].astype(_np_dtype(eb)))
            return None
        if i.op == "kmemstr":
            # dst = main-memory handle, src1 = SPM addr
            self.mem[i.dst] = s.read(i.src1, i.length, eb).copy()
            return None

        a = s.read(i.src1, i.length, eb) if i.src1 is not None else None
        b = s.read(i.src2, i.length, eb) if i.src2 is not None else None
        if i.op == "kaddv":
            s.write(i.dst, (a.astype(np.int64) + b).astype(a.dtype))
        elif i.op == "ksubv":
            s.write(i.dst, (a.astype(np.int64) - b).astype(a.dtype))
        elif i.op == "kvmul":
            s.write(i.dst, _mul32(a, b).astype(a.dtype))
        elif i.op == "kvred":
            return int(np.int64(a.sum(dtype=np.int64)).astype(np.int32))
        elif i.op == "kdotp":
            return int(np.int64(_mul32(a, b).sum(dtype=np.int64))
                       .astype(np.int32))
        elif i.op == "kdotpps":
            prod = _mul32(a, b).sum(dtype=np.int64)
            return int(np.int64(prod >> i.scalar).astype(np.int32))
        elif i.op == "ksvaddsc":
            s.write(i.dst, (a.astype(np.int64) + int(i.scalar)).astype(a.dtype))
        elif i.op == "ksvaddrf":
            return int(np.int64(a.astype(np.int64).sum(dtype=np.int64)
                                + int(i.scalar)).astype(np.int32))
        elif i.op == "ksvmulsc":
            s.write(i.dst, _mul32(a, int(i.scalar)).astype(a.dtype))
        elif i.op == "ksvmulrf":
            return int(np.int64(_mul32(a, int(i.scalar)).sum(dtype=np.int64))
                       .astype(np.int32))
        elif i.op == "ksrlv":
            ua = a.astype(np.uint32 if eb == 4 else np.uint16 if eb == 2
                          else np.uint8)
            s.write(i.dst, (ua >> np.uint32(i.scalar)).astype(a.dtype))
        elif i.op == "ksrav":
            s.write(i.dst, (a >> np.int32(i.scalar)).astype(a.dtype))
        elif i.op == "krelu":
            s.write(i.dst, np.maximum(a, 0).astype(a.dtype))
        elif i.op == "kvslt":
            s.write(i.dst, (a < b).astype(a.dtype))
        elif i.op == "ksvslt":
            s.write(i.dst, (a < np.int32(i.scalar)).astype(a.dtype))
        elif i.op == "kvcp":
            s.write(i.dst, a)
        else:
            raise ValueError(f"cannot execute {i.op}")
        return None


def _np_dtype(elem_bytes: int):
    return {1: np.int8, 2: np.int16, 4: np.int32}[elem_bytes]
