"""Scratchpad memories (SPMs) + allocator (the port's copy of
``repro.core.spm``).

The paper: "The instructions implement vector operations without relying on
a vector register file, but rather on a memory space mapped on the local
SPMs, for maximum flexibility. The programmer can move vector data at any
point of the SPM address space with no constraint except the total
capacity." — so the model is a flat byte-addressable space of N x capacity
bytes, organized in D banks per SPM (one SPM line per cycle feeds the MFU).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from repro_torch.configs.base import KlessydraConfig


class SpmError(Exception):
    pass


@dataclass
class SpmSpace:
    """Functional SPM state for one SPMI (one hart's view, or the shared
    view): flat int8 backing store with int32 vector accessors."""

    config: KlessydraConfig
    data: np.ndarray = field(default=None)
    _alloc_ptr: int = 0
    _allocs: Dict[str, tuple] = field(default_factory=dict)

    def __post_init__(self):
        if self.data is None:
            self.data = np.zeros(self.total_bytes, dtype=np.int8)

    @property
    def total_bytes(self) -> int:
        return self.config.N * self.config.spm_kbytes * 1024

    # ---- allocator ------------------------------------------------------
    def alloc(self, name: str, length: int, elem_bytes: int = 4) -> int:
        """Bump allocator; returns the byte address. Alignment = SPM line
        (D banks x 4B) so vector ops start bank-aligned."""
        line = max(self.config.D * 4, 4)
        addr = (self._alloc_ptr + line - 1) // line * line
        nbytes = length * elem_bytes
        if addr + nbytes > self.total_bytes:
            raise SpmError(
                f"SPM overflow allocating {name!r}: {addr + nbytes} > "
                f"{self.total_bytes} (N={self.config.N} x "
                f"{self.config.spm_kbytes}KiB)")
        self._alloc_ptr = addr + nbytes
        self._allocs[name] = (addr, length, elem_bytes)
        return addr

    def addr_of(self, name: str) -> int:
        return self._allocs[name][0]

    def reset(self):
        self._alloc_ptr = 0
        self._allocs.clear()
        self.data[:] = 0

    # ---- typed views -----------------------------------------------------
    def read(self, addr: int, length: int, elem_bytes: int = 4) -> np.ndarray:
        dt = {1: np.int8, 2: np.int16, 4: np.int32}[elem_bytes]
        return self.data[addr:addr + length * elem_bytes].view(dt).copy()

    def write(self, addr: int, values: np.ndarray):
        raw = np.ascontiguousarray(values).reshape(-1).view(np.int8)
        if addr + raw.size > self.total_bytes:
            raise SpmError(f"SPM write out of range @{addr}+{raw.size}")
        self.data[addr:addr + raw.size] = raw
