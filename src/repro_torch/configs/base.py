"""Configuration dataclasses (the port's copy of ``repro.configs.base``,
as far as the port uses it): ``KlessydraConfig``, the paper's coprocessor
taxonomy (M, F, D, N) used by the cycle model in ``repro_torch.core``, the
KVI lowering and the serving engine. The reference's LM framework
configs (``ModelConfig``, ``ShapeConfig``, ``Parallelism``, ``ArchSpec``,
``SHAPES``) are not copied yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


# ---------------------------------------------------------------------------
# Klessydra (paper) configs
# ---------------------------------------------------------------------------

# Internal MFU functional units (contended individually by the
# heterogeneous-MIMD scheme; see repro_torch.core.isa.Unit — kept as string
# literals here so configs stay import-light).
MFU_UNITS = ("adder", "multiplier", "shifter", "cmp", "move")


def _is_pow2(x: int) -> bool:
    return x >= 1 and (x & (x - 1)) == 0


@dataclass(frozen=True)
class KlessydraConfig:
    """The paper's coprocessor design space: SPMI count M, MFU count F,
    lanes D, SPMs N, plus SPM capacity and hart count.

    Degenerate combinations are rejected at construction time (M < 1,
    F > M, non-power-of-two D, zero-byte SPMs, ...) with a ``ValueError``
    naming the offending field — the design-space sweeps rely on this
    being the single validation point.
    """

    name: str
    M: int = 1                       # number of SPM interfaces
    F: int = 1                       # number of MFUs
    D: int = 1                       # lanes per MFU (= SPM banks)
    N: int = 4                       # number of SPMs per SPMI
    harts: int = 3                   # IMT hardware threads
    spm_kbytes: int = 4              # capacity of each SPM (KiB)
    elem_bytes: int = 4              # 32-bit fixed point (paper default)
    mem_port_bytes: int = 4          # 32-bit main-memory port
    vector_setup_cycles: int = 5     # "initial latency between 4 and 8 cycles"
    mem_latency_cycles: int = 2      # main memory access latency
    # Narrowest SIMD lane the MFU datapath can split a 32-bit bank into:
    # 8 => full sub-word SIMD (4x8-bit or 2x16-bit per bank, the paper's
    # sub-word extension and the simulator's historical behavior);
    # 32 => no sub-word hardware (narrow elements stream one per lane).
    subword_bits: int = 8
    # Per-internal-unit FU replication inside each MFU, as ("unit", count)
    # overrides, e.g. (("multiplier", 2),). Units not listed have one
    # instance. Only the heterogeneous-MIMD scheme (shared MFU contended
    # per internal unit) can exploit counts > 1.
    fu_counts: Tuple[Tuple[str, int], ...] = ()

    def __post_init__(self):
        def bad(fieldname: str, why: str):
            raise ValueError(
                f"KlessydraConfig({self.name!r}): field {fieldname!r} "
                f"{why}")
        if self.M < 1:
            bad("M", f"must be >= 1 SPM interface, got {self.M}")
        if self.F < 1:
            bad("F", f"must be >= 1 MFU, got {self.F}")
        if self.F > self.M:
            bad("F", f"cannot exceed M (more MFUs than SPM interfaces "
                     f"to feed them), got F={self.F} > M={self.M}")
        if not _is_pow2(self.D):
            bad("D", f"must be a power of two >= 1 (SPM bank count), "
                     f"got {self.D}")
        if self.N < 1:
            bad("N", f"must be >= 1 SPM per interface, got {self.N}")
        if self.harts < 1:
            bad("harts", f"must be >= 1, got {self.harts}")
        if self.spm_kbytes < 1:
            bad("spm_kbytes", f"must be >= 1 KiB (a zero-byte SPM can "
                              f"hold no vector), got {self.spm_kbytes}")
        if self.elem_bytes not in (1, 2, 4):
            bad("elem_bytes", f"must be 1, 2 or 4, got {self.elem_bytes}")
        if self.mem_port_bytes < 1:
            bad("mem_port_bytes", f"must be >= 1, got {self.mem_port_bytes}")
        if self.vector_setup_cycles < 0:
            bad("vector_setup_cycles",
                f"must be >= 0, got {self.vector_setup_cycles}")
        if self.mem_latency_cycles < 0:
            bad("mem_latency_cycles",
                f"must be >= 0, got {self.mem_latency_cycles}")
        if self.subword_bits not in (8, 16, 32):
            bad("subword_bits", f"must be 8, 16 or 32, got "
                                f"{self.subword_bits}")
        seen = set()
        for entry in self.fu_counts:
            if (not isinstance(entry, tuple)) or len(entry) != 2:
                bad("fu_counts", f"entries must be (unit, count) pairs, "
                                 f"got {entry!r}")
            unit, count = entry
            if unit not in MFU_UNITS:
                bad("fu_counts", f"unknown MFU unit {unit!r} "
                                 f"(valid: {MFU_UNITS})")
            if unit in seen:
                bad("fu_counts", f"duplicate unit {unit!r}")
            seen.add(unit)
            if not isinstance(count, int) or count < 1:
                bad("fu_counts", f"count for {unit!r} must be an int >= 1, "
                                 f"got {count!r}")

    def fu_count(self, unit: str) -> int:
        """How many instances of one internal functional unit each MFU
        carries (1 unless overridden in ``fu_counts``)."""
        for u, c in self.fu_counts:
            if u == unit:
                return c
        return 1

    @property
    def spm_capacity_bytes(self) -> int:
        """Unified SPM address space per interface: N SPMs of spm_kbytes."""
        return self.N * self.spm_kbytes * 1024

    @property
    def scheme(self) -> str:
        if self.M == 1 and self.F == 1:
            return "SISD" if self.D == 1 else f"SIMD"
        if self.M > 1 and self.F == self.M:
            return "SymMIMD" if self.D == 1 else "SymMIMD+SIMD"
        if self.M > 1 and self.F == 1:
            return "HetMIMD" if self.D == 1 else "HetMIMD+SIMD"
        return "custom"

    def replace(self, **kw) -> "KlessydraConfig":
        return dataclasses.replace(self, **kw)


def klessydra_taxonomy() -> dict:
    """The exact configuration sweep of the paper's Table 2."""
    out = {}
    for D in (1, 2, 4, 8):
        out[f"sisd" if D == 1 else f"simd_d{D}"] = KlessydraConfig(
            name="SISD" if D == 1 else f"SIMD D={D}", M=1, F=1, D=D)
        out[f"sym_mimd_d{D}" if D > 1 else "sym_mimd"] = KlessydraConfig(
            name=f"Sym MIMD D={D}", M=3, F=3, D=D)
        out[f"het_mimd_d{D}" if D > 1 else "het_mimd"] = KlessydraConfig(
            name=f"Het MIMD D={D}", M=3, F=1, D=D)
    return out
