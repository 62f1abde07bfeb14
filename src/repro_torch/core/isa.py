"""The Klessydra-T custom vector instruction extension (paper Table 1);
the port's copy of ``repro.core.isa``.

Each instruction has:
  * functional semantics over SPM-resident int32 fixed-point vectors
    (executed by ``repro_torch.core.mfu``), and
  * a timing/contention class used by the cycle simulator:
      - ``unit``: which MFU internal functional unit it occupies
        (the heterogeneous-MIMD scheme contends on these individually), and
      - ``engine``: MFU vs LSU (LSU transfers overlap MFU compute).

Latency model (paper: "latency proportional to the vector length", SPM line
= D banks per cycle, initial latency 4-8 cycles): setup + ceil(len/D) for
MFU ops; setup_mem + ceil(bytes/mem_port) for LSU ops.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Dict, Optional, Tuple

import numpy as np


class Unit(Enum):
    ADDER = "adder"
    MULTIPLIER = "multiplier"
    SHIFTER = "shifter"
    CMP = "cmp"
    MOVE = "move"
    LSU = "lsu"


@dataclass(frozen=True)
class OpDef:
    name: str
    unit: Unit
    engine: str            # "mfu" | "lsu"
    description: str


# paper Table 1, verbatim order
OPDEFS: Dict[str, OpDef] = {o.name: o for o in [
    OpDef("kmemld", Unit.LSU, "lsu", "load vector into scratchpad region"),
    OpDef("kmemstr", Unit.LSU, "lsu", "store vector into main memory"),
    OpDef("kaddv", Unit.ADDER, "mfu", "adds vectors in scratchpad region"),
    OpDef("ksubv", Unit.ADDER, "mfu", "subtract vectors in scratchpad region"),
    OpDef("kvmul", Unit.MULTIPLIER, "mfu", "multiply vectors in scratchpad"),
    OpDef("kvred", Unit.ADDER, "mfu", "reduce vector by addition"),
    OpDef("kdotp", Unit.MULTIPLIER, "mfu", "vector dot product into register"),
    OpDef("ksvaddsc", Unit.ADDER, "mfu", "add vector + scalar into scratchpad"),
    OpDef("ksvaddrf", Unit.ADDER, "mfu", "add vector + scalar into register"),
    OpDef("ksvmulsc", Unit.MULTIPLIER, "mfu",
          "multiply vector + scalar into scratchpad"),
    OpDef("ksvmulrf", Unit.MULTIPLIER, "mfu",
          "multiply vector + scalar into register"),
    OpDef("kdotpps", Unit.MULTIPLIER, "mfu",
          "vector dot product and post scaling"),
    OpDef("ksrlv", Unit.SHIFTER, "mfu", "vector logic shift within scratchpad"),
    OpDef("ksrav", Unit.SHIFTER, "mfu",
          "vector arithmetic shift within scratchpad"),
    OpDef("krelu", Unit.CMP, "mfu", "vector ReLu within scratchpad"),
    OpDef("kvslt", Unit.CMP, "mfu", "compare vectors and create mask vector"),
    OpDef("ksvslt", Unit.CMP, "mfu", "compare vector-scalar and create mask"),
    OpDef("kvcp", Unit.MOVE, "mfu", "copy vector within scratchpad region"),
]}


@dataclass
class Instr:
    """One dynamic KVI instruction instance.

    dst/src1/src2 are SPM addresses (byte offsets into the unified SPM
    address space) or None; ``scalar`` holds an immediate/register scalar
    operand; ``length`` is the element count (32-bit elements by default).
    """
    op: str
    dst: Optional[int] = None
    src1: Optional[int] = None
    src2: Optional[int] = None
    scalar: int = 0
    length: int = 0
    elem_bytes: int = 4

    def __post_init__(self):
        if self.op not in OPDEFS and self.op != "scalar":
            raise ValueError(f"unknown KVI op {self.op!r}")

    @property
    def unit(self) -> Unit:
        return OPDEFS[self.op].unit

    @property
    def engine(self) -> str:
        return OPDEFS[self.op].engine

    @property
    def bytes(self) -> int:
        return self.length * self.elem_bytes


@dataclass
class Scalar:
    """A compressed run of ``count`` scalar (non-coprocessor) instructions —
    loop bookkeeping, address arithmetic, branches. Each consumes one issue
    slot of its hart."""
    count: int

    op: str = "scalar"
    engine: str = "none"


def mfu_cycles(instr: Instr, D: int, setup: int,
               min_elem_bytes: int = 1) -> Tuple[int, int]:
    """(unit_cycles, spmi_cycles) for one vector op.

    * SPMI streaming: one SPM line (D banks) per cycle PER VECTOR SOURCE —
      each SPM has a single read port, so two-source ops (kaddv, kvmul,
      kdotp, ...) stream two lines per result line. The paper's own D-sweep
      implies this: conv32 cycle deltas between D=1/2/4/8 are ~1.6x the
      single-pass prediction and fit the two-pass model within ~5%.
    * Functional unit occupancy: one line per cycle (the adder/multiplier
      pipelines are line-rate) — this is why heterogeneous MIMD (shared
      units, per-hart SPMIs) stays within 1-7% of symmetric MIMD in the
      paper: the SPMI streaming, not the unit, is the real bottleneck.

    Sub-word SIMD: 8/16-bit elements pack more lanes per 32-bit bank —
    but only down to the hardware's narrowest supported lane width
    (``min_elem_bytes`` = config.subword_bits/8). A datapath without
    sub-word lanes (min_elem_bytes=4) streams narrow elements one per
    bank, getting no packing benefit."""
    eff_eb = max(instr.elem_bytes, min_elem_bytes)
    lanes = D * max(1, 4 // eff_eb)
    n_src = max(int(instr.src1 is not None) + int(instr.src2 is not None), 1)
    lines = int(np.ceil(instr.length / max(lanes, 1)))
    return setup + lines, setup + n_src * lines


def lsu_cycles(instr: Instr, mem_port_bytes: int, setup: int) -> int:
    """Main-memory transfer: 32-bit port, one word per cycle."""
    return setup + int(np.ceil(instr.bytes / mem_port_bytes))
