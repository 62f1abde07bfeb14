"""Backend-neutral fusion-region planning.

The Klessydra speedups hinge on *chaining*: a run of element-wise vector
ops whose intermediates never round-trip through main memory (hardware:
SPM-resident operands feeding back-to-back FU passes; the torch backend:
one fused kernel launch with a per-thread slot file). This pass computes
it ONCE on the IR, as the reference's planner does, so the torch backend
runs each :class:`FusedRegion` as a single launch without re-deriving
the plan.

A region is a maximal run of element-wise instructions (``kvcp`` — pure
data movement — excluded) sharing one vector length and element width,
cut when a window would read a stale value or overlap pending writes
(the flush hazards of a region's gather/scatter), or when the slot-file bounds
``max_ops`` / ``max_inputs`` are hit. ``ScalarBlock`` items do not break
a region; any other instruction does.

The plan is attached as ``program.meta["fused_regions"]`` by the
:func:`fuse_regions` pass.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.kvi.ir import (ELEMWISE_OPS, KviInstr, KviOp, KviProgram,
                          ScalarBlock)

# one region-internal slot instruction: (op, dst_slot, src1, src2|None, imm)
SlotOp = Tuple[str, int, int, Optional[int], int]
# one operand window: (vreg id, element offset, length)
Key = Tuple[int, int, int]

MAX_FUSED_OPS = 64                    # slot-file pressure bounds
MAX_FUSED_INPUTS = 24

META_KEY = "fused_regions"


def _overlaps(a: Key, b: Key) -> bool:
    return (a[0] == b[0] and a != b
            and a[1] < b[1] + b[2] and b[1] < a[1] + a[2])


@dataclass(frozen=True)
class FusedRegion:
    """One maximal element-wise chain, ready for fused execution.

    items   — indices into ``program.items`` (ascending; non-contiguous
              only across ScalarBlock fillers).
    ops     — the slot program, in instruction order.
    inputs  — (window, slot) pairs gathered before the region runs.
    outputs — (window, slot) pairs written back after, in first-write
              order.
    """

    items: Tuple[int, ...]
    length: int
    elem_bytes: int
    ops: Tuple[SlotOp, ...]
    inputs: Tuple[Tuple[Key, int], ...]
    outputs: Tuple[Tuple[Key, int], ...]
    n_slots: int


@dataclass(frozen=True)
class FusionPlan:
    """All regions of one program plus the bounds they were planned
    under (backends re-plan if their slot-file bounds differ)."""

    regions: Tuple[FusedRegion, ...]
    max_ops: int = MAX_FUSED_OPS
    max_inputs: int = MAX_FUSED_INPUTS

    @property
    def n_fused_ops(self) -> int:
        return sum(len(r.ops) for r in self.regions)

    def member_items(self) -> frozenset:
        return frozenset(i for r in self.regions for i in r.items)


class _Builder:
    """Mutable accumulation state for one region being planned."""

    def __init__(self, length: int, elem_bytes: int):
        self.length = length
        self.elem_bytes = elem_bytes
        self.item_idx: List[int] = []
        self.ops: List[SlotOp] = []
        self.slot_of: Dict[Key, int] = {}
        self.gathered: List[Key] = []
        self.written: List[Key] = []

    def slot_for(self, key: Key, is_dst: bool,
                 max_inputs: int) -> Optional[int]:
        """Slot index for ``key``; None means the region must be cut
        first (window overlaps pending writes, or input file full)."""
        if (key not in self.written
                and any(_overlaps(key, w) for w in self.written)):
            # reads: the gathered window went stale; writes: two
            # overlapping written windows would write back in first-write
            # order — both hazards end the region here
            return None
        if key in self.slot_of:
            return self.slot_of[key]
        if not is_dst and len(self.gathered) >= max_inputs:
            return None
        s = len(self.slot_of)
        self.slot_of[key] = s
        if not is_dst:
            self.gathered.append(key)
        return s

    def finish(self) -> FusedRegion:
        return FusedRegion(
            items=tuple(self.item_idx),
            length=self.length, elem_bytes=self.elem_bytes,
            ops=tuple(self.ops),
            inputs=tuple((k, self.slot_of[k]) for k in self.gathered),
            outputs=tuple((k, self.slot_of[k]) for k in self.written),
            n_slots=len(self.slot_of))


def plan_fusion_regions(program: KviProgram,
                        max_ops: int = MAX_FUSED_OPS,
                        max_inputs: int = MAX_FUSED_INPUTS) -> FusionPlan:
    """Segment ``program`` into maximal fusable element-wise regions.

    Pure function of the instruction stream — structurally identical
    programs get identical plans, which is what lets batched backends
    share one plan per group.
    """
    regions: List[FusedRegion] = []
    seg: Optional[_Builder] = None

    def cut():
        nonlocal seg
        if seg is not None and seg.ops:
            regions.append(seg.finish())
        seg = None

    for idx, it in enumerate(program.items):
        if isinstance(it, ScalarBlock):
            continue                  # scalar work does not break a chain
        i: KviInstr = it
        if i.op not in ELEMWISE_OPS or i.op is KviOp.KVCP:
            cut()                     # data movement / reductions end it
            continue
        if seg is not None and (seg.length != i.length
                                or seg.elem_bytes != i.elem_bytes
                                or len(seg.ops) >= max_ops):
            cut()
        while True:
            if seg is None:
                seg = _Builder(i.length, i.elem_bytes)
            slots = []
            ok = True
            for ref, is_dst in ((i.src1, False), (i.src2, False),
                                (i.dst, True)):
                if ref is None:
                    slots.append(None)
                    continue
                s = seg.slot_for((ref.id, ref.offset, i.length), is_dst,
                                 max_inputs)
                if s is None:
                    ok = False
                    break
                slots.append(s)
            if ok:
                break
            cut()
        s1, s2, d = slots
        seg.ops.append((i.op.value, d, s1, s2, i.scalar))
        seg.item_idx.append(idx)
        dkey = (i.dst.id, i.dst.offset, i.length)
        if dkey not in seg.written:
            seg.written.append(dkey)
    cut()
    return FusionPlan(tuple(regions), max_ops, max_inputs)


def fuse_regions(program: KviProgram) -> KviProgram:
    """The pipeline pass: attach the fusion plan as program metadata."""
    plan = plan_fusion_regions(program)
    if not plan.regions:
        return program
    return program.with_meta(**{META_KEY: plan})
