"""Dead-code elimination: drop never-observed instructions and the vregs
nothing references afterwards.

An instruction is observed when a value it writes can reach an output
buffer (:func:`~repro_torch.kvi.passes.liveness.observable_items`). Dropping a
dead instruction can strand a vreg entirely; stranded vregs are removed
and the survivors renumbered (declaration order preserved), with every
``Ref`` remapped. ``ScalarBlock`` items always survive — they model
scalar work the cycle backends charge for.

Semantics-preserving by construction: output buffers see the exact same
writes. Beyond dropping work, DCE shrinks the liveness footprint the SPM
allocator packs, so it can *unlock* programs near the scratchpad
capacity limit.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kvi.ir import (KviInstr, KviProgram, Ref, ScalarBlock, VReg)
from repro_torch.kvi.passes.liveness import observable_items


def _drop_stale_plan(meta: dict) -> dict:
    """A rewritten instruction stream invalidates any attached fusion
    plan (item indices shift, vreg ids remap) — strip it; a later
    ``fuse_regions`` re-plans on the new stream."""
    from repro_torch.kvi.passes.fusion import META_KEY
    return {k: v for k, v in meta.items() if k != META_KEY}


def dce(program: KviProgram) -> KviProgram:
    live = observable_items(program)
    items = [it for it, keep in zip(program.items, live) if keep]

    referenced = set()
    for it in items:
        if isinstance(it, KviInstr):
            for ref in (it.dst, it.src1, it.src2):
                if ref is not None and ref.space == "vreg":
                    referenced.add(ref.id)

    if all(live) and len(referenced) == len(program.vregs):
        return program                # nothing to do: keep identity

    keep_regs = [r for r in program.vregs if r.id in referenced]
    remap = {r.id: i for i, r in enumerate(keep_regs)}
    vregs = tuple(VReg(r.name, remap[r.id], r.length, r.elem_bytes)
                  for r in keep_regs)

    def sub(ref: Optional[Ref]) -> Optional[Ref]:
        if ref is None or ref.space != "vreg":
            return ref
        return Ref("vreg", remap[ref.id], ref.offset)

    new_items = []
    for it in items:
        if isinstance(it, ScalarBlock):
            new_items.append(it)
        else:
            new_items.append(KviInstr(it.op, sub(it.dst), sub(it.src1),
                                      sub(it.src2), it.scalar, it.length,
                                      it.elem_bytes))
    return program.replace(items=tuple(new_items), vregs=vregs,
                           meta=_drop_stale_plan(program.meta))
