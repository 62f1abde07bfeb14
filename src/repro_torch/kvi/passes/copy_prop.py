"""Copy propagation over whole-register ``kvcp`` moves.

After ``kvcp d, s`` where both windows cover their full registers (same
length, same element width), later reads of ``d`` are redirected to the
equivalent window of ``s`` — until either register is written again.
Chains resolve transitively (``kvcp b, a; kvcp c, b`` makes reads of
``c`` read ``a``). Identity copies left behind by the substitution are
dropped outright; copies whose destination is never read again become
dead and fall to the ``dce`` pass.

This matters beyond cycle counts: a ``kvcp`` is data movement, so it
BREAKS an element-wise fusion region (on the torch backend it forces a
segment flush — an extra kernel launch and a device copy; on the
hardware model an extra SPM copy). Removing the move lets the fusion
planner weld the two halves into one region.

Partial-window copies (e.g. the FFT bit-reversal's single-element moves)
are left untouched — only their *source* operands get substituted.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.kvi.ir import KviInstr, KviOp, KviProgram, Ref, ScalarBlock


def _is_full(program: KviProgram, ref: Ref, length: int) -> bool:
    return (ref is not None and ref.space == "vreg" and ref.offset == 0
            and length == program.vreg_by_id(ref.id).length)


def copy_prop(program: KviProgram) -> KviProgram:
    copies: Dict[int, int] = {}       # dst vreg id -> equivalent src id
    items = []
    changed = False

    def sub(ref: Optional[Ref]) -> Optional[Ref]:
        nonlocal changed
        if (ref is not None and ref.space == "vreg"
                and ref.id in copies):
            changed = True
            return Ref("vreg", copies[ref.id], ref.offset)
        return ref

    def invalidate(rid: int):
        copies.pop(rid, None)
        for d in [d for d, s in copies.items() if s == rid]:
            del copies[d]

    for it in program.items:
        if isinstance(it, ScalarBlock):
            items.append(it)
            continue
        src1, src2 = sub(it.src1), sub(it.src2)
        if it.op is KviOp.KMEMSTR:     # dst is a memory buffer, no reg def
            items.append(it if src1 is it.src1 else
                         KviInstr(it.op, it.dst, src1, src2, it.scalar,
                                  it.length, it.elem_bytes))
            continue
        if (it.op is KviOp.KVCP and _is_full(program, it.dst, it.length)
                and _is_full(program, src1, it.length)
                and program.vreg_by_id(it.dst.id).elem_bytes
                == program.vreg_by_id(src1.id).elem_bytes):
            if src1.id == it.dst.id:   # identity move — drop it
                changed = True
                continue
            invalidate(it.dst.id)
            copies[it.dst.id] = src1.id
            items.append(it if src1 is it.src1 else
                         KviInstr(it.op, it.dst, src1, None, it.scalar,
                                  it.length, it.elem_bytes))
            continue
        # any other definition of dst ends equivalences through it
        invalidate(it.dst.id)
        if src1 is it.src1 and src2 is it.src2:
            items.append(it)
        else:
            items.append(KviInstr(it.op, it.dst, src1, src2, it.scalar,
                                  it.length, it.elem_bytes))
    if not changed:
        return program
    from repro_torch.kvi.passes.dce import _drop_stale_plan
    return program.replace(items=tuple(items),
                           meta=_drop_stale_plan(program.meta))
