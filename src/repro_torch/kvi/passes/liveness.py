"""Per-program liveness analysis over virtual vector registers.

Granularity is the whole vreg: a read of any window makes the register
live, and only a write covering the full register kills it. That is
conservative for partial writes (the untouched elements survive), which
is exactly what the downstream consumers need:

  * :func:`observable_items` — backward may-observe analysis feeding the
    ``dce`` pass (an instruction is dead when nothing it writes can reach
    an output buffer),
  * :func:`reg_intervals` — first-touch/last-touch live ranges feeding
    the linear-scan SPM allocator of :mod:`repro_torch.kvi.lowering`
    (two vregs with disjoint ranges may share scratchpad lines),
  * :func:`peak_live_bytes` — the allocator's true capacity requirement,
    reported by ``SpmOverflowError``.

Memory buffers are tracked alongside: a ``kmemstr`` is observable when
its target buffer is a program output *or* is loaded again later; a
``kmemld`` keeps its source buffer live.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.kvi.ir import (REDUCTION_OPS, KviInstr, KviOp, KviProgram,
                          ScalarBlock)


def _kmemld_width(program: KviProgram, instr: KviInstr) -> int:
    """Elements a ``kmemld`` writes: the MFU transfers exactly the WHOLE
    buffer into the destination window, independent of the instruction's
    declared ``length`` (see ``Mfu.execute`` / ``KviProgramBuilder.
    kmemld``, which rejects lengths overstating the buffer)."""
    return program.mem_by_id(instr.src1.id).length


def _is_full_def(program: KviProgram, instr: KviInstr) -> bool:
    """True when ``instr`` overwrites every element of its dst vreg."""
    reg = program.vreg_by_id(instr.dst.id)
    if instr.op is KviOp.KMEMLD:
        width = _kmemld_width(program, instr)
    elif instr.op in REDUCTION_OPS:
        width = 1                     # register-file result, one element
    else:
        width = instr.length
    return instr.dst.offset == 0 and width >= reg.length


def observable_items(program: KviProgram) -> List[bool]:
    """Per-item flag: can this item's effect reach an output buffer?

    Backward walk. ``ScalarBlock`` items are always observable (they
    model scalar work the timing backends must keep). ``kmemstr`` to a
    buffer that is neither an output nor re-loaded later is dead; a full
    re-store of a buffer kills earlier stores to it.
    """
    items = program.items
    live = [True] * len(items)
    live_regs: set = set()
    live_mems = {m.id for m in program.mems if m.is_output}
    for idx in range(len(items) - 1, -1, -1):
        it = items[idx]
        if isinstance(it, ScalarBlock):
            continue
        op = it.op
        if op is KviOp.KMEMSTR:
            mid = it.dst.id
            if mid not in live_mems:
                live[idx] = False
                continue
            if it.length >= program.mem_by_id(mid).length:
                live_mems.discard(mid)   # full overwrite kills older stores
            live_regs.add(it.src1.id)
            continue
        if op is KviOp.KMEMLD:
            if it.dst.id not in live_regs:
                live[idx] = False
                continue
            if _is_full_def(program, it):
                live_regs.discard(it.dst.id)
            live_mems.add(it.src1.id)
            continue
        # MFU op writing a vreg (element-wise or reduction-with-spill)
        if it.dst.id not in live_regs:
            live[idx] = False
            continue
        if _is_full_def(program, it):
            live_regs.discard(it.dst.id)
        live_regs.add(it.src1.id)
        if it.src2 is not None:
            live_regs.add(it.src2.id)
    return live


def reg_intervals(program: KviProgram,
                  pin_uninitialized: bool = False
                  ) -> Dict[int, Tuple[int, int]]:
    """vreg id -> (first touch, last touch) item indices, inclusive.
    Registers never referenced by any instruction are absent.

    With ``pin_uninitialized=True`` (what the SPM allocator uses), any
    register whose first touch is NOT a full-width definition — an
    uninitialized read, or a partial first write whose untouched elements
    may be read later — has its interval start pinned to item 0. Pinned
    registers can never inherit another register's recycled scratchpad
    lines, so their unwritten elements read as fresh zeros, exactly the
    pre-reuse semantics every backend agrees on."""
    iv: Dict[int, Tuple[int, int]] = {}
    pinned: set = set()

    def touch(rid: int, idx: int, full_def: bool):
        if rid not in iv:
            iv[rid] = (idx, idx)
            if not full_def:
                pinned.add(rid)
        else:
            s, e = iv[rid]
            iv[rid] = (min(s, idx), max(e, idx))

    for idx, it in enumerate(program.items):
        if not isinstance(it, KviInstr):
            continue
        # reads logically precede the write within one instruction
        for ref in (it.src1, it.src2):
            if ref is not None and ref.space == "vreg":
                touch(ref.id, idx, full_def=False)
        if it.dst is not None and it.dst.space == "vreg":
            touch(it.dst.id, idx, full_def=_is_full_def(program, it))
    if pin_uninitialized:
        for rid in pinned:
            iv[rid] = (0, iv[rid][1])
    return iv


def peak_live_bytes(program: KviProgram, align: int = 4,
                    pin_uninitialized: bool = False) -> int:
    """Maximum over all program points of the summed (alignment-padded)
    footprint of simultaneously live vregs — the smallest SPM that can
    hold the program under perfect register reuse."""
    iv = reg_intervals(program, pin_uninitialized)
    deltas: Dict[int, int] = {}
    for rid, (s, e) in iv.items():
        r = program.vreg_by_id(rid)
        size = -(-r.length * r.elem_bytes // align) * align
        deltas[s] = deltas.get(s, 0) + size
        deltas[e + 1] = deltas.get(e + 1, 0) - size
    peak = cur = 0
    for idx in sorted(deltas):
        cur += deltas[idx]
        peak = max(peak, cur)
    return peak


def total_vreg_bytes(program: KviProgram, align: int = 4) -> int:
    """Alignment-padded footprint of ALL declared vregs — what the old
    bump allocator needed."""
    return sum(-(-r.length * r.elem_bytes // align) * align
               for r in program.vregs)
