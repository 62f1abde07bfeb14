"""Structural verification of a :class:`~repro_torch.kvi.ir.KviProgram`.

:func:`verify_program` checks a program **without executing it**: every
operand window against its register's declared length, every element
width against its operands, every memory transfer against its buffer,
def-before-use at element granularity, declared outputs actually
written, and the registry invariants (unique names, position-consistent
ids) the id-indexed lookups rely on. It deliberately re-checks
conditions the builders already enforce — the verifier is the sanitizer
for programs that arrive from *outside* the builders (future serving /
model-lowering frontends, hand-built IR, buggy passes) and trusts
nothing.

Findings are :class:`~repro_torch.kvi.analysis.diagnostics.Diagnostic`
records with stable ``KVI1xx`` codes; see ``diagnostics.CODES``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.kvi.analysis.diagnostics import DiagnosticReport
from repro_torch.kvi.ir import (ELEMWISE_OPS, MEM_OPS, REDUCTION_OPS,
                          TWO_SOURCE_OPS, KviInstr, KviOp, KviProgram,
                          Ref, ScalarBlock, np_dtype)

_VALID_ELEM_BYTES = (1, 2, 4)


def instr_effects(program: KviProgram, instr: KviInstr
                  ) -> Tuple[List[Tuple[Ref, int]], List[Tuple[Ref, int]]]:
    """(reads, writes) as lists of ``(ref, element extent)`` — the exact
    windows an instruction touches under MFU semantics:

      * ``kmemld`` writes the WHOLE source buffer's extent into the
        destination window (the MFU transfers complete buffers),
      * reductions write a single element (the register-file result
        spilled to the dst view),
      * everything else reads/writes ``instr.length`` elements.

    Shared by the verifier, the dependence graph and the fusion audit,
    so every analysis agrees on what an instruction touches. Operands
    whose refs are malformed (wrong space, dangling id) are skipped —
    the verifier reports those separately.
    """
    reads: List[Tuple[Ref, int]] = []
    writes: List[Tuple[Ref, int]] = []
    op = instr.op
    if op is KviOp.KMEMLD:
        width = instr.length
        src = instr.src1
        if (isinstance(src, Ref) and src.space == "mem"
                and 0 <= src.id < len(program.mems)):
            width = program.mem_by_id(src.id).length
        if isinstance(instr.dst, Ref) and instr.dst.space == "vreg":
            writes.append((instr.dst, width))
        return reads, writes
    if op is KviOp.KMEMSTR:
        if isinstance(instr.src1, Ref) and instr.src1.space == "vreg":
            reads.append((instr.src1, instr.length))
        return reads, writes
    for src in (instr.src1, instr.src2):
        if isinstance(src, Ref) and src.space == "vreg":
            reads.append((src, instr.length))
    if isinstance(instr.dst, Ref) and instr.dst.space == "vreg":
        writes.append((instr.dst, 1 if op in REDUCTION_OPS
                       else instr.length))
    return reads, writes


def _check_registries(program: KviProgram, rep: DiagnosticReport) -> None:
    """Unique names + position-consistent ids for vregs and mems."""
    for kind, seq in (("vreg", program.vregs), ("mem", program.mems)):
        seen: Dict[str, int] = {}
        for idx, r in enumerate(seq):
            if r.name in seen:
                rep.add("KVI111",
                        f"{kind} name {r.name!r} declared at positions "
                        f"{seen[r.name]} and {idx}",
                        program.name, subject=f"{kind}:{r.name}")
            else:
                seen[r.name] = idx
            if r.id != idx:
                rep.add("KVI112",
                        f"{kind} {r.name!r} has id {r.id} at position "
                        f"{idx}; id-indexed lookups would alias",
                        program.name, subject=f"{kind}:{r.name}")
            if r.elem_bytes not in _VALID_ELEM_BYTES:
                rep.add("KVI114",
                        f"{kind} {r.name!r} has elem_bytes "
                        f"{r.elem_bytes}; must be 1/2/4",
                        program.name, subject=f"{kind}:{r.name}")
            if r.length <= 0:
                rep.add("KVI102",
                        f"{kind} {r.name!r} has degenerate length "
                        f"{r.length}",
                        program.name, subject=f"{kind}:{r.name}")


def _check_mem_init(program: KviProgram, rep: DiagnosticReport) -> None:
    for m in program.mems:
        arr = program.mem_init.get(m.id)
        if arr is None:
            rep.add("KVI108",
                    f"buffer {m.name!r} has no mem_init entry",
                    program.name, subject=f"mem:{m.name}")
            continue
        if int(np.size(arr)) != m.length:
            rep.add("KVI108",
                    f"buffer {m.name!r} declares {m.length} elements but "
                    f"mem_init holds {int(np.size(arr))}",
                    program.name, subject=f"mem:{m.name}")
        if (m.elem_bytes in _VALID_ELEM_BYTES
                and np.asarray(arr).dtype != np_dtype(m.elem_bytes)):
            rep.add("KVI108",
                    f"buffer {m.name!r} declares elem_bytes "
                    f"{m.elem_bytes} but mem_init dtype is "
                    f"{np.asarray(arr).dtype}",
                    program.name, subject=f"mem:{m.name}")


def _operand_roles(op: KviOp):
    """(role, expected space, required) triples for one opcode."""
    if op is KviOp.KMEMLD:
        return (("dst", "vreg", True), ("src1", "mem", True),
                ("src2", None, False))
    if op is KviOp.KMEMSTR:
        return (("dst", "mem", True), ("src1", "vreg", True),
                ("src2", None, False))
    return (("dst", "vreg", True), ("src1", "vreg", True),
            ("src2", "vreg", op in TWO_SOURCE_OPS))


def _resolve(program: KviProgram, ref: Ref):
    """The VReg/MemRef a ref names, or None when the id dangles."""
    pool = program.vregs if ref.space == "vreg" else program.mems
    if 0 <= ref.id < len(pool):
        return pool[ref.id]
    return None


def verify_program(program: KviProgram) -> DiagnosticReport:
    """Run every structural check; returns the (possibly empty) report."""
    rep = DiagnosticReport()
    _check_registries(program, rep)
    _check_mem_init(program, rep)

    # defined-element tracking for use-before-def (KVI109): element
    # granularity, so per-element writers like the FFT's bit-reversal
    # kvcp loop are recognized as covering their register
    defined: Dict[int, np.ndarray] = {
        r.id: np.zeros(max(r.length, 1), dtype=bool)
        for r in program.vregs}
    warned_uninit: set = set()
    stored_mems: set = set()

    for idx, it in enumerate(program.items):
        if isinstance(it, ScalarBlock):
            if it.count <= 0:
                rep.add("KVI102",
                        f"scalar block with degenerate count {it.count}",
                        program.name, item=idx, subject=f"item{idx}")
            continue
        if not isinstance(it, KviInstr):
            rep.add("KVI101",
                    f"item of unknown type {type(it).__name__}",
                    program.name, item=idx, subject=f"item{idx}")
            continue
        op = it.op
        opname = op.value if isinstance(op, KviOp) else repr(op)
        if (not isinstance(op, KviOp)
                or op not in MEM_OPS | REDUCTION_OPS | ELEMWISE_OPS):
            rep.add("KVI101", f"unknown/unclassified op {opname!r}",
                    program.name, item=idx, op=opname,
                    subject=f"item{idx}")
            continue
        if it.length <= 0:
            rep.add("KVI102", f"instruction length {it.length} <= 0",
                    program.name, item=idx, op=opname,
                    subject=f"item{idx}")
            continue
        if it.elem_bytes not in _VALID_ELEM_BYTES:
            rep.add("KVI114",
                    f"instruction elem_bytes {it.elem_bytes}; must be "
                    f"1/2/4", program.name, item=idx, op=opname,
                    subject=f"item{idx}")

        # operand presence / space / id resolution
        operands: Dict[str, Optional[Ref]] = {
            "dst": it.dst, "src1": it.src1, "src2": it.src2}
        bad_ref = False
        for role, space, required in _operand_roles(op):
            ref = operands[role]
            if ref is None:
                if required:
                    rep.add("KVI100",
                            f"{opname} requires a {role} operand",
                            program.name, item=idx, op=opname,
                            subject=f"item{idx}:{role}")
                    bad_ref = True
                continue
            if space is None:
                continue              # tolerated extra operand
            if ref.space != space:
                rep.add("KVI104",
                        f"{opname} {role} must be a {space} reference, "
                        f"got {ref.space!r}",
                        program.name, item=idx, op=opname,
                        subject=f"item{idx}:{role}")
                bad_ref = True
                continue
            if _resolve(program, ref) is None:
                rep.add("KVI103",
                        f"{opname} {role} references {ref.space} "
                        f"#{ref.id}, but the program declares only "
                        f"{len(program.vregs) if ref.space == 'vreg' else len(program.mems)}",
                        program.name, item=idx, op=opname,
                        subject=f"item{idx}:{role}")
                bad_ref = True
        if bad_ref:
            continue

        # elem_bytes agreement across instruction + every operand
        for role in ("dst", "src1", "src2"):
            ref = operands[role]
            if ref is None:
                continue
            tgt = _resolve(program, ref)
            if tgt is not None and tgt.elem_bytes != it.elem_bytes:
                rep.add("KVI106",
                        f"{opname} {role} ({'vreg' if ref.space == 'vreg' else 'buffer'} "
                        f"{tgt.name!r}, elem_bytes {tgt.elem_bytes}) "
                        f"disagrees with instruction elem_bytes "
                        f"{it.elem_bytes}",
                        program.name, item=idx, op=opname,
                        subject=f"item{idx}:{role}")

        # memory transfer extents vs. the buffer; the MFU transfers
        # whole buffers, so a nonzero mem-operand offset is silently
        # ignored by every backend — flag it (KVI113)
        for role in ("dst", "src1", "src2"):
            ref = operands[role]
            if ref is not None and ref.space == "mem" and ref.offset != 0:
                rep.add("KVI113",
                        f"{opname} {role} carries offset {ref.offset} "
                        f"into buffer "
                        f"{_resolve(program, ref).name!r}, which the "
                        f"MFU ignores (whole-buffer transfers)",
                        program.name, item=idx, op=opname,
                        subject=f"item{idx}:{role}")
        if op is KviOp.KMEMLD:
            mem = _resolve(program, it.src1)
            if it.length != mem.length:
                rep.add("KVI107",
                        f"kmemld declares {it.length} elements but the "
                        f"MFU transfers buffer {mem.name!r} whole "
                        f"({mem.length} elements)",
                        program.name, item=idx, op=opname,
                        subject=f"item{idx}:src1")
        elif op is KviOp.KMEMSTR:
            mem = _resolve(program, it.dst)
            if it.length > mem.length:
                rep.add("KVI107",
                        f"kmemstr of {it.length} elements overruns "
                        f"buffer {mem.name!r} ({mem.length} elements)",
                        program.name, item=idx, op=opname,
                        subject=f"item{idx}:dst")
            stored_mems.add(it.dst.id)

        # window bounds + use-before-def over the touched extents
        reads, writes = instr_effects(program, it)
        for ref, width in reads + writes:
            reg = _resolve(program, ref)
            if ref.offset < 0 or ref.offset + width > reg.length:
                rep.add("KVI105",
                        f"{opname} window "
                        f"[{ref.offset}:{ref.offset + width}) outside "
                        f"vreg {reg.name!r} of length {reg.length}",
                        program.name, item=idx, op=opname,
                        subject=f"item{idx}:vreg:{reg.name}")
        for ref, width in reads:
            reg = _resolve(program, ref)
            lo = max(ref.offset, 0)
            hi = min(ref.offset + width, reg.length)
            if (hi > lo and not defined[ref.id][lo:hi].all()
                    and (idx, ref.id) not in warned_uninit):
                first = lo + int(np.argmin(defined[ref.id][lo:hi]))
                rep.add("KVI109",
                        f"{opname} reads vreg {reg.name!r} element "
                        f"{first} before any write (reads as zero)",
                        program.name, item=idx, op=opname,
                        subject=f"item{idx}:vreg:{reg.name}")
                warned_uninit.add((idx, ref.id))
        for ref, width in writes:
            reg = _resolve(program, ref)
            lo = max(ref.offset, 0)
            hi = min(ref.offset + width, reg.length)
            if hi > lo:
                defined[ref.id][lo:hi] = True

    # declared outputs must be produced by some store
    for m in program.outputs:
        if m.id not in stored_mems:
            rep.add("KVI110",
                    f"output buffer {m.name!r} is never written by any "
                    f"kmemstr", program.name, subject=f"mem:{m.name}")
    return rep
