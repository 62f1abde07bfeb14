"""Hazard and resource analysis over KVI programs and workloads.

Four analyses, all static (no backend ever runs):

  * :func:`dependence_graph` — RAW/WAR/WAW edges between instructions,
    at vreg-*window* granularity (two writes to disjoint halves of one
    register are independent; overlapping windows are not). This is the
    paper's SPM interlock discipline lifted to the IR.
  * :func:`audit_fusion_plan` — legality of a planned
    :class:`~repro_torch.kvi.passes.fusion.FusionPlan`: regions may weld only
    element-wise ops of one (length, elem_bytes), must respect the
    stale-read / overlapping-write-back hazards the planner cuts on,
    and must fit their declared slot-file bounds.
  * :func:`spm_pressure` — the static scratchpad requirement of a
    program on one machine configuration: peak-live bytes under the
    exact liveness + alignment rules the linear-scan allocator uses, so
    an over-capacity program is reported (``KVI301``) *before* lowering
    raises :class:`~repro_torch.kvi.lowering.SpmOverflowError`.
  * :func:`check_workload` — cross-hart races: two structurally
    different programs on different harts writing the same logical
    buffer under the shared scheme. MemRefs are program-local, so the
    logical identity of a buffer across programs is its
    ``(name, length, elem_bytes)`` signature — the convention external
    frontends use for shared tensors. Data instances of one program
    structure are exempt: the workload model gives each entry its own
    output slot (``dedup_entry_outputs`` / the Pallas batch grid), so
    same-named outputs across a homogeneous batch are per-instance by
    construction.

:func:`analyze_program` / :func:`analyze_workload` bundle the
structural verifier with these checks — the entry points the CLI, the
pass pipeline and the backend ``verify=`` gates call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.configs.base import KlessydraConfig
from repro_torch.kvi.analysis.diagnostics import DiagnosticReport
from repro_torch.kvi.analysis.verifier import instr_effects, verify_program
from repro_torch.kvi.ir import (ELEMWISE_OPS, KviInstr, KviOp, KviProgram,
                          ScalarBlock)
from repro_torch.kvi.passes.fusion import META_KEY, FusionPlan
from repro_torch.kvi.passes.liveness import peak_live_bytes

#: one vreg window: (vreg id, element offset, element extent)
Window = Tuple[int, int, int]


def windows_overlap(a: Window, b: Window) -> bool:
    """Do two (vreg, offset, extent) windows touch common elements?"""
    return (a[0] == b[0]
            and a[1] < b[1] + b[2] and b[1] < a[1] + a[2])


@dataclass(frozen=True)
class DepEdge:
    """One dependence between two instructions (item indices)."""

    src: int                          # earlier instruction
    dst: int                          # later, dependent instruction
    kind: str                         # "RAW" | "WAR" | "WAW"
    reg: int                          # vreg id the windows live in
    src_window: Window
    dst_window: Window


@dataclass(frozen=True)
class DependenceGraph:
    """All window-granular dependences of one program."""

    edges: Tuple[DepEdge, ...]

    def by_kind(self, kind: str) -> Tuple[DepEdge, ...]:
        return tuple(e for e in self.edges if e.kind == kind)

    @property
    def counts(self) -> Dict[str, int]:
        out = {"RAW": 0, "WAR": 0, "WAW": 0}
        for e in self.edges:
            out[e.kind] += 1
        return out

    def predecessors(self, item: int) -> Tuple[int, ...]:
        return tuple(sorted({e.src for e in self.edges
                             if e.dst == item}))


def _covers(a: Window, b: Window) -> bool:
    """Window ``a`` fully contains window ``b`` (same vreg)."""
    return (a[0] == b[0] and a[1] <= b[1]
            and a[1] + a[2] >= b[1] + b[2])


def dependence_graph(program: KviProgram) -> DependenceGraph:
    """RAW/WAR/WAW edges over vreg windows — the *immediate*
    dependences: a write kills every history entry it fully covers, so
    each edge links an access to the latest frontier access it
    conflicts with. Any access ordered before a killed entry is ordered
    before the covering write too, so the full dependence order is the
    transitive closure of these edges — same ordering constraints,
    near-linear size (the exhaustive all-pairs graph is quadratic on
    in-place update chains like the FFT butterflies).
    """
    edges: List[DepEdge] = []
    # per vreg, the frontier in chronological order, split by kind so a
    # read never scans the (conflict-free) read history
    past_reads: Dict[int, List[Tuple[int, Window]]] = {}
    past_writes: Dict[int, List[Tuple[int, Window]]] = {}

    def scan(hist, win, idx, kind):
        for prev_idx, prev_win in hist:
            if prev_idx != idx and windows_overlap(win, prev_win):
                edges.append(DepEdge(prev_idx, idx, kind, win[0],
                                     prev_win, win))

    for idx, it in enumerate(program.items):
        if not isinstance(it, KviInstr):
            continue
        reads, writes = instr_effects(program, it)
        for ref, width in reads:
            win: Window = (ref.id, ref.offset, width)
            scan(past_writes.get(ref.id, ()), win, idx, "RAW")
            past_reads.setdefault(ref.id, []).append((idx, win))
        for ref, width in writes:
            win = (ref.id, ref.offset, width)
            scan(past_writes.get(ref.id, ()), win, idx, "WAW")
            scan(past_reads.get(ref.id, ()), win, idx, "WAR")
            # this write dominates everything it fully covers: later
            # conflicts with a covered entry conflict with this write
            # too, so dropping covered entries loses no ordering (only
            # redundant transitive edges)
            for hist in (past_reads.setdefault(ref.id, []),
                         past_writes.setdefault(ref.id, [])):
                hist[:] = [h for h in hist if not _covers(win, h[1])]
            past_writes[ref.id].append((idx, win))
    return DependenceGraph(tuple(edges))


# ---------------------------------------------------------------------------
# Fusion-plan legality
# ---------------------------------------------------------------------------


def audit_fusion_plan(program: KviProgram,
                      plan: Optional[FusionPlan] = None
                      ) -> DiagnosticReport:
    """Check a fusion plan (``plan`` or ``program.meta['fused_regions']``)
    against the weld-legality rules the planner promises; an empty
    report when the program carries no plan."""
    rep = DiagnosticReport()
    if plan is None:
        plan = program.meta.get(META_KEY)
    if plan is None:
        return rep
    if not isinstance(plan, FusionPlan):
        rep.add("KVI204",
                f"meta[{META_KEY!r}] is {type(plan).__name__}, not a "
                f"FusionPlan", program.name, subject="plan")
        return rep
    claimed: Set[int] = set()
    for rno, region in enumerate(plan.regions):
        subj = f"region{rno}"
        prev = None
        members: List[KviInstr] = []
        bad = False
        for item in region.items:
            if not (0 <= item < len(program.items)):
                rep.add("KVI204",
                        f"region {rno} references item {item}, program "
                        f"has {len(program.items)}",
                        program.name, item=item, subject=subj)
                bad = True
                continue
            if prev is not None and item <= prev:
                rep.add("KVI204",
                        f"region {rno} items not strictly ascending at "
                        f"{item}", program.name, item=item, subject=subj)
                bad = True
            prev = item
            if item in claimed:
                rep.add("KVI204",
                        f"item {item} welded into more than one region",
                        program.name, item=item, subject=subj)
                bad = True
            claimed.add(item)
            it = program.items[item]
            if (not isinstance(it, KviInstr)
                    or it.op not in ELEMWISE_OPS
                    or it.op is KviOp.KVCP):
                what = (it.op.value if isinstance(it, KviInstr)
                        else type(it).__name__)
                rep.add("KVI201",
                        f"region {rno} welds non-element-wise item "
                        f"{item} ({what})",
                        program.name, item=item,
                        op=what if isinstance(it, KviInstr) else None,
                        subject=subj)
                bad = True
                continue
            members.append(it)
            if (it.length != region.length
                    or it.elem_bytes != region.elem_bytes):
                rep.add("KVI202",
                        f"region {rno} planned for length "
                        f"{region.length}/eb{region.elem_bytes} welds "
                        f"item {item} with length {it.length}/"
                        f"eb{it.elem_bytes}",
                        program.name, item=item, op=it.op.value,
                        subject=subj)
                bad = True
        if bad:
            continue
        # replay the slot-file walk: stale reads and overlapping
        # write-backs are exactly what the planner must have cut on
        written: List[Window] = []
        slots: Set[Window] = set()
        inputs = 0
        for item, it in zip(region.items, members):
            for src in (it.src1, it.src2):
                if src is None:
                    continue
                key: Window = (src.id, src.offset, it.length)
                if key not in written and any(
                        windows_overlap(key, w) for w in written):
                    rep.add("KVI203",
                            f"region {rno} item {item} reads window "
                            f"{key} overlapping a pending region write "
                            f"(stale read across the weld)",
                            program.name, item=item, op=it.op.value,
                            subject=subj)
                if key not in slots:
                    slots.add(key)
                    if key not in written:
                        inputs += 1
            dkey: Window = (it.dst.id, it.dst.offset, it.length)
            if any(windows_overlap(dkey, w) for w in written
                   if w != dkey):
                rep.add("KVI203",
                        f"region {rno} item {item} writes window {dkey} "
                        f"overlapping a distinct pending write "
                        f"(write-back order hazard)",
                        program.name, item=item, op=it.op.value,
                        subject=subj)
            slots.add(dkey)
            if dkey not in written:
                written.append(dkey)
        if len(region.items) > plan.max_ops:
            rep.add("KVI303",
                    f"region {rno} welds {len(region.items)} ops; plan "
                    f"bound is {plan.max_ops}",
                    program.name, subject=subj)
        if inputs > plan.max_inputs:
            rep.add("KVI303",
                    f"region {rno} gathers {inputs} inputs; plan bound "
                    f"is {plan.max_inputs}",
                    program.name, subject=subj)
    return rep


# ---------------------------------------------------------------------------
# Static SPM pressure
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpmPressure:
    """The static scratchpad requirement of one (program, config)."""

    program: str
    peak_live_bytes: int              # liveness-exact requirement
    total_vreg_bytes: int             # sum of all vregs (no reuse)
    capacity_bytes: int
    line_bytes: int                   # allocation granule (D lanes)

    @property
    def fits(self) -> bool:
        return self.peak_live_bytes <= self.capacity_bytes

    @property
    def utilization(self) -> float:
        return self.peak_live_bytes / self.capacity_bytes

    def as_dict(self) -> Dict[str, object]:
        return {"peak_live_bytes": self.peak_live_bytes,
                "total_vreg_bytes": self.total_vreg_bytes,
                "capacity_bytes": self.capacity_bytes,
                "fits": self.fits}


def spm_pressure(program: KviProgram,
                 config: KlessydraConfig) -> SpmPressure:
    """Peak-live SPM bytes under the allocator's exact rules (line
    alignment from the config's lane count, uninitialized registers
    pinned live-from-start) — what
    :func:`repro_torch.kvi.lowering.allocate_vregs` will demand, computed
    without running it."""
    from repro_torch.kvi.passes.liveness import total_vreg_bytes
    line = max(config.D * 4, 4)
    return SpmPressure(
        program.name,
        peak_live_bytes(program, line, pin_uninitialized=True),
        total_vreg_bytes(program, line),
        config.spm_capacity_bytes, line)


def check_spm_pressure(program: KviProgram, config: KlessydraConfig
                       ) -> DiagnosticReport:
    rep = DiagnosticReport()
    p = spm_pressure(program, config)
    if not p.fits:
        rep.add("KVI301",
                f"peak-live vreg footprint {p.peak_live_bytes} B exceeds "
                f"SPM capacity {p.capacity_bytes} B on config "
                f"{config.name!r}; lowering would raise SpmOverflowError",
                program.name, subject=f"spm:{config.name}")
    return rep


# ---------------------------------------------------------------------------
# Workload-level checks
# ---------------------------------------------------------------------------


def _logical_buffers(program: KviProgram) -> Tuple[Set[tuple], Set[tuple]]:
    """(written, read) logical buffer identities of one program. A
    buffer's cross-program identity is (name, length, elem_bytes)."""
    written: Set[tuple] = set()
    read: Set[tuple] = set()
    for it in program.items:
        if not isinstance(it, KviInstr):
            continue
        if it.op is KviOp.KMEMSTR and it.dst is not None \
                and it.dst.space == "mem" \
                and 0 <= it.dst.id < len(program.mems):
            m = program.mem_by_id(it.dst.id)
            written.add((m.name, m.length, m.elem_bytes))
        elif it.op is KviOp.KMEMLD and it.src1 is not None \
                and it.src1.space == "mem" \
                and 0 <= it.src1.id < len(program.mems):
            m = program.mem_by_id(it.src1.id)
            read.add((m.name, m.length, m.elem_bytes))
    return written, read


def check_workload(workload, config: Optional[KlessydraConfig] = None,
                   shared_scheme: bool = True) -> DiagnosticReport:
    """Workload-level hazards: hart pinning vs. the machine, and
    cross-hart buffer races between structurally different programs
    (write/write is an error under the shared scheme, read/write a
    warning)."""
    from repro_torch.kvi.workload import structural_signature
    rep = DiagnosticReport()
    if config is not None:
        for i, e in enumerate(workload.entries):
            if e.hart is not None and e.hart >= config.harts:
                rep.add("KVI302",
                        f"entry {i} ({e.program.name!r}) pinned to hart "
                        f"{e.hart}; config {config.name!r} has "
                        f"{config.harts} harts",
                        e.program.name, subject=f"entry{i}")

    sigs = [structural_signature(e.program) for e in workload.entries]
    bufs = {}
    for e in workload.entries:
        if id(e.program) not in bufs:
            bufs[id(e.program)] = _logical_buffers(e.program)
    flagged: Set[tuple] = set()
    for i, a in enumerate(workload.entries):
        for j in range(i + 1, len(workload.entries)):
            b = workload.entries[j]
            if sigs[i] == sigs[j]:
                continue              # data instances: per-entry outputs
            if (a.hart is not None and b.hart is not None
                    and a.hart == b.hart):
                continue              # same hart: sequential, no race
            wa, ra = bufs[id(a.program)]
            wb, rb = bufs[id(b.program)]
            for name, length, eb in sorted(wa & wb):
                k = ("ww", name, length, eb)
                if k in flagged or not shared_scheme:
                    continue
                flagged.add(k)
                rep.add("KVI210",
                        f"programs {a.program.name!r} (entry {i}) and "
                        f"{b.program.name!r} (entry {j}) on different "
                        f"harts both write buffer {name!r} "
                        f"({length} x {eb} B) — write/write race under "
                        f"the shared scheme",
                        workload.name, subject=f"mem:{name}")
            for name, length, eb in sorted((wa & rb) | (wb & ra)):
                k = ("rw", name, length, eb)
                if k in flagged:
                    continue
                flagged.add(k)
                rep.add("KVI211",
                        f"buffer {name!r} ({length} x {eb} B) is "
                        f"written by one hart and read by another "
                        f"({a.program.name!r} entry {i} / "
                        f"{b.program.name!r} entry {j}) with no "
                        f"ordering between harts",
                        workload.name, subject=f"mem:{name}")
    return rep


# ---------------------------------------------------------------------------
# Bundled entry points
# ---------------------------------------------------------------------------


def analyze_program(program: KviProgram,
                    config: Optional[KlessydraConfig] = None
                    ) -> DiagnosticReport:
    """Structural verification + fusion-plan audit (+ static SPM
    pressure when a machine ``config`` is given)."""
    rep = verify_program(program)
    rep.extend(audit_fusion_plan(program))
    if config is not None:
        rep.extend(check_spm_pressure(program, config))
    return rep


def analyze_workload(workload,
                     config: Optional[KlessydraConfig] = None,
                     shared_scheme: bool = True) -> DiagnosticReport:
    """Every distinct program analyzed once, plus the workload-level
    hazard checks."""
    rep = DiagnosticReport()
    seen: Set[int] = set()
    for e in workload.entries:
        if id(e.program) in seen:
            continue
        seen.add(id(e.program))
        rep.extend(analyze_program(e.program, config=config))
    rep.extend(check_workload(workload, config=config,
                              shared_scheme=shared_scheme))
    return rep
