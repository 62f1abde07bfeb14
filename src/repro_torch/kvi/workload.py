"""Composite workloads: batches of KVI programs with hart assignments.

The paper's central claim is the synergy between interleaved multi-
threading and data-level parallelism: three harts each drive vector work,
including *composite* workloads where conv / FFT / matmul run on different
harts concurrently. A :class:`KviWorkload` makes that batch a first-class
object every backend executes through ``Backend.run_workload()``:

  * one entry       — equivalent to the legacy single-program ``run()``,
  * homogeneous     — N data instances of one program structure (the
                      paper's homogeneous protocol; the torch backend
                      runs the whole batch as ONE kernel launch per
                      fused segment over all N instances),
  * composite       — different programs pinned to different harts (the
                      paper's conv32 / fft256 / matmul64 on harts 0/1/2).

A :class:`HartAssignment` pins an entry to a hart; unpinned entries are
placed round-robin over the machine's harts at execution time (see
:meth:`KviWorkload.assign_harts`). Entries pinned to the same hart execute
back-to-back in entry order — exactly the repeated-kernel streams of the
paper's composite measurement protocol.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.kvi.backend import BackendResult
from repro_torch.kvi.ir import KviProgram


@dataclass(frozen=True)
class HartAssignment:
    """Placement of one workload entry.

    hart — pinned hart index, or None to let the executor place the entry
           (round-robin over the scheme's harts, in entry order).
    """

    hart: Optional[int] = None

    def __post_init__(self):
        if self.hart is not None and self.hart < 0:
            raise ValueError(f"hart must be >= 0, got {self.hart}")


@dataclass(frozen=True)
class WorkloadEntry:
    """One (program, hart-assignment) pair; the program's ``mem_init``
    buffers are this entry's data instance."""

    program: KviProgram
    assignment: HartAssignment = HartAssignment()

    @property
    def hart(self) -> Optional[int]:
        return self.assignment.hart


def structural_signature(program: KviProgram) -> tuple:
    """Hashable key identifying a program's *structure* — instruction
    stream, register shapes, buffer shapes — ignoring the data in
    ``mem_init``. Two programs with equal signatures are data instances of
    the same computation, which is what lets the torch backend batch them
    into one compiled kernel."""
    return (
        program.items,
        tuple((r.length, r.elem_bytes) for r in program.vregs),
        tuple((m.name, m.length, m.elem_bytes, m.is_output)
              for m in program.mems),
    )


@dataclass(frozen=True)
class KviWorkload:
    """An immutable batch of (program, hart-assignment, data-instance)
    entries — the unit of execution for ``Backend.run_workload()``."""

    name: str
    entries: Tuple[WorkloadEntry, ...]
    meta: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self):
        if not self.entries:
            raise ValueError("workload needs at least one entry")

    # ---- constructors ---------------------------------------------------
    @classmethod
    def single(cls, program: KviProgram) -> "KviWorkload":
        """One program, unpinned — the legacy ``run()`` protocol."""
        return cls(program.name, (WorkloadEntry(program),))

    @classmethod
    def replicate(cls, program: KviProgram, n: int) -> "KviWorkload":
        """The same program (same data) on ``n`` harts — the paper's
        homogeneous measurement protocol for one kernel."""
        return cls(f"{program.name}x{n}",
                   tuple(WorkloadEntry(program, HartAssignment(h))
                         for h in range(n)))

    @classmethod
    def homogeneous(cls, programs: Sequence[KviProgram],
                    name: Optional[str] = None,
                    pin_harts: bool = False) -> "KviWorkload":
        """N data instances of one program structure. All programs must
        share a structural signature; with ``pin_harts`` instance i is
        pinned to hart i."""
        programs = list(programs)
        if not programs:
            raise ValueError("workload needs at least one entry")
        sig = structural_signature(programs[0])
        for p in programs[1:]:
            if structural_signature(p) != sig:
                raise ValueError(
                    f"homogeneous workload requires structurally identical "
                    f"programs; {p.name!r} differs from {programs[0].name!r}")
        entries = tuple(
            WorkloadEntry(p, HartAssignment(i if pin_harts else None))
            for i, p in enumerate(programs))
        return cls(name or f"{programs[0].name}x{len(programs)}", entries)

    @classmethod
    def composite(cls, by_hart: Mapping[int, Sequence[KviProgram]],
                  name: str = "composite") -> "KviWorkload":
        """Different program streams pinned to different harts. Entry order
        within a hart is execution order (back-to-back repetitions)."""
        entries = []
        for hart in sorted(by_hart):
            for p in by_hart[hart]:
                entries.append(WorkloadEntry(p, HartAssignment(hart)))
        return cls(name, tuple(entries))

    # ---- structure ------------------------------------------------------
    def map_programs(self, fn) -> "KviWorkload":
        """A workload with each entry's program replaced by
        ``fn(program)``; assignments and meta are preserved. ``fn`` runs
        once per distinct program OBJECT, so entries sharing a program
        keep sharing the mapped one (identity-keyed caches downstream —
        dedup, lowering — stay effective). Returns ``self`` when ``fn``
        is an identity on every entry (the no-op-pass fast path)."""
        cache: Dict[int, KviProgram] = {}
        entries = []
        changed = False
        for e in self.entries:
            mapped = cache.get(id(e.program))
            if mapped is None:
                mapped = fn(e.program)
                cache[id(e.program)] = mapped
            if mapped is e.program:
                entries.append(e)
            else:
                changed = True
                entries.append(WorkloadEntry(mapped, e.assignment))
        if not changed:
            return self
        return KviWorkload(self.name, tuple(entries), dict(self.meta))

    @property
    def programs(self) -> Tuple[KviProgram, ...]:
        return tuple(e.program for e in self.entries)

    @property
    def is_homogeneous(self) -> bool:
        """True when every entry is a data instance of the same program
        structure (batchable into one compiled kernel)."""
        sigs = {structural_signature(e.program) for e in self.entries}
        return len(sigs) == 1

    def assign_harts(self, n_harts: int) -> List[List[int]]:
        """Resolve assignments for a machine with ``n_harts`` harts:
        returns per-hart lists of entry indices in execution order. Pinned
        entries keep their hart (error if out of range); unpinned entries
        are placed round-robin in entry order."""
        per_hart: List[List[int]] = [[] for _ in range(n_harts)]
        rr = 0
        for i, e in enumerate(self.entries):
            h = e.hart
            if h is None:
                h = rr % n_harts
                rr += 1
            elif h >= n_harts:
                raise ValueError(
                    f"entry {i} ({e.program.name!r}) pinned to hart {h} "
                    f"but the machine has {n_harts} harts")
            per_hart[h].append(i)
        return per_hart

    def __repr__(self):
        return (f"KviWorkload({self.name!r}, {len(self.entries)} entries, "
                f"{'homogeneous' if self.is_homogeneous else 'composite'})")


def dedup_entry_outputs(entries: Sequence[WorkloadEntry], run_program
                        ) -> List[Dict[str, object]]:
    """Per-entry outputs with each distinct program OBJECT executed once:
    ``run_program(program) -> outputs dict`` runs on first sight; sibling
    entries reusing the same object get array copies, so mutating one
    entry's buffers cannot corrupt the others. The ``oracle`` backend's
    per-entry execution rides on it, as in the reference."""
    cache: Dict[int, Dict[str, object]] = {}
    seen = set()
    outs = []
    for e in entries:
        k = id(e.program)
        if k not in cache:
            cache[k] = run_program(e.program)
        out = cache[k]
        if k in seen:
            out = {name: v.copy() for name, v in out.items()}
        seen.add(k)
        outs.append(out)
    return outs


@dataclass
class WorkloadResult:
    """What one backend run of a workload produced.

    entry_results — one :class:`BackendResult` per workload entry, in
                    entry order (``outputs`` filled; per-entry ``timing``
                    left None — timing is a workload-level property).
    timing        — scheme name -> SimResult for the WHOLE workload
                    (cyclesim only): all harts, all entries, with
                    contention between them.
    """

    backend: str
    workload: KviWorkload
    entry_results: Tuple[BackendResult, ...]
    timing: Optional[Dict[str, object]] = None
    meta: Dict[str, object] = field(default_factory=dict)

    @property
    def cycles(self) -> Optional[Dict[str, int]]:
        if self.timing is None:
            return None
        return {k: v.cycles for k, v in self.timing.items()}

    @property
    def hart_utilization(self) -> Optional[Dict[str, List[Dict[str, float]]]]:
        """Per-scheme, per-hart busy/stall/idle cycle breakdown (the
        reference simulator's ``HartStats`` accounting). ``None`` for
        timing-less backends. Each entry satisfies busy + stall + idle ==
        total (the workload's cycles)."""
        if self.timing is None:
            return None
        return {scheme: [dict(h.breakdown(), utilization=h.utilization)
                         for h in sim.per_hart]
                for scheme, sim in self.timing.items()}

    @property
    def outputs(self) -> Tuple[Dict[str, object], ...]:
        return tuple(r.outputs for r in self.entry_results)

    @property
    def kernel_launches(self) -> Optional[int]:
        """Kernel launches this run issued (fused regions plus
        reductions; the counterpart of the reference's ``pallas_calls``),
        or ``None`` when the backend does not count them."""
        n = self.meta.get("kernel_launches")
        return None if n is None else int(n)

    def entry_result(self, i: int = 0) -> BackendResult:
        """Entry ``i``'s result, with the workload-level timing attached
        (what the legacy single-program ``run()`` returns)."""
        r = self.entry_results[i]
        if self.timing is not None and r.timing is None:
            return BackendResult(r.backend, r.outputs, self.timing)
        return r
