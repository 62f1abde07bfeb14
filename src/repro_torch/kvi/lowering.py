"""Lowering: KviProgram (virtual registers) -> core Instr trace (SPM
addresses), shared by the ``oracle`` backend and the cycle model (the
port's copy of ``repro.kvi.lowering``).

Virtual registers become SPM allocations via **liveness-based linear
scan**: each vreg's live range (first touch .. last touch) is computed
with :mod:`repro_torch.kvi.passes.liveness` and registers whose ranges do
not overlap share scratchpad lines. Programs whose *peak-live* footprint
fits the SPM therefore lower even when the *total* vreg footprint does
not — the reuse a programmer would hand-craft. A genuine overflow raises
:class:`SpmOverflowError` naming the program, its peak-live bytes and
the capacity.

Memory buffers become main-memory handles. Reduction instructions whose
IR dst is a vreg view get the legacy ``rf_store`` annotation — the
register-file result spilled to its architectural destination, modelled
as one scalar store by the cycle simulator (see
``repro_torch.core.programs``).

With ``chaining=True`` the lowered element-wise instructions inside a
planned :class:`~repro_torch.kvi.passes.fusion.FusedRegion` (after the
first) carry a ``chain_discount`` — the FU-chaining setup savings the cycle
simulator subtracts (the paper's back-to-back SPM-resident op streams).

Timing-only callers pass ``functional=False``: the lowered trace then
*aliases* the program's ``mem_init`` buffers instead of copying them
(simulation never touches memory contents) and refuses to ``execute()``.
:class:`TraceCache` builds on that to share one lowered trace per
``(program, config fingerprint, chaining)`` across run protocols — the
design-space sweep's preflight, homogeneous and composite runs all hit
the same allocation instead of re-running the SPM linear scan.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.configs.base import KlessydraConfig
from repro_torch.core.isa import Instr, Scalar
from repro_torch.core.spm import SpmError, SpmSpace
from repro_torch.kvi.ir import (REDUCTION_OPS, KviInstr, KviOp,
                                KviProgram, ScalarBlock)
from repro_torch.kvi.passes.fusion import META_KEY, FusionPlan
from repro_torch.kvi.passes.liveness import peak_live_bytes, reg_intervals

Item = Union[Instr, Scalar]


class SpmOverflowError(SpmError):
    """The SPM allocator cannot place a program's vregs. Usually the
    peak-live footprint genuinely exceeds capacity (no register-reuse
    schedule can fit it); rarely the linear scan fragments a fit that
    exists in principle — the message distinguishes the two."""

    def __init__(self, program: KviProgram, peak_live: int, capacity: int,
                 config: KlessydraConfig):
        self.program_name = program.name
        self.peak_live_bytes = peak_live
        self.capacity_bytes = capacity
        self.fragmented = peak_live <= capacity
        spm = f"{capacity} B (N={config.N} x {config.spm_kbytes} KiB)"
        if self.fragmented:
            msg = (f"SPM overflow lowering {program.name!r}: peak-live "
                   f"vreg footprint {peak_live} B fits the SPM capacity "
                   f"{spm}, but linear-scan placement fragmented it — "
                   f"reorder register lifetimes or raise spm_kbytes")
        else:
            msg = (f"SPM overflow lowering {program.name!r}: peak-live "
                   f"vreg footprint {peak_live} B exceeds SPM capacity "
                   f"{spm}; no live-range reuse can fit this program — "
                   f"shrink vectors or raise spm_kbytes")
        super().__init__(msg)


def _align_up(x: int, a: int) -> int:
    return -(-x // a) * a


def allocate_vregs(program: KviProgram,
                   config: KlessydraConfig) -> Dict[int, int]:
    """Linear-scan SPM allocation: vreg id -> byte address.

    Registers are placed in live-range start order at the lowest
    SPM-line-aligned address not occupied by any register whose live
    range overlaps. Registers not fully defined before first read are
    pinned live-from-start so they never inherit recycled lines (their
    unwritten elements read as zeros on every backend). Untouched vregs
    get no address (nothing references them). Raises
    :class:`SpmOverflowError` on overflow.
    """
    line = max(config.D * 4, 4)
    capacity = config.spm_capacity_bytes
    intervals = reg_intervals(program, pin_uninitialized=True)
    placed: List[Tuple[int, int, int, int]] = []   # (addr, size, start, end)
    addr_of: Dict[int, int] = {}
    order = sorted(intervals, key=lambda rid: (intervals[rid][0], rid))
    for rid in order:
        r = program.vreg_by_id(rid)
        size = _align_up(r.length * r.elem_bytes, line)
        s, e = intervals[rid]
        busy = sorted((a, sz) for a, sz, s2, e2 in placed
                      if not (e < s2 or e2 < s))
        cur = 0
        for a, sz in busy:
            if a - cur >= size:
                break
            cur = max(cur, a + sz)
        if cur + size > capacity:
            raise SpmOverflowError(
                program,
                peak_live_bytes(program, line, pin_uninitialized=True),
                capacity, config)
        placed.append((cur, size, s, e))
        addr_of[rid] = cur
    return addr_of


def _chained_items(program: KviProgram) -> frozenset:
    """Item indices eligible for the FU-chaining discount: every region
    member after its region's first op (the head pays full setup)."""
    plan = program.meta.get(META_KEY)
    if not isinstance(plan, FusionPlan):
        return frozenset()
    return frozenset(i for r in plan.regions for i in r.items[1:])


@dataclass
class LoweredTrace:
    """One KviProgram bound to one machine configuration.

    ``functional=False`` marks a timing-only trace: its ``mem`` dict
    aliases the program's ``mem_init`` buffers (no copies were made), so
    executing it would corrupt the immutable program — ``execute()``
    refuses."""

    program: KviProgram
    config: KlessydraConfig
    items: List[Item]
    spm: SpmSpace
    mem: Dict[int, np.ndarray]       # legacy handle -> buffer
    vreg_addr: Dict[int, int]        # vreg id -> SPM byte address
    out_handles: Dict[str, int]      # output name -> legacy mem handle
    functional: bool = True

    def execute(self) -> Dict[str, np.ndarray]:
        """Run the trace functionally on the SPM/main-memory model and
        collect the program's output buffers (bit-exact Mfu semantics)."""
        if not self.functional:
            raise RuntimeError(
                f"trace of {self.program.name!r} was lowered with "
                f"functional=False (mem buffers alias the program's "
                f"mem_init); re-lower functionally to execute")
        from repro_torch.core.programs import _run_items
        _run_items(self.items, self.spm, self.mem)
        return self.collect_outputs()

    def collect_outputs(self) -> Dict[str, np.ndarray]:
        out = {}
        for m in self.program.outputs:
            shape = self.program.mem_init[m.id].shape
            out[m.name] = self.mem[m.id].reshape(shape).copy()
        return out


def lower(program: KviProgram, config: KlessydraConfig,
          chaining: bool = False, functional: bool = True,
          vreg_addr: Optional[Dict[int, int]] = None) -> LoweredTrace:
    """Bind a program's vregs/buffers to one machine config and emit the
    dynamic Instr/Scalar trace the simulator and Mfu consume.

    ``functional=False`` skips the ``mem_init`` buffer copies (the trace
    aliases the program's buffers and cannot be executed — timing-only).
    ``vreg_addr`` injects a precomputed SPM allocation so repeated lowers
    of one (program, config) pair skip the linear-scan allocator — the
    :class:`TraceCache` fast path."""
    spm = SpmSpace(config)
    if vreg_addr is None:
        vreg_addr = allocate_vregs(program, config)
    # legacy memory handles are the MemRef ids (declaration order)
    if functional:
        mem = {m.id: program.mem_init[m.id].copy() for m in program.mems}
    else:
        mem = {m.id: program.mem_init[m.id] for m in program.mems}
    out_handles = {m.name: m.id for m in program.outputs}
    chained = _chained_items(program) if chaining else frozenset()

    def vaddr(ref):
        r = program.vreg_by_id(ref.id)
        return vreg_addr[ref.id] + r.elem_bytes * ref.offset

    items: List[Item] = []
    for idx, it in enumerate(program.items):
        if isinstance(it, ScalarBlock):
            items.append(Scalar(it.count))
            continue
        assert isinstance(it, KviInstr)
        op = it.op
        if op is KviOp.KMEMLD:
            items.append(Instr("kmemld", dst=vaddr(it.dst), src1=it.src1.id,
                               length=it.length, elem_bytes=it.elem_bytes))
        elif op is KviOp.KMEMSTR:
            items.append(Instr("kmemstr", dst=it.dst.id,
                               src1=vaddr(it.src1), length=it.length,
                               elem_bytes=it.elem_bytes))
        elif op in REDUCTION_OPS:
            i = Instr(op.value,
                      src1=vaddr(it.src1),
                      src2=vaddr(it.src2) if it.src2 is not None else None,
                      scalar=it.scalar, length=it.length,
                      elem_bytes=it.elem_bytes)
            # register-file result spilled to the dst view's SPM location
            dreg = program.vreg_by_id(it.dst.id)
            i.rf_store = (vreg_addr[it.dst.id], it.dst.offset,
                          dreg.elem_bytes)
            items.append(i)
        else:
            i = Instr(op.value, dst=vaddr(it.dst),
                      src1=vaddr(it.src1),
                      src2=vaddr(it.src2) if it.src2 is not None
                      else None,
                      scalar=it.scalar, length=it.length,
                      elem_bytes=it.elem_bytes)
            if idx in chained:
                # chained op: operands stream straight off the previous
                # op's result lines — skip the FU startup latency
                i.chain_discount = config.vector_setup_cycles
            items.append(i)
    return LoweredTrace(program, config, items, spm, mem, vreg_addr,
                        out_handles, functional=functional)


# ---------------------------------------------------------------------------
# Trace caching across run protocols
# ---------------------------------------------------------------------------


def config_fingerprint(config: KlessydraConfig) -> tuple:
    """A stable hashable identity for one machine configuration —
    every field, so any parameter that could change lowering or timing
    distinguishes cache entries. In-memory only (tuples of live
    values); the persistent sweep cache
    (the reference's ``repro.kvi.dse.pointcache``) covers the same ground
    content-addressably via the point's canonical dict + program
    fingerprints."""
    return dataclasses.astuple(config)


@dataclass
class TraceCache:
    """Caches :func:`lower` results keyed on
    ``(program identity, config fingerprint, chaining)``.

    One sweep point runs each kernel through up to three protocols —
    SPM preflight, the homogeneous run, the composite run — and without
    caching each of them re-runs the linear-scan SPM allocator and
    re-copies ``mem_init``. Through the cache the allocator runs exactly
    once per (program, config): timing-only traces (``functional=False``)
    are shared outright (simulation never mutates them), and functional
    lowers reuse the cached SPM allocation while still getting fresh
    buffer copies (execution mutates memory).

    ``hits`` / ``misses`` count cache lookups; ``misses`` equals the
    number of allocator runs, which is what the sweep's per-point
    accounting asserts on.

    Keys use program *identity* (programs are pinned alive so ids can't
    recycle), so the cache only pays off when callers hand the backend
    stable program objects — i.e. ``passes=()`` with pre-optimized
    programs, the DSE configuration. A backend whose pass pipeline is
    active rewrites programs into fresh objects per run, making every
    lookup a miss; scope a TraceCache to one program set (the sweep
    builds one per point), don't share it across unrelated runs.
    """

    hits: int = 0
    misses: int = 0
    # key -> timing-only trace; each trace's .program field keeps the
    # keyed program alive, so id() keys can never be recycled onto a
    # different program object
    _traces: Dict[tuple, LoweredTrace] = field(default_factory=dict)

    def _key(self, program: KviProgram, config: KlessydraConfig,
             chaining: bool) -> tuple:
        return (id(program), config_fingerprint(config), bool(chaining))

    def lower(self, program: KviProgram, config: KlessydraConfig,
              chaining: bool = False,
              functional: bool = True) -> LoweredTrace:
        """Drop-in for :func:`lower` with caching."""
        key = self._key(program, config, chaining)
        trace = self._traces.get(key)
        if trace is None:
            self.misses += 1
            trace = lower(program, config, chaining=chaining,
                          functional=False)
            self._traces[key] = trace
        else:
            self.hits += 1
        if not functional:
            return trace
        return lower(program, config, chaining=chaining, functional=True,
                     vreg_addr=trace.vreg_addr)

    @property
    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses}
