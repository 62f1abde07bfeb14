"""CycleSimBackend — functional values + cycle timing for the paper's
three coprocessor schemes (repro_torch.core.simulator); the port's copy
of ``repro.kvi.cyclesim``.

The unit of execution is a :class:`~repro_torch.kvi.workload.KviWorkload`:
entries lower to per-hart Instr/Scalar traces (entries pinned to the same
hart run back-to-back in entry order), so the paper's composite protocol —
conv on hart 0, FFT on hart 1, matmul on hart 2 — runs natively through
the IR. ``run_workload()`` returns both:

  * per-entry outputs — bit-identical to the oracle backend (same Mfu
                        execution of the same lowered trace), and
  * timing           — scheme name -> SimResult for shared (M=1,F=1),
                       symmetric MIMD (M=3,F=3) and heterogeneous MIMD
                       (M=3,F=1), for the WHOLE workload with inter-hart
                       contention.

The single-program ``run()`` keeps the paper's homogeneous protocol: the
program is replicated on all harts (``replicate_harts=True``).

Paper invariant (validated in tests, homogeneous AND composite):
    sym-MIMD cycles <= het-MIMD cycles <= shared cycles.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import KlessydraConfig
from repro_torch.core.simulator import (SimRecorder, SimResult,
                                        _merge_intervals, simulate)
from repro_torch.kvi.backend import (BackendBase, BackendResult,
                                     register_backend)
from repro_torch.kvi.ir import KviProgram
from repro_torch.kvi.lowering import TraceCache, lower
from repro_torch.kvi.workload import (KviWorkload, WorkloadResult,
                                      dedup_entry_outputs)

#: Version token of the cycle-accurate timing semantics (lowering cost
#: annotations + :func:`repro_torch.core.simulator.simulate` event model),
#: part of every persistent sweep cache key
#: (:mod:`repro_torch.kvi.dse.pointcache`). Bump it whenever a change alters
#: simulated cycles, utilization or busy/stall accounting for an
#: unchanged program — cached sweep records keyed to the old token then
#: miss instead of serving stale timings. Explicit by design (not a
#: source hash): refactors that provably preserve timing keep caches
#: warm.
TIMING_VERSION = 1


def _subtract(intervals: List[Tuple[int, int]],
              cover: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Pieces of sorted merged half-open ``intervals`` not overlapped by
    sorted merged ``cover`` — interval-list counterpart of the
    simulator's ``_length_outside`` (used so the emitted stall/idle spans
    sum to exactly the ``HartStats`` breakdown)."""
    out: List[Tuple[int, int]] = []
    ci = 0
    for s, e in intervals:
        cur = s
        while cur < e:
            while ci < len(cover) and cover[ci][1] <= cur:
                ci += 1
            if ci == len(cover) or cover[ci][0] >= e:
                out.append((cur, e))
                break
            cs, ce = cover[ci]
            if cs > cur:
                out.append((cur, cs))
            cur = max(cur, min(ce, e))
    return out


def emit_sim_trace(obs, scheme: str, rec: SimRecorder,
                   res: SimResult) -> None:
    """Render one scheme's :class:`SimRecorder` capture onto the obs
    bundle: per-hart instruction/fused/scalar occupancy spans, stall
    spans (issue waits minus the hart's own in-flight work, matching the
    ``HartStats`` convention), explicit idle spans, FU-hold lanes for
    contended resource instances, and cycle metrics.

    Emitted invariant (pinned by the trace-integrity tests): per hart,
    the stall spans sum to ``stall_cycles``, the idle spans sum to
    ``idle_cycles``, and busy/stall/idle tile ``[0, cycles)``."""
    tr = obs.tracer
    m = obs.metrics
    proc = f"cyclesim:{scheme}"
    H = len(res.per_hart)
    total = res.cycles
    hist = m.histogram(f"cyclesim.{scheme}.instr_cycles")

    # exact per-hart activity cover — scalar blocks decompose into their
    # owned 1-cycle issue slots, mirroring the simulator's accounting
    act: List[List[Tuple[int, int]]] = [[] for _ in range(H)]
    for h, op, engine, s, e, chained in rec.instrs:
        act[h].append((s, e))
        tr.span((proc, f"hart{h}"), op, s, e - s,
                cat="fused" if chained else "instr",
                args={"engine": engine})
        hist.observe(e - s)
    for h, s, e, count in rec.scalars:
        act[h].extend((s + k * H, s + k * H + 1) for k in range(count))
        tr.span((proc, f"hart{h}"), f"scalar x{count}", s, e - s,
                cat="scalar", args={"count": count})

    covers = [_merge_intervals(iv) for iv in act]
    stall_cover: List[List[Tuple[int, int]]] = [[] for _ in range(H)]
    for h, op, s, e in rec.waits:
        for ps, pe in _subtract([(s, e)], covers[h]):
            tr.span((proc, f"hart{h}"), f"wait:{op}", ps, pe - ps,
                    cat="stall")
            stall_cover[h].append((ps, pe))
    for h in range(H):
        occupied = _merge_intervals(covers[h] + stall_cover[h])
        for s, e in _subtract([(0, total)], occupied):
            tr.span((proc, f"hart{h}"), "idle", s, e - s, cat="idle")

    # FU-hold lanes: which resource instance each op pinned, and when —
    # het-MIMD's per-internal-unit contention becomes visible here
    for key, s, e in rec.holds:
        lane = "fu:" + "-".join(str(p) for p in key)
        tr.span((proc, lane), lane[3:], s, e - s, cat="hold")

    st = res.per_hart
    m.counter(f"cyclesim.{scheme}.instructions").inc(
        sum(h.instructions for h in st))
    m.counter(f"cyclesim.{scheme}.vector_ops").inc(
        sum(h.vector_ops for h in st))
    m.counter(f"cyclesim.{scheme}.lsu_ops").inc(
        sum(h.lsu_ops for h in st))
    m.counter(f"cyclesim.{scheme}.stall_cycles").inc(
        sum(h.stall_cycles for h in st))
    m.gauge(f"cyclesim.{scheme}.cycles").set(total)


def default_schemes(D: int = 4, spm_kbytes: int = 64,
                    ) -> Dict[str, KlessydraConfig]:
    """The paper's three coprocessor schemes at one DLP width.

    Scheme construction lives on the design-space subsystem
    (:func:`repro_torch.kvi.dse.space.scheme_config`) — this is the
    D-parameterized slice of that space the single-config callers use."""
    from repro_torch.kvi.dse.space import SCHEMES, scheme_config
    return {s: scheme_config(s, D=D, spm_kbytes=spm_kbytes)
            for s in SCHEMES}


@register_backend("cyclesim")
class CycleSimBackend(BackendBase):
    """Values + per-scheme cycle counts from the event-driven simulator."""

    def __init__(self,
                 schemes: Optional[Dict[str, KlessydraConfig]] = None,
                 replicate_harts: bool = True,
                 passes=None, chaining: bool = False,
                 trace_cache: Optional[TraceCache] = None,
                 verify: bool = False, obs=None):
        self.schemes = schemes or default_schemes()
        self.replicate_harts = replicate_harts
        self.passes = passes
        self.verify = verify
        # optional telemetry bundle (repro_torch.kvi.obs.Obs): when enabled,
        # every simulate() call records per-event timelines and emits
        # them as per-scheme Perfetto tracks + cycle metrics
        self.obs = obs
        # FU chaining: ops inside a planned FusedRegion (after the head)
        # skip their startup latency — the paper's back-to-back SPM-
        # resident op streams. Off by default so the Table 2/3 numbers
        # stay the legacy ones; needs the fuse_regions pass to plan the
        # regions (no effect with passes=()).
        self.chaining = chaining
        # shared LoweredTrace cache: callers running one program set
        # through several workloads (the DSE sweep's preflight +
        # homogeneous + composite protocols) pass a TraceCache so the
        # SPM allocator runs once per (program, config), not per run
        self.trace_cache = trace_cache

    def run(self, program: KviProgram) -> BackendResult:
        """Single-program protocol: replicate on all harts (the paper's
        homogeneous measurement) unless ``replicate_harts=False``. With
        schemes of unequal hart counts the SMALLEST count is replicated,
        so every scheme times the same workload (the paper's schemes all
        have 3 harts, where this is exactly the legacy per-scheme
        replication)."""
        if self.replicate_harts:
            n = min(cfg.harts for cfg in self.schemes.values())
            wl = KviWorkload.replicate(program, n)
        else:
            wl = KviWorkload.single(program)
        return self.run_workload(wl).entry_result(0)

    def run_workload(self, workload: KviWorkload,
                     functional: bool = True,
                     verify: Optional[bool] = None) -> WorkloadResult:
        """Timing for the whole workload per scheme, plus (with
        ``functional=True``) per-entry outputs. Timing-only callers (the
        Table-2 sweeps) pass ``functional=False`` to skip the Mfu replay."""
        workload = self.optimize_workload(workload, verify=verify)
        timing: Dict[str, SimResult] = {}
        entry_outputs = None if functional else \
            [{} for _ in workload.entries]
        lower_fn = self.trace_cache.lower if self.trace_cache is not None \
            else lower
        for scheme, cfg in self.schemes.items():
            # lower each distinct program once per scheme (entries often
            # share program objects, e.g. the replicated protocol);
            # timing-only runs skip the mem_init buffer copies, and a
            # TraceCache shares the whole trace across run protocols
            traces = {}
            for e in workload.entries:
                if id(e.program) not in traces:
                    traces[id(e.program)] = lower_fn(
                        e.program, cfg, chaining=self.chaining,
                        functional=functional)
            if entry_outputs is None:
                # functional values: same trace + Mfu path as the oracle
                # (shared dedup/copy semantics in dedup_entry_outputs),
                # so Oracle == CycleSim bit-for-bit by construction
                entry_outputs = dedup_entry_outputs(
                    workload.entries,
                    lambda p, traces=traces: traces[id(p)].execute())
            per_hart = workload.assign_harts(cfg.harts)
            progs = [
                [it for i in idxs
                 for it in traces[id(workload.entries[i].program)].items]
                for idxs in per_hart]
            if self.obs is not None and self.obs.enabled:
                rec = SimRecorder()
                timing[scheme] = simulate(cfg, progs, recorder=rec)
                emit_sim_trace(self.obs, scheme, rec, timing[scheme])
            else:
                timing[scheme] = simulate(cfg, progs)
        results = tuple(BackendResult(self.name, out)
                        for out in entry_outputs)
        return WorkloadResult(self.name, workload, results, timing)
