"""Continuous-admission hart scheduler: pack queued programs onto free
harts, then execute the packed workload on any backend (the port's copy
of ``repro.kvi.scheduler``).

The slot/free-list policy mirrors the reference's
``repro.serving.engine.ServingEngine``
at coprocessor granularity: the scheduler's "slots" are harts, a hart is
*free* when its accumulated estimated cycles is the minimum of all harts,
and admission is continuous — each queued program is dispatched to the
hart that will free up first (earliest-finish-first), in submission
order. There is no head-of-line blocking: a long matmul on one hart does
not delay conv instances landing on the other two.

Estimates come from a solo cycle simulation of each distinct program
(cached by structure), so packing reflects real kernel latencies rather
than instruction counts; the *final* timing of the packed workload — with
true inter-hart contention per scheme — comes from running it through
``CycleSimBackend.run_workload``.

    sched = HartScheduler(n_harts=3)
    for p in programs:
        sched.submit(p)
    result = sched.run(get_backend("cyclesim"))   # dispatch + execute
    # or, to inspect the packing first:
    #   workload = sched.dispatch()               # drains the queue
    #   result = backend.run_workload(workload)
    # or, request-driven (the serving engine's protocol):
    #   ticket = sched.admit(program, now=arrival_cycle)
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.configs.base import KlessydraConfig
from repro_torch.kvi.ir import KviProgram
from repro_torch.kvi.lowering import TraceCache, lower
from repro_torch.kvi.workload import (HartAssignment, KviWorkload,
                                      WorkloadEntry, WorkloadResult,
                                      structural_signature)

# the estimator's machine model: one representative scheme (heterogeneous
# MIMD — per-hart SPMI — because packing decisions are per-hart)
_EST_CFG = KlessydraConfig("sched_est", M=3, F=1, D=4, spm_kbytes=64)


def simulated_profile(program: KviProgram,
                      cfg: Optional[KlessydraConfig] = None,
                      trace_cache: Optional[TraceCache] = None,
                      ) -> Dict[str, int]:
    """Solo cycle profile of one program on one hart (no contention):
    ``{"cycles", "busy", "stall", "idle"}`` — the per-request cost the
    scheduler packs with and the serving engine attributes to harts.

    The lower is timing-only (no ``mem_init`` copies — simulation never
    reads buffer contents), and a :class:`TraceCache` shares the SPM
    allocation with every other estimator/profiler call on the same
    program object, so admission never repeats the linear scan per
    request wave."""
    from repro_torch.core.simulator import simulate
    cfg = cfg or _EST_CFG
    if trace_cache is not None:
        trace = trace_cache.lower(program, cfg, functional=False)
    else:
        trace = lower(program, cfg, functional=False)
    sim = simulate(cfg, [trace.items])
    h = sim.per_hart[0]
    return {"cycles": sim.cycles, "busy": h.busy_cycles,
            "stall": h.stall_cycles, "idle": h.idle_cycles}


def simulated_cycles(program: KviProgram,
                     cfg: Optional[KlessydraConfig] = None,
                     trace_cache: Optional[TraceCache] = None) -> int:
    """Solo cycle count of one program on one hart (no contention) — the
    scheduler's latency estimate."""
    return simulated_profile(program, cfg, trace_cache)["cycles"]


@dataclass
class Ticket:
    """One queued program and where it ended up."""

    tid: int
    program: KviProgram
    est_cycles: int = 0
    hart: Optional[int] = None           # assigned at dispatch
    start_est: int = 0                   # estimated admission cycle

    @property
    def finish_est(self) -> int:
        """Estimated completion cycle (admission + solo latency)."""
        return self.start_est + self.est_cycles


class HartScheduler:
    """Earliest-finish-first packer over ``n_harts`` hart streams.

    Two admission protocols share the estimator and the ticket log:

      * batch drain — ``submit()`` programs, then ``dispatch()`` packs
        the whole queue onto harts at once (the original protocol).
      * continuous  — ``admit(program, now)`` places one program
        immediately on the hart that frees earliest, keeping persistent
        per-hart clocks (``hart_free``) across calls. This is the
        serving engine's path: requests stream in over virtual time and
        each lands on a hart the moment it is admitted.
    """

    def __init__(self, n_harts: int = 3,
                 estimator: Optional[Callable[[KviProgram], int]] = None,
                 est_config: Optional[KlessydraConfig] = None,
                 trace_cache: Optional[TraceCache] = None, obs=None):
        self.n_harts = n_harts
        self._estimator = estimator
        self._est_cfg = est_config or _EST_CFG
        self.trace_cache = trace_cache
        # optional telemetry bundle (repro_torch.kvi.obs.Obs): ticket spans on
        # per-hart scheduler lanes + admission counters / queue gauge
        self.obs = obs
        self._est_cache: Dict[tuple, int] = {}   # structure -> cycles
        self._tids = itertools.count()
        self.queue: List[Ticket] = []
        self.dispatched: List[Ticket] = []
        # persistent per-hart busy-until clocks for admit(); dispatch()
        # keeps its own fresh heap (batch packing starts from an empty
        # machine, matching the original semantics)
        self.hart_free: List[int] = [0] * n_harts

    # ------------------------------------------------------------------
    def estimate(self, program: KviProgram) -> int:
        """Estimated solo cycles (cached per program structure)."""
        if self._estimator is not None:
            return int(self._estimator(program))
        key = structural_signature(program)
        if key not in self._est_cache:
            self._est_cache[key] = simulated_cycles(
                program, self._est_cfg, trace_cache=self.trace_cache)
        return self._est_cache[key]

    def submit(self, program: KviProgram) -> Ticket:
        """Queue one program; returns its ticket."""
        t = Ticket(next(self._tids), program, self.estimate(program))
        self.queue.append(t)
        if self.obs is not None and self.obs.enabled:
            self.obs.metrics.counter("scheduler.submitted").inc()
            self.obs.metrics.gauge("scheduler.queue_depth").set(
                len(self.queue))
        return t

    def admit(self, program: KviProgram, now: int = 0,
              est: Optional[int] = None) -> Ticket:
        """Continuous admission: place ``program`` immediately on the
        hart that frees earliest, starting no earlier than ``now`` (the
        arrival / engine-step cycle). ``est`` overrides the estimator
        (callers that profiled the structure once pass it to skip the
        per-request signature lookup). Ties break on the lowest hart
        index — deterministic for a fixed submission order."""
        est = self.estimate(program) if est is None else int(est)
        h = min(range(self.n_harts),
                key=lambda i: (self.hart_free[i], i))
        start = max(int(now), self.hart_free[h])
        t = Ticket(next(self._tids), program, est, hart=h, start_est=start)
        self.hart_free[h] = start + est
        self.dispatched.append(t)
        self._record_ticket(t)
        return t

    # ------------------------------------------------------------------
    def dispatch(self, name: str = "scheduled") -> KviWorkload:
        """Drain the queue onto harts (continuous admission): each program
        goes to the hart with the earliest estimated finish time, in
        submission order. Returns the packed workload; per-ticket ``hart``
        and ``start_est`` record the placement."""
        if not self.queue:
            raise ValueError("nothing queued")
        # (accumulated_cycles, seq, hart) min-heap = the free list ordered
        # by when each hart frees up. ``seq`` is a monotonic push counter:
        # under EQUAL finish times the hart that became free earliest (in
        # submission order of the work that freed it) wins — a stable,
        # deterministic tie-break instead of an arbitrary hart-index race.
        # Initially seq == hart index, so an empty machine fills 0,1,2,...
        loads = [(0, h, h) for h in range(self.n_harts)]
        heapq.heapify(loads)
        seq = itertools.count(self.n_harts)
        entries = []
        for t in self.queue:
            load, _, h = heapq.heappop(loads)
            t.hart, t.start_est = h, load
            heapq.heappush(loads, (load + t.est_cycles, next(seq), h))
            entries.append(WorkloadEntry(t.program, HartAssignment(h)))
            self._record_ticket(t)
        self.dispatched.extend(self.queue)
        self.queue = []
        return KviWorkload(name, tuple(entries),
                           meta={"scheduler": "earliest_finish",
                                 "n_harts": self.n_harts})

    def _record_ticket(self, t: Ticket) -> None:
        """Telemetry for one placed ticket: an estimated-occupancy span
        on the ticket's hart lane plus admission counters."""
        if self.obs is None or not self.obs.enabled:
            return
        self.obs.tracer.span(
            ("scheduler", f"hart{t.hart}"),
            getattr(t.program, "name", None) or f"ticket{t.tid}",
            t.start_est, t.est_cycles, cat="ticket",
            args={"tid": t.tid})
        self.obs.metrics.counter("scheduler.admitted").inc()
        self.obs.metrics.histogram("scheduler.est_cycles").observe(
            t.est_cycles)

    def run(self, backend, name: str = "scheduled") -> WorkloadResult:
        """Dispatch whatever is queued and execute it on ``backend``."""
        return backend.run_workload(self.dispatch(name))

    # ------------------------------------------------------------------
    @property
    def hart_loads(self) -> List[int]:
        """Estimated accumulated cycles per hart over all dispatched work."""
        loads = [0] * self.n_harts
        for t in self.dispatched:
            if t.hart is not None:
                loads[t.hart] += t.est_cycles
        return loads
