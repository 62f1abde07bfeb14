"""Request-driven KVI serving engine: continuous admission onto harts,
signature batching into one walk-kernel launch per bucket, warm
launch-record reuse (the port's copy of ``repro.kvi.serving.engine``).

The engine joins the repo's three serving ingredients into one system:

  * **admission** — :class:`~repro_torch.kvi.scheduler.HartScheduler.admit`
    places each arrived request on the hart that frees earliest
    (continuous admission: no head-of-line blocking — a long matmul on
    one hart never delays convs landing on the others). Latency is
    measured in *virtual cycles*: request arrival to estimated hart
    completion, using the scheduler's solo-simulation profiles.
  * **batching** — every engine step groups the admitted wave by
    :func:`~repro_torch.kvi.workload.structural_signature` (== by template)
    and executes each group through ``TorchBackend.run_workload`` as a
    homogeneous batch: on the card one launch of the walk kernel
    (``csrc/kvi_walk.cu``) per bucket, regardless of bucket size.
  * **compiled-kernel reuse** — batch sizes are bucketed to powers of
    two (``max_batch`` cap) so the set of compiled shapes is finite, and
    every bucket is **prewarmed** before traffic: the backend's
    :class:`~repro_torch.kvi.torch_backend.KernelCache` then serves the
    whole run hit-only — steady-state traffic rebuilds nothing.

Engine time advances in *batching windows*: a step admits everything
that has arrived by ``now``, executes it, and the next step begins when
the earliest hart frees (or at the next arrival when the machine is
idle). Under load, requests accumulate during the window — batch sizes
grow with traffic, which is exactly the throughput-under-occupancy story
the paper tells at kernel granularity.

Everything except wall-clock measurements is deterministic under the
load seed: the report's cycle-domain metrics (latency percentiles,
utilization, batch histograms, cache counters) are byte-stable, which
:func:`canonical_report` exposes for the determinism gates.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.kvi.lowering import TraceCache
# the volatile-key set and scrubber live in the obs layer, as in the
# reference; SERVE_VOLATILE stays importable from here
from repro_torch.kvi.obs.scrub import SERVE_VOLATILE, scrub  # noqa: F401
from repro_torch.kvi.scheduler import HartScheduler, Ticket
from repro_torch.kvi.serving.load import KernelTemplate, RequestSpec
from repro_torch.kvi.workload import KviWorkload


def canonical_report(report: Dict[str, object]) -> str:
    """The report serialized with every wall-clock field stripped —
    byte-identical across runs for the same seed, trace and engine
    configuration (the determinism gate compares these)."""
    return json.dumps(scrub(report, SERVE_VOLATILE),
                      indent=2, sort_keys=True)


def bucket_sizes(n: int, max_batch: int) -> List[int]:
    """Greedy power-of-two split of a group of ``n`` requests into
    compiled batch-shape buckets: 13 -> [8, 4, 1] under max_batch=8.
    Bounding the shape set is what makes ahead-of-time prewarming (and
    a 100% steady-state cache hit rate) possible."""
    if n <= 0:
        return []
    sizes = []
    b = 1
    while b * 2 <= max_batch:
        b *= 2
    while n > 0:
        while b > n:
            b //= 2
        sizes.append(b)
        n -= b
    return sizes


def _percentiles(xs: Sequence[int]) -> Dict[str, int]:
    """Deterministic integer latency percentiles (nearest-rank)."""
    if not xs:
        return {"p50": 0, "p95": 0, "p99": 0, "mean": 0, "max": 0}
    arr = np.sort(np.asarray(xs, dtype=np.int64))
    def rank(q: float) -> int:
        return int(arr[min(len(arr) - 1,
                           max(0, int(np.ceil(q * len(arr))) - 1))])
    return {"p50": rank(0.50), "p95": rank(0.95), "p99": rank(0.99),
            "mean": int(np.floor(arr.mean())), "max": int(arr[-1])}


@dataclass
class ServedRequest:
    """One request's lifecycle through the engine."""

    rid: int
    spec: RequestSpec
    template: KernelTemplate
    ticket: Optional[Ticket] = None      # filled at admission
    step: int = -1                       # engine step that executed it

    @property
    def latency_cycles(self) -> int:
        return self.ticket.finish_est - self.spec.t


@dataclass
class StepRecord:
    """Per-step observability: admitted wave and executed buckets."""

    step: int
    now: int
    wave_size: int
    buckets: List[int] = field(default_factory=list)
    cache_misses: int = 0


class ServeEngine:
    """The request-driven serving loop over one fixed set of harts.

    backend   — a ``TorchBackend`` (programs execute for real, on the
                card or with ``device="cpu"``; wall throughput and cache
                metrics are measured), or ``None`` for schedule-only runs
                (tests, trace analysis — all cycle-domain metrics still
                produced).
    batching  — ``False`` degrades every group to one-request-at-a-time
                execution (the baseline the ≥2x benchmark gate compares
                against). The virtual-time schedule is identical either
                way; only wall-clock execution differs.
    max_batch — compiled batch-shape cap (power of two).
    """

    def __init__(self, templates: Dict[str, KernelTemplate],
                 n_harts: int = 3, backend=None, batching: bool = True,
                 max_batch: int = 8, seed: int = 0, prewarm: bool = True,
                 trace_cache: Optional[TraceCache] = None, obs=None):
        if max_batch < 1 or (max_batch & (max_batch - 1)) != 0:
            raise ValueError(f"max_batch must be a power of two, "
                             f"got {max_batch}")
        self.templates = dict(templates)
        self.backend = backend
        self.batching = batching
        self.max_batch = max_batch
        self.seed = seed
        self.prewarm = prewarm
        # optional telemetry bundle (repro_torch.kvi.obs.Obs): request flows,
        # step/wall spans and latency metrics; shared with the scheduler
        # so ticket spans land in the same trace
        self.obs = obs
        self.scheduler = HartScheduler(
            n_harts=n_harts,
            trace_cache=trace_cache if trace_cache is not None
            else TraceCache(), obs=obs)
        self.requests: List[ServedRequest] = []
        self.steps: List[StepRecord] = []
        self._warm_rids = 0              # prewarm instance counter

    # ------------------------------------------------------------------
    def _execute_group(self, tpl: KernelTemplate,
                       reqs: List[ServedRequest], step: StepRecord
                       ) -> None:
        """Execute one signature group as bucketed homogeneous batches
        (or one-at-a-time with ``batching=False``)."""
        sizes = bucket_sizes(len(reqs), self.max_batch) \
            if self.batching else [1] * len(reqs)
        pos = 0
        for size in sizes:
            chunk = reqs[pos:pos + size]
            pos += size
            step.buckets.append(size)
            if self.backend is None:
                continue
            programs = [r.template.instantiate(self.seed, r.rid)
                        for r in chunk]
            wl = KviWorkload.homogeneous(
                programs, name=f"serve.{tpl.name}.s{step.step}x{size}")
            res = self.backend.run_workload(wl)
            step.cache_misses += res.meta["compile_cache"]["misses"]

    def prewarm_buckets(self) -> float:
        """Ahead-of-time compile: run one throwaway batch per (template,
        bucket size) so every compiled shape the loop can request is
        already in the backend's kernel cache. Returns the wall seconds
        spent (the serving analogue of the DSE's compile/steady split)."""
        if self.backend is None:
            return 0.0
        t0 = time.perf_counter()
        buckets = [1] if not self.batching else \
            [2 ** i for i in range(self.max_batch.bit_length())
             if 2 ** i <= self.max_batch]
        for name in sorted(self.templates):
            tpl = self.templates[name]
            for size in buckets:
                programs = []
                for _ in range(size):
                    # prewarm rids live far above real ones (2**48 + k):
                    # data contents are irrelevant, only shapes compile
                    programs.append(tpl.instantiate(
                        self.seed, 2 ** 48 + self._warm_rids))
                    self._warm_rids += 1
                self.backend.run_workload(KviWorkload.homogeneous(
                    programs, name=f"prewarm.{tpl.name}.x{size}"))
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    def run(self, specs: Sequence[RequestSpec]) -> Dict[str, object]:
        """Serve the whole arrival stream; returns the report dict
        (see :meth:`report`)."""
        t_engine = time.perf_counter()
        obs_on = self.obs is not None and self.obs.enabled
        req_base = len(self.requests)    # flow-id offset across runs
        step_base = len(self.steps)
        specs = sorted(specs, key=lambda s: (s.t,))
        reqs = []
        for rid, s in enumerate(specs):
            tpl = self.templates.get(s.template_key)
            if tpl is None:
                raise KeyError(
                    f"request {rid} wants template {s.template_key!r}; "
                    f"engine serves {sorted(self.templates)}")
            reqs.append(ServedRequest(rid, s, tpl))
        pw_start = self.obs.tracer.wall_us() if obs_on else 0.0
        prewarm_s = self.prewarm_buckets() if self.prewarm else 0.0
        if obs_on and prewarm_s:
            self.obs.tracer.wall_span(("serving", "wall"), "prewarm",
                                      pw_start)

        execute_s = 0.0
        i = 0
        now = 0
        step_no = 0
        sched = self.scheduler
        while i < len(reqs):
            if reqs[i].spec.t > now:
                # machine idle until the next arrival
                now = reqs[i].spec.t
            wave = []
            while i < len(reqs) and reqs[i].spec.t <= now:
                wave.append(reqs[i])
                i += 1
            step = StepRecord(step_no, now, len(wave))
            # continuous admission: earliest-finish-first, arrival order
            for r in wave:
                r.ticket = sched.admit(r.template.program, now=now,
                                       est=r.template.est_cycles)
                r.step = step_no
            # signature batching: one homogeneous batch per template
            groups: Dict[str, List[ServedRequest]] = {}
            for r in wave:
                groups.setdefault(r.template.name, []).append(r)
            t0 = time.perf_counter()
            ex_start = self.obs.tracer.wall_us() if obs_on else 0.0
            for name in sorted(groups):
                self._execute_group(self.templates[name], groups[name],
                                    step)
            execute_s += time.perf_counter() - t0
            if obs_on and self.backend is not None and groups:
                self.obs.tracer.wall_span(
                    ("serving", "wall"), f"execute.step{step_no}",
                    ex_start, args={"wave": len(wave)})
            self.steps.append(step)
            step_no += 1
            if i < len(reqs):
                # next batching window opens when the earliest hart
                # frees; arrivals in between accumulate into the wave
                now = max(now, min(sched.hart_free))
        self.requests.extend(reqs)
        report = self.report(prewarm_s=prewarm_s, execute_s=execute_s,
                             engine_s=time.perf_counter() - t_engine)
        if obs_on:
            self._emit_telemetry(reqs, req_base, step_base, report)
        return report

    def _emit_telemetry(self, reqs: List[ServedRequest], req_base: int,
                        step_base: int, report: Dict[str, object]) -> None:
        """One run's worth of cycle-domain telemetry: per-request flow
        arrows (arrival -> hart admission -> estimated completion),
        batching-window spans, and the latency/throughput metrics. The
        flow events alone reconstruct the report's makespan and latency
        percentiles — ``python -m repro_torch.kvi.obs view`` recomputes them
        and the tests cross-check against this report."""
        tr = self.obs.tracer
        for r in reqs:
            fid = req_base + r.rid
            hart_track = ("scheduler", f"hart{r.ticket.hart}")
            tr.flow_start(("serving", "arrivals"), f"req{fid}",
                          r.spec.t, fid,
                          args={"template": r.template.name,
                                "client": r.spec.client})
            tr.flow_step(hart_track, f"req{fid}", r.ticket.start_est, fid)
            tr.flow_end(hart_track, f"req{fid}", r.ticket.finish_est, fid)
        makespan = report["throughput"]["makespan_cycles"]
        new_steps = self.steps[step_base:]
        for j, s in enumerate(new_steps):
            end = new_steps[j + 1].now if j + 1 < len(new_steps) \
                else max(makespan, s.now)
            tr.span(("serving", "steps"), f"step{s.step}", s.now,
                    max(0, end - s.now), cat="step",
                    args={"wave": s.wave_size,
                          "buckets": list(s.buckets)})

        m = self.obs.metrics
        m.counter("serving.requests").inc(len(reqs))
        m.counter("serving.steps").inc(len(new_steps))
        hist = m.histogram("serving.latency_cycles")
        for r in reqs:
            hist.observe(r.latency_cycles)
        m.gauge("serving.makespan_cycles").set(makespan)
        cc = report.get("compile_cache")
        if cc:
            m.absorb("serving.compile_cache",
                     {k: cc[k] for k in ("hits", "misses", "entries",
                                         "loop_misses")})

    # ------------------------------------------------------------------
    def report(self, prewarm_s: float = 0.0, execute_s: float = 0.0,
               engine_s: float = 0.0) -> Dict[str, object]:
        """The serving metrics dict, with the keys of the reference's
        ``BENCH_kvi_serve.json`` (wall fields are the
        :data:`SERVE_VOLATILE` set; everything else is deterministic under
        the load seed)."""
        reqs = self.requests
        n = len(reqs)
        makespan = max((r.ticket.finish_est for r in reqs), default=0)
        latencies = [r.latency_cycles for r in reqs]

        # per-hart busy/stall/idle attribution from the solo profiles
        n_harts = self.scheduler.n_harts
        busy = [0] * n_harts
        stall = [0] * n_harts
        occupied = [0] * n_harts
        for r in reqs:
            h = r.ticket.hart
            busy[h] += r.template.profile["busy"]
            stall[h] += r.template.profile["stall"]
            occupied[h] += r.ticket.est_cycles
        harts = []
        for h in range(n_harts):
            idle = makespan - busy[h] - stall[h]
            harts.append({
                "busy": busy[h], "stall": stall[h], "idle": idle,
                "total": makespan,
                "utilization": round(busy[h] / makespan, 4)
                if makespan else 0.0,
                "occupancy": round(occupied[h] / makespan, 4)
                if makespan else 0.0})

        per_template: Dict[str, Dict[str, object]] = {}
        for name in sorted(self.templates):
            sub = [r.latency_cycles for r in reqs
                   if r.template.name == name]
            per_template[name] = {
                "n": len(sub),
                "est_cycles": self.templates[name].est_cycles,
                "latency_cycles": _percentiles(sub)}

        wave_hist: Dict[str, int] = {}
        batch_hist: Dict[str, int] = {}
        loop_misses = 0
        last_miss_step = -1
        for s in self.steps:
            wave_hist[str(s.wave_size)] = \
                wave_hist.get(str(s.wave_size), 0) + 1
            for b in s.buckets:
                batch_hist[str(b)] = batch_hist.get(str(b), 0) + 1
            if s.cache_misses:
                loop_misses += s.cache_misses
                last_miss_step = s.step

        compile_cache = None
        if self.backend is not None:
            stats = self.backend.kernel_cache.stats
            served = stats["hits"] + stats["misses"]
            compile_cache = {
                "hits": stats["hits"], "misses": stats["misses"],
                "entries": stats["entries"],
                "loop_misses": loop_misses,
                "last_miss_step": last_miss_step,
                # the acceptance gate: with prewarming, the serving loop
                # itself never compiles — hit rate 1.0 in steady state
                "steady_hit_rate": 1.0 if loop_misses == 0 else round(
                    1.0 - loop_misses / max(served, 1), 4)}

        throughput = {
            "requests": n,
            "makespan_cycles": makespan,
            "req_per_kcycle": round(1000.0 * n / makespan, 4)
            if makespan else 0.0,
        }
        if self.backend is not None:
            throughput["execute_s"] = round(execute_s, 4)
            throughput["prewarm_s"] = round(prewarm_s, 4)
            throughput["req_per_s"] = round(n / execute_s, 2) \
                if execute_s > 0 else 0.0

        report = {
            "engine": {
                "n_harts": n_harts,
                "batching": self.batching,
                "max_batch": self.max_batch,
                "prewarm": self.prewarm,
                "backend": getattr(self.backend, "name", None),
                "seed": self.seed,
                "templates": {name: self.templates[name].as_dict()
                              for name in sorted(self.templates)},
            },
            "n_steps": len(self.steps),
            "throughput": throughput,
            "latency_cycles": _percentiles(latencies),
            "per_template": per_template,
            "hart_utilization": harts,
            "wave_sizes": wave_hist,
            "batch_sizes": batch_hist,
            "engine_s": round(engine_s, 4),
        }
        if compile_cache is not None:
            report["compile_cache"] = compile_cache
        if n:
            report["clients"] = len({r.spec.client for r in reqs})
        return report
