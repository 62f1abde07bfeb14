"""The two-fidelity evaluator: cheap analytic scores, targeted sims.

**Low fidelity** (:meth:`TwoFidelityEvaluator.low_fid`) scores a batch
of candidates without lowering or simulating anything: per-kernel
closed-form cycle/energy estimates
(:func:`repro_torch.kvi.dse.cost.estimate_kernel` over a
:class:`~repro_torch.kvi.dse.cost.KernelProfile` built once per
``(precision, passes)`` pair), the exact analytic area, and the static
SPM preflight (:func:`repro_torch.kvi.passes.liveness.peak_live_bytes` with
the allocator's own line rounding, cached per ``(precision, passes,
D)`` since the liveness peak depends on nothing else) — thousands of
points per second.

**High fidelity** (:meth:`TwoFidelityEvaluator.high_fid`) batch-
confirms an explicit point list through the existing
:func:`repro_torch.kvi.dse.sweep.sweep` driver: the same executors, the same
persistent :class:`~repro_torch.kvi.dse.pointcache.PointCache`, the same
per-point ``TraceCache`` — so a candidate revisited in a later round
(or a later *search*) costs nothing.

Evaluation accounting draws a deliberate line:

  * ``high_evals`` — distinct points *requested* for confirmation.
    Deterministic (persistent-cache hits still count: they would be
    simulations without the store), part of the canonical report, and
    the number the "<= 50% of exhaustive" acceptance gate reads.
  * ``fresh_evals`` — points that actually ran the simulator this
    process. Volatile by definition (cold vs warm), scrubbed from
    canonical output, and the number the "warm re-search does zero
    cyclesim work" test reads.

The port's copy of ``repro.kvi.dse.search.evaluator``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.kvi.dse.cost import (KernelProfile, estimate_kernel,
                                      hardware_cost, kernel_profile)
from repro_torch.kvi.dse.space import DesignPoint
from repro_torch.kvi.dse.sweep import KernelFactory, PointRecord, sweep


@dataclass(frozen=True)
class LowFidScore:
    """One candidate's analytic scorecard. ``objectives`` mirrors the
    high-fidelity metric tuple ``(workload-mix cycles, area LUTeq,
    workload-mix energy nJ)`` — minimized, directly comparable between
    candidates (NOT between fidelities). ``None`` when the static SPM
    preflight rejected the point."""

    point: DesignPoint
    feasible: bool
    reason: Optional[str] = None
    objectives: Optional[Tuple[float, float, float]] = None
    kernels: Optional[Dict[str, Dict[str, float]]] = None


class TwoFidelityEvaluator:
    """Score cheaply, simulate rarely, remember everything.

    ``weights`` is the workload mix — kernel name -> weight in the
    scalar/mix objectives (missing kernels weigh 1.0). ``cache`` is the
    persistent point cache shared with the exhaustive sweep;
    ``executor`` / ``max_workers`` fan the confirmation batches out
    (pass a persistent :class:`~repro_torch.kvi.dse.executors.
    ProcessExecutor` to amortize pool spawn across rounds)."""

    def __init__(self, kernel_factory: KernelFactory,
                 weights: Optional[Dict[str, float]] = None,
                 composite: bool = True,
                 cache=None, executor=None, max_workers: int = 4,
                 emit=None, obs=None):
        self.kernel_factory = kernel_factory
        self.weights = dict(weights or {})
        self.composite = composite
        self.cache = cache
        self.executor = executor
        self.max_workers = max_workers
        self.emit = emit
        self.obs = obs
        self.low_evals = 0
        self.high_evals = 0
        self.fresh_evals = 0
        self._records: Dict[str, PointRecord] = {}
        self._profiles: Dict[tuple, Dict[str, KernelProfile]] = {}
        self._spm_peaks: Dict[tuple, int] = {}
        self._low_seen: set = set()
        # program/fingerprint reuse across every high-fid round
        self._shared_opt: dict = {}

    # -- shared program/profile caches ------------------------------------

    def _programs_for(self, precision_bits: int, passes) -> Dict[str, object]:
        """The optimized programs of one (precision, passes) class —
        the exact objects ``sweep`` would build, via the same shared
        cache, so profiles and simulations agree."""
        from repro_torch.kvi.dse.sweep import optimize_kernels
        raw = self._shared_opt.setdefault("raw", {})
        if precision_bits not in raw:
            raw[precision_bits] = self.kernel_factory(precision_bits)
        opt = self._shared_opt.setdefault("opt", {})
        key = (precision_bits, passes)
        if key not in opt:
            opt[key] = optimize_kernels(raw[precision_bits], passes)
        return opt[key]

    def _profiles_for(self, precision_bits: int,
                      passes) -> Dict[str, KernelProfile]:
        key = (precision_bits, passes)
        if key not in self._profiles:
            self._profiles[key] = {
                name: kernel_profile(p)
                for name, p in self._programs_for(precision_bits,
                                                  passes).items()}
        return self._profiles[key]

    def _spm_peak(self, precision_bits: int, passes, D: int) -> int:
        """Max over kernels of the allocator's liveness peak — depends
        only on the programs and the line width (D), never on SPM
        capacity, so one number serves every capacity on the axis."""
        key = (precision_bits, passes, D)
        if key not in self._spm_peaks:
            from repro_torch.kvi.passes.liveness import peak_live_bytes
            line = max(D * 4, 4)
            self._spm_peaks[key] = max(
                peak_live_bytes(p, line, pin_uninitialized=True)
                for p in self._programs_for(precision_bits,
                                            passes).values())
        return self._spm_peaks[key]

    # -- objectives --------------------------------------------------------

    def _mix(self, per_kernel: Dict[str, Dict[str, float]],
             cycles_key: str, energy_key: str) -> Tuple[float, float]:
        c = sum(self.weights.get(k, 1.0) * float(v[cycles_key])
                for k, v in per_kernel.items())
        e = sum(self.weights.get(k, 1.0) * float(v[energy_key])
                for k, v in per_kernel.items())
        return c, e

    def objectives(self, rec: PointRecord
                   ) -> Tuple[float, float, float]:
        """High-fidelity metric tuple of a confirmed record:
        (mix cycles, area LUTeq, mix energy nJ), minimized."""
        c, e = self._mix(rec.kernels, "cycles", "energy_nj")
        return (c, rec.area.area_luteq, e)

    # -- low fidelity ------------------------------------------------------

    def low_fid(self, points: Sequence[DesignPoint]
                ) -> List[LowFidScore]:
        """Analytic scores for a candidate batch (order-preserving).
        Pure closed-form: cost-model estimates + static SPM preflight.
        First-time points count toward ``low_evals``."""
        out: List[LowFidScore] = []
        for pt in points:
            if pt.name not in self._low_seen:
                self._low_seen.add(pt.name)
                self.low_evals += 1
            cfg = pt.config()
            peak = self._spm_peak(pt.precision_bits, pt.passes, pt.D)
            if peak > cfg.spm_capacity_bytes:
                out.append(LowFidScore(
                    pt, False,
                    reason=f"static SPM overflow: peak-live {peak} B > "
                           f"capacity {cfg.spm_capacity_bytes} B"))
                continue
            profiles = self._profiles_for(pt.precision_bits, pt.passes)
            per = {name: estimate_kernel(prof, cfg,
                                         chaining=pt.chaining)
                   for name, prof in profiles.items()}
            c, e = self._mix(per, "est_cycles", "est_energy_nj")
            out.append(LowFidScore(
                pt, True,
                objectives=(c, hardware_cost(cfg).area_luteq, e),
                kernels=per))
        return out

    # -- high fidelity -----------------------------------------------------

    def high_fid(self, points: Sequence[DesignPoint],
                 label: str = "confirm") -> List[PointRecord]:
        """Cycle-accurate confirmation of ``points`` (order-preserving;
        duplicates and previously-confirmed points served from the
        in-run memo for free). ``label`` names the round in the point
        cache's per-round accounting."""
        todo, seen_batch = [], set()
        for pt in points:
            if pt.name in self._records or pt.name in seen_batch:
                continue
            seen_batch.add(pt.name)
            todo.append(pt)
        if todo:
            self.high_evals += len(todo)
            if self.cache is not None:
                self.cache.begin_round(label)
            result = sweep(todo, self.kernel_factory,
                           composite=self.composite,
                           max_workers=self.max_workers,
                           executor=self.executor, cache=self.cache,
                           emit=None, obs=self.obs,
                           shared_opt_cache=self._shared_opt)
            for rec in result.records:
                self._records[rec.point.name] = rec
                if not rec.cached:
                    self.fresh_evals += 1
            if self.emit:
                n_fresh = sum(not r.cached for r in result.records)
                self.emit(f"search[{label}] confirmed {len(todo)} "
                          f"points ({n_fresh} fresh sims)")
        return [self._records[pt.name] for pt in points
                if pt.name in self._records]

    def record(self, name: str) -> Optional[PointRecord]:
        return self._records.get(name)

    @property
    def confirmed(self) -> Dict[str, PointRecord]:
        """Every confirmed record so far (name -> record)."""
        return dict(self._records)

    @property
    def stats(self) -> Dict[str, int]:
        return {"low_evals": self.low_evals,
                "high_evals": self.high_evals,
                "fresh_evals": self.fresh_evals}
