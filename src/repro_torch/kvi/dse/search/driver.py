"""The search driver: wire sampler + evaluator + strategy, report.

:func:`run_search` is what the ``python -m repro_torch.kvi.dse search`` CLI
and the bench harness call. It owns the run-level policy the pieces
deliberately don't:

  * **seeding** — one ``random.Random(seed)`` feeds the sampler and
    the strategy; nothing else in the stack touches randomness, so a
    (space, strategy, seed, budget) tuple fully determines the search.
  * **executor lifecycle** — confirmation batches are small and
    repeated, so ``auto`` resolves once for the whole search (serial
    under :data:`~repro_torch.kvi.dse.executors.AUTO_SERIAL_MAX` budgeted
    sims, a *persistent* process pool above it — one spawn amortized
    over every rung) instead of per-batch like the exhaustive sweep.
  * **the exhaustive yardstick** — in smoke/validation runs it
    confirms the remaining grid afterwards (through the same evaluator,
    so the shared point cache makes the overlap free) and scores the
    search's front-recovery fraction against the true Pareto front.

Artifacts (with ``out_dir``): ``dse_search.json`` (full),
``dse_search_canonical.json`` (volatile-scrubbed bytes — what the CI
determinism gate diffs), ``dse_search.md``,
``dse_search_trajectory.svg`` and ``BENCH_torch_kvi_search.json``.

The port's copy of ``repro.kvi.dse.search.driver``.
"""
from __future__ import annotations

import json
import os
import random
import time
from typing import Callable, Dict, Optional

from repro_torch.kvi.dse.executors import (AUTO_SERIAL_MAX, ProcessExecutor,
                                           SerialExecutor, SweepExecutor,
                                           ThreadExecutor)
from repro_torch.kvi.dse.pareto import pareto_front
from repro_torch.kvi.dse.search.evaluator import TwoFidelityEvaluator
from repro_torch.kvi.dse.search.result import SearchResult, front_recovery
from repro_torch.kvi.dse.search.sampler import CandidateSampler
from repro_torch.kvi.dse.search.strategies import (DEFAULT_EPS, STRATEGIES,
                                                   SearchBudget)
from repro_torch.kvi.dse.space import DesignSpace, SpaceConstraints

#: default high-fidelity budget: half the grid (the acceptance bar the
#: strategies must beat), floored for tiny spaces and capped so big
#: synthetic spaces don't turn "auto-tune" back into "enumerate".
MAX_DEFAULT_BUDGET = 64


def default_budget(grid: int) -> int:
    return min(MAX_DEFAULT_BUDGET, max(8, (grid + 1) // 2))


def _resolve_executor(spec, budget: int, max_workers: int):
    """(executor instance or None, owned) — resolved once per search.
    Strings mirror the sweep CLI's choices; ``auto`` keys off the
    *total* sim budget, and the process choice is persistent so rung
    after rung reuses one worker pool."""
    if isinstance(spec, SweepExecutor):
        return spec, False
    if spec in (None, "auto"):
        if budget < AUTO_SERIAL_MAX:
            return SerialExecutor(), True
        return ProcessExecutor(max_workers=max_workers,
                               persistent=True), True
    if spec == "process":
        return ProcessExecutor(max_workers=max_workers,
                               persistent=True), True
    if spec == "thread":
        return ThreadExecutor(max_workers=max_workers), True
    if spec == "serial":
        return SerialExecutor(), True
    raise ValueError(f"unknown executor {spec!r}")


def run_search(strategy: str = "successive_halving",
               smoke: bool = False, seed: int = 0,
               budget: Optional[int] = None,
               pool: Optional[int] = None,
               eps: float = DEFAULT_EPS,
               population: int = 12, generations: int = 8,
               space: Optional[DesignSpace] = None,
               constraints: Optional[SpaceConstraints] = None,
               weights: Optional[Dict[str, float]] = None,
               kernel_factory=None,
               compare_exhaustive: Optional[bool] = None,
               emit: Optional[Callable[[str], None]] = None,
               out_dir: Optional[str] = None,
               max_workers: int = 4,
               executor=None, cache=None, obs=None) -> SearchResult:
    """Search ``space`` for the best design under ``budget``
    cycle-accurate evaluations; returns a :class:`SearchResult`.

    ``compare_exhaustive`` (default: on for smoke runs, off otherwise)
    additionally confirms the full grid afterwards and records the
    front-recovery fraction + walltime-vs-exhaustive in the result —
    the numbers CI gates on. ``cache`` / ``executor`` / ``obs`` follow
    the exhaustive sweep's conventions."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"choose from {sorted(STRATEGIES)}")
    from repro_torch.kvi.dse.report import (full_space, paper_kernel_factory,
                                            smoke_space)
    space_label = "custom" if space is not None \
        else ("smoke" if smoke else "full")
    space = space or (smoke_space() if smoke else full_space())
    if kernel_factory is None:
        kernel_factory = paper_kernel_factory(smoke=smoke, seed=seed)
    if compare_exhaustive is None:
        compare_exhaustive = smoke
    grid = space.grid_size
    sbudget = SearchBudget(
        max_high_evals=budget if budget is not None
        else default_budget(grid),
        pool=pool, eps=eps, population=population,
        generations=generations)

    rng = random.Random(seed)
    sampler = CandidateSampler(space, constraints=constraints, rng=rng)
    ex, owned = _resolve_executor(executor, sbudget.max_high_evals,
                                  max_workers)
    evaluator = TwoFidelityEvaluator(
        kernel_factory, weights=weights, cache=cache, executor=ex,
        max_workers=max_workers, emit=emit, obs=obs)
    try:
        t0 = time.perf_counter()
        run = STRATEGIES[strategy](sampler, evaluator, sbudget, rng,
                                   obs=obs)
        search_wall = time.perf_counter() - t0
        # snapshot before the (optional) exhaustive yardstick inflates
        # the counters — these are the search's own numbers
        evaluations: Dict[str, object] = dict(evaluator.stats)
        evaluations["sampler"] = sampler.stats

        best = run.best(evaluator)
        front = run.front(evaluator)
        meta: Dict[str, object] = {
            "space": space_label,
            "smoke": smoke,
            "grid_size": grid,
            "budget": sbudget.as_dict(),
            "walltime_s": round(search_wall, 3),
            "executor": type(ex).__name__ if ex is not None else "auto",
        }
        if weights:
            meta["weights"] = dict(weights)
        if constraints is not None:
            meta["constraints"] = constraints.as_dict()
        meta["front_metrics"] = {
            r.point.name: [round(v, 3)
                           for v in evaluator.objectives(r)]
            for r in front}

        if compare_exhaustive:
            t1 = time.perf_counter()
            evaluator.high_fid(list(space.points()),
                               label="exhaustive")
            exhaustive_wall = time.perf_counter() - t1
            ok = [r for r in evaluator.confirmed.values() if r.ok]
            true_front = pareto_front(ok, key=evaluator.objectives)
            recovery = front_recovery(
                [evaluator.objectives(r) for r in front],
                [evaluator.objectives(r) for r in true_front])
            meta["recovery"] = {
                "front_recovery": round(recovery, 6),
                "exhaustive_front_size": len(true_front),
                "search_front_size": len(front),
                "walltime_s": round(exhaustive_wall, 3),
            }
            if emit:
                emit(f"search[{strategy}] recovered {recovery:.0%} of "
                     f"the exhaustive front with "
                     f"{evaluations['high_evals']}/{grid} sims")

        if cache is not None:
            meta["point_cache"] = cache.stats
        result = SearchResult(strategy=strategy, seed=seed, best=best,
                              front=front, trajectory=run.trajectory,
                              rungs=run.rungs,
                              evaluations=evaluations, meta=meta)
        if obs is not None and obs.enabled:
            m = obs.metrics
            m.counter("dse.search.low_evals").inc(
                evaluations["low_evals"])
            m.counter("dse.search.high_evals").inc(
                evaluations["high_evals"])
            m.gauge("dse.search.front_size").set(len(front))

        if out_dir is not None:
            _write_artifacts(result, out_dir, emit=emit)
        return result
    finally:
        if owned and ex is not None:
            ex.close()


def _write_artifacts(result: SearchResult, out_dir: str,
                     emit=None) -> None:
    from repro_torch.kvi.dse.plots import write_search_plots
    os.makedirs(out_dir, exist_ok=True)
    result.save_json(os.path.join(out_dir, "dse_search.json"))
    with open(os.path.join(out_dir, "dse_search_canonical.json"),
              "w") as f:
        f.write(result.canonical_json() + "\n")
    wrote_svg = write_search_plots(result, out_dir)
    with open(os.path.join(out_dir, "dse_search.md"), "w") as f:
        f.write(result.to_markdown())
    # cross-link: if the exhaustive sweep's report already lives here,
    # append the trajectory section it would have added itself had the
    # search run first (idempotent — skip when already linked)
    report_md = os.path.join(out_dir, "dse_report.md")
    if wrote_svg and os.path.exists(report_md):
        from repro_torch.kvi.dse.report import SEARCH_TRAJECTORY_SECTION
        with open(report_md) as f:
            body = f.read()
        if "dse_search_trajectory.svg" not in body:
            with open(report_md, "a") as f:
                f.write(SEARCH_TRAJECTORY_SECTION)
    bench = {
        "strategy": result.strategy,
        "seed": result.seed,
        "grid_size": result.meta.get("grid_size"),
        "evaluations": dict(result.evaluations),
        "exhaustive_fraction": result.exhaustive_fraction,
        "best": result.best.point.name if result.best else None,
        "front_size": len(result.front),
        "walltime_s": result.meta.get("walltime_s"),
        "rungs": list(result.rungs),
    }
    rec = result.meta.get("recovery")
    if rec:
        bench["front_recovery"] = rec["front_recovery"]
        bench["exhaustive_front_size"] = rec["exhaustive_front_size"]
        bench["exhaustive_walltime_s"] = rec["walltime_s"]
    pc = result.meta.get("point_cache")
    if pc:
        bench["point_cache"] = pc
    with open(os.path.join(out_dir, "BENCH_torch_kvi_search.json"),
              "w") as f:
        json.dump(bench, f, indent=2, sort_keys=True)
    if emit:
        emit(f"search artifacts written to {out_dir}")
