"""Budget-constrained auto-tuner: *search* the design space instead of
enumerating it.

The exhaustive sweep (:mod:`repro_torch.kvi.dse.sweep`) reproduces the
paper's 96-point comparison, but enumeration stops scaling exactly
where the ROADMAP goes next — mesh axes, fu_counts and precision
multiply the grid into thousands of points. This package inverts the
sweep into a design *question*: given an area/energy budget and a
workload mix, find the best configuration while running the
cycle-accurate simulator on as few points as possible.

The pieces:

  * :class:`~repro_torch.kvi.dse.search.sampler.CandidateSampler` — draws
    feasible points from constraint predicates
    (:class:`~repro_torch.kvi.dse.space.SpaceConstraints`) by decoding random
    flat indices (``DesignSpace.point_at``) — the grid is never
    materialized. Also the mutation/crossover operators the
    evolutionary strategy uses.
  * :class:`~repro_torch.kvi.dse.search.evaluator.TwoFidelityEvaluator` —
    the **low-fidelity** rung scores candidates purely from the
    analytic cost model (:func:`repro_torch.kvi.dse.cost.estimate_kernel`)
    plus the static SPM preflight — no lowering, no simulation,
    thousands of points per second. The **high-fidelity** rung batch-
    confirms survivors on :class:`~repro_torch.kvi.cyclesim.CycleSimBackend`
    through the existing sweep executors, persistent
    :class:`~repro_torch.kvi.dse.pointcache.PointCache` and shared
    ``TraceCache`` — revisited candidates are free across rounds.
  * :mod:`~repro_torch.kvi.dse.search.strategies` — pluggable seed-
    deterministic strategies (``random``, ``successive_halving``,
    ``evolutionary``), all emitting best-so-far trajectories.
  * :class:`~repro_torch.kvi.dse.search.result.SearchResult` — the report:
    best config, trajectory, evaluations-vs-exhaustive fraction, with
    the same canonical-JSON / volatile-scrub determinism contract as
    the sweep.
  * :func:`~repro_torch.kvi.dse.search.driver.run_search` — the driver the
    ``python -m repro_torch.kvi.dse search`` CLI and the bench harness call.

The port's copy of ``repro.kvi.dse.search``.
"""
from __future__ import annotations

from repro_torch.kvi.dse.search.driver import run_search  # noqa: F401
from repro_torch.kvi.dse.search.evaluator import (  # noqa: F401
    LowFidScore, TwoFidelityEvaluator)
from repro_torch.kvi.dse.search.result import (  # noqa: F401
    SearchResult, front_recovery)
from repro_torch.kvi.dse.search.sampler import CandidateSampler  # noqa: F401
from repro_torch.kvi.dse.search.strategies import (  # noqa: F401
    STRATEGIES, SearchBudget, StrategyRun)

__all__ = ["CandidateSampler", "TwoFidelityEvaluator", "LowFidScore",
           "SearchBudget", "StrategyRun", "STRATEGIES", "SearchResult",
           "front_recovery", "run_search"]
