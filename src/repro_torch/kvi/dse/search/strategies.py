"""Pluggable search strategies: random screening, successive halving,
evolutionary. All seed-deterministic — every random decision flows from
the one ``random.Random`` the driver seeds — and all two-fidelity:
candidates are scored by the analytic model first and only survivors
spend cycle-accurate simulations, so each strategy operates under a
hard ``max_high_evals`` budget.

The shared geometry: the low-fidelity objective tuple ``(mix cycles,
area, mix energy)`` carries *exact* area (same closed form as high
fidelity) but *estimated* cycles/energy, so survivor selection uses
**ε-relaxed dominance** — a candidate is culled only when another
candidate beats it by more than the estimator's error margin in the
estimated coordinates (and outright in exact area). Layer-peeling this
relaxed dominance gives the successive-halving rungs; the ε=0 special
case is ordinary non-dominated sorting.

The port's copy of ``repro.kvi.dse.search.strategies``.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.kvi.dse.pareto import pareto_front
from repro_torch.kvi.dse.search.evaluator import (LowFidScore,
                                                  TwoFidelityEvaluator)
from repro_torch.kvi.dse.search.sampler import CandidateSampler
from repro_torch.kvi.dse.sweep import PointRecord

#: default ε of the relaxed low-fidelity dominance: the estimator's
#: observed per-scheme error band is ~7% (see the calibration note in
#: :data:`repro_torch.kvi.dse.cost.CALIBRATION`); 2% on top of layer peeling
#: keeps every true front member in the first rung on the smoke space
#: while culling ~60% of candidates before any simulation.
DEFAULT_EPS = 0.02


@dataclass(frozen=True)
class SearchBudget:
    """What a search may spend. ``max_high_evals`` is the hard
    cycle-accurate budget (the scarce resource); ``pool`` bounds the
    candidate set strategies screen analytically (default
    ``min(grid, 8 * max_high_evals)``); ``eps`` relaxes low-fidelity
    dominance; ``population`` / ``generations`` shape the evolutionary
    loop."""

    max_high_evals: int
    pool: Optional[int] = None
    eps: float = DEFAULT_EPS
    population: int = 12
    generations: int = 8

    def pool_size(self, grid: int) -> int:
        if self.pool is not None:
            return min(self.pool, grid)
        return min(grid, 8 * max(self.max_high_evals, 1))

    def as_dict(self) -> dict:
        return {"max_high_evals": self.max_high_evals,
                "pool": self.pool, "eps": self.eps,
                "population": self.population,
                "generations": self.generations}


@dataclass
class StrategyRun:
    """What a strategy hands back: confirmed records in confirmation
    order, the best-so-far trajectory (one entry per confirmation
    round) and per-rung evaluation accounting."""

    confirmed: List[PointRecord] = field(default_factory=list)
    trajectory: List[dict] = field(default_factory=list)
    rungs: List[dict] = field(default_factory=list)

    def best(self, evaluator: TwoFidelityEvaluator
             ) -> Optional[PointRecord]:
        """The budget-feasible best config: minimal workload-mix
        cycles among confirmed points (ties to smaller area, then
        name — fully deterministic)."""
        ok = [r for r in self.confirmed if r.ok]
        if not ok:
            return None
        return min(ok, key=lambda r: (*evaluator.objectives(r)[:2],
                                      r.point.name))

    def front(self, evaluator: TwoFidelityEvaluator
              ) -> List[PointRecord]:
        ok = [r for r in self.confirmed if r.ok]
        return pareto_front(ok, key=evaluator.objectives)


# ---------------------------------------------------------------------------
# ε-relaxed dominance over low-fidelity scores
# ---------------------------------------------------------------------------


def _eps_dominates(a, b, eps: float) -> bool:
    """``a`` ε-dominates ``b``: at least as good everywhere even after
    handicapping a's *estimated* coordinates by (1+eps) — area (index
    1) is exact and compares directly — and strictly better somewhere
    at face value."""
    return (a[1] <= b[1]
            and a[0] * (1.0 + eps) <= b[0]
            and a[2] * (1.0 + eps) <= b[2]
            and (a[0] < b[0] or a[1] < b[1] or a[2] < b[2]))


def eps_peel(scores: Sequence[LowFidScore],
             eps: float) -> List[List[LowFidScore]]:
    """Layer-peel feasible scores by ε-relaxed dominance: layer 0 is
    everything not ε-dominated (a superset of the est-Pareto front that
    absorbs the estimator's error band), layer 1 the same after
    removing layer 0, and so on. Infeasible scores are dropped. Each
    layer is sorted by (mix cycles, area, name) so downstream
    truncation is deterministic."""
    remaining = [s for s in scores if s.feasible]
    layers: List[List[LowFidScore]] = []
    while remaining:
        layer = [s for s in remaining
                 if not any(_eps_dominates(o.objectives, s.objectives,
                                           eps)
                            for o in remaining if o is not s)]
        if not layer:                    # cannot happen (minima stay);
            layer = list(remaining)      # guard against degeneracy
        key = {id(s) for s in layer}
        remaining = [s for s in remaining if id(s) not in key]
        layer.sort(key=lambda s: (s.objectives[0], s.objectives[1],
                                  s.point.name))
        layers.append(layer)
    return layers


# ---------------------------------------------------------------------------
# The strategy loop harness
# ---------------------------------------------------------------------------


class _Harness:
    """Budget bookkeeping + trajectory recording shared by all
    strategies."""

    def __init__(self, evaluator: TwoFidelityEvaluator,
                 budget: SearchBudget, obs=None):
        self.ev = evaluator
        self.budget = budget
        self.obs = obs
        self.run = StrategyRun()
        self._confirmed_names: set = set()

    @property
    def remaining(self) -> int:
        return self.budget.max_high_evals - self.ev.high_evals

    def confirm(self, points, label: str) -> List[PointRecord]:
        """Confirm up to ``remaining`` new points; record the rung and
        the best-so-far trajectory sample."""
        new = [p for p in points if p.name not in self._confirmed_names]
        new = new[:max(self.remaining, 0)]
        if not new:
            return []
        recs = self.ev.high_fid(new, label=label)
        fresh_recs = [r for r in recs
                      if r.point.name not in self._confirmed_names]
        for r in fresh_recs:
            self._confirmed_names.add(r.point.name)
        self.run.confirmed.extend(fresh_recs)
        self.run.rungs.append({"rung": label,
                               "requested": len(new),
                               "high_evals": self.ev.high_evals,
                               "low_evals": self.ev.low_evals})
        best = self.run.best(self.ev)
        entry = {"high_evals": self.ev.high_evals,
                 "best_point": best.point.name if best else None,
                 "best_mix_cycles": round(
                     self.ev.objectives(best)[0], 3) if best else None,
                 "front_size": len(self.run.front(self.ev))}
        self.run.trajectory.append(entry)
        if self.obs is not None and self.obs.enabled:
            m = self.obs.metrics
            m.counter("dse.search.confirmations").inc(len(new))
            if best is not None:
                m.gauge("dse.search.best_mix_cycles").set(
                    entry["best_mix_cycles"])
        return fresh_recs

    def front_names(self) -> set:
        return {r.point.name for r in self.run.front(self.ev)}


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------


def _screen(sampler: CandidateSampler, evaluator: TwoFidelityEvaluator,
            budget: SearchBudget) -> List[List[LowFidScore]]:
    """Draw the candidate pool and ε-peel its analytic scores."""
    pool = sampler.draw(budget.pool_size(sampler.grid_size))
    scores = evaluator.low_fid(pool)
    return eps_peel(scores, budget.eps)


def random_search(sampler: CandidateSampler,
                  evaluator: TwoFidelityEvaluator,
                  budget: SearchBudget, rng: random.Random,
                  obs=None) -> StrategyRun:
    """One-shot screened random search: a uniform feasible pool,
    analytically scored, and the single most promising slice (the
    ε-relaxed front, then following layers) confirmed up to budget.
    The baseline every adaptive strategy must beat."""
    h = _Harness(evaluator, budget, obs=obs)
    layers = _screen(sampler, evaluator, budget)
    flat = [s.point for layer in layers for s in layer]
    h.confirm(flat[:budget.max_high_evals], label="screen")
    return h.run


def successive_halving(sampler: CandidateSampler,
                       evaluator: TwoFidelityEvaluator,
                       budget: SearchBudget, rng: random.Random,
                       obs=None) -> StrategyRun:
    """Rung-by-rung confirmation of the ε-peeled layers: rung 0 is the
    relaxed analytic front (cheap rank → expensive confirmation of
    survivors only), each further rung the next layer. Stops when the
    budget is spent or a whole rung fails to move the confirmed Pareto
    front (deeper layers are est-dominated by *two* margins — they
    cannot plausibly improve it)."""
    h = _Harness(evaluator, budget, obs=obs)
    layers = _screen(sampler, evaluator, budget)
    for i, layer in enumerate(layers):
        if h.remaining <= 0:
            break
        before = h.front_names()
        added = h.confirm([s.point for s in layer], label=f"rung{i}")
        if i > 0 and added and h.front_names() == before:
            break
    return h.run


def evolutionary(sampler: CandidateSampler,
                 evaluator: TwoFidelityEvaluator,
                 budget: SearchBudget, rng: random.Random,
                 obs=None) -> StrategyRun:
    """A (μ+λ) loop over the confirmed front: the initial population
    seeds from the analytic ε-front (plus best-estimate fill), and each
    generation mutates/crosses parents drawn from the confirmed Pareto
    front, screening children analytically before spending sims.
    Revisited children are free (evaluator memo + point cache)."""
    h = _Harness(evaluator, budget, obs=obs)
    layers = _screen(sampler, evaluator, budget)
    flat = [s for layer in layers for s in layer]
    # seed with the whole relaxed analytic front (every candidate the
    # estimator can't rule out), topped up to `population` from the
    # next layers; confirm() truncates to the budget
    n_init = max(budget.population,
                 len(layers[0]) if layers else 0)
    h.confirm([s.point for s in flat[:n_init]], label="init")

    for gen in range(budget.generations):
        if h.remaining <= 0:
            break
        parents = [r.point for r in h.run.front(evaluator)]
        if not parents:
            break
        children: List = []
        child_names = set()
        # λ = population offspring attempts per generation
        for _ in range(budget.population):
            if len(parents) >= 2 and rng.random() < 0.5:
                p1, p2 = rng.sample(parents, 2)
                child = sampler.crossover(p1, p2)
            else:
                child = sampler.mutate(rng.choice(parents))
            if child is None or child.name in child_names \
                    or child.name in h._confirmed_names:
                continue
            child_names.add(child.name)
            children.append(child)
        if not children:
            break
        scored = evaluator.low_fid(children)
        viable = sorted((s for s in scored if s.feasible),
                        key=lambda s: (s.objectives[0],
                                       s.objectives[1], s.point.name))
        if not viable:
            continue
        added = h.confirm([s.point for s in viable],
                          label=f"gen{gen}")
        if not added:
            break
    return h.run


STRATEGIES: Dict[str, object] = {
    "random": random_search,
    "successive_halving": successive_halving,
    "evolutionary": evolutionary,
}
