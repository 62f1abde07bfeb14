"""Search reports: what the tuner found and what it cost to find.

:class:`SearchResult` follows the same persistence contract as
:class:`~repro_torch.kvi.dse.sweep.SweepResult`: ``to_json`` carries
everything (timings included), ``canonical_json`` strips the shared
volatile-key set (:data:`repro_torch.kvi.obs.scrub.DSE_VOLATILE` — which
includes ``fresh_evals``, the cold-vs-warm simulation count) so two
seeded runs of the same search compare byte-identical regardless of
executor choice or cache temperature. The CI gate diffs those bytes.

:func:`front_recovery` is the acceptance metric: the fraction of an
exhaustive-sweep Pareto front a search's confirmed front covers,
tie-tolerant — a front member counts as recovered when some confirmed
point matches its ``(cycles, area, energy)`` within a relative
tolerance, because distinct configs can land on identical metrics.

The port's copy of ``repro.kvi.dse.search.result``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.kvi.dse.sweep import PointRecord, scrub_volatile


def front_recovery(found: Sequence[Tuple[float, float, float]],
                   reference: Sequence[Tuple[float, float, float]],
                   rel_tol: float = 1e-6) -> float:
    """Fraction of ``reference`` front metric tuples matched by some
    ``found`` tuple, coordinate-wise within ``rel_tol`` relative
    tolerance (ties between distinct configs with equal metrics count
    once — compare *metric tuples*, not point names). 1.0 for an empty
    reference."""
    ref = sorted(set(tuple(map(float, t)) for t in reference))
    if not ref:
        return 1.0
    got = [tuple(map(float, t)) for t in found]

    def close(a, b):
        return all(abs(x - y) <= rel_tol * max(abs(x), abs(y), 1.0)
                   for x, y in zip(a, b))

    hit = sum(1 for r in ref if any(close(g, r) for g in got))
    return hit / len(ref)


@dataclass
class SearchResult:
    """One search run, JSON-persistable.

    ``best`` / ``front`` hold confirmed :class:`PointRecord` objects
    (full cycle-accurate measurements — a search never reports
    estimates as results). ``evaluations`` separates the deterministic
    budget accounting (``low_evals`` / ``high_evals`` / per-rung
    ``rungs``) from the volatile ``fresh_evals``; ``meta`` carries the
    run shape (strategy, seed, budget, space size, walltime)."""

    strategy: str
    seed: int
    best: Optional[PointRecord]
    front: List[PointRecord]
    trajectory: List[dict] = field(default_factory=list)
    rungs: List[dict] = field(default_factory=list)
    evaluations: Dict[str, object] = field(default_factory=dict)
    meta: Dict[str, object] = field(default_factory=dict)

    @property
    def exhaustive_fraction(self) -> Optional[float]:
        """high-fidelity evaluations as a fraction of the full grid —
        the headline "searched, didn't enumerate" number."""
        grid = self.meta.get("grid_size")
        if not grid:
            return None
        return float(self.evaluations.get("high_evals", 0)) / grid

    def front_metrics(self, objectives) -> List[Tuple[float, float, float]]:
        return [objectives(r) for r in self.front]

    def to_json(self) -> Dict[str, object]:
        frac = self.exhaustive_fraction
        return {
            "strategy": self.strategy,
            "seed": self.seed,
            "best": self.best.as_dict() if self.best else None,
            "front": [r.as_dict() for r in self.front],
            "trajectory": list(self.trajectory),
            "rungs": list(self.rungs),
            "evaluations": dict(
                self.evaluations,
                exhaustive_fraction=round(frac, 6)
                if frac is not None else None),
            "meta": dict(self.meta),
        }

    def canonical_json(self) -> str:
        """The search serialized with every volatile field stripped —
        byte-identical for the same (space, strategy, seed, budget)
        across executors and cache temperatures."""
        return json.dumps(scrub_volatile(self.to_json()), indent=2,
                          sort_keys=True)

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    def to_markdown(self) -> str:
        """Human summary for ``dse_search.md``."""
        lines = [
            "# KVI design-space search",
            "",
            f"- strategy: `{self.strategy}` (seed {self.seed})",
            f"- space: {self.meta.get('grid_size', '?')} points "
            f"({self.meta.get('space', 'custom')})",
        ]
        ev = self.evaluations
        frac = self.exhaustive_fraction
        lines.append(
            f"- evaluations: {ev.get('low_evals', 0)} analytic, "
            f"{ev.get('high_evals', 0)} cycle-accurate"
            + (f" ({frac:.1%} of exhaustive)" if frac is not None
               else ""))
        if self.best is not None:
            lines.append(f"- best: `{self.best.point.name}`")
        lines += ["", "## Confirmed Pareto front", "",
                  "| point | mix cycles | area (LUTeq) | mix energy (nJ) |",
                  "|---|---|---|---|"]
        for r in self.front:
            row = self.meta.get("front_metrics", {}).get(r.point.name)
            if row:
                lines.append(f"| `{r.point.name}` | {row[0]:.1f} | "
                             f"{row[1]:.0f} | {row[2]:.1f} |")
            else:
                lines.append(f"| `{r.point.name}` | | | |")
        lines += ["", "## Trajectory", "",
                  "| high-fid evals | best point | best mix cycles | front size |",
                  "|---|---|---|---|"]
        for t in self.trajectory:
            lines.append(f"| {t['high_evals']} | "
                         f"`{t.get('best_point')}` | "
                         f"{t.get('best_mix_cycles')} | "
                         f"{t.get('front_size')} |")
        lines.append("")
        lines.append("![search trajectory](dse_search_trajectory.svg)")
        lines.append("")
        return "\n".join(lines)
