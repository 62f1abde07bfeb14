"""Feasible-candidate sampling without materializing the grid.

:class:`CandidateSampler` is the search tuner's only source of design
points. It draws uniform flat indices into the
:class:`~repro_torch.kvi.dse.space.DesignSpace` mixed-radix grid
(``point_at`` decodes them in O(1)) and keeps only points the
:class:`~repro_torch.kvi.dse.space.SpaceConstraints` accept — so a
5000-point synthetic space with a tight area budget costs rejection
checks (closed-form cost model, microseconds each), never an
enumeration. When rejection sampling stalls (tiny feasible region or
the sampler has already seen most of the grid) it falls back to one
deterministic shuffled scan of the remaining indices, so ``draw``
terminates on any space.

The evolutionary strategy's variation operators live here too —
:meth:`mutate` re-draws one axis of a point (scheme moves re-draw the
scheme-coupled ``(M, F)`` pair and ``fu_counts`` with it) and
:meth:`crossover` mixes two parents axis-wise — because the sampler is
the one object that knows the space's axes *and* the feasibility
predicate. All randomness flows from the one ``random.Random`` handed
in by the driver: no module-level RNG anywhere in the search stack.

The port's copy of ``repro.kvi.dse.search.sampler``.
"""
from __future__ import annotations

import random
from typing import List, Optional, Set

from repro_torch.kvi.dse.space import (DesignPoint, DesignSpace,
                                       SpaceConstraints)

#: rejection-sampling attempts per requested point before falling back
#: to the deterministic shuffled scan of all unseen indices.
ATTEMPTS_PER_DRAW = 64


class CandidateSampler:
    """Draw distinct feasible points; mutate/cross them for evolution.

    ``seen`` persists across :meth:`draw` calls — a sampler never
    returns the same point twice, which is what lets strategies treat
    successive draws as a growing candidate pool."""

    def __init__(self, space: DesignSpace,
                 constraints: Optional[SpaceConstraints] = None,
                 rng: Optional[random.Random] = None):
        self.space = space
        self.constraints = constraints
        self.rng = rng if rng is not None else random.Random(0)
        self.attempts = 0            # indices drawn (incl. rejected)
        self.rejections = 0          # infeasible / duplicate draws
        self._seen_idx: Set[int] = set()
        self._seen_names: Set[str] = set()

    # -- feasibility ------------------------------------------------------

    def feasible(self, point: DesignPoint) -> bool:
        return self.constraints is None \
            or self.constraints.feasible(point)

    @property
    def grid_size(self) -> int:
        return self.space.grid_size

    # -- drawing ----------------------------------------------------------

    def _admit(self, point: DesignPoint) -> bool:
        if point.name in self._seen_names or not self.feasible(point):
            self.rejections += 1
            return False
        self._seen_names.add(point.name)
        return True

    def draw(self, n: int) -> List[DesignPoint]:
        """Up to ``n`` new distinct feasible points (fewer only when
        the feasible region is exhausted). Uniform over the unseen
        feasible grid in the rejection phase; the shuffled-scan
        fallback preserves determinism but not uniformity."""
        out: List[DesignPoint] = []
        grid = self.space.grid_size
        budget = ATTEMPTS_PER_DRAW * max(n, 1)
        while len(out) < n and budget > 0 \
                and len(self._seen_idx) < grid:
            budget -= 1
            self.attempts += 1
            idx = self.rng.randrange(grid)
            if idx in self._seen_idx:
                self.rejections += 1
                continue
            self._seen_idx.add(idx)
            pt = self.space.point_at(idx)
            if self._admit(pt):
                out.append(pt)
        if len(out) < n and len(self._seen_idx) < grid:
            # deterministic fallback: scan the unseen remainder once,
            # in rng-shuffled order
            rest = [i for i in range(grid) if i not in self._seen_idx]
            self.rng.shuffle(rest)
            for idx in rest:
                self._seen_idx.add(idx)
                pt = self.space.point_at(idx)
                if self._admit(pt):
                    out.append(pt)
                    if len(out) >= n:
                        break
        return out

    # -- variation operators (evolutionary strategy) ----------------------

    def _axis_choices(self, point: DesignPoint) -> List[str]:
        """Axes that have somewhere to move for this point."""
        sp = self.space
        axes: List[str] = []
        if len(sp.schemes) > 1:
            axes.append("scheme")
        if len(sp._mf_pairs(point.scheme)) > 1:
            axes.append("mf")
        if len(sp.lanes) > 1:
            axes.append("lanes")
        if len(sp.precisions) > 1:
            axes.append("precision")
        if len(sp.spm_kbytes) > 1:
            axes.append("spm")
        if len(sp.chaining) > 1:
            axes.append("chaining")
        if len(sp.pipelines) > 1:
            axes.append("pipeline")
        if len(sp._scheme_fus(point.scheme)) > 1:
            axes.append("fu")
        return axes

    def _rebuild(self, **kw) -> Optional[DesignPoint]:
        try:
            return DesignPoint(**kw)
        except ValueError:
            return None

    def _as_kwargs(self, point: DesignPoint) -> dict:
        return {"scheme": point.scheme, "M": point.M, "F": point.F,
                "D": point.D, "precision_bits": point.precision_bits,
                "spm_kbytes": point.spm_kbytes,
                "chaining": point.chaining,
                "fu_counts": point.fu_counts, "passes": point.passes}

    def _other(self, options, current):
        options = [o for o in options if o != current]
        return self.rng.choice(options) if options else current

    def mutate(self, point: DesignPoint,
               max_tries: int = 8) -> Optional[DesignPoint]:
        """A feasible neighbor differing from ``point`` in one axis
        (scheme moves also re-draw the coupled ``(M, F)`` pair and
        ``fu_counts``), or ``None`` when ``max_tries`` mutations all
        land infeasible. Already-seen names are allowed — the
        strategy's confirmed-set dedup handles revisits (they are free
        through the evaluator's memo anyway)."""
        sp = self.space
        axes = self._axis_choices(point)
        if not axes:
            return None
        for _ in range(max_tries):
            kw = self._as_kwargs(point)
            axis = self.rng.choice(axes)
            if axis == "scheme":
                scheme = self._other(list(sp.schemes), point.scheme)
                m, f = self.rng.choice(sp._mf_pairs(scheme))
                kw.update(scheme=scheme, M=m, F=f,
                          fu_counts=self.rng.choice(
                              sp._scheme_fus(scheme)))
            elif axis == "mf":
                m, f = self._other(sp._mf_pairs(point.scheme),
                                   (point.M, point.F))
                kw.update(M=m, F=f)
            elif axis == "lanes":
                kw["D"] = self._other(list(sp.lanes), point.D)
            elif axis == "precision":
                kw["precision_bits"] = self._other(
                    list(sp.precisions), point.precision_bits)
            elif axis == "spm":
                kw["spm_kbytes"] = self._other(
                    list(sp.spm_kbytes), point.spm_kbytes)
            elif axis == "chaining":
                kw["chaining"] = not point.chaining
            elif axis == "pipeline":
                kw["passes"] = self._other(
                    list(sp.pipelines), point.passes)
            else:                                      # fu
                kw["fu_counts"] = self._other(
                    list(sp._scheme_fus(point.scheme)), point.fu_counts)
            child = self._rebuild(**kw)
            if child is not None and child.name != point.name \
                    and self.feasible(child):
                return child
        return None

    def crossover(self, a: DesignPoint, b: DesignPoint,
                  max_tries: int = 8) -> Optional[DesignPoint]:
        """A feasible axis-wise mix of two parents: each independent
        axis comes from a coin-flipped parent; the scheme-coupled
        fields (``M``/``F``/``fu_counts``) follow whichever parent
        donated the scheme. ``None`` when every try is infeasible or
        collapses onto a parent."""
        for _ in range(max_tries):
            donor = a if self.rng.random() < 0.5 else b
            kw = {"scheme": donor.scheme, "M": donor.M, "F": donor.F,
                  "fu_counts": donor.fu_counts}
            for axis, attr in (("D", "D"),
                               ("precision_bits", "precision_bits"),
                               ("spm_kbytes", "spm_kbytes"),
                               ("chaining", "chaining"),
                               ("passes", "passes")):
                kw[axis] = getattr(
                    a if self.rng.random() < 0.5 else b, attr)
            child = self._rebuild(**kw)
            if child is not None and child.name not in (a.name, b.name) \
                    and self.feasible(child):
                return child
        return None

    @property
    def stats(self) -> dict:
        return {"attempts": self.attempts,
                "rejections": self.rejections,
                "distinct_points": len(self._seen_names),
                "grid_size": self.space.grid_size}
