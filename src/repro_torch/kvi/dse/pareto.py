"""Non-dominated (Pareto) front extraction over swept design points (the
port's copy of ``repro.kvi.dse.pareto``).

All objectives are minimized (cycles, area, energy). ``a`` dominates
``b`` when a is <= b in every objective and strictly < in at least one —
so metric-identical points never dominate each other, which makes the
front's *metric set* invariant under point duplication and permutation
(the property the hypothesis tests pin down).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True when metric vector ``a`` Pareto-dominates ``b`` (minimize)."""
    if len(a) != len(b):
        raise ValueError(f"metric arity mismatch: {len(a)} vs {len(b)}")
    return all(x <= y for x, y in zip(a, b)) and \
        any(x < y for x, y in zip(a, b))


def pareto_front(items: Sequence, key: Optional[Callable] = None) -> List:
    """The items whose metric vector no other item dominates, in input
    order. ``key`` maps an item to its metric tuple (identity when
    omitted). Duplicates of a front point are all kept — they are
    mutually non-dominated by the strictness rule."""
    key = key or (lambda x: x)
    metrics = [tuple(key(it)) for it in items]
    out = []
    for i, it in enumerate(items):
        if not any(dominates(metrics[j], metrics[i])
                   for j in range(len(items)) if j != i):
            out.append(it)
    return out


def front_metrics(items: Sequence,
                  key: Optional[Callable] = None) -> List[Tuple]:
    """The front as a sorted, de-duplicated list of metric tuples — the
    canonical representation (invariant under duplication/permutation
    of the input)."""
    key = key or (lambda x: x)
    return sorted(set(tuple(key(it)) for it in pareto_front(items, key)))
