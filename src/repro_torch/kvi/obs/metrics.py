"""Cross-layer metrics registry: counters, gauges and exact-bucket
histograms behind one ``snapshot() -> dict`` with a stable schema (the
port's copy of ``repro.kvi.obs.metrics``).

Every execution layer already counted *something* — the torch backend's
compile cache hits/misses and walk launches, the lowering ``TraceCache``,
the scheduler's queue, the serving engine's latency percentiles — each
with its own ad-hoc dict shape. A
:class:`MetricsRegistry` absorbs them behind three primitive types:

  * :class:`Counter`   — monotonically increasing event count,
  * :class:`Gauge`     — last-written value,
  * :class:`Histogram` — exact-bucket distribution (every distinct
    observed value keeps its own bucket — latencies here are integer
    virtual cycles, so exact buckets are both small and lossless, and
    nearest-rank percentiles computed from them are *identical* to the
    percentiles computed from the raw samples).

Metric names are dotted paths (``"serving.latency_cycles"``), created on
first use. ``snapshot()`` returns a plain sorted dict — deterministic
whenever the recorded values are — and ``save()`` writes it as JSON.
Wall-clock observations belong under names carrying a ``_s``/``_us``
suffix listed in :data:`~repro_torch.kvi.obs.scrub.TRACE_VOLATILE`-style key
sets, so canonical comparisons can scrub them with the shared helper.

The disabled path allocates nothing: :data:`NULL_METRICS` hands every
caller the same no-op instruments, so instrumented code never needs a
``None`` check around ``metrics.counter("x").inc()``.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written value (int or float)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Exact-bucket distribution: every observed value is its own
    bucket, so the summary percentiles are exact nearest-rank — the same
    convention the serving engine's ``_percentiles`` uses on raw
    samples."""

    __slots__ = ("buckets", "count", "total")

    def __init__(self):
        self.buckets: Dict[float, int] = {}
        self.count = 0
        self.total = 0

    def observe(self, v, n: int = 1) -> None:
        v = v if isinstance(v, float) else int(v)
        self.buckets[v] = self.buckets.get(v, 0) + n
        self.count += n
        self.total += v * n

    def percentile(self, q: float):
        """Exact nearest-rank percentile over the buckets."""
        if not self.count:
            return 0
        rank = max(1, -(-int(q * self.count * 100) // 100))  # ceil
        seen = 0
        for v in sorted(self.buckets):
            seen += self.buckets[v]
            if seen >= rank:
                return v
        return max(self.buckets)

    def summary(self) -> Dict[str, object]:
        if not self.count:
            return {"count": 0, "sum": 0, "min": 0, "max": 0,
                    "mean": 0.0, "p50": 0, "p95": 0, "p99": 0,
                    "buckets": {}}
        return {
            "count": self.count,
            "sum": self.total,
            "min": min(self.buckets),
            "max": max(self.buckets),
            "mean": round(self.total / self.count, 6),
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
            "buckets": {str(k): self.buckets[k]
                        for k in sorted(self.buckets)},
        }


class MetricsRegistry:
    """Name -> instrument store with a stable ``snapshot()`` schema.

    Instruments are created on first use and shared thereafter; the
    snapshot is ``{"counters": {...}, "gauges": {...}, "histograms":
    {name: summary}}`` with names sorted — byte-deterministic whenever
    the recorded values are."""

    enabled = True

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- instruments ---------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram()
        return h

    def absorb(self, prefix: str, stats: Dict[str, int]) -> None:
        """Fold a legacy ``{"hits": n, "misses": m, ...}`` counter dict
        into ``<prefix>.<key>`` counters — the adapter the scattered
        cache-stat dicts (KernelCache / TraceCache / PointCache) ride in
        on."""
        for k in sorted(stats):
            v = stats[k]
            if isinstance(v, bool) or not isinstance(v, int):
                continue
            self.counter(f"{prefix}.{k}").inc(v)

    # -- export --------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        return {
            "schema": "kvi-metrics-v1",
            "counters": {k: self._counters[k].value
                         for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k].value
                       for k in sorted(self._gauges)},
            "histograms": {k: self._histograms[k].summary()
                           for k in sorted(self._histograms)},
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
            f.write("\n")


class _NullInstrument:
    """One shared do-nothing counter/gauge/histogram."""

    __slots__ = ()
    value = 0
    count = 0
    total = 0
    buckets: Dict[float, int] = {}

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v, n: int = 1) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class NullMetrics(MetricsRegistry):
    """Zero-allocation disabled registry: every lookup returns the one
    shared no-op instrument and ``snapshot()`` is empty."""

    enabled = False

    def __init__(self):
        super().__init__()

    def counter(self, name: str):
        return _NULL_INSTRUMENT

    def gauge(self, name: str):
        return _NULL_INSTRUMENT

    def histogram(self, name: str):
        return _NULL_INSTRUMENT

    def absorb(self, prefix: str, stats: Dict[str, int]) -> None:
        pass


NULL_METRICS = NullMetrics()


def validate_metrics(snapshot: object) -> List[str]:
    """Structural check of a metrics snapshot (the saved-artifact gate):
    returns a list of problems, empty when valid."""
    errs: List[str] = []
    if not isinstance(snapshot, dict):
        return ["snapshot is not a dict"]
    if snapshot.get("schema") != "kvi-metrics-v1":
        errs.append(f"bad schema tag {snapshot.get('schema')!r}")
    for section in ("counters", "gauges", "histograms"):
        if not isinstance(snapshot.get(section), dict):
            errs.append(f"missing section {section!r}")
    for name, v in (snapshot.get("counters") or {}).items():
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            errs.append(f"counter {name!r} not a non-negative int: {v!r}")
    for name, h in (snapshot.get("histograms") or {}).items():
        if not isinstance(h, dict):
            errs.append(f"histogram {name!r} not a dict")
            continue
        missing = [k for k in ("count", "sum", "min", "max",
                               "p50", "p95", "p99", "buckets")
                   if k not in h]
        if missing:
            errs.append(f"histogram {name!r} missing {missing}")
            continue
        n = sum(h["buckets"].values()) if isinstance(h["buckets"], dict) \
            else -1
        if h["count"] != n:
            errs.append(f"histogram {name!r}: count {h['count']} != "
                        f"bucket total {n}")
        if h["count"] and not (h["min"] <= h["p50"] <= h["p95"]
                               <= h["p99"] <= h["max"]):
            errs.append(f"histogram {name!r}: percentile ordering broken")
    return errs
