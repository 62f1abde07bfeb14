"""Unified telemetry for the port's KVI stack: tracing, metrics, scrubbing
(the port's copy of ``repro.kvi.obs``).

One :class:`Obs` bundle rides through every execution layer —
``CycleSimBackend``, ``TorchBackend``, ``HartScheduler`` and
``ServeEngine`` all take an optional ``obs=`` parameter (default off,
zero overhead). When enabled it collects:

  * a :class:`~repro_torch.kvi.obs.trace.Tracer` — span/instant/counter/
    flow events on dual clocks (virtual cycles + wall seconds), exported
    as Chrome trace-event JSON for Perfetto / ``chrome://tracing``;
  * a :class:`~repro_torch.kvi.obs.metrics.MetricsRegistry` — counters,
    gauges and exact-bucket histograms behind one ``snapshot()``.

``python -m repro_torch.kvi.obs view TRACE`` summarizes a saved trace
(text timeline + top-k stall attribution); ``... validate TRACE`` checks
it against the kvi-trace-v1 schema. The volatile-key scrubber every
canonical-report producer shares lives in
:mod:`repro_torch.kvi.obs.scrub`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.kvi.obs.metrics import (NULL_METRICS, Counter,  # noqa: F401
                                         Gauge, Histogram,
                                         MetricsRegistry, NullMetrics,
                                         validate_metrics)
from repro_torch.kvi.obs.schema import (TRACE_SCHEMA,  # noqa: F401
                                        validate_trace)
from repro_torch.kvi.obs.scrub import (ALL_VOLATILE,  # noqa: F401
                                       DSE_VOLATILE, SERVE_VOLATILE,
                                       TRACE_VOLATILE, scrub)
from repro_torch.kvi.obs.trace import (CLOCK_CYCLES,  # noqa: F401
                                       CLOCK_WALL, NULL_TRACER,
                                       NullTracer, Tracer,
                                       canonical_trace, load_trace)


@dataclass
class Obs:
    """The observability bundle instrumented layers thread through.

    Construct with :meth:`on` for a live collector, or pass ``None``
    (the default everywhere) for a true no-op — instrumented code
    guards on ``obs is not None and obs.enabled`` so the disabled path
    costs nothing."""

    tracer: Tracer = field(default_factory=lambda: NULL_TRACER)
    metrics: MetricsRegistry = field(default_factory=lambda: NULL_METRICS)

    @property
    def enabled(self) -> bool:
        return self.tracer.enabled or self.metrics.enabled

    @classmethod
    def on(cls) -> "Obs":
        """A live bundle: fresh tracer + fresh metrics registry."""
        return cls(tracer=Tracer(), metrics=MetricsRegistry())

    def save(self, trace_path=None, metrics_path=None) -> None:
        """Write whatever was collected (either path may be None)."""
        if trace_path:
            self.tracer.save(trace_path)
        if metrics_path:
            self.metrics.save(metrics_path)


#: the canonical disabled bundle (shared; allocates nothing per use)
NULL_OBS = Obs()
