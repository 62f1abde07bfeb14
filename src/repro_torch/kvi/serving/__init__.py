"""Request-driven serving for KVI programs: load generation, continuous
hart admission, signature batching and warm launch-record reuse (the
port's copy of ``repro.kvi.serving``).

Quick start::

    from repro_torch.kvi import get_backend
    from repro_torch.kvi.serving import (ServeEngine, make_templates,
                                         poisson_arrivals, SMOKE_MIX)
    templates = make_templates(SMOKE_MIX, smoke=True, seed=0)
    specs = poisson_arrivals(templates, n_requests=64,
                             mean_interarrival_cycles=40.0, seed=0)
    engine = ServeEngine(templates, n_harts=3, backend=None)
    report = engine.run(specs)          # schedule-only (no device)

Attach ``get_backend("torch", passes=())`` to execute the batched
programs for real — one launch of the walk kernel per bucket on the card
(``device="cpu"`` runs its plain version) — and measure wall throughput
plus launch-record cache behaviour; run
``python -m repro_torch.kvi.serving`` for the CLI.
"""
from repro_torch.kvi.serving.engine import (SERVE_VOLATILE, ServedRequest,
                                            ServeEngine, StepRecord,
                                            bucket_sizes, canonical_report)
from repro_torch.kvi.serving.load import (DEFAULT_MIX, SMOKE_MIX,
                                          KernelTemplate, RequestSpec,
                                          load_trace, make_templates,
                                          poisson_arrivals, save_trace,
                                          template_key)

__all__ = [
    "DEFAULT_MIX",
    "SMOKE_MIX",
    "SERVE_VOLATILE",
    "KernelTemplate",
    "RequestSpec",
    "ServeEngine",
    "ServedRequest",
    "StepRecord",
    "bucket_sizes",
    "canonical_report",
    "load_trace",
    "make_templates",
    "poisson_arrivals",
    "save_trace",
    "template_key",
]
