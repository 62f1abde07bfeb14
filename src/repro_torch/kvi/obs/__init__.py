"""repro_torch.kvi.obs — the port's telemetry layer, so far only the
volatile-key scrubber (:mod:`repro_torch.kvi.obs.scrub`) that the serving
engine's canonical report needs.

The reference's tracer, metrics registry and ``Obs`` bundle
(``repro.kvi.obs``) are not copied yet (ROADMAP.md queue 1 item 4): the
port's layers take ``obs=None`` and refuse a live bundle
(:func:`repro_torch.kvi.backend.refuse_obs`).
"""
from repro_torch.kvi.obs.scrub import (ALL_VOLATILE, DSE_VOLATILE,
                                       SERVE_VOLATILE, TRACE_VOLATILE,
                                       scrub)

__all__ = ["ALL_VOLATILE", "DSE_VOLATILE", "SERVE_VOLATILE",
           "TRACE_VOLATILE", "scrub"]
