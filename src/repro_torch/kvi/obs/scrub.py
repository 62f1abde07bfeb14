"""The one volatile-key scrubber every canonical-output producer shares
(the port's copy of ``repro.kvi.obs.scrub``, key sets unchanged).

Reports that must be *byte-deterministic* across runs — the serving
engine's ``canonical_report`` here; the DSE sweep and the telemetry layer
in the reference — also carry wall-clock quantities, nondeterministic by
nature. :func:`scrub` gives "this object, with every wall-clock /
run-shape field removed, recursively". The sets are the reference's, so
a canonical report of the port and one of the reference drop the same
keys and can be compared byte for byte.
"""
from __future__ import annotations

#: wall-clock / run-shape fields of the DSE sweep: timing measurements,
#: the executor label (names *how* the sweep ran, not what it measured)
#: and point-cache metadata (differs cold vs. warm by definition).
DSE_VOLATILE = frozenset({"wall_s", "walltime_s", "pallas_walltime_s",
                          "pallas_compile_s", "pallas_steady_s",
                          "total_wall_s", "executor",
                          "cached", "point_cache", "fresh_evals"})

#: the serving engine's wall-clock / rate fields, on top of the DSE set
#: (its report embeds backend meta that carries the DSE names).
SERVE_VOLATILE = DSE_VOLATILE | frozenset(
    {"req_per_s", "execute_s", "prewarm_s", "engine_s"})

#: wall-clock fields telemetry events and metrics snapshots carry next
#: to their deterministic virtual-cycle payload.
TRACE_VOLATILE = frozenset({"wall_s", "wall_us", "dur_wall_us",
                            "points_per_s", "eta_s"})

#: the union — safe as a default because the sets are disjoint from
#: every deterministic key any producer emits (pinned by tests).
ALL_VOLATILE = DSE_VOLATILE | SERVE_VOLATILE | TRACE_VOLATILE


def scrub(obj, keys: frozenset = ALL_VOLATILE):
    """``obj`` with every ``keys`` entry removed, recursively — the
    canonical (timing- and executor-free) view of a report, trace or
    metrics snapshot. Dicts and lists/tuples are rebuilt; scalars pass
    through."""
    if isinstance(obj, dict):
        return {k: scrub(v, keys) for k, v in obj.items()
                if k not in keys}
    if isinstance(obj, (list, tuple)):
        return [scrub(v, keys) for v in obj]
    return obj
