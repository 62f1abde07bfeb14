"""Cycle-accurate tracer with a Chrome-trace-event JSON exporter (the
port's copy of ``repro.kvi.obs.trace``).

Every execution layer emits *events* onto named tracks; the exporter
writes the Chrome trace-event JSON that Perfetto and ``chrome://tracing``
load directly, with process/thread metadata so the UI shows readable
lanes ("cyclesim:het_mimd" / "hart0", "serving" / "hart2", ...).

Two clock domains coexist, as separate tracks:

  * **cycles** — virtual simulated cycles, the deterministic domain.
    One cycle maps to one trace microsecond (``ts`` is the cycle
    number), so per-hart busy/stall/idle intervals, instruction spans
    and request flows land at exact simulated times, byte-reproducible
    under a fixed seed.
  * **wall**   — real seconds since tracer construction, for the layers
    with no virtual clock (the torch backend's runs on the card, the LM
    train step's spans). The tracer reads the epoch clock beside its
    ``time.perf_counter`` base and exports it as ``otherData``'s
    ``wall_epoch_ns``: wall event ``ts`` (µs) sits at ``wall_epoch_ns +
    1000 * ts`` on the epoch clock, the clock ``torch.profiler`` stamps
    its host and device events with, so a wall span can be placed
    against a profiler trace. Wall tracks are volatile by nature;
    :func:`canonical_trace` drops them and that base (and scrubs wall
    argument fields) so determinism gates can byte-compare what remains.

Event kinds map to Chrome phases: :meth:`Tracer.span` -> complete
(``X``), :meth:`Tracer.instant` -> ``i``, :meth:`Tracer.counter` ->
``C``, and :meth:`Tracer.flow_start` / ``flow_step`` / ``flow_end`` ->
``s``/``t``/``f`` — the arrows linking one request's arrival ->
admission -> completion across tracks.

The disabled path is zero-allocation: :data:`NULL_TRACER` implements the
same surface as no-ops with ``enabled = False``, and instrumented hot
loops (the cycle simulator's inner loop) additionally gate their
recording on ``obs is not None`` so a run without observability executes
the exact pre-instrumentation instruction path.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.kvi.obs.scrub import TRACE_VOLATILE, scrub

#: clock-domain tags events carry (a non-Chrome field; viewers ignore it)
CLOCK_CYCLES = "cycles"
CLOCK_WALL = "wall"

Track = Tuple[str, str]            # (process name, thread/lane name)


class Tracer:
    """Span/instant/counter/flow event collector over named tracks.

    A *track* is a ``(process, lane)`` name pair — e.g.
    ``("cyclesim:het_mimd", "hart0")`` — mapped lazily to stable integer
    pid/tid in first-use order (deterministic for a deterministic event
    stream). ``clock`` selects the event's domain: ``"cycles"``
    (default; ``ts`` is a virtual cycle) or ``"wall"`` (``ts`` in real
    microseconds since tracer construction, or supplied explicitly).
    """

    enabled = True

    def __init__(self):
        self.events: List[dict] = []
        self._pids: Dict[str, int] = {}
        self._tids: Dict[Track, int] = {}
        self._wall0 = time.perf_counter()
        #: the epoch clock (ns) at ``_wall0``: the wall domain's base on
        #: the profiler's clock
        self.wall_epoch_ns = time.time_ns()

    # -- track bookkeeping ---------------------------------------------
    def _ids(self, track: Track) -> Tuple[int, int]:
        pid = self._pids.get(track[0])
        if pid is None:
            pid = self._pids[track[0]] = len(self._pids) + 1
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = \
                sum(t[0] == track[0] for t in self._tids) + 1
        return pid, tid

    def wall_us(self) -> float:
        """Microseconds since tracer construction (the wall domain)."""
        return (time.perf_counter() - self._wall0) * 1e6

    def wall_us_at(self, perf_s: float) -> float:
        """A ``time.perf_counter()`` reading in the wall domain (µs)."""
        return (perf_s - self._wall0) * 1e6

    # -- emitters ------------------------------------------------------
    def _emit(self, ph: str, track: Track, name: str, ts, cat: str,
              clock: str, args: Optional[dict], **extra) -> None:
        pid, tid = self._ids(track)
        ev = {"ph": ph, "pid": pid, "tid": tid, "name": name,
              "cat": cat, "ts": ts, "clock": clock}
        if args:
            ev["args"] = args
        ev.update(extra)
        self.events.append(ev)

    def span(self, track: Track, name: str, ts, dur, cat: str = "span",
             clock: str = CLOCK_CYCLES,
             args: Optional[dict] = None) -> None:
        """A complete event: ``[ts, ts + dur)`` on ``track``."""
        self._emit("X", track, name, ts, cat, clock, args, dur=dur)

    def instant(self, track: Track, name: str, ts, cat: str = "mark",
                clock: str = CLOCK_CYCLES,
                args: Optional[dict] = None) -> None:
        self._emit("i", track, name, ts, cat, clock, args, s="t")

    def counter(self, track: Track, name: str, ts, values: Dict[str, float],
                clock: str = CLOCK_CYCLES) -> None:
        """A counter sample: ``values`` are the series of one chart."""
        self._emit("C", track, name, ts, "counter", clock, dict(values))

    def flow_start(self, track: Track, name: str, ts, flow_id: int,
                   cat: str = "flow", clock: str = CLOCK_CYCLES,
                   args: Optional[dict] = None) -> None:
        self._emit("s", track, name, ts, cat, clock, args, id=flow_id)

    def flow_step(self, track: Track, name: str, ts, flow_id: int,
                  cat: str = "flow", clock: str = CLOCK_CYCLES,
                  args: Optional[dict] = None) -> None:
        self._emit("t", track, name, ts, cat, clock, args, id=flow_id)

    def flow_end(self, track: Track, name: str, ts, flow_id: int,
                 cat: str = "flow", clock: str = CLOCK_CYCLES,
                 args: Optional[dict] = None) -> None:
        self._emit("f", track, name, ts, cat, clock, args,
                   id=flow_id, bp="e")

    def wall_span(self, track: Track, name: str, start_us: float,
                  cat: str = "wall", args: Optional[dict] = None) -> None:
        """A wall-domain span from ``start_us`` (a prior
        :meth:`wall_us` reading) to now."""
        self.span(track, name, round(start_us, 3),
                  round(self.wall_us() - start_us, 3), cat=cat,
                  clock=CLOCK_WALL, args=args)

    # -- export --------------------------------------------------------
    def to_chrome(self) -> Dict[str, object]:
        """The Chrome trace-event JSON object: metadata naming every
        track, then all events sorted by (pid, tid, ts, emission
        order) — the deterministic serialization the schema validator
        and the byte-identity tests consume."""
        events: List[dict] = []
        for pname, pid in sorted(self._pids.items(), key=lambda kv: kv[1]):
            events.append({"ph": "M", "pid": pid, "tid": 0,
                           "name": "process_name", "cat": "__metadata",
                           "ts": 0, "args": {"name": pname}})
        for (pname, lname), tid in sorted(self._tids.items(),
                                          key=lambda kv: kv[1]):
            events.append({"ph": "M", "pid": self._pids[pname],
                           "tid": tid, "name": "thread_name",
                           "cat": "__metadata", "ts": 0,
                           "args": {"name": lname}})
        order = {id(ev): i for i, ev in enumerate(self.events)}
        events.extend(sorted(
            self.events,
            key=lambda ev: (ev["pid"], ev["tid"], ev["ts"],
                            order[id(ev)])))
        return {"displayTimeUnit": "ms", "traceEvents": events,
                "otherData": {"wall_epoch_ns": self.wall_epoch_ns}}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1, sort_keys=True)
            f.write("\n")


class NullTracer(Tracer):
    """Zero-allocation disabled tracer: every emitter returns
    immediately, ``events`` stays empty."""

    enabled = False

    def _emit(self, ph, track, name, ts, cat, clock, args, **extra):
        pass

    def wall_us(self) -> float:
        return 0.0


NULL_TRACER = NullTracer()


def canonical_trace(trace: Dict[str, object]) -> Dict[str, object]:
    """The deterministic view of an exported trace: wall-domain events
    and the wall domain's epoch base dropped (both are real time),
    volatile argument fields scrubbed everywhere else. Two runs with the
    same seed and configuration produce byte-identical canonical traces
    — what the determinism tests compare."""
    events = [scrub(ev, TRACE_VOLATILE)
              for ev in trace.get("traceEvents", [])
              if ev.get("clock") != CLOCK_WALL]
    out = {k: v for k, v in trace.items()
           if k not in ("traceEvents", "otherData")}
    other = {k: v for k, v in trace.get("otherData", {}).items()
             if k != "wall_epoch_ns"}
    if other:
        out["otherData"] = other
    out["traceEvents"] = events
    return out


def load_trace(path: str) -> Dict[str, object]:
    """Read a saved Chrome trace JSON (the viewer/validator entry)."""
    with open(path) as f:
        return json.load(f)
