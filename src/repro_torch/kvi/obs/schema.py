"""Trace integrity validation: every exported trace must satisfy the
schema below before it is worth opening in Perfetto.

Checked invariants (the test suite gates every producer on these):

  * top-level shape — ``traceEvents`` list + ``displayTimeUnit``;
  * per event — a known Chrome phase, integer pid/tid, a numeric
    non-negative ``ts``, a name, and the phase-specific requirements
    (``X`` needs a non-negative ``dur``, flow phases need an ``id``,
    counters need numeric ``args``);
  * per track — timestamps non-decreasing in serialized order (the
    exporter sorts; a violation means a producer wrote through the
    exporter's back);
  * span nesting — any explicit ``B``/``E`` pairs balance per track;
  * flows — every flow id has exactly one start and one end, with
    ``ts(start) <= ts(step) <= ts(end)``;
  * clocks — every non-metadata event is tagged with a known clock
    domain, and cycle-domain timestamps are integers (virtual cycles).

``TRACE_SCHEMA`` documents the same contract as a JSON-Schema object
(for humans and external tooling); :func:`validate_trace` is the
dependency-free implementation CI and the tests call.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.kvi.obs.trace import CLOCK_CYCLES, CLOCK_WALL

#: phases the exporter can produce (+ explicit B/E for completeness)
_PHASES = frozenset({"X", "B", "E", "i", "C", "s", "t", "f", "M"})

#: the contract, as a JSON-Schema document (informational; the enforced
#: implementation is :func:`validate_trace`)
TRACE_SCHEMA: Dict[str, object] = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "title": "kvi-trace-v1",
    "type": "object",
    "required": ["traceEvents", "displayTimeUnit"],
    "properties": {
        "displayTimeUnit": {"type": "string"},
        "traceEvents": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["ph", "pid", "tid", "ts", "name"],
                "properties": {
                    "ph": {"enum": sorted(_PHASES)},
                    "pid": {"type": "integer", "minimum": 0},
                    "tid": {"type": "integer", "minimum": 0},
                    "ts": {"type": "number", "minimum": 0},
                    "dur": {"type": "number", "minimum": 0},
                    "name": {"type": "string"},
                    "cat": {"type": "string"},
                    "id": {"type": "integer"},
                    "clock": {"enum": [CLOCK_CYCLES, CLOCK_WALL]},
                    "args": {"type": "object"},
                },
            },
        },
    },
}


def validate_trace(trace: object) -> List[str]:
    """Every violation of the kvi-trace-v1 contract, as messages; an
    empty list means the trace is valid."""
    errs: List[str] = []
    if not isinstance(trace, dict):
        return ["trace is not a dict"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    if not isinstance(trace.get("displayTimeUnit"), str):
        errs.append("displayTimeUnit missing")

    last_ts: Dict[tuple, float] = {}
    open_spans: Dict[tuple, List[str]] = {}
    flows: Dict[object, Dict[str, List[float]]] = {}
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not a dict")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            errs.append(f"{where}: unknown phase {ph!r}")
            continue
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                errs.append(f"{where}: {k} not an integer")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or isinstance(ts, bool) \
                or ts < 0:
            errs.append(f"{where}: ts not a non-negative number: {ts!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errs.append(f"{where}: name missing")
        if ph == "M":
            continue
        clock = ev.get("clock")
        if clock not in (CLOCK_CYCLES, CLOCK_WALL):
            errs.append(f"{where}: unknown clock {clock!r}")
        elif clock == CLOCK_CYCLES and ts != int(ts):
            errs.append(f"{where}: cycle-domain ts {ts!r} not integral")

        track = (ev.get("pid"), ev.get("tid"), clock)
        if ts < last_ts.get(track, 0):
            errs.append(f"{where}: ts {ts} decreases on track "
                        f"pid={track[0]} tid={track[1]} "
                        f"(last {last_ts[track]})")
        last_ts[track] = ts

        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or isinstance(dur, bool) \
                    or dur < 0:
                errs.append(f"{where}: X event needs dur >= 0, "
                            f"got {dur!r}")
        elif ph == "B":
            open_spans.setdefault(track, []).append(ev.get("name", ""))
        elif ph == "E":
            stack = open_spans.get(track)
            if not stack:
                errs.append(f"{where}: E without matching B on track "
                            f"pid={track[0]} tid={track[1]}")
            else:
                stack.pop()
        elif ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or any(
                    not isinstance(v, (int, float)) or isinstance(v, bool)
                    for v in args.values()):
                errs.append(f"{where}: counter args must be a non-empty "
                            f"dict of numbers")
        elif ph in ("s", "t", "f"):
            if "id" not in ev:
                errs.append(f"{where}: flow event without id")
            else:
                rec = flows.setdefault(ev["id"], {"s": [], "t": [],
                                                  "f": []})
                rec[ph].append(ts)

    for track, stack in open_spans.items():
        if stack:
            errs.append(f"unclosed span(s) {stack} on track "
                        f"pid={track[0]} tid={track[1]}")
    for fid, rec in flows.items():
        if len(rec["s"]) != 1 or len(rec["f"]) != 1:
            errs.append(f"flow {fid}: needs exactly one start and one "
                        f"end, got {len(rec['s'])}/{len(rec['f'])}")
            continue
        s, f = rec["s"][0], rec["f"][0]
        if s > f:
            errs.append(f"flow {fid}: start ts {s} after end ts {f}")
        if any(t < s or t > f for t in rec["t"]):
            errs.append(f"flow {fid}: step outside [start, end]")
    return errs
