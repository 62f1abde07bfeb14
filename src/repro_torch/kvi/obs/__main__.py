"""CLI: summarize or validate saved KVI telemetry.

    python -m repro_torch.kvi.obs view kvi_trace.json [--metrics kvi_metrics.json]
    python -m repro_torch.kvi.obs validate kvi_trace.json [--metrics ...]

``view`` prints a text timeline per cycle-domain track (busy ``█`` /
stall ``▒`` / idle ``·``), the serving request-flow summary (requests,
makespan, latency percentiles — recomputed from the flow events alone,
cross-checked against the engine's report in tests) and the top-k stall
attribution by span name. ``validate`` checks the trace against the
kvi-trace-v1 schema (and the metrics snapshot when given) and exits
non-zero on any violation.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.kvi.obs.metrics import validate_metrics
from repro_torch.kvi.obs.schema import validate_trace
from repro_torch.kvi.obs.trace import CLOCK_CYCLES, load_trace

#: timeline bar width in characters
_WIDTH = 60


def _percentiles(xs) -> Dict[str, int]:
    """Nearest-rank percentiles, the serving engine's exact convention
    (so the trace-derived numbers reproduce the report's)."""
    if not xs:
        return {"p50": 0, "p95": 0, "p99": 0, "mean": 0, "max": 0}
    arr = np.sort(np.asarray(xs, dtype=np.int64))

    def rank(q: float) -> int:
        return int(arr[min(len(arr) - 1,
                           max(0, int(np.ceil(q * len(arr))) - 1))])

    return {"p50": rank(0.50), "p95": rank(0.95), "p99": rank(0.99),
            "mean": int(np.floor(arr.mean())), "max": int(arr[-1])}


def _track_names(events) -> Dict[Tuple[int, int], str]:
    """(pid, tid) -> "process/lane" from the metadata events."""
    procs: Dict[int, str] = {}
    lanes: Dict[Tuple[int, int], str] = {}
    for ev in events:
        if ev.get("ph") != "M":
            continue
        if ev.get("name") == "process_name":
            procs[ev["pid"]] = ev.get("args", {}).get("name", "?")
        elif ev.get("name") == "thread_name":
            lanes[(ev["pid"], ev["tid"])] = \
                ev.get("args", {}).get("name", "?")
    return {(pid, tid): f"{procs.get(pid, pid)}/{lane}"
            for (pid, tid), lane in lanes.items()}


def flow_summary(events) -> Optional[Dict[str, object]]:
    """Makespan + latency percentiles reconstructed from the request
    flow events alone: latency(id) = ts(flow end) - ts(flow start)."""
    starts: Dict[object, float] = {}
    ends: Dict[object, float] = {}
    for ev in events:
        if ev.get("ph") == "s":
            starts[ev.get("id")] = ev["ts"]
        elif ev.get("ph") == "f":
            ends[ev.get("id")] = ev["ts"]
    done = sorted(set(starts) & set(ends), key=str)
    if not done:
        return None
    latencies = [int(ends[i] - starts[i]) for i in done]
    return {"requests": len(done),
            "makespan_cycles": int(max(ends[i] for i in done)),
            "latency_cycles": _percentiles(latencies)}


def _bar(busy: List[Tuple[float, float]], stall: List[Tuple[float, float]],
         t_end: float, width: int = _WIDTH) -> str:
    """busy/stall/idle occupancy of [0, t_end) as one character bar;
    busy wins a column over stall, stall over idle."""
    cols = []
    scale = t_end / width if t_end else 1

    def covered(iv, lo, hi):
        return any(s < hi and e > lo for s, e in iv)

    for c in range(width):
        lo, hi = c * scale, (c + 1) * scale
        if covered(busy, lo, hi):
            cols.append("█")
        elif covered(stall, lo, hi):
            cols.append("▒")
        else:
            cols.append("·")
    return "".join(cols)


def stall_attribution(events, top: int = 5) -> List[Tuple[str, int, int]]:
    """(span name, total stalled cycles, occurrences) for cycle-domain
    stall spans, largest first — "what were the harts waiting on"."""
    agg: Dict[str, List[int]] = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "stall" \
                and ev.get("clock") == CLOCK_CYCLES:
            a = agg.setdefault(ev["name"], [0, 0])
            a[0] += int(ev.get("dur", 0))
            a[1] += 1
    rows = sorted(((n, d, c) for n, (d, c) in agg.items()),
                  key=lambda r: (-r[1], r[0]))
    return rows[:top]


def view(trace_path: str, metrics_path: Optional[str] = None,
         top: int = 5, out=print) -> Dict[str, object]:
    """Print the trace summary; returns the computed summary dict (the
    tests cross-check it against the engine's report)."""
    trace = load_trace(trace_path)
    events = trace.get("traceEvents", [])
    names = _track_names(events)
    out(f"# {trace_path}: {len(events)} events, "
        f"{len(names)} tracks")

    # per-track cycle-domain occupancy bars
    per_track: Dict[tuple, Dict[str, list]] = {}
    t_end = 0.0
    for ev in events:
        if ev.get("ph") != "X" or ev.get("clock") != CLOCK_CYCLES:
            continue
        key = (ev["pid"], ev["tid"])
        d = per_track.setdefault(key, {"busy": [], "stall": []})
        iv = (ev["ts"], ev["ts"] + ev.get("dur", 0))
        kind = "stall" if ev.get("cat") == "stall" else \
            None if ev.get("cat") == "idle" else "busy"
        if kind:
            d[kind].append(iv)
        t_end = max(t_end, iv[1])
    if per_track:
        out(f"\n## timeline (0..{int(t_end)} cycles; "
            f"█ busy ▒ stall · idle)")
        for key in sorted(per_track):
            d = per_track[key]
            label = names.get(key, f"pid{key[0]}/tid{key[1]}")
            out(f"  {label:36s} {_bar(d['busy'], d['stall'], t_end)}")

    summary: Dict[str, object] = {}
    flows = flow_summary(events)
    if flows:
        summary.update(flows)
        lat = flows["latency_cycles"]
        out(f"\n## request flows")
        out(f"  requests={flows['requests']} "
            f"makespan={flows['makespan_cycles']} cycles")
        out(f"  latency p50={lat['p50']} p95={lat['p95']} "
            f"p99={lat['p99']} mean={lat['mean']} max={lat['max']}")

    stalls = stall_attribution(events, top=top)
    if stalls:
        out(f"\n## top-{len(stalls)} stall attribution")
        for name, dur, cnt in stalls:
            out(f"  {name:24s} {dur:10d} cycles over {cnt} waits")
    summary["stalls"] = [{"name": n, "cycles": d, "count": c}
                         for n, d, c in stalls]

    if metrics_path:
        with open(metrics_path) as f:
            snap = json.load(f)
        out(f"\n## metrics ({metrics_path})")
        for k, v in snap.get("counters", {}).items():
            out(f"  counter {k} = {v}")
        for k, v in snap.get("gauges", {}).items():
            out(f"  gauge   {k} = {v}")
        for k, h in snap.get("histograms", {}).items():
            out(f"  hist    {k}: n={h['count']} p50={h['p50']} "
                f"p99={h['p99']} max={h['max']}")
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.kvi.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("view", help="summarize a saved trace")
    v.add_argument("trace")
    v.add_argument("--metrics", default=None,
                   help="also summarize a metrics snapshot JSON")
    v.add_argument("--top", type=int, default=5,
                   help="stall-attribution rows to print")
    c = sub.add_parser("validate",
                       help="schema-validate a trace (+ metrics)")
    c.add_argument("trace")
    c.add_argument("--metrics", default=None)
    args = ap.parse_args(argv)

    if args.cmd == "view":
        view(args.trace, metrics_path=args.metrics, top=args.top)
        return 0
    errs = validate_trace(load_trace(args.trace))
    if args.metrics:
        with open(args.metrics) as f:
            errs += validate_metrics(json.load(f))
    for e in errs:
        print(f"INVALID: {e}", file=sys.stderr)
    label = args.trace + (f" + {args.metrics}" if args.metrics else "")
    print(f"{label}: " + ("OK" if not errs else f"{len(errs)} errors"))
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
