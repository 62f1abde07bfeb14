"""CLI for the KVI serving engine (the port's copy of
``python -m repro.kvi.serving``, every flag kept, plus ``--device``).

    python -m repro_torch.kvi.serving                  # 256 requests, card
    python -m repro_torch.kvi.serving --smoke --device cpu
    python -m repro_torch.kvi.serving --requests 200 --interarrival 30 \\
        --harts 3 --max-batch 8 --out serve.json
    python -m repro_torch.kvi.serving --trace arrivals.json --no-backend

The backend is ``get_backend("torch", passes=(), device=DEVICE)``: the
card by default (it raises without one; there is no CPU fallback),
``--device cpu`` for the walk kernel's plain version. ``--no-backend``
runs schedule-only (no device): all cycle-domain metrics, no wall-clock
execution. ``--save-trace`` persists the generated Poisson arrivals for
replay with ``--trace``. ``--trace-out`` / ``--metrics-out`` run with a
live telemetry bundle (:class:`repro_torch.kvi.obs.Obs`) and save its
Chrome trace and metrics snapshot; ``python -m repro_torch.kvi.obs
view`` / ``validate`` read them.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.kvi.serving.engine import ServeEngine, canonical_report
from repro_torch.kvi.serving.load import (DEFAULT_MIX, SMOKE_MIX,
                                          load_trace, make_templates,
                                          poisson_arrivals, save_trace)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kvi.serving",
        description="Serve a mixed KVI kernel request stream.")
    ap.add_argument("--smoke", action="store_true",
                    help="small kernels, small stream (CI-sized)")
    ap.add_argument("--requests", type=int, default=None,
                    help="number of Poisson requests (default 64 smoke, "
                         "256 full)")
    ap.add_argument("--interarrival", type=float, default=None,
                    help="mean inter-arrival gap in virtual cycles")
    ap.add_argument("--clients", type=int, default=1000,
                    help="simulated client population")
    ap.add_argument("--harts", type=int, default=3)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-batching", action="store_true",
                    help="execute one request at a time (baseline)")
    ap.add_argument("--no-prewarm", action="store_true",
                    help="skip ahead-of-time bucket compilation")
    ap.add_argument("--no-backend", action="store_true",
                    help="schedule-only: no device, no execution")
    ap.add_argument("--device", default=None,
                    help="torch device of the backend (default: the "
                         "CUDA card; 'cpu' runs the kernels' plain "
                         "versions)")
    ap.add_argument("--trace", default=None,
                    help="replay arrivals from a JSON trace file")
    ap.add_argument("--save-trace", default=None,
                    help="write the generated arrivals to this path")
    ap.add_argument("--out", default=None,
                    help="write the report JSON here (default stdout)")
    ap.add_argument("--canonical", action="store_true",
                    help="emit the wall-clock-scrubbed canonical report")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto-loadable Chrome trace of the "
                         "run (request flows, hart lanes, step windows)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot JSON")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    mix = SMOKE_MIX if args.smoke else DEFAULT_MIX
    templates = make_templates(mix, smoke=args.smoke, seed=args.seed)

    if args.trace:
        specs = load_trace(args.trace)
    else:
        n = args.requests if args.requests is not None else \
            (64 if args.smoke else 256)
        gap = args.interarrival if args.interarrival is not None else 40.0
        specs = poisson_arrivals(templates, n, gap,
                                 n_clients=args.clients, seed=args.seed)
    if args.save_trace:
        save_trace(specs, args.save_trace)

    obs = None
    if args.trace_out or args.metrics_out:
        from repro_torch.kvi.obs import Obs
        obs = Obs.on()

    backend = None
    if not args.no_backend:
        from repro_torch.kvi.backend import get_backend
        backend = get_backend("torch", passes=(), obs=obs,
                              device=args.device)

    engine = ServeEngine(templates, n_harts=args.harts, backend=backend,
                         batching=not args.no_batching,
                         max_batch=args.max_batch, seed=args.seed,
                         prewarm=not args.no_prewarm, obs=obs)
    report = engine.run(specs)
    if obs is not None:
        obs.save(trace_path=args.trace_out,
                 metrics_path=args.metrics_out)
        for path in (args.trace_out, args.metrics_out):
            if path:
                print(f"telemetry -> {path}", file=sys.stderr)
    text = canonical_report(report) if args.canonical else \
        json.dumps(report, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        lat = report["latency_cycles"]
        cc = report.get("compile_cache") or {}
        print(f"served {report['throughput']['requests']} requests in "
              f"{report['throughput']['makespan_cycles']} cycles "
              f"(p50={lat['p50']} p99={lat['p99']}; "
              f"cache hits={cc.get('hits', '-')} "
              f"misses={cc.get('misses', '-')}) -> {args.out}")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
