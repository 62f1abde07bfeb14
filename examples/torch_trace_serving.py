"""Capture and summarize a Perfetto trace of a serving run on the port.

Runs the smoke serving stream schedule-only (no device needed), collects
the unified telemetry bundle — request flows, per-hart ticket lanes,
batching-window spans and the metrics registry — then writes
``kvi_trace.json`` (load it at https://ui.perfetto.dev or
``chrome://tracing``) plus ``kvi_metrics.json`` into ``--out-dir``, and
prints the text timeline via ``repro_torch.kvi.obs view``,
cross-checking the trace-derived makespan/latency numbers against the
engine's own report.

Run:  PYTHONPATH=src python examples/torch_trace_serving.py [--out-dir .]
"""
import argparse
import sys
from pathlib import Path

from repro_torch.kvi.obs import Obs, validate_metrics, validate_trace
from repro_torch.kvi.obs.__main__ import view
from repro_torch.kvi.serving import (SMOKE_MIX, ServeEngine, make_templates,
                                     poisson_arrivals)


def main(out_dir: str = ".") -> int:
    templates = make_templates(SMOKE_MIX, smoke=True, seed=0)
    specs = poisson_arrivals(templates, 64, 40.0, n_clients=200, seed=0)

    obs = Obs.on()
    engine = ServeEngine(templates, n_harts=3, backend=None, seed=0,
                         obs=obs)
    report = engine.run(specs)
    trace_path = str(Path(out_dir) / "kvi_trace.json")
    metrics_path = str(Path(out_dir) / "kvi_metrics.json")
    obs.save(trace_path=trace_path, metrics_path=metrics_path)

    errs = validate_trace(obs.tracer.to_chrome()) + \
        validate_metrics(obs.metrics.snapshot())
    for e in errs:
        print(f"INVALID: {e}", file=sys.stderr)
    if errs:
        return 1

    summary = view(trace_path, metrics_path=metrics_path)
    assert summary["makespan_cycles"] == \
        report["throughput"]["makespan_cycles"]
    assert summary["latency_cycles"]["p99"] == \
        report["latency_cycles"]["p99"]
    print(f"\ntrace-derived makespan/p99 match the engine report; "
          f"open {trace_path} in https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=".")
    sys.exit(main(ap.parse_args().out_dir))
