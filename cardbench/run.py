"""One run of one cell of the port's benchmark.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Loads the cell's files by name (see
``harness/manifest.py``), runs its kind (``kinds/<kind>.py``): set-up,
the measured window, with ``--trace 1`` the traced steps, then the check
against the plain reference. Prints each compared number beside its
limit as the last lines of standard error, and one JSON line as the last
line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``. Exits 2 without a result when the cell's cards are missing,
and 3 when JAX or the JAX package was loaded.
"""
import time

T_SCRIPT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)     # the checkout, not this folder, is importable

from cardbench.harness import env  # noqa: E402


def make_result(cell, ctx: dict, traced: bool, chips: int) -> dict:
    """The result line of a run from what its kind measured: the cell's
    end-to-end metrics, or with ``traced`` its per-layer ones, each that
    its reader finds; the device; the breakdown; the checks last."""
    from cardbench.harness import manifest
    from cardbench.harness.trace import top
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = manifest.load_metric(m["name"], cell.bench_dir).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": ctx["device_kind"], "count": chips,
              "memory_peak_bytes": ctx["memory_peak_bytes"]}
    result = {"correct": ctx["correct"], "attempted": ctx["attempted"],
              "failed": ctx["failed"], "metrics": metrics, "device": device}
    t = ctx.get("trace")
    if traced and t:
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": top(t["device_s"]),
                               "idle_gaps": top(t["idle_gap_s"])}
    result["checks"] = {k: {"value": v, "limit": ctx["limits"].get(k)}
                        for k, v in ctx["checks"].items()}
    return result


def main(argv=None) -> int:
    t_start = T_SCRIPT - env.process_age_s()
    env.pin_caches(ROOT)
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from cardbench.harness import manifest
    cell = manifest.load_cell(ROOT / "BENCHMARK.json", args.workload)

    import torch
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    kind = manifest.load_code("kinds", cell.kind)
    ctx = kind.run(cell, args.seed, args.seconds, bool(args.trace), t_start)
    ctx["device_kind"] = torch.cuda.get_device_name(0)

    result = make_result(cell, ctx, bool(args.trace), chips)
    result["device"]["power_limit"] = env.power_limit()
    found = env.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    from cardbench.harness.compare import lines
    sys.stdout.flush()
    print("\n".join(lines(ctx["checks"], ctx["limits"])), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
