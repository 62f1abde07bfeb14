"""The readings the limits of a training cell's comparison are set from,
at the cell's own size: the program's first steps against the plain
reference on many seeds (the lower readings), the reference in the
lower-precision control's place (``--control-seeds``: FP8 training's
rounding), and the program
with a fault planted (``--fault-seeds``). No window is measured. The
benchmark's runs never run this.

    python3 cardbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 1 2 3 --fault half_batch --fault-seeds 1 2 3 \
        --out build/calib.json
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)     # the checkout, not this folder, is importable

from cardbench.harness import env  # noqa: E402


def worst_leaves(prog: dict, ref: dict) -> dict:
    """The leaf each by-leaf gap comes from (for reading the numbers)."""
    out = {}
    for part in ("grad", "change"):
        out[part] = max(ref[part], key=lambda k: abs(prog[part][k] -
                                                     ref[part][k]) /
                        max(ref[part][k], 1e-30))
    return out


def main(argv=None) -> int:
    env.pin_caches(ROOT)
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch
    from cardbench.harness import compare, faults, manifest
    sys.path.insert(0, str(ROOT / "src"))
    from cardbench.kinds import train as kt

    cell = manifest.load_cell(ROOT / "BENCHMARK.json", args.workload)
    dev = torch.device("cuda")
    n = cell.workload["check_steps"]
    tr = kt.Trainer(cell, dev)
    sound_step = tr.train_step
    rows = []
    seeds = sorted(set(args.seeds) | set(args.control_seeds) |
                   set(args.fault_seeds))
    for seed in seeds:
        t = time.perf_counter()
        batches = kt.make_batches(cell, seed)
        ref = kt.reference_steps(cell, seed, batches, n, dev)
        kt.free(dev)
        runs = {}
        if seed in args.seeds:
            runs["program"] = ("program", None)
        if seed in args.fault_seeds:
            for f in args.fault:
                runs[f] = ("program", f)
        if seed in args.control_seeds:
            runs["control_fp8"] = ("control", "fp8")
        for name, (side, what) in runs.items():
            if side == "program":
                tr.train_step = (sound_step if what is None else
                                 faults.FAULTS[what](sound_step))
                p, o, summ = kt.first_steps(tr, seed, batches, n)
                del p, o
            else:
                summ = kt.reference_steps(cell, seed, batches, n, dev,
                                          product=what)
            kt.free(dev)
            row = {"seed": seed, "run": name,
                   "numbers": compare.numbers(summ, ref),
                   "worst": worst_leaves(summ, ref),
                   "loss": summ["loss"], "ref_loss": ref["loss"],
                   "grad_norm": summ["grad_norm"],
                   "ref_grad_norm": ref["grad_norm"],
                   "summary": summ, "ref": ref}
            rows.append(row)
            print(json.dumps({k: v for k, v in row.items()
                              if k not in ("summary", "ref")}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", flush=True)
    with open(args.out, "w") as f:
        json.dump({"workload": args.workload,
                   "device": torch.cuda.get_device_name(0),
                   "power": env.power_limit(), "rows": rows}, f, indent=1)
    for name in sorted({r["run"] for r in rows}):
        sel = [r["numbers"] for r in rows if r["run"] == name]
        print(name, len(sel), {k: [min(x[k] for x in sel),
                                   max(x[k] for x in sel)] for k in sel[0]})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
