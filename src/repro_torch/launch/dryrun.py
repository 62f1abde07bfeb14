"""Multi-pod dry run, the port of the reference's ``repro/launch/dryrun.py``:
build every (arch x shape) cell on the production meshes (16x16
single-pod, 2x16x16 multi-pod), run its step once on the meta device
under the step accountant, and record per-device FLOPs, HBM bytes,
collective bytes, the analytic memory and traffic models and the
roofline terms (the port's ``HW``: an H100) to
``artifacts/dryrun_torch/*.json``.

The mesh is a ``DeviceMesh`` over a fake process group of 256 or 512
ranks in this one process (collectives move nothing; every tensor is a
meta DTensor, so nothing is allocated). No card is needed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --summary   # the table
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from repro_torch.compat import fake_store


@contextlib.contextmanager
def fake_world(size: int):
    """A default process group of ``size`` fake ranks (this process is
    rank 0), destroyed on exit."""
    dist.init_process_group("fake", store=fake_store(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(tree) -> int:
    """Per-device bytes of a tree of (meta) tensors and DTensors."""
    from repro_torch.compat import DTensor
    from repro_torch.launch.hlo_analysis import _tensor_bytes
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, DTensor):
        return _tensor_bytes(tree.to_local())
    return _tensor_bytes(tree)


def _run_cell(arch: str, shape_name: str, mesh, multi_pod: bool,
              out_dir: Path, overrides=None, tag: str = "") -> dict:
    """One cell on ``mesh`` (a production mesh over the fake group)."""
    from repro_torch.launch.compile import (build_cell,
                                            estimate_device_memory,
                                            estimate_hbm_traffic, lower_cell)
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.launch.mesh import HW

    n_chips = mesh.size()
    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh, overrides=overrides)
    fn, args = lower_cell(cell)
    t_lower = time.time() - t0
    t1 = time.time()
    # per-device accounting of one traced run of the step (the
    # reference's compile + trip-count-aware HLO analysis)
    acct = analyze_step(fn, *args, top_collectives=8)
    t_compile = time.time() - t1
    flops = acct["dot_flops"]
    hbm_bytes = acct["hbm_bytes"]
    coll = acct["collective_bytes"]

    mem_d = {
        "argument_size_in_bytes": _nbytes(args),
        "output_size_in_bytes": _nbytes(acct["result"]),
        "temp_size_in_bytes": None,      # an eager meta run allocates none
        "xla_cost_flops_once": acct["global_dot_flops"],
        "xla_cost_bytes_once": hbm_bytes,
    }
    est = estimate_device_memory(cell)
    traffic = estimate_hbm_traffic(cell)

    # roofline terms; per-device quantities / per-card rates
    terms = {
        "t_compute_s": flops / HW["peak_flops_bf16"],
        "t_memory_s": traffic["total"] / HW["hbm_bw"],
        "t_memory_hlo_upper_s": hbm_bytes / HW["hbm_bw"],
        "t_collective_s": coll["total"] / HW["link_bw"],
    }
    terms["bottleneck"] = max(
        ["t_compute_s", "t_memory_s", "t_collective_s"],
        key=lambda k: terms[k])

    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": list(mesh.mesh.shape), "axes": list(mesh.mesh_dim_names),
        "chips": int(n_chips), "tag": tag,
        "kind": cell.shape.kind,
        "flops_per_device": flops,
        "hbm_bytes_per_device": hbm_bytes,
        "collective_bytes_per_device": coll,
        "top_collectives": acct.get("top_collectives", []),
        "memory_analysis": mem_d,
        "estimated_device_memory": est,
        "hbm_traffic_model": traffic,
        "per_device_live_bytes": est["total"],
        "fits_hbm": bool(est["total"] < HW["hbm_bytes"]),
        "roofline": terms,
        "downgrades": [list(map(str, d)) for d in cell.rules.downgrades],
        "t_lower_s": round(t_lower, 2), "t_compile_s": round(t_compile, 2),
        "status": "ok",
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    pod = "multipod" if multi_pod else "pod"
    name = f"{arch}_{shape_name}_{pod}{('_' + tag) if tag else ''}.json"
    (out_dir / name).write_text(json.dumps(rec, indent=2))
    return rec


def model_flops(arch: str, shape_name: str) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) for train; 2*N*D fwd-only (the
    reference's ``benchmarks/roofline_report.py:model_flops``)."""
    from repro_torch.configs import get_shape, get_spec
    from repro_torch.models import model_zoo as zoo
    cfg, shape = get_spec(arch).model, get_shape(shape_name)
    n_active = zoo.active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # decode: one token


def summary(out_dir: Path) -> str:
    """A Markdown table of the records in ``out_dir``, one row an arch,
    one column a shape, each cell "16x16 / 2x16x16": FLOPs a device,
    estimated GiB a device, whether that fits 80 GB, the bottleneck, and
    FLOPs a device x chips over ``model_flops``; a failed cell's last
    error line; "not run" for a cell with no record; "-" for a shape the
    arch has no cell of."""
    from repro_torch.configs import SHAPES, arch_cells, list_archs
    recs = {}
    for f in sorted(out_dir.glob("*.json")):
        r = json.loads(f.read_text())
        mesh = "2x16x16" if "_multipod" in f.name else "16x16"
        if r.get("status") != "ok":
            err = r.get("error", "").strip().splitlines()[-1:] or ["?"]
            text = f"fail: {err[0][:100]}"
        else:
            ratio = r["flops_per_device"] * r["chips"] / \
                model_flops(r["arch"], r["shape"])
            text = (f"{r['flops_per_device']:.3e}, "
                    f"{r['per_device_live_bytes'] / 2**30:.2f} GiB, "
                    f"{'fits' if r['fits_hbm'] else 'no fit'}, "
                    f"{r['roofline']['bottleneck'][2:-2]}, {ratio:.2f}x")
        recs[(r["arch"], r["shape"], mesh)] = text
    out = ["| arch | " + " | ".join(SHAPES) + " |",
           "|---|" + "---|" * len(SHAPES)]
    for arch in list_archs():
        shapes = {s for _, s in arch_cells(arch)}
        out.append(f"| {arch} | " + " | ".join(
            " / ".join(recs.get((arch, s, m), "not run")
                       for m in ("16x16", "2x16x16"))
            if s in shapes else "-" for s in SHAPES) + " |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["no", "yes", "both"], default="no")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--tag", default="", help="variant tag for perf iterations")
    ap.add_argument("--override", action="append", default=[],
                    help="key=value Parallelism/ModelConfig override")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--summary", action="store_true",
                    help="print a Markdown table of --out's records and "
                         "exit")
    args = ap.parse_args(argv)
    if args.summary:
        print(summary(Path(args.out)))
        return 0

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        with contextlib.suppress(json.JSONDecodeError):
            v = json.loads(v)
        overrides[k] = v

    from repro_torch.configs import all_cells, arch_cells
    from repro_torch.launch.mesh import make_production_mesh
    if args.all:
        cells = all_cells()
    else:
        assert args.arch, "--arch required without --all"
        cells = arch_cells(args.arch) if not args.shape else \
            [(args.arch, args.shape)]

    pods = {"no": [False], "yes": [True], "both": [False, True]}[args.multi_pod]
    out_dir = Path(args.out)
    failures = []
    # one fake group a mesh size (a process holds one default group)
    for mp in pods:
        with fake_world(512 if mp else 256):
            mesh = make_production_mesh(multi_pod=mp, device_type="cpu")
            for arch, shape in cells:
                pod = "multipod" if mp else "pod"
                fname = out_dir / f"{arch}_{shape}_{pod}" \
                    f"{('_' + args.tag) if args.tag else ''}.json"
                if args.skip_existing and fname.exists():
                    prev = json.loads(fname.read_text())
                    if prev.get("status") == "ok":
                        print(f"SKIP {arch} {shape} {pod} (cached)")
                        continue
                label = f"{arch} {shape} {pod}"
                try:
                    rec = _run_cell(arch, shape, mesh, mp, out_dir,
                                    overrides=overrides or None,
                                    tag=args.tag)
                    r = rec["roofline"]
                    print(f"OK   {label}: run={rec['t_compile_s']}s "
                          f"flops/dev={rec['flops_per_device']:.3e} "
                          f"est/dev={rec['per_device_live_bytes']/2**30:.2f}"
                          f"GiB fits={rec['fits_hbm']} "
                          f"[comp={r['t_compute_s']:.4f}s "
                          f"mem={r['t_memory_s']:.4f}s "
                          f"coll={r['t_collective_s']:.4f}s -> "
                          f"{r['bottleneck']}]", flush=True)
                except Exception as e:  # noqa: BLE001 — record & continue
                    failures.append(label)
                    out_dir.mkdir(parents=True, exist_ok=True)
                    fname.write_text(json.dumps(
                        {"arch": arch, "shape": shape, "status": "fail",
                         "error": traceback.format_exc()}, indent=2))
                    print(f"FAIL {label}: {type(e).__name__}: {e}",
                          flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        return 1
    print("\nALL CELLS PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
