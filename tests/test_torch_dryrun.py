"""The port's dry-run machinery (repro_torch.launch.compile, .dryrun).

* ``estimate_device_memory`` and ``estimate_hbm_traffic`` (both
  ``attention_impl``s) equal the reference's at 1e-9 relative for every
  cell of ``all_cells()`` on both production meshes: arithmetic over
  templates and rules, run on abstract meshes in both packages, the
  port's cell built from the reference's config.
* The dry run of the reference test's two cells (tests/test_dryrun.py)
  on a (2, 4) mesh of a fake process group, in a subprocess that makes
  and destroys its own group, with that test's assertions; its record
  has every key of the reference's (repro/launch/dryrun.py).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
from jax.sharding import AbstractMesh as JaxAbstractMesh

import repro.configs as rcfg
from repro.launch import compile as rcompile
from repro_torch.launch import compile as tcompile
from repro_torch.launch.mesh import AbstractMesh
from test_torch_lm_params import port_spec

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = {
    "pod": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
}
REL = 1e-9

#: the reference's record (repro/launch/dryrun.py:77-95)
RECORD_KEYS = {
    "arch", "shape", "mesh", "axes", "chips", "tag", "kind",
    "flops_per_device", "hbm_bytes_per_device",
    "collective_bytes_per_device", "top_collectives", "memory_analysis",
    "estimated_device_memory", "hbm_traffic_model", "per_device_live_bytes",
    "fits_hbm", "roofline", "downgrades", "t_lower_s", "t_compile_s",
    "status"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "xla_cost_flops_once",
               "xla_cost_bytes_once"}
ROOFLINE_KEYS = {"t_compute_s", "t_memory_s", "t_memory_hlo_upper_s",
                 "t_collective_s", "bottleneck"}


def _close(got: dict, want: dict):
    assert set(got) == set(want), (set(got), set(want))
    for k, w in want.items():
        assert abs(got[k] - w) <= REL * max(abs(w), 1.0), (k, got[k], w)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("cell", rcfg.all_cells(), ids="-".join)
def test_estimates_equal_the_reference(cell, mesh_name):
    arch, shape = cell
    dims, axes = MESHES[mesh_name]
    ref = rcompile.build_cell(arch, shape, JaxAbstractMesh(dims, axes))
    # the port's side built from the reference's config (the stand-in
    # hybrid block for hymba-1.5b)
    port = tcompile.build_cell(
        arch, shape, AbstractMesh(dims, axes),
        overrides=dataclasses.asdict(port_spec(arch).model))
    _close(tcompile.estimate_device_memory(port),
           rcompile.estimate_device_memory(ref))
    _close(tcompile.estimate_hbm_traffic(port),
           rcompile.estimate_hbm_traffic(ref))
    # the flash kernel keeps the scores on chip, as Pallas does
    _close(tcompile.estimate_hbm_traffic(port, attention_impl="kernel"),
           rcompile.estimate_hbm_traffic(ref, attention_impl="pallas"))
    # the same downgrades (the trees are walked in another order: jax
    # sorts dict keys)
    assert sorted(map(str, port.rules.downgrades)) == \
        sorted(map(str, ref.rules.downgrades))


SCRIPT = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    from repro_torch.compat import init_device_mesh
    from repro_torch.launch.dryrun import _run_cell, fake_world

    arch, shape, out = sys.argv[1], sys.argv[2], Path(sys.argv[3])
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        rec = _run_cell(arch, shape, mesh, False, out)
    print("RESULT:" + json.dumps(rec))
""")


def run_cell(arch, shape, tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    p = subprocess.run([sys.executable, "-c", SCRIPT, arch, shape,
                        str(tmp_path)], capture_output=True, text=True,
                       timeout=480, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [l for l in p.stdout.splitlines() if l.startswith("RESULT:")][0]
    rec = json.loads(line[len("RESULT:"):])
    on_disk = json.loads(
        (tmp_path / f"{arch}_{shape}_pod.json").read_text())
    assert on_disk == rec
    return rec


def _check_record(rec):
    assert set(rec) == RECORD_KEYS
    assert set(rec["memory_analysis"]) == MEMORY_KEYS
    assert set(rec["roofline"]) == ROOFLINE_KEYS
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert rec["mesh"] == [2, 4] and rec["axes"] == ["data", "model"]


def test_train_cell_on_8_fake_devices(tmp_path):
    rec = run_cell("llama3.2-1b", "train_4k", tmp_path)
    _check_record(rec)
    assert rec["flops_per_device"] > 1e12         # per-device flops
    coll = rec["collective_bytes_per_device"]["total"]
    assert coll > 1e6                             # TP all-reduces present
    assert rec["per_device_live_bytes"] > 0
    assert rec["hbm_traffic_model"]["total"] > 0
    # --summary's row: this cell on the 16x16 side, the rest not run
    from repro_torch.launch.dryrun import model_flops, summary
    row = [l for l in summary(tmp_path).splitlines()
           if l.startswith("| llama3.2-1b |")][0]
    ratio = rec["flops_per_device"] * 8 / model_flops("llama3.2-1b",
                                                      "train_4k")
    assert row.split(" | ")[1].startswith(
        f"{rec['flops_per_device']:.3e}, ") and f"{ratio:.2f}x / not run" \
        in row


def test_decode_cell_on_8_fake_devices(tmp_path):
    rec = run_cell("mamba2-1.3b", "long_500k", tmp_path)
    _check_record(rec)
    assert rec["flops_per_device"] > 1e8          # one-token decode
    assert rec["per_device_live_bytes"] > 0


MESH_SCRIPT = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import (HW, make_host_mesh,
                                         make_production_mesh)

    out = {}
    for size, multi_pod in ((256, False), (512, True)):
        with fake_world(size):
            m = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            out[str(size)] = [list(m.mesh.shape), list(m.mesh_dim_names)]
    with fake_world(8):
        m = make_host_mesh(device_type="cpu")
        out["host"] = [list(m.mesh.shape), list(m.mesh_dim_names)]
    out["initialized_after"] = dist.is_initialized()
    out["hw"] = HW
    print("RESULT:" + json.dumps(out))
""")


def test_production_and_host_meshes():
    """The production meshes over fake groups of 256 and 512 ranks, the
    host mesh over the world; each group destroyed on exit; HW holds the
    H100's data-sheet figures (no TPU figure)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    p = subprocess.run([sys.executable, "-c", MESH_SCRIPT],
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [l for l in p.stdout.splitlines() if l.startswith("RESULT:")][0]
    r = json.loads(line[len("RESULT:"):])
    assert r["256"] == [[16, 16], ["data", "model"]]
    assert r["512"] == [[2, 16, 16], ["pod", "data", "model"]]
    assert r["host"] == [[8, 1], ["data", "model"]]
    assert not r["initialized_after"]
    assert r["hw"] == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12,
                       "link_bw": 450e9, "hbm_bytes": 80e9}
