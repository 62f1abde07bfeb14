"""The port carries programs and plans across from the reference package
and stands alone: ``program_from_reference`` round trips, the copied
pass pipeline plans the same fusion regions, the copied builders emit the
same programs, and no module of the port imports ``jax`` or ``repro``."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kvi import passes as ref_passes
from repro.kvi import programs as ref_programs
from repro.kvi.workload import structural_signature as ref_signature
import repro_torch.kvi as tk
from repro_torch.kvi import programs as port_programs
from repro_torch.kvi.torch_backend import TorchBackend

ROOT = Path(__file__).resolve().parents[1]


def _paper_programs(mod, eb=4):
    rng = np.random.default_rng(0)
    img = rng.integers(-50, 50, (8, 8))
    f3, f5 = rng.integers(-4, 5, (3, 3)), rng.integers(-4, 5, (5, 5))
    A, B = rng.integers(-50, 50, (8, 8)), rng.integers(-50, 50, (8, 8))
    x = rng.integers(-100, 100, 32)
    return {
        "conv_f3": mod.conv2d_program(img, f3, shift=2, elem_bytes=eb),
        "conv_f5": mod.conv2d_program(img, f5, shift=3, elem_bytes=eb),
        "matmul_resident": mod.matmul_program(A, B, resident=True,
                                              elem_bytes=eb),
        "matmul_streamed": mod.matmul_program(A, B, shift=4, resident=False,
                                              elem_bytes=eb),
        "fft32": mod.fft_program(x, x[::-1], elem_bytes=eb),
        "demo": mod.pipeline_demo_program(x, stages=3),
    }


def _instr_tuple(it):
    if hasattr(it, "op"):
        refs = tuple(None if r is None else (r.space, r.id, r.offset)
                     for r in (it.dst, it.src1, it.src2))
        return (it.op.value, refs, it.scalar, it.length, it.elem_bytes)
    return ("scalar", it.count)


@pytest.mark.parametrize("name", sorted(_paper_programs(ref_programs)))
def test_program_from_reference_round_trip(name):
    ref = ref_passes.optimize_program(_paper_programs(ref_programs)[name])
    port = tk.program_from_reference(ref)
    assert isinstance(port, tk.KviProgram)
    assert port.name == ref.name and port.alg_ops == ref.alg_ops
    assert [_instr_tuple(i) for i in port.items] == \
        [_instr_tuple(i) for i in ref.items]
    assert [(r.name, r.id, r.length, r.elem_bytes) for r in port.vregs] == \
        [(r.name, r.id, r.length, r.elem_bytes) for r in ref.vregs]
    assert [(m.name, m.id, m.length, m.elem_bytes, m.is_output)
            for m in port.mems] == [(m.name, m.id, m.length, m.elem_bytes,
                                     m.is_output) for m in ref.mems]
    for k, v in ref.mem_init.items():
        np.testing.assert_array_equal(port.mem_init[k], v)
        assert port.mem_init[k].dtype == v.dtype
        assert port.mem_init[k] is not v                  # copied
    # the reference's plan is dropped; everything else in meta carries
    assert "fused_regions" not in port.meta
    assert {k: v for k, v in ref.meta.items() if k != "fused_regions"} \
        == port.meta


def _region_tuple(r):
    return (r.items, r.length, r.elem_bytes, r.ops, r.inputs, r.outputs,
            r.n_slots)


@pytest.mark.parametrize("eb", [1, 4])
@pytest.mark.parametrize("name", sorted(_paper_programs(ref_programs)))
def test_copied_pipeline_plans_the_same_regions(name, eb):
    ref = _paper_programs(ref_programs, eb)[name]
    ref_opt = ref_passes.optimize_program(ref)
    port_opt = tk.optimize_program(tk.program_from_reference(ref))
    # matmul_streamed has no element-wise chain, hence no plan
    ref_plan = ref_opt.meta.get("fused_regions")
    port_plan = port_opt.meta.get("fused_regions")
    assert (ref_plan is None) == (port_plan is None) == (
        name == "matmul_streamed")
    if port_plan is not None:
        assert [_region_tuple(r) for r in port_plan.regions] == \
            [_region_tuple(r) for r in ref_plan.regions]
        assert (port_plan.max_ops, port_plan.max_inputs) == (64, 24)
    assert [_instr_tuple(i) for i in port_opt.items] == \
        [_instr_tuple(i) for i in ref_opt.items]


@pytest.mark.parametrize("eb", [1, 2, 4])
def test_copied_builders_emit_the_same_programs(eb):
    refs = _paper_programs(ref_programs, eb)
    ports = _paper_programs(port_programs, eb)
    for name, ref in refs.items():
        port = ports[name]
        assert tk.structural_signature(port) == tk.structural_signature(
            tk.program_from_reference(ref)), name
        assert ref_signature(ref)[1:] == tk.structural_signature(port)[1:]
        assert port.mem_init.keys() == ref.mem_init.keys()
        for k, v in ref.mem_init.items():
            np.testing.assert_array_equal(port.mem_init[k], v)
            assert port.mem_init[k].dtype == v.dtype


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.kvi, repro_torch.kernels.checks\n"
            "import repro_torch.kernels.ops, repro_torch.kernels.ref\n"
            "import repro_torch.kernels.micro, repro_torch.models\n"
            "import repro_torch.kernels.flash_attention\n"
            "import repro_torch.kernels.ssd_scan\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src"),
                        "PATH": "/usr/bin:/bin"}, cwd=ROOT, timeout=120)


def test_default_device_is_the_card():
    """``TorchBackend()`` runs on the card, and raises without one: there
    is no silent CPU fallback."""
    if torch.cuda.is_available():
        assert TorchBackend().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchBackend()
        with pytest.raises(RuntimeError):
            tk.get_backend("torch")
