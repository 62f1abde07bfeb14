"""Card tests: each CUDA kernel against its plain PyTorch version on the
same CUDA tensors, at the main path's shapes, and the backend on the card
against the backend on the CPU. Marked ``cuda``; they skip with a reason
where no card (or no nvcc) is present — decided in a fixture, never at
import, so every worker collects the same tests. Run them on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.kvi as tk
from repro_torch.kernels import checks
from repro_torch.kernels import fused_vops as fv
from repro_torch.kernels import kdotp as kd
from repro_torch.kernels.build import nvcc_path
from repro_torch.kvi.programs import conv2d_program, fft_program
from repro_torch.kvi.torch_backend import TorchBackend

pytestmark = pytest.mark.cuda

INT_TYPES = (torch.int8, torch.int16, torch.int32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("hazard", [False, True])
@pytest.mark.parametrize("dtype", INT_TYPES)
@pytest.mark.parametrize("case", [c for c in checks.main_path_cases()
                                  if c[0].startswith("fused")],
                         ids=lambda c: c[0])
def test_fused_kernel_equals_plain(card, case, dtype, hazard):
    rng = np.random.default_rng(3)
    before = fv.launch_count
    shape = dict(case[1])
    if hazard and shape["n"] < 2:
        shape["n"] = 2
    assert checks.check_fused(rng, dtype, device=card, hazard=hazard,
                              **shape) == 0
    torch.cuda.synchronize()
    assert fv.launch_count == before + 1


INT_FLUSHES = [(kd.POST_NONE, 0, kd.ORACLE, True),
               (kd.POST_SHIFT, 9, kd.ORACLE, True),
               (kd.POST_SHIFT, 70, kd.ORACLE, True),
               (kd.POST_NONE, 0, kd.ORACLE, False),
               (kd.POST_ADD, -(1 << 40), kd.ORACLE, False),
               (kd.POST_MUL, 2_000_000_011, kd.ORACLE, False),
               (kd.POST_SHIFT, 7, kd.WRAP32, True),
               (kd.POST_SHIFT, 40, kd.WRAP32, True)]
FLOAT_FLUSHES = [(kd.POST_NONE, 0, kd.WRAP32, True),
                 (kd.POST_SHIFT, 3, kd.WRAP32, True),
                 (kd.POST_NONE, 0, kd.WRAP32, False)]
REDUCE_CASES = [(dt, *f) for dt in INT_TYPES for f in INT_FLUSHES] + \
    [(torch.float32, *f) for f in FLOAT_FLUSHES]


@pytest.mark.parametrize("dtype,post,scalar,mode,dot", REDUCE_CASES)
def test_reduce_kernel_equals_plain(card, dtype, post, scalar, mode, dot):
    rng = np.random.default_rng(4)
    shape = dict(checks.main_path_cases())["kdotp matmul64"]
    before = kd.launch_count
    out_dtypes = (None,) if dtype == torch.float32 else (None, torch.int8)
    for out_dtype in out_dtypes:
        checks.check_reduce(rng, dtype, shape["rows"], shape["n"], card,
                            dot=dot, post=post, scalar=scalar, mode=mode,
                            out_dtype=out_dtype)
    # one long row per block: the strided accumulation and the tree
    checks.check_reduce(rng, dtype, 3, 5000, card, dot=dot, post=post,
                        scalar=scalar, mode=mode)
    assert kd.launch_count == before + len(out_dtypes) + 1


def test_overflowing_kdotpps_on_the_card(card):
    checks.check_overflow_kdotpps(card)


def test_backend_on_the_card_equals_cpu(card):
    rng = np.random.default_rng(5)
    protos = [tk.optimize_program(conv2d_program(
        rng.integers(-99, 99, (16, 16)), rng.integers(-5, 5, (3, 3)),
        shift=4)), tk.optimize_program(fft_program(
            rng.integers(-99, 99, 64), rng.integers(-99, 99, 64)))]
    progs = [p.replace(mem_init={k: rng.permutation(v)
                                 for k, v in p.mem_init.items()})
             for p in protos for _ in range(8)]
    wl = tk.KviWorkload("mix", tuple(tk.WorkloadEntry(p) for p in progs))
    f0, r0 = fv.launch_count, kd.launch_count
    got = TorchBackend(passes=()).run_workload(wl)
    assert fv.launch_count > f0
    want = TorchBackend(device="cpu", passes=()).run_workload(wl)
    assert got.kernel_launches == want.kernel_launches \
        == fv.launch_count - f0 + kd.launch_count - r0
    for g, w in zip(got.entry_results, want.entry_results):
        for name, arr in w.outputs.items():
            np.testing.assert_array_equal(g.outputs[name], arr)
