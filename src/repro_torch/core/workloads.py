"""Workload assembly + energy model (a copy of the reference's
``repro/core/workloads.py``): reproduce the paper's measurement
protocol (homogeneous = same kernel on all 3 harts on different data;
composite = conv / FFT / MatMul on three respective harts, repeatedly;
metric = average cycle count per computation kernel).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.configs.base import KlessydraConfig, klessydra_taxonomy
from repro_torch.core import baselines
from repro_torch.core.simulator import simulate

RNG = np.random.default_rng(42)


def _lower_items(prog, cfg):
    """Bind a backend-neutral KviProgram to ``cfg`` and return its
    Instr/Scalar trace (lazy import: repro_torch.kvi imports
    repro_torch.core.isa)."""
    from repro_torch.kvi.lowering import lower
    return lower(prog, cfg).items


def _cyclesim(cfg: KlessydraConfig):
    """A CycleSimBackend timing exactly one scheme (lazy import:
    repro_torch.kvi imports repro_torch.core.isa)."""
    from repro_torch.kvi.cyclesim import CycleSimBackend
    return CycleSimBackend(schemes={"scheme": cfg})


def _conv_prog(cfg, S=32, F=3, seed=0):
    from repro_torch.kvi.programs import conv2d_program
    rng = np.random.default_rng(seed)
    img = rng.integers(-128, 128, (S, S)).astype(np.int32)
    filt = rng.integers(-8, 8, (F, F)).astype(np.int32)
    return conv2d_program(img, filt, shift=4)


def _fft_prog(cfg, n=256, seed=0):
    from repro_torch.kvi.programs import fft_program
    rng = np.random.default_rng(seed)
    re = rng.integers(-2048, 2048, n).astype(np.int32)
    im = rng.integers(-2048, 2048, n).astype(np.int32)
    return fft_program(re, im)


def _matmul_prog(cfg, n=64, seed=0):
    from repro_torch.kvi.programs import matmul_program
    rng = np.random.default_rng(seed)
    A = rng.integers(-64, 64, (n, n)).astype(np.int32)
    B = rng.integers(-64, 64, (n, n)).astype(np.int32)
    return matmul_program(A, B, shift=4,
                          spm_bytes=cfg.N * cfg.spm_kbytes * 1024)


KERNEL_BUILDERS: Dict[str, Callable] = {
    "conv4": lambda cfg, seed=0: _conv_prog(cfg, 4, 3, seed),
    "conv8": lambda cfg, seed=0: _conv_prog(cfg, 8, 3, seed),
    "conv16": lambda cfg, seed=0: _conv_prog(cfg, 16, 3, seed),
    "conv32": lambda cfg, seed=0: _conv_prog(cfg, 32, 3, seed),
    "conv32_f5": lambda cfg, seed=0: _conv_prog(cfg, 32, 5, seed),
    "conv32_f7": lambda cfg, seed=0: _conv_prog(cfg, 32, 7, seed),
    "conv32_f9": lambda cfg, seed=0: _conv_prog(cfg, 32, 9, seed),
    "conv32_f11": lambda cfg, seed=0: _conv_prog(cfg, 32, 11, seed),
    "fft256": lambda cfg, seed=0: _fft_prog(cfg, 256, seed),
    "matmul64": lambda cfg, seed=0: _matmul_prog(cfg, 64, seed),
}

BASELINE_ARGS = {
    "conv4": ("conv", dict(S=4)), "conv8": ("conv", dict(S=8)),
    "conv16": ("conv", dict(S=16)), "conv32": ("conv", dict(S=32)),
    "conv32_f5": ("conv", dict(S=32, F=5)),
    "conv32_f7": ("conv", dict(S=32, F=7)),
    "conv32_f9": ("conv", dict(S=32, F=9)),
    "conv32_f11": ("conv", dict(S=32, F=11)),
    "fft256": ("fft", dict(n=256)), "matmul64": ("matmul", dict(n=64)),
}


def homogeneous_workload(cfg: KlessydraConfig, kernel: str,
                         harts: Optional[int] = None):
    """The paper's homogeneous protocol as a KviWorkload: `kernel` on
    every hart, different data per hart (seed = hart index)."""
    from repro_torch.kvi.workload import (HartAssignment, KviWorkload,
                                    WorkloadEntry)
    n = harts if harts is not None else cfg.harts
    entries = tuple(
        WorkloadEntry(KERNEL_BUILDERS[kernel](cfg, seed=h),
                      HartAssignment(h))
        for h in range(n))
    return KviWorkload(f"homogeneous_{kernel}", entries,
                       meta={"kernel": kernel})


COMPOSITE_KERNELS = ("conv32", "fft256", "matmul64")


def composite_workload(cfg: KlessydraConfig,
                       reps: Optional[Dict[str, int]] = None,
                       kernels=COMPOSITE_KERNELS):
    """The paper's composite protocol as a KviWorkload: conv32 / fft256 /
    matmul64 pinned to harts 0/1/2, each repeated ``reps[kernel]`` times
    back-to-back on fresh data (seed = 100*hart + rep). Kernels missing
    from ``reps`` run once."""
    from repro_torch.kvi.workload import KviWorkload
    reps = reps or {"conv32": 6, "fft256": 6, "matmul64": 1}
    by_hart = {
        h: [KERNEL_BUILDERS[kern](cfg, seed=100 * h + r)
            for r in range(reps.get(kern, 1))]
        for h, kern in enumerate(kernels)}
    wl = KviWorkload.composite(by_hart, name="composite")
    wl.meta.update(kernels=tuple(kernels), reps=dict(reps))
    return wl


def homogeneous_cycles(cfg: KlessydraConfig, kernel: str) -> dict:
    """All harts run `kernel` on different data; avg cycles per kernel.
    KERNEL_BUILDERS produce backend-neutral KviPrograms; the workload runs
    through ``CycleSimBackend.run_workload`` bound to ``cfg``."""
    res = _cyclesim(cfg).run_workload(homogeneous_workload(cfg, kernel),
                                      functional=False)
    sim = res.timing["scheme"]
    return {"avg_cycles": sim.cycles / cfg.harts, "total_cycles": sim.cycles,
            "mfu_util": sim.mfu_utilization}


def composite_cycles(cfg: KlessydraConfig, reps: Optional[Dict[str, int]] = None
                     ) -> dict:
    """conv32 / fft256 / matmul64 on harts 0/1/2 repeatedly; per-kernel
    average = hart finish time / instances (the matmul hart dominates)."""
    reps = reps or {"conv32": 6, "fft256": 6, "matmul64": 1}
    res = _cyclesim(cfg).run_workload(composite_workload(cfg, reps),
                                      functional=False)
    sim = res.timing["scheme"]
    out = {}
    for h, kern in enumerate(COMPOSITE_KERNELS):
        out[kern] = sim.per_hart[h].finish_cycle / reps[kern]
    out["total_cycles"] = sim.cycles
    return out


# ---------------------------------------------------------------------------
# energy + absolute-time model (paper Figs 3-4): cycles from OUR simulator,
# fmax + resource counts from the paper's published synthesis table.
# Dynamic power proxy: P ∝ (LUT + 2*FF) * f; energy = P * T = proxy * cycles.
# Normalized against ZeroRiscy exactly as Fig 4 does.
# ---------------------------------------------------------------------------

def exec_time_us(scheme: str, D: int, cycles: float) -> float:
    _, _, fmax = baselines.synthesis_for(scheme, D)
    return cycles / fmax  # us (fmax in MHz)


def energy_proxy(scheme: str, D: int, cycles: float) -> float:
    ff, lut, fmax = baselines.synthesis_for(scheme, D)
    power = (lut + 2.0 * ff)          # ∝ dynamic power / f
    return power * cycles             # ∝ energy (f cancels: E = P/f * cycles)


def energy_per_op(scheme: str, D: int, cycles: float, alg_ops: int) -> float:
    return energy_proxy(scheme, D, cycles) / max(alg_ops, 1)
