"""Analytic cycle models for the comparison cores of Table 2 (a copy of
the reference's ``repro/core/baselines.py``).

  * Klessydra-T03: the same IMT core without the vector coprocessor —
    scalar RV32IMA code, IPC=1 aggregate across 3 harts (no stalls by
    construction), no DSP/hardware-loop support.
  * RI5CY: single-issue in-order with DSP extension (MAC + hardware loops)
    — fewer instructions per MAC, but load-use and branch stalls.
  * ZeroRiscy: 2-stage single-issue, no DSP — more cycles per MAC
    (multi-cycle multiplier) + branch overhead.

The per-MAC instruction constants are calibrated once against the paper's
published Table 2 cycle counts (they are *data*, recorded below), and the
models then generalize across kernel sizes — benchmarks/table2 checks the
model against every published cell.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ScalarCoreModel:
    name: str
    # cycles per inner-loop MAC (load, mul, add, store amortized, index)
    conv_mac: float
    matmul_mac: float
    fft_butterfly: float            # cycles per radix-2 butterfly
    loop_overhead: float            # per inner-loop iteration extra
    kernel_overhead: float = 200.0  # setup/teardown per kernel


def conv_cycles(m: ScalarCoreModel, S: int, F: int) -> int:
    macs = S * S * F * F
    return int(macs * (m.conv_mac + m.loop_overhead) + m.kernel_overhead)


def matmul_cycles(m: ScalarCoreModel, n: int) -> int:
    macs = n ** 3
    return int(macs * (m.matmul_mac + m.loop_overhead) + m.kernel_overhead)


def fft_cycles(m: ScalarCoreModel, n: int) -> int:
    bf = (n // 2) * int(np.log2(n))
    reorder = 6 * n
    return int(bf * m.fft_butterfly + reorder + m.kernel_overhead)


# Calibrated so that the model reproduces the paper's Table 2 within a few
# percent on the published sizes (conv 4..32 w/ 3x3, fft 256, matmul 64):
#   T03:      conv32 79230, fft 47256, matmul 2679304
#   RI5CY:    conv32 57020, fft 37344, matmul 1360854
#   ZeroRiscy conv32 113793, fft 61158, matmul 4006241
T03 = ScalarCoreModel("klessydra-t03", conv_mac=8.2, matmul_mac=9.7,
                      fft_butterfly=44.0, loop_overhead=0.4)
RI5CY = ScalarCoreModel("ri5cy", conv_mac=5.9, matmul_mac=4.9,
                        fft_butterfly=35.0, loop_overhead=0.3)
ZERORISCY = ScalarCoreModel("zeroriscy", conv_mac=11.9, matmul_mac=14.5,
                            fft_butterfly=57.0, loop_overhead=0.4)

BASELINES = {m.name: m for m in (T03, RI5CY, ZERORISCY)}


def baseline_cycles(core: str, kernel: str, **kw) -> int:
    m = BASELINES[core]
    if kernel == "conv":
        return conv_cycles(m, kw["S"], kw.get("F", 3))
    if kernel == "matmul":
        return matmul_cycles(m, kw["n"])
    if kernel == "fft":
        return fft_cycles(m, kw["n"])
    raise ValueError(kernel)


# Published synthesis data (paper Table 2) — used by the energy/time
# figures; these are *inputs from the paper*, not our results.
SYNTHESIS = {
    # name: dict(D -> (FF, LUT, fmax_MHz))
    "sisd":          {1: (2488, 6982, 144.4)},
    "simd":          {2: (2627, 8400, 146.0), 4: (3301, 11366, 137.2),
                      8: (4800, 17331, 137.7)},
    "sym_mimd":      {1: (3512, 10458, 148.2)},
    "sym_mimd_simd": {2: (4712, 15943, 131.7), 4: (6753, 25089, 120.0),
                      8: (10854, 43419, 105.1)},
    "het_mimd":      {1: (3012, 10182, 117.2)},
    "het_mimd_simd": {2: (3871, 15577, 128.9), 4: (5015, 23282, 122.0),
                      8: (7325, 42944, 108.6)},
    "klessydra-t03": {0: (1418, 4281, 221.1)},
    "ri5cy":         {0: (2527, 7674, 91.4)},
    "zeroriscy":     {0: (1933, 5275, 117.2)},
}


def synthesis_for(scheme: str, D: int):
    """(FF, LUT, fmax_MHz) for a Klessydra config or baseline core."""
    key = {
        ("SISD", 1): ("sisd", 1),
        ("SIMD", 0): ("simd", D),
        ("SymMIMD", 1): ("sym_mimd", 1),
        ("SymMIMD+SIMD", 0): ("sym_mimd_simd", D),
        ("HetMIMD", 1): ("het_mimd", 1),
        ("HetMIMD+SIMD", 0): ("het_mimd_simd", D),
    }
    if scheme in ("klessydra-t03", "ri5cy", "zeroriscy"):
        return SYNTHESIS[scheme][0]
    for (s, d), (grp, dd) in key.items():
        if s == scheme and (d == 1 and D == 1 or d == 0 and D > 1):
            return SYNTHESIS[grp][dd]
    raise KeyError((scheme, D))
