"""The lintable-target registry: every stock program and workload the
``python -m repro_torch.kvi.analysis`` CLI (and the CI ``kvi-lint`` step) can
check by name.

Targets are zero-argument factories so nothing is built until asked
for; data is drawn from a fixed seed so lint findings are reproducible.
Paper-scale sizes (conv 32x32, FFT-256, matmul 64x64) — static analysis
never executes anything, so full-size programs lint in milliseconds.
"""
from __future__ import annotations

from typing import Callable, Dict, Union

import numpy as np

from repro_torch.kvi.ir import KviProgram
from repro_torch.kvi.workload import KviWorkload

Target = Union[KviProgram, KviWorkload]

_SEED = 0


def _rng():
    return np.random.default_rng(_SEED)


def _conv(elem_bytes: int = 4) -> KviProgram:
    from repro_torch.kvi.programs import conv2d_program
    rng = _rng()
    lim = {1: 8, 2: 64, 4: 128}[elem_bytes]
    img = rng.integers(-lim, lim, (32, 32)).astype(np.int32)
    filt = rng.integers(-8, 8, (3, 3)).astype(np.int32)
    return conv2d_program(img, filt, shift=4, elem_bytes=elem_bytes)


def _fft(elem_bytes: int = 4) -> KviProgram:
    from repro_torch.kvi.programs import fft_program
    rng = _rng()
    lim = {1: 8, 2: 64, 4: 128}[elem_bytes]
    re = rng.integers(-lim, lim, 256).astype(np.int32)
    im = rng.integers(-lim, lim, 256).astype(np.int32)
    return fft_program(re, im, elem_bytes=elem_bytes)


def _matmul(resident: bool = True, elem_bytes: int = 4) -> KviProgram:
    from repro_torch.kvi.programs import matmul_program
    rng = _rng()
    lim = {1: 4, 2: 32, 4: 64}[elem_bytes]
    A = rng.integers(-lim, lim, (64, 64)).astype(np.int32)
    B = rng.integers(-lim, lim, (64, 64)).astype(np.int32)
    return matmul_program(A, B, shift=2, resident=resident,
                          elem_bytes=elem_bytes)


def _pipeline_demo() -> KviProgram:
    from repro_torch.kvi.programs import pipeline_demo_program
    return pipeline_demo_program(
        _rng().integers(-64, 64, 256).astype(np.int32), stages=4)


def _composite() -> KviWorkload:
    """The paper's composite protocol: conv / FFT / matmul pinned to
    harts 0 / 1 / 2 — the benchmark workload the sweep times."""
    return KviWorkload.composite(
        {0: [_conv()], 1: [_fft()], 2: [_matmul()]},
        name="composite_paper")


def _homogeneous() -> KviWorkload:
    """The homogeneous protocol: one conv replicated on three harts."""
    return KviWorkload.replicate(_conv(), 3)


#: name -> factory; the CLI's ``--all`` iterates this in order
REGISTERED_TARGETS: Dict[str, Callable[[], Target]] = {
    "conv32": _conv,
    "conv32_b16": lambda: _conv(elem_bytes=2),
    "conv32_b8": lambda: _conv(elem_bytes=1),
    "fft256": _fft,
    "matmul64": _matmul,
    "matmul64_streamed": lambda: _matmul(resident=False),
    "pipeline_demo": _pipeline_demo,
    "composite_paper": _composite,
    "conv32x3": _homogeneous,
}


def registered_targets() -> Dict[str, Callable[[], Target]]:
    return dict(REGISTERED_TARGETS)


def build_target(name: str) -> Target:
    try:
        return REGISTERED_TARGETS[name]()
    except KeyError:
        raise KeyError(
            f"unknown lint target {name!r}; available: "
            f"{sorted(REGISTERED_TARGETS)}") from None
