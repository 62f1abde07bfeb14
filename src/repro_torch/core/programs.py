"""DEPRECATED authoring layer, the port of the reference's
``repro/core/programs.py`` — the paper's kernels live in
``repro_torch.kvi.programs`` as backend-neutral
:class:`~repro_torch.kvi.ir.KviProgram` definitions (authored once,
executed on the oracle / cyclesim / torch backends).

This module remains as a thin compatibility shim:

  * ``build_conv2d`` / ``build_fft`` / ``build_matmul`` return the legacy
    :class:`Program` (an ``Instr``/``Scalar`` trace bound to one config),
    produced by lowering the canonical KVI programs.
  * ``ProgramBuilder`` still works for hand-rolled traces but emits a
    ``DeprecationWarning``; use :class:`repro_torch.kvi.KviProgramBuilder`.
  * :func:`_run_items` replays a trace on the SPM/main-memory model — it
    is also what :meth:`repro_torch.kvi.lowering.LoweredTrace.execute`
    runs.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, List, Union

import numpy as np

from repro_torch.configs.base import KlessydraConfig
from repro_torch.core.isa import Instr, Scalar
from repro_torch.core.mfu import Mfu
from repro_torch.core.spm import SpmSpace

# NOTE: repro_torch.kvi is imported lazily inside the shim builders below —
# repro_torch.kvi.lowering imports repro_torch.core.isa, so a module-level
# import here would make the two packages circular.

Item = Union[Instr, Scalar]


@dataclass
class Program:
    name: str
    items: List[Item]
    alg_ops: int                     # algorithmic mul+add count (energy denom)
    builder: "ProgramBuilder"

    @property
    def n_instructions(self) -> int:
        return sum(i.count if isinstance(i, Scalar) else 1
                   for i in self.items)


def _run_items(items, spm: SpmSpace, mem: Dict[int, np.ndarray]):
    """Replay a trace on the SPM/main-memory model, spilling register-file
    reduction results (``rf_store``) back into the SPM. (Shared with
    ``repro_torch.kvi.lowering.LoweredTrace.execute``; rf_store is the
    new 3-tuple ``(addr, elem_index, elem_bytes)`` or the legacy 2-tuple.)"""
    mfu = Mfu(spm, mem)
    for it in items:
        if isinstance(it, Instr):
            r = mfu.execute(it)
            tgt = getattr(it, "rf_store", None)
            if tgt is not None and r is not None:
                addr, j, eb = tgt if len(tgt) == 3 else (*tgt, 4)
                dt = {1: np.int8, 2: np.int16, 4: np.int32}[eb]
                # wrap to the destination width like the hardware store
                # (np >= 2 raises on out-of-range python ints otherwise)
                spm.write(addr + eb * j, np.array([r], np.int64).astype(dt))
    return mem


class ProgramBuilder:
    """Emit-and-execute assembler for KVI traces.

    .. deprecated:: use :class:`repro_torch.kvi.KviProgramBuilder` — it produces
       a backend-neutral program instead of a config-bound trace.
    """

    def __init__(self, config: KlessydraConfig, _warn: bool = True):
        if _warn:
            warnings.warn(
                "repro_torch.core.programs.ProgramBuilder is deprecated; "
                "author programs with repro_torch.kvi.KviProgramBuilder and "
                "run them through repro_torch.kvi.get_backend(...)",
                DeprecationWarning, stacklevel=2)
        self.cfg = config
        self.spm = SpmSpace(config)
        self.mem: Dict[int, np.ndarray] = {}
        self._mem_next = 0
        self.items: List[Item] = []

    # ---- memory handles --------------------------------------------------
    def to_memory(self, arr: np.ndarray) -> int:
        h = self._mem_next
        self._mem_next += 1
        self.mem[h] = np.ascontiguousarray(arr)
        return h

    # ---- emitters ----------------------------------------------------------
    def emit(self, op: str, **kw) -> Instr:
        i = Instr(op, **kw)
        self.items.append(i)
        return i

    def scalar(self, n: int):
        if n > 0:
            self.items.append(Scalar(n))

    def kmemld(self, dst_addr: int, mem_handle: int, length: int):
        self.emit("kmemld", dst=dst_addr, src1=mem_handle, length=length)

    def kmemstr(self, mem_handle: int, src_addr: int, length: int):
        self.emit("kmemstr", dst=mem_handle, src1=src_addr, length=length)

    # ---- finish ------------------------------------------------------------
    def finish(self, name: str, alg_ops: int) -> Program:
        return Program(name, self.items, alg_ops, self)

    def run_functional(self) -> Dict[int, np.ndarray]:
        """Execute the trace on the SPM/main-memory model."""
        return _run_items(self.items, self.spm, self.mem)


def _legacy_program(kvi_prog, cfg: KlessydraConfig) -> Program:
    """Lower a KVI program to one config and wrap it in the legacy
    ``Program``/``ProgramBuilder`` shape existing call sites expect."""
    from repro_torch.kvi.lowering import lower
    trace = lower(kvi_prog, cfg)
    pb = ProgramBuilder(cfg, _warn=False)
    pb.spm = trace.spm
    pb.mem = trace.mem
    pb._mem_next = len(trace.mem)
    pb.items = trace.items
    prog = Program(kvi_prog.name, trace.items, kvi_prog.alg_ops, pb)
    prog.kvi_program = kvi_prog
    prog.trace = trace
    return prog


# ---------------------------------------------------------------------------
# Legacy builders — now shims over repro_torch.kvi.programs
# ---------------------------------------------------------------------------

def build_matmul(cfg: KlessydraConfig, A: np.ndarray, B: np.ndarray,
                 shift: int = 0) -> Program:
    from repro_torch.kvi.programs import matmul_program
    spm_bytes = cfg.N * cfg.spm_kbytes * 1024
    kp = matmul_program(A, B, shift=shift, spm_bytes=spm_bytes)
    return _legacy_program(kp, cfg)


def build_conv2d(cfg: KlessydraConfig, img: np.ndarray, filt: np.ndarray,
                 shift: int = 0) -> Program:
    from repro_torch.kvi.programs import conv2d_program
    kp = conv2d_program(img, filt, shift=shift)
    return _legacy_program(kp, cfg)


def build_fft(cfg: KlessydraConfig, x_re: np.ndarray,
              x_im: np.ndarray) -> Program:
    from repro_torch.kvi.programs import fft_program
    kp = fft_program(x_re, x_im)
    prog = _legacy_program(kp, cfg)
    prog.out_handles = (prog.trace.out_handles["out_re"],
                        prog.trace.out_handles["out_im"])
    return prog


# ---------------------------------------------------------------------------
# Result collectors (trace-level, unchanged API)
# ---------------------------------------------------------------------------

def matmul_result(prog: Program, n: int, p: int) -> np.ndarray:
    """Collect the per-row kmemstr outputs back into a matrix."""
    rows = []
    for it in prog.items:
        if isinstance(it, Instr) and it.op == "kmemstr":
            rows.append(prog.builder.mem[it.dst])
    return np.stack(rows[-n:], axis=0)


def conv2d_result(prog: Program, S: int) -> np.ndarray:
    rows = []
    for it in prog.items:
        if isinstance(it, Instr) and it.op == "kmemstr":
            rows.append(prog.builder.mem[it.dst])
    return np.stack(rows[-S:], axis=0)


def conv2d_oracle(img: np.ndarray, filt: np.ndarray, shift: int = 0):
    S, F = img.shape[0], filt.shape[0]
    pad = F // 2
    padded = np.zeros((S + 2 * pad, S + 2 * pad), np.int64)
    padded[pad:pad + S, pad:pad + S] = img
    out = np.zeros((S, S), np.int64)
    for fr in range(F):
        for fc in range(F):
            out += int(filt[fr, fc]) * padded[fr:fr + S, fc:fc + S]
    return (out >> shift).astype(np.int32) if shift else out.astype(np.int32)


Q = 15                               # Q15 twiddle format (kvi.programs.Q)


def fft_result(prog: Program) -> np.ndarray:
    ore, oim = prog.out_handles
    return (prog.builder.mem[ore].astype(np.float64) +
            1j * prog.builder.mem[oim].astype(np.float64))
