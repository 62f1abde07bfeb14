"""Fused element-wise KVI slot programs: the port of the reference's
``repro/kvi/pallas_backend.py::_fused_kernel``.

A slot program is a tuple of ``(op, dst, src1, src2|None, imm)`` slot
instructions over a small slot file (the same tuples the fusion planner
emits, :class:`~repro_torch.kvi.passes.fusion.FusedRegion`). Three layers:

* :func:`apply_vop` — one op's semantics on torch tensors, computed in
  int64 and wrapped back to the element width with ``.to(dtype)``;
* :func:`fused_vops` — the wrapper: a packed program (:class:`FusedRecord`)
  plus :class:`Windows` (column offsets of every input and output window
  in a ``(rows, width)`` tensor) runs as ONE launch of the CUDA
  interpreter kernel ``csrc/fused_vops.cu`` on a CUDA tensor, or as
  :func:`fused_vops_plain` on a CPU tensor;
* :func:`fused_elementwise_call` — the public counterpart of the
  reference's ``fused_elementwise_call`` over separate input tensors.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import load_library

# one slot instruction: (op, dst, src1, src2|None, imm)
SlotOp = Tuple[str, int, int, Optional[int], int]

OPCODES = {op: code for code, op in enumerate((
    "kaddv", "ksubv", "kvmul", "ksvaddsc", "ksvmulsc", "ksrlv", "ksrav",
    "krelu", "kvslt", "ksvslt", "kvcp"))}
OPS_BY_CODE = {code: op for op, code in OPCODES.items()}
TWO_SOURCE = frozenset({"kaddv", "ksubv", "kvmul", "kvslt"})
MAX_OPS, MAX_INPUTS, MAX_OUTPUTS = 64, 24, 64
MAX_SLOTS = MAX_INPUTS + MAX_OPS
NO_SLOT = 255
DTYPES = {torch.int8: 0, torch.int16: 1, torch.int32: 2}
_INT64 = (-(1 << 63), (1 << 63) - 1)

#: kernel launches so far (the CUDA path only; the plain version and
#: validation failures do not count)
launch_count = 0


def _shift_count(s: int, cap: int) -> int:
    """A shift count as the kernel reads it: counts at or above the
    width (or negative, i.e. huge unsigned) act as ``cap``."""
    return s if 0 <= s <= cap else cap


def apply_vop(op: str, a: torch.Tensor, b: Optional[torch.Tensor],
              imm: int) -> torch.Tensor:
    """Element-wise KVI semantics: wrap-around integer arithmetic like
    the paper's MFU datapath (``repro/core/mfu.py``). ``imm`` is an
    int64; add and mul wrap it, ksvslt compares it exactly."""
    dt = a.dtype
    bits = 8 * a.element_size()
    mask = (1 << bits) - 1
    if op == "kaddv":
        r = a.long() + b.long()
    elif op == "ksubv":
        r = a.long() - b.long()
    elif op == "kvmul":
        r = a.long() * b.long()
    elif op == "ksvaddsc":
        r = a.long() + (imm & mask)
    elif op == "ksvmulsc":
        r = a.long() * (imm & mask)
    elif op == "ksrlv":
        r = (a.long() & mask) >> _shift_count(imm, 63)
    elif op == "ksrav":
        r = a.long() >> _shift_count(imm, 63)
    elif op == "krelu":
        r = a.clamp_min(0)
    elif op == "kvslt":
        r = a < b
    elif op == "ksvslt":
        r = a.long() < imm
    elif op == "kvcp":
        r = a
    else:
        raise ValueError(f"{op} is not an element-wise KVI op")
    return r.to(dt)


@dataclass(frozen=True)
class FusedRecord:
    """A slot program packed for launch: ``prog`` is an int64 tensor on
    the target device holding ``[word, imm]`` per op (``word = opcode |
    dst << 8 | src1 << 16 | src2 << 24``, src2 255 when absent), then the
    input slots, then the output slots. Built once per structure."""

    prog: torch.Tensor
    n_ops: int
    n_in: int
    n_out: int
    n_slots: int
    threads: int = 256


def program_words(program: Sequence[SlotOp], in_slots: Sequence[int],
                  out_slots: Sequence[int], n_slots: int) -> List[int]:
    """Validate a slot program against the kernel's limits and pack it
    into the int64 words of :class:`FusedRecord` ``prog``."""
    if not 1 <= len(program) <= MAX_OPS:
        raise ValueError(f"slot program needs 1..{MAX_OPS} ops, "
                         f"got {len(program)}")
    if not 1 <= len(in_slots) <= MAX_INPUTS:
        raise ValueError(f"slot program needs 1..{MAX_INPUTS} inputs, "
                         f"got {len(in_slots)}")
    if not 1 <= len(out_slots) <= MAX_OUTPUTS:
        raise ValueError(f"slot program needs 1..{MAX_OUTPUTS} outputs, "
                         f"got {len(out_slots)}")
    if not 1 <= n_slots <= MAX_SLOTS:
        raise ValueError(f"slot file of {n_slots} exceeds {MAX_SLOTS}")

    def slot(s) -> int:
        if not 0 <= s < n_slots:
            raise ValueError(f"slot {s} outside the slot file of {n_slots}")
        return s

    words: List[int] = []
    for op, d, s1, s2, imm in program:
        if op not in OPCODES:
            raise ValueError(f"{op} is not an element-wise KVI op")
        if op in TWO_SOURCE and s2 is None:
            raise ValueError(f"{op} needs two source slots")
        if not _INT64[0] <= imm <= _INT64[1]:
            raise ValueError(f"{op}: immediate {imm} does not fit int64")
        s2 = NO_SLOT if s2 is None else slot(s2)
        words += [OPCODES[op] | slot(d) << 8 | slot(s1) << 16 | s2 << 24,
                  int(imm)]
    return words + [slot(s) for s in in_slots] + [slot(s) for s in out_slots]


def pack_program(program: Sequence[SlotOp], in_slots: Sequence[int],
                 out_slots: Sequence[int], n_slots: int,
                 device: torch.device, threads: int = 256) -> FusedRecord:
    """Validate a slot program against the kernel's limits and pack it
    into a :class:`FusedRecord` on ``device``."""
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads per block must be a multiple of 32 in "
                         f"[32, 1024], got {threads}")
    words = program_words(program, in_slots, out_slots, n_slots)
    prog = torch.tensor(words, dtype=torch.int64, device=device)
    return FusedRecord(prog, len(program), len(in_slots), len(out_slots),
                       n_slots, threads)


class Windows:
    """Column offsets of a region's input and output windows of length
    ``n`` in a ``(rows, width)`` tensor. ``hazard`` marks an output
    window that overlaps an input window at another offset: run in place,
    one thread's write could then reach another thread's read, so the
    wrapper writes such a region to scratch and copies it back."""

    __slots__ = ("in_cols", "out_cols", "n", "hazard", "scratch_cols")

    def __init__(self, in_cols: Sequence[int], out_cols: Sequence[int],
                 n: int):
        self.in_cols = np.ascontiguousarray(in_cols, dtype=np.int64)
        self.out_cols = np.ascontiguousarray(out_cols, dtype=np.int64)
        self.n = int(n)
        self.hazard = any(o != i and o < i + n and i < o + n
                          for o in self.out_cols.tolist()
                          for i in self.in_cols.tolist())
        self.scratch_cols = np.arange(len(self.out_cols), dtype=np.int64) * n


def _check(record: FusedRecord, win: Windows, src: torch.Tensor,
           dst: torch.Tensor) -> None:
    if src.dtype not in DTYPES or dst.dtype != src.dtype:
        raise TypeError(f"fused_vops takes int8/int16/int32 tensors of one "
                        f"dtype, got {src.dtype} and {dst.dtype}")
    if src.dim() != 2 or dst.dim() != 2 or src.shape[0] != dst.shape[0]:
        raise ValueError(f"fused_vops takes (rows, width) tensors with one "
                         f"row count, got {tuple(src.shape)} and "
                         f"{tuple(dst.shape)}")
    if src.stride(1) != 1 or dst.stride(1) != 1:
        raise ValueError("fused_vops needs unit stride along the columns")
    if not (src.device == dst.device == record.prog.device):
        raise ValueError(f"fused_vops: tensors on {src.device} and "
                         f"{dst.device}, program on {record.prog.device}")
    if (len(win.in_cols) != record.n_in
            or len(win.out_cols) != record.n_out):
        raise ValueError("windows do not match the program's inputs and "
                         "outputs")
    for cols, t in ((win.in_cols, src), (win.out_cols, dst)):
        if cols.min() < 0 or cols.max() + win.n > t.shape[1]:
            raise IndexError(f"window outside the tensor's {t.shape[1]} "
                             f"columns")


def fused_vops(record: FusedRecord, win: Windows, src: torch.Tensor,
               dst: torch.Tensor) -> None:
    """Run the packed slot program over every row: read every input
    window of ``src``, then write every output window of ``dst`` (which
    may be ``src``). CUDA tensors launch the kernel once; CPU tensors run
    :func:`fused_vops_plain`."""
    _check(record, win, src, dst)
    if src.device.type == "cpu":
        fused_vops_plain(record, win, src, dst)
        return
    if src.device.type != "cuda":
        raise ValueError(f"fused_vops: unsupported device {src.device}")
    in_place = (src.untyped_storage().data_ptr()
                == dst.untyped_storage().data_ptr())
    if win.hazard and in_place:
        scratch = torch.empty((dst.shape[0], record.n_out * win.n),
                              dtype=dst.dtype, device=dst.device)
        _launch(record, win.in_cols, win.scratch_cols, src, scratch, win.n)
        for k, c in enumerate(win.out_cols.tolist()):
            dst[:, c:c + win.n].copy_(scratch[:, k * win.n:(k + 1) * win.n])
    else:
        _launch(record, win.in_cols, win.out_cols, src, dst, win.n)


def _launch(record: FusedRecord, in_cols: np.ndarray, out_cols: np.ndarray,
            src: torch.Tensor, dst: torch.Tensor, n: int) -> None:
    global launch_count
    lib = _library()
    rc = lib.fused_vops_launch(
        DTYPES[src.dtype], record.prog.data_ptr(), record.n_ops,
        record.n_in, record.n_out, src.data_ptr(), src.stride(0),
        dst.data_ptr(), dst.stride(0), in_cols.ctypes.data,
        out_cols.ctypes.data, src.shape[0], n, record.threads,
        torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_vops kernel launch failed: CUDA error "
                           f"{rc}")
    launch_count += 1


def _library() -> ctypes.CDLL:
    lib = load_library("fused_vops")
    fn = lib.fused_vops_launch
    if fn.argtypes is None:
        i64, vp, ci = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, ci, ci, ci, vp, i64, vp, i64, vp, vp, i64,
                       i64, ci, vp]
        fn.restype = ci
    return lib


def fused_vops_plain(record: FusedRecord, win: Windows, src: torch.Tensor,
                     dst: torch.Tensor) -> None:
    """The plain PyTorch version of :func:`fused_vops`: decodes the same
    packed program and applies :func:`apply_vop` op by op. Runs on any
    device; the CPU tests and the on-card comparison use it."""
    words = record.prog.cpu().tolist()
    n_ops, n_in = record.n_ops, record.n_in
    in_slots = words[2 * n_ops:2 * n_ops + n_in]
    out_slots = words[2 * n_ops + n_in:]
    n = win.n
    slots: List[Optional[torch.Tensor]] = [None] * record.n_slots
    for s, c in zip(in_slots, win.in_cols.tolist()):
        slots[s] = src[:, c:c + n].clone()        # gather before any write
    for i in range(n_ops):
        w, imm = words[2 * i], words[2 * i + 1]
        op = OPS_BY_CODE[w & 0xff]
        d, s1, s2 = (w >> 8) & 0xff, (w >> 16) & 0xff, (w >> 24) & 0xff
        slots[d] = apply_vop(op, slots[s1],
                             None if s2 == NO_SLOT else slots[s2], imm)
    for s, c in zip(out_slots, win.out_cols.tolist()):
        dst[:, c:c + n].copy_(slots[s])


def fused_elementwise_call(program: Sequence[SlotOp],
                           inputs: Sequence[Tuple[int, torch.Tensor]],
                           out_slots: Sequence[int],
                           n_slots: Optional[int] = None,
                           block: int = 256,
                           batched: bool = False,
                           cache=None) -> List[torch.Tensor]:
    """Run an element-wise slot program as one fused launch.

    ``inputs`` preload (slot, vector) pairs; every entry of ``out_slots``
    comes back as a tensor of the common vector length. All vectors share
    one length, dtype and device. With ``batched=True`` every input is
    ``(N, n)`` and outputs come back ``(N, n)``. ``block`` is the CUDA
    block size. With a cache (anything with the
    :class:`~repro_torch.kvi.torch_backend.KernelCache` ``get``) the
    packed program is built once per structure and device."""
    program = tuple(program)
    if not inputs:
        raise ValueError("fused program needs at least one input vector")
    if n_slots is None:
        n_slots = 1 + max([s for s, _ in inputs] + [o[1] for o in program]
                          + list(out_slots))
    if batched:
        arrs = [x.reshape(x.shape[0], -1) for _, x in inputs]
        N = arrs[0].shape[0]
    else:
        arrs = [x.reshape(1, -1) for _, x in inputs]
        N = None
    n, dt, device = arrs[0].shape[1], arrs[0].dtype, arrs[0].device
    if any(x.shape != arrs[0].shape for x in arrs):
        raise ValueError("input length mismatch in fused program")
    in_slots = tuple(s for s, _ in inputs)
    out_slots = tuple(out_slots)

    def build() -> FusedRecord:
        return pack_program(program, in_slots, out_slots, n_slots, device,
                            block)

    if cache is None:
        record = build()
    else:
        record = cache.get(("fused", program, in_slots, out_slots, n_slots,
                            N, n, block, str(dt), str(device)), build)
    src = torch.cat(arrs, dim=1)
    dst = torch.empty((src.shape[0], len(out_slots) * n), dtype=dt,
                      device=device)
    win = Windows(np.arange(len(arrs)) * n, np.arange(len(out_slots)) * n, n)
    fused_vops(record, win, src, dst)
    outs = [dst[:, k * n:(k + 1) * n] for k in range(len(out_slots))]
    return outs if batched else [o.reshape(n) for o in outs]
