"""Batched reductions: kdotp / kdotpps / kvred (paper Table 1), the port
of the reference's ``repro/kernels/kdotp.py::_reduce_kernel``.

:func:`reduce_rows` reduces every row of a ``(rows, n)`` operand (or the
element-wise product of two) into one element per row, with a flush step:

* ``ORACLE`` mode (what the KVI backend uses): the exact 64-bit modular
  sum, then the post op — an arithmetic shift (kdotpps), a scalar add
  (ksvaddrf) or a scalar multiply (ksvmulrf, ``s * sum(a) == sum(a * s)``
  mod 2^64) — then a wrap to the destination's width. Bit-identical to
  the oracle (``repro/core/mfu.py``), also where the sum overflows int32.
* ``WRAP32`` mode (the public :func:`kdotp` / :func:`kdotpps` /
  :func:`kvred`): wrap the sum to int32 first, then shift — the order of
  the reference Pallas kernel and ``repro.kernels.ref.kdotp_ref``.

uint8 operands widen without sign (the reference's ``astype(int32)``).
float32 operands accumulate in float32 and a shift divides by 2^shift.
On a CUDA tensor the wrapper launches ``csrc/kdotp.cu`` once for all
rows; on a CPU tensor it runs :func:`reduce_rows_plain`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import load_library

ORACLE, WRAP32 = 0, 1
POST_NONE, POST_SHIFT, POST_ADD, POST_MUL = 0, 1, 2, 3
DTYPES = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.float32: 3,
          torch.uint8: 4}
_INT64 = (-(1 << 63), (1 << 63) - 1)
_M32 = 0xFFFFFFFF

#: kernel launches so far (the CUDA path only)
launch_count = 0


def _check(out: torch.Tensor, a: torch.Tensor, b: Optional[torch.Tensor],
           post: int, scalar: int, mode: int) -> None:
    if a.dtype not in DTYPES:
        raise TypeError(f"reduce_rows takes int8/int16/int32/uint8/float32, "
                        f"got {a.dtype}")
    if a.dim() != 2 or a.stride(1) != 1:
        raise ValueError("reduce_rows takes a (rows, n) operand with unit "
                         "column stride")
    if b is not None and (b.dtype != a.dtype or b.shape != a.shape
                          or b.stride(1) != 1 or b.device != a.device):
        raise ValueError("reduce_rows: the second operand must match the "
                         "first in dtype, shape, device and unit stride")
    if out.dim() != 1 or out.shape[0] != a.shape[0] or out.device != a.device:
        raise ValueError(f"reduce_rows: out must be ({a.shape[0]},) on "
                         f"{a.device}, got {tuple(out.shape)} on {out.device}")
    is_float = a.dtype == torch.float32
    if is_float != (out.dtype == torch.float32) or out.dtype not in DTYPES:
        raise TypeError(f"reduce_rows: {a.dtype} operands cannot flush into "
                        f"{out.dtype}")
    if mode not in (ORACLE, WRAP32) or post not in (
            POST_NONE, POST_SHIFT, POST_ADD, POST_MUL):
        raise ValueError(f"reduce_rows: bad mode {mode} or post op {post}")
    if (is_float or mode == WRAP32) and post not in (POST_NONE, POST_SHIFT):
        raise ValueError("float and WRAP32 reductions flush with a shift "
                         "only")
    if not _INT64[0] <= scalar <= _INT64[1]:
        raise ValueError(f"scalar {scalar} does not fit int64")


def reduce_rows(out: torch.Tensor, a: torch.Tensor,
                b: Optional[torch.Tensor] = None, *, post: int = POST_NONE,
                scalar: int = 0, mode: int = ORACLE) -> None:
    """``out[r] = flush(sum_i a[r, i] * b[r, i])`` (``b=None``: the sum
    of ``a[r]``). ``out`` is a 1-D view (any stride, e.g. one column of
    a register file) whose dtype the result wraps to."""
    global launch_count
    _check(out, a, b, post, scalar, mode)
    if a.device.type == "cpu":
        reduce_rows_plain(out, a, b, post=post, scalar=scalar, mode=mode)
        return
    if a.device.type != "cuda":
        raise ValueError(f"reduce_rows: unsupported device {a.device}")
    rows, n = a.shape
    threads = min(256, max(32, -(-n // 32) * 32))
    rc = _library().kdotp_rows(
        DTYPES[a.dtype], DTYPES[out.dtype], a.data_ptr(),
        None if b is None else b.data_ptr(), a.stride(0),
        0 if b is None else b.stride(0), out.data_ptr(), out.stride(0),
        rows, n, post, scalar, mode, threads,
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kdotp kernel launch failed: CUDA error {rc}")
    launch_count += 1


def _library() -> ctypes.CDLL:
    lib = load_library("kdotp")
    fn = lib.kdotp_rows
    if fn.argtypes is None:
        i64, vp, ci = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, ci, vp, vp, i64, i64, vp, i64, i64, i64, ci, i64,
                       ci, ci, vp]
        fn.restype = ci
    return lib


def reduce_rows_plain(out: torch.Tensor, a: torch.Tensor,
                      b: Optional[torch.Tensor] = None, *,
                      post: int = POST_NONE, scalar: int = 0,
                      mode: int = ORACLE) -> None:
    """The plain PyTorch version of :func:`reduce_rows` (int64 work, cast
    down with ``.to``). Runs on any device."""
    if a.dtype == torch.float32:
        acc = (a * b if b is not None else a).sum(dim=1)
        if post == POST_SHIFT:
            acc = acc / 2.0 ** scalar
        out.copy_(acc)
        return
    acc = (a.long() * b.long() if b is not None else a.long()).sum(
        dim=1, dtype=torch.int64)
    if mode == WRAP32:
        acc = acc.to(torch.int32)
        if post == POST_SHIFT:
            acc = acc >> (scalar if 0 <= scalar < 32 else 31)
    elif post == POST_SHIFT:
        acc = acc >> (scalar if 0 <= scalar < 64 else 63)
    elif post == POST_ADD:
        acc = ((acc & _M32) + (scalar & _M32)) & _M32
    elif post == POST_MUL:
        # the low 32 bits of acc * scalar, without int64 overflow: only
        # they survive the wrap to an element of at most 32 bits
        lo, hi = scalar & 0xFFFF, (scalar >> 16) & 0xFFFF
        acc = acc & _M32
        acc = (acc * lo + (((acc * hi) & 0xFFFF) << 16)) & _M32
    out.copy_(acc)                  # wraps to out's width


def _scalar_reduce(a: torch.Tensor, b: Optional[torch.Tensor],
                   shift: int) -> torch.Tensor:
    a = a.reshape(1, -1)
    b = None if b is None else b.reshape(1, -1)
    out_dtype = torch.float32 if a.dtype == torch.float32 else torch.int32
    out = torch.empty((1,), dtype=out_dtype, device=a.device)
    reduce_rows(out, a.contiguous(), None if b is None else b.contiguous(),
                post=POST_SHIFT if shift else POST_NONE, scalar=shift,
                mode=WRAP32)
    return out[0]


def kdotp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum(a * b)`` as an int32 (wrapped) or float32 0-d tensor."""
    return _scalar_reduce(a, b, 0)


def kdotpps(a: torch.Tensor, b: torch.Tensor, shift: int) -> torch.Tensor:
    """``kdotp`` with the post-scaling shift applied at flush (after the
    wrap to int32, as the reference kernel does)."""
    return _scalar_reduce(a, b, shift)


def kvred(a: torch.Tensor) -> torch.Tensor:
    """``sum(a)`` as an int32 (wrapped) or float32 0-d tensor."""
    return _scalar_reduce(a, None, 0)
