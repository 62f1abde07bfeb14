"""Dense matrix product, the port of the reference's
``repro/kernels/spm_matmul.py::_matmul_kernel``.

``spm_matmul(a, b)`` computes ``a [M, K] @ b [K, N]``: int8 operands
accumulate in a wrapping 32-bit integer and give int32; float32 and
bf16 operands accumulate in float32 (never TF32) and give the input's
dtype, or ``out_dtype`` (float32 or bf16). Any M, K, N.

On a CUDA tensor the wrapper launches one of the two kernels of
``csrc/spm_matmul.cu``, picked by the operand type: bf16 and int8 run
the tensor-core kernel (wgmma fed by TMA; :data:`tc_launch_count`), on
operands that :func:`tc_operands` pads to 16-byte rows and, for int8,
transposes to ``[N, K]``; float32 runs the CUDA-core kernel (float32
on the tensor cores would be TF32). This is a dispatch on the type, not
a fallback: a launch that fails raises. On a CPU tensor the wrapper runs
:func:`spm_matmul_plain`. The reference's TPU block sizes (``bm``,
``bn``, ``bk``) and ``interpret`` have no counterpart: the CUDA kernels'
tiles are fixed.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.common import round_up

IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 3}

#: kernel launches so far (the CUDA path only), both kernels
launch_count = 0
#: of those, launches of the tensor-core kernel (bf16 and int8)
tc_launch_count = 0


def uses_tensor_cores(dtype: torch.dtype) -> bool:
    """Whether a product of ``dtype`` operands runs the tensor-core
    kernel on the card (bf16, int8) or the CUDA-core one (float32)."""
    return dtype in (torch.bfloat16, torch.int8)


def result_dtype(dtype: torch.dtype,
                 out_dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """The output dtype of a product of ``dtype`` operands: int32 for
    int8, else ``out_dtype`` or the input's dtype."""
    if dtype not in IN_DTYPES:
        raise TypeError(f"spm_matmul takes float32, bfloat16 or int8 "
                        f"operands, got {dtype}")
    if dtype == torch.int8:
        if out_dtype not in (None, torch.int32):
            raise TypeError(f"an int8 product gives int32, not {out_dtype}")
        return torch.int32
    out = dtype if out_dtype is None else out_dtype
    if out not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a float product gives float32 or bfloat16, not "
                        f"{out}")
    return out


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"spm_matmul takes [M, K] @ [K, N], got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"spm_matmul operands differ: {a.dtype} on "
                         f"{a.device} and {b.dtype} on {b.device}")


def spm_matmul(a: torch.Tensor, b: torch.Tensor, *,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` (see the module docstring for types). CUDA tensors
    launch one kernel once; CPU tensors run :func:`spm_matmul_plain`."""
    global launch_count, tc_launch_count
    _check(a, b)
    od = result_dtype(a.dtype, out_dtype)
    if a.device.type == "cpu":
        return spm_matmul_plain(a, b, out_dtype=od)
    if a.device.type != "cuda":
        raise ValueError(f"spm_matmul: unsupported device {a.device}")
    (M, K), N = a.shape, b.shape[1]
    c = torch.empty((M, N), dtype=od, device=a.device)
    if c.numel() == 0:
        return c
    stream = torch.cuda.current_stream(a.device).cuda_stream
    lib = _library()
    if uses_tensor_cores(a.dtype):
        ak, bk = tc_operands(a, b)
        rc = lib.spm_matmul_tc_launch(
            IN_DTYPES[a.dtype], OUT_DTYPES[od], ak.data_ptr(), bk.data_ptr(),
            c.data_ptr(), M, N, ak.shape[1], bk.shape[-1], stream)
    else:
        a, b = a.contiguous(), b.contiguous()
        rc = lib.spm_matmul_launch(IN_DTYPES[a.dtype], OUT_DTYPES[od],
                                   a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                   M, N, K, stream)
    if rc != 0:
        raise RuntimeError(f"spm_matmul kernel launch failed: CUDA error {rc}")
    launch_count += 1
    tc_launch_count += uses_tensor_cores(a.dtype)
    return c


def _aligned(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``x`` as a contiguous, 16-byte aligned ``[rows, cols]`` tensor,
    zero-padded on the right and at the bottom; ``x`` itself when it is
    one already."""
    if tuple(x.shape) == (rows, cols):
        x = x.contiguous()
        if x.data_ptr() % 16 == 0:
            return x
    out = x.new_zeros((rows, cols))
    out[:x.shape[0], :x.shape[1]] = x
    return out


def tc_operands(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core kernel's operands for ``a [M, K] @ b [K, N]``:
    TMA needs rows that are whole 16-byte multiples, so K is padded with
    zeros to a multiple of 8 (bf16) or 16 (int8), and a bf16 b's N to a
    multiple of 8 — zero terms leave every sum as it is. bf16 gives
    ``(a [M, Kp], b [Kp, Np])`` (the kernel reads b N-major); int8 gives
    ``(a [M, Kp], b^T [N, Kp])``, since 8-bit tensor-core operands must
    be K-major. Runs on any device; on the card its copies are glue
    outside the kernel."""
    (M, K), N = a.shape, b.shape[1]
    if a.dtype == torch.int8:
        Kp = round_up(max(K, 1), 16)
        return _aligned(a, M, Kp), _aligned(b.t(), N, Kp)
    Kp = round_up(max(K, 1), 8)
    return _aligned(a, M, Kp), _aligned(b, Kp, round_up(N, 8))


def _library() -> ctypes.CDLL:
    lib = load_library("spm_matmul")
    fn = lib.spm_matmul_launch
    if fn.argtypes is None:
        i64, vp, ci = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, ci, vp, vp, vp, i64, i64, i64, vp]
        fn.restype = ci
        tc = lib.spm_matmul_tc_launch
        tc.argtypes = [ci, ci, vp, vp, vp, i64, i64, i64, i64, vp]
        tc.restype = ci
    return lib


def spm_matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`spm_matmul`, on any device.

    int8 multiplies in float64, which is exact (every product is below
    2^14 in magnitude, so every partial sum stays below 2^53 while
    K < 2^39) and runs on the card, where ``torch.matmul`` takes no
    integer tensors; the sum then wraps to int32 like the reference's
    accumulator. Floats multiply in float32 (``torch.matmul``; TF32 is
    off by PyTorch's default) and round once to the output dtype."""
    _check(a, b)
    od = result_dtype(a.dtype, out_dtype)
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).long().to(torch.int32)
    return (a.float() @ b.float()).to(od)
