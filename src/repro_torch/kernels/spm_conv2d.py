"""Same-size 2-D convolution, the port of the reference's
``repro/kernels/spm_conv2d.py::_conv_kernel``.

``spm_conv2d(img, filt, shift=s)`` correlates an ``[H, W]`` image with
an ``[F, F]`` filter over a zero padding of ``F // 2`` rows and columns
on the top and left and ``F - 1 - F // 2`` on the bottom and right (so
an even F pads asymmetrically, as the reference does), and returns an
``[H, W]`` image of the input's dtype:

* int32: exact, the accumulator wrapping at 32 bits, then shifted
  arithmetically by ``shift`` (the reference's order: wrap, then shift;
  a shift outside ``[0, 31]`` acts as 31, the sign fill);
* float32 and bfloat16: accumulated in float32 tap by tap in ``(fr,
  fc)`` order, rounded once to the input's dtype; ``shift`` is ignored,
  as in the reference.

Other dtypes raise ``TypeError``: the reference accumulates int8/int16
images in float32 and casts back, where an out-of-range cast is
backend-defined. On a CUDA tensor the wrapper launches
``csrc/spm_conv2d.cu`` once; on a CPU tensor it runs
:func:`spm_conv2d_plain`. The reference's ``block_rows`` and
``interpret`` have no counterpart.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as tnf

from repro_torch.kernels.build import load_library

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 3}
TILE = 32                          # output tile edge (csrc/spm_tiles.cuh)
SMEM_LIMIT = 232_448               # bytes of shared memory a block may use
_M32 = 0xFFFFFFFF

#: kernel launches so far (the CUDA path only)
launch_count = 0


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype of an image dtype: int32 or float32."""
    if dtype not in DTYPES:
        raise TypeError(f"spm_conv2d takes float32, bfloat16 or int32 "
                        f"images, got {dtype}")
    return torch.int32 if dtype == torch.int32 else torch.float32


def shift_count(shift: int) -> int:
    """A post-shift count as the kernel applies it."""
    return shift if 0 <= shift <= 31 else 31


def check_filter(filt: torch.Tensor, img: torch.Tensor) -> int:
    """Validate an ``[F, F]`` filter beside an image; returns F."""
    if img.dim() != 2 or filt.dim() != 2 or filt.shape[0] != filt.shape[1] \
            or filt.shape[0] < 1:
        raise ValueError(f"conv2d takes an [H, W] image and an [F, F] "
                         f"filter, got {tuple(img.shape)} and "
                         f"{tuple(filt.shape)}")
    if filt.device != img.device:
        raise ValueError(f"conv2d: image on {img.device}, filter on "
                         f"{filt.device}")
    F = int(filt.shape[0])
    if ((TILE + F - 1) ** 2 + F * F) * 4 > SMEM_LIMIT:
        raise ValueError(f"conv2d: a {F} x {F} filter needs more shared "
                         f"memory than a block has")
    return F


def spm_conv2d(img: torch.Tensor, filt: torch.Tensor, *,
               shift: int = 0) -> torch.Tensor:
    """The same-size convolution (see the module docstring). CUDA
    tensors launch the kernel once; CPU tensors run the plain version."""
    global launch_count
    acc = acc_dtype(img.dtype)
    F = check_filter(filt, img)
    if img.device.type == "cpu":
        return spm_conv2d_plain(img, filt, shift=shift)
    if img.device.type != "cuda":
        raise ValueError(f"spm_conv2d: unsupported device {img.device}")
    img = img.contiguous()
    f = filt.to(acc).contiguous()
    H, W = img.shape
    out = torch.empty((H, W), dtype=img.dtype, device=img.device)
    if out.numel() == 0:
        return out
    rc = _library().spm_conv2d_launch(
        DTYPES[img.dtype], img.data_ptr(), f.data_ptr(), out.data_ptr(), H,
        W, F, shift_count(shift),
        torch.cuda.current_stream(img.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spm_conv2d kernel launch failed: CUDA error "
                           f"{rc}")
    launch_count += 1
    return out


def _library() -> ctypes.CDLL:
    lib = load_library("spm_conv2d")
    fn = lib.spm_conv2d_launch
    if fn.argtypes is None:
        i64, vp, ci = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, i64, i64, ci, ci, vp]
        fn.restype = ci
    return lib


def correlate_plain(padded: torch.Tensor, filt: torch.Tensor,
                    shift: int = 0) -> torch.Tensor:
    """Valid F x F correlation of a padded image, in the kernel's
    arithmetic, on any device: int32 products summed modulo 2^32 (in
    int64, masked to the low 32 bits after every tap, so nothing
    overflows), wrapped, then shifted; floats summed in float32, one
    rounded product and one rounded sum per tap, in ``(fr, fc)`` order.
    Returns the input's dtype."""
    F = filt.shape[0]
    H, W = padded.shape[0] - F + 1, padded.shape[1] - F + 1
    if acc_dtype(padded.dtype) == torch.int32:
        x, w = padded.long(), filt.to(torch.int32).long()
        acc = torch.zeros((H, W), dtype=torch.int64, device=padded.device)
        for fr in range(F):
            for fc in range(F):
                acc = (acc + (x[fr:fr + H, fc:fc + W] * w[fr, fc] & _M32)
                       ) & _M32
        acc = acc.to(torch.int32)                    # wraps to int32
        return acc >> shift_count(shift) if shift else acc
    x, w = padded.float(), filt.float()
    acc = torch.zeros((H, W), dtype=torch.float32, device=padded.device)
    for fr in range(F):
        for fc in range(F):
            acc = acc + x[fr:fr + H, fc:fc + W] * w[fr, fc]
    return acc.to(padded.dtype)


def spm_conv2d_plain(img: torch.Tensor, filt: torch.Tensor, *,
                     shift: int = 0) -> torch.Tensor:
    """The plain PyTorch version of :func:`spm_conv2d`: pad as the
    reference does, then :func:`correlate_plain`. Runs on any device."""
    acc_dtype(img.dtype)
    F = check_filter(filt, img)
    pad = F // 2
    padded = tnf.pad(img, (pad, F - 1 - pad, pad, F - 1 - pad))
    return correlate_plain(padded, filt, shift)
