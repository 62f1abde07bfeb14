"""The heterogeneous-MIMD composite, the port of the reference's
``repro/kernels/het_mimd.py::_composite_kernel``: the paper's three
kernels, on three "harts", in ONE kernel launch.

``het_mimd_composite(img, filt, fft_re, fft_im, A, B)`` returns
``(conv, fft_re, fft_im, mm)``:

* hart 0: ``conv [H, W]``, the valid F x F correlation of the
  pre-padded ``img [H + F - 1, W + F - 1]`` with ``filt [F, F]``,
  float32 out and no shift (unlike :func:`spm_conv2d`);
* hart 1: the FFT of ``fft_re / fft_im [nb, n]`` as :func:`spm_fft`;
* hart 2: ``mm = A [m, k] @ B [k, p]`` accumulated in float32, float32
  out whatever the operands' dtype.

Every operand is taken in float32, as the reference's branches cast
them, at any F. On CUDA tensors the wrapper launches ``csrc/het_mimd.cu``
once: the block index range is the hart (matmul tiles first, the
longest blocks, then conv tiles, then FFT row groups) and selects the
tile program. The conv hart stages its tile's whole input window for F
up to :data:`STREAM_F` and streams the input rows above it
(:func:`conv_streamed`). On CPU tensors it runs
:func:`het_mimd_composite_plain`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.spm_conv2d import check_filter, correlate_plain
from repro_torch.kernels.spm_fft import check_planes, pass_plan, sm_count, \
    spm_fft_plain, twiddles

TILE = 32                          # conv tile edge (csrc/spm_tiles.cuh)
SMEM_LIMIT = 232_448               # bytes of shared memory a block may use
#: the widest filter whose conv tiles stage the whole (31 + F)^2 window
STREAM_F = 32

#: kernel launches so far (the CUDA path only)
launch_count = 0


def conv_streamed(F: int) -> bool:
    """Whether the conv hart streams input rows (``conv_rows_tile``:
    one ``TILE + F - 1`` row in shared memory) rather than staging its
    tile's ``(TILE + F - 1)^2`` window and the filter (``conv_tile``)."""
    return F > STREAM_F


def conv_smem_bytes(F: int) -> int:
    """The conv hart's shared memory a block (csrc/spm_tiles.cuh)."""
    if conv_streamed(F):
        return (TILE + F - 1) * 4
    return ((TILE + F - 1) ** 2 + F * F) * 4


def check_tile_filter(filt: torch.Tensor, img: torch.Tensor) -> int:
    """:func:`check_filter`, and the conv hart's shared-memory test (a
    row of ``TILE + F - 1`` floats: F up to 58 000). Returns F."""
    F = check_filter(filt, img)
    if conv_smem_bytes(F) > SMEM_LIMIT:
        raise ValueError(f"het_mimd: a {F} x {F} filter needs more shared "
                         f"memory than a block has")
    return F


def _f32(*ts: torch.Tensor):
    return [t.to(torch.float32).contiguous() for t in ts]


def _check(img, filt, fft_re, fft_im, A, B) -> Tuple[int, int]:
    """Validate the six operands; returns ``(F, log2(n))``."""
    F = check_tile_filter(filt, img)
    if img.shape[0] < F or img.shape[1] < F:
        raise ValueError(f"het_mimd: the pre-padded image "
                         f"{tuple(img.shape)} is smaller than the filter")
    log2n = check_planes(fft_re, fft_im)
    if A.dim() != 2 or B.dim() != 2 or A.shape[1] != B.shape[0]:
        raise ValueError(f"het_mimd takes A [m, k] @ B [k, p], got "
                         f"{tuple(A.shape)} @ {tuple(B.shape)}")
    if not img.device == fft_re.device == A.device == B.device:
        raise ValueError("het_mimd: operands on more than one device")
    return F, log2n


def het_mimd_composite(img: torch.Tensor, filt: torch.Tensor,
                       fft_re: torch.Tensor, fft_im: torch.Tensor,
                       A: torch.Tensor, B: torch.Tensor):
    """conv2d + FFT + matmul in one launch (see the module docstring).
    Returns ``(conv, fft_re, fft_im, mm)``, all float32."""
    global launch_count
    F, log2n = _check(img, filt, fft_re, fft_im, A, B)
    if img.device.type == "cpu":
        return het_mimd_composite_plain(img, filt, fft_re, fft_im, A, B)
    if img.device.type != "cuda":
        raise ValueError(f"het_mimd: unsupported device {img.device}")
    img, filt, fft_re, fft_im, A, B = _f32(img, filt, fft_re, fft_im, A, B)
    H, W = img.shape[0] - F + 1, img.shape[1] - F + 1
    (nb, n), (M, K), N = fft_re.shape, A.shape, B.shape[1]
    tw = twiddles(n, img.device)
    conv = torch.empty((H, W), dtype=torch.float32, device=img.device)
    ore, oim = torch.empty_like(fft_re), torch.empty_like(fft_im)
    mm = torch.empty((M, N), dtype=torch.float32, device=img.device)
    if conv.numel() + ore.numel() + mm.numel() == 0:
        return conv, ore, oim, mm
    plan = pass_plan(n, nb, sm_count(img.device))
    rc = _library().het_mimd_launch(
        img.data_ptr(), filt.data_ptr(), F, int(conv_streamed(F)),
        conv.data_ptr(), H, W,
        fft_re.data_ptr(), fft_im.data_ptr(), tw.data_ptr(), ore.data_ptr(),
        oim.data_ptr(), nb, log2n, plan.packed, plan.rows_per_block,
        A.data_ptr(), B.data_ptr(), mm.data_ptr(), M, K, N,
        torch.cuda.current_stream(img.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"het_mimd kernel launch failed: CUDA error {rc}")
    launch_count += 1
    return conv, ore, oim, mm


def _library() -> ctypes.CDLL:
    lib = load_library("het_mimd")
    fn = lib.het_mimd_launch
    if fn.argtypes is None:
        i64, vp, ci = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, vp, i64, i64, vp, vp, vp, vp, vp, i64,
                       ci, ctypes.c_uint, ci, vp, vp, vp, i64, i64, i64, vp]
        fn.restype = ci
    return lib


def het_mimd_composite_plain(img, filt, fft_re, fft_im, A, B):
    """The plain PyTorch version of :func:`het_mimd_composite`, on any
    device: the three parts' plain versions on float32 operands."""
    _check(img, filt, fft_re, fft_im, A, B)
    img, filt, fft_re, fft_im, A, B = _f32(img, filt, fft_re, fft_im, A, B)
    ore, oim = spm_fft_plain(fft_re, fft_im)
    return correlate_plain(img, filt), ore, oim, A @ B
