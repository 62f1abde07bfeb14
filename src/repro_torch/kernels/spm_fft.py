"""Batched radix-2 FFT, the port of the reference's
``repro/kernels/spm_fft.py::_fft_kernel``.

``spm_fft(re, im)`` transforms every row of ``[B, n]`` real and
imaginary planes (n a power of two, at most :data:`MAX_N`) and returns
the float32 planes of the DFT. The algorithm is the reference's:
``log2(n)`` decimation-in-frequency stages over contiguous halves, the
stage of half-size ``h`` multiplying the difference by the twiddle
``cos/sin(float32(-2 pi) * k / (2 h))``, then the bit-reversal gather
``out[:, j] = x[:, bitrev(j)]``. :func:`twiddles` builds that table
once per n and device; the kernel and :func:`spm_fft_plain` read the
same table and round every operation alike, so on the card the two
agree bit for bit.

On a CUDA tensor the wrapper launches ``csrc/spm_fft.cu`` once, with
the pass plan of :func:`pass_plan`; on a CPU tensor it runs
:func:`spm_fft_plain`. n above :data:`MAX_N` raises ``ValueError``: one
row then needs more than the 128 KB of shared memory the kernel is built
for. The reference's ``batch_block`` and ``interpret`` have no
counterpart.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import load_library

MAX_N = 16384
#: the kernel's block size, its most radix-2 stages in one pass, and the
#: H100's SM count
THREADS = 256
MAX_RADIX = 4
SMS = 132

#: kernel launches so far (the CUDA path only)
launch_count = 0

_TWIDDLES: Dict[Tuple[int, str], torch.Tensor] = {}


def _bitrev(n: int) -> np.ndarray:
    """The bit-reversal permutation of ``range(n)`` (the reference's)."""
    bits = int(np.log2(n))
    return np.array([int(f"{i:0{bits}b}"[::-1], 2) for i in range(n)],
                    np.int32)


def check_planes(re: torch.Tensor, im: torch.Tensor) -> int:
    """Validate ``[B, n]`` planes; returns log2(n)."""
    if re.dim() != 2 or re.shape != im.shape or re.device != im.device:
        raise ValueError(f"spm_fft takes two [B, n] planes on one device, "
                         f"got {tuple(re.shape)} on {re.device} and "
                         f"{tuple(im.shape)} on {im.device}")
    n = int(re.shape[1])
    if n < 1 or n & (n - 1):
        raise ValueError(f"spm_fft: n = {n} is not a power of two")
    if n > MAX_N:
        raise ValueError(f"spm_fft: n = {n} exceeds {MAX_N} (one row would "
                         f"not fit a block's shared memory)")
    return n.bit_length() - 1


class PassPlan(NamedTuple):
    """How the kernel runs n points: ``radices[p]`` radix-2 stages in
    pass p, from half-size n / 2 down; ``threads_per_row`` threads hold a
    row in the first pass (16 points each at radix 4); a block holds a
    tile of ``rows_per_block`` rows in ``smem_bytes`` of shared memory
    (two planes of whole 32-word lines, the swizzle's unit)."""

    radices: Tuple[int, ...]
    threads_per_row: int
    rows_per_block: int
    smem_bytes: int

    @property
    def packed(self) -> int:
        """The launcher's form: the number of passes in bits 0-3, the
        stages of pass p in bits 4 + 4 p."""
        return len(self.radices) | sum(r << (4 + 4 * p)
                                       for p, r in enumerate(self.radices))


@functools.lru_cache(maxsize=None)
def pass_plan(n: int, batch: Optional[int] = None, sms: int = SMS
              ) -> PassPlan:
    """The kernel's plan for rows of n points (a power of two up to
    :data:`MAX_N`): ceil(log2(n) / 4) passes of near-equal radix (n <= 16:
    one pass; n = 1: one pass of no stage), as many rows a tile as a
    block's threads hold in the first pass, and with ``batch`` rows no
    more than ``batch // sms`` of them, so a small batch still spreads
    over the card's ``sms`` SMs."""
    if n < 1 or n & (n - 1) or n > MAX_N:
        raise ValueError(f"spm_fft: no plan for n = {n}")
    log2n = n.bit_length() - 1
    passes = max(1, -(-log2n // MAX_RADIX))
    radix, extra = divmod(log2n, passes)
    radices = (radix + 1,) * extra + (radix,) * (passes - extra)
    threads = n >> radices[0]
    rows = max(1, THREADS // threads)
    if batch is not None:
        rows = min(rows, max(1, batch // sms))
    return PassPlan(radices, threads, rows, 2 * 4 * (-(-rows * n // 32) * 32))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def twiddles(n: int, device) -> torch.Tensor:
    """``[2, max(n - 1, 1)]`` float32 on ``device``: the cosines, then the
    sines, of every stage; half-size h reads entries ``h - 1 .. 2h - 2``.
    Computed with the reference's float32 formula and cached per
    ``(n, device)``."""
    device = torch.device(device)
    key = (n, str(device))
    tw = _TWIDDLES.get(key)
    if tw is None:
        tw = torch.zeros((2, max(n - 1, 1)), dtype=torch.float32,
                         device=device)
        h = 1
        while h < n:
            k = torch.arange(h, dtype=torch.float32, device=device)
            ang = k * (-2.0 * math.pi) / (2 * h)
            tw[0, h - 1:2 * h - 1] = torch.cos(ang)
            tw[1, h - 1:2 * h - 1] = torch.sin(ang)
            h *= 2
        _TWIDDLES[key] = tw
    return tw


def spm_fft(re: torch.Tensor, im: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DFT of every row (see the module docstring). CUDA tensors
    launch the kernel once; CPU tensors run :func:`spm_fft_plain`."""
    global launch_count
    log2n = check_planes(re, im)
    if re.device.type == "cpu":
        return spm_fft_plain(re, im)
    if re.device.type != "cuda":
        raise ValueError(f"spm_fft: unsupported device {re.device}")
    re = re.to(torch.float32).contiguous()
    im = im.to(torch.float32).contiguous()
    B, n = re.shape
    tw = twiddles(n, re.device)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    if re.numel() == 0:
        return ore, oim
    plan = pass_plan(n, B, sm_count(re.device))
    rc = _library().spm_fft_launch(
        re.data_ptr(), im.data_ptr(), tw.data_ptr(), ore.data_ptr(),
        oim.data_ptr(), B, log2n, plan.packed, plan.rows_per_block,
        torch.cuda.current_stream(re.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spm_fft kernel launch failed: CUDA error {rc}")
    launch_count += 1
    return ore, oim


def _library() -> ctypes.CDLL:
    lib = load_library("spm_fft")
    fn = lib.spm_fft_launch
    if fn.argtypes is None:
        i64, vp, ci = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i64, ci, ctypes.c_uint, ci, vp]
        fn.restype = ci
    return lib


def spm_fft_plain(re: torch.Tensor, im: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`spm_fft`, on any device: the
    reference's stages over ``[B, n / m, m]`` views, each product and
    sum rounded on its own in float32, with the kernel's twiddles
    (:func:`twiddles`)."""
    check_planes(re, im)
    B, n = re.shape
    tw = twiddles(n, re.device)
    x_re, x_im = re.to(torch.float32), im.to(torch.float32)
    m = n
    while m >= 2:
        h = m // 2
        wre, wim = tw[0, h - 1:2 * h - 1], tw[1, h - 1:2 * h - 1]
        r3, i3 = x_re.reshape(B, n // m, m), x_im.reshape(B, n // m, m)
        a_re, b_re, a_im, b_im = r3[..., :h], r3[..., h:], i3[..., :h], \
            i3[..., h:]
        d_re, d_im = a_re - b_re, a_im - b_im
        x_re = torch.cat([a_re + b_re, d_re * wre - d_im * wim],
                         dim=2).reshape(B, n)
        x_im = torch.cat([a_im + b_im, d_re * wim + d_im * wre],
                         dim=2).reshape(B, n)
        m = h
    perm = torch.from_numpy(_bitrev(n)).to(device=re.device,
                                           dtype=torch.long)
    return x_re[:, perm], x_im[:, perm]
