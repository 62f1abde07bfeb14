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
* float32, bfloat16 and float16: accumulated in float32 tap by tap in
  ``(fr, fc)`` order (one rounded product, one rounded sum), rounded
  once to the input's dtype (to nearest even); ``shift`` is ignored, as
  in the reference;
* int8, int16 and uint8: accumulated in float32 like the float images,
  then cast back as XLA casts float32 to an integer: truncated toward
  zero and saturated to the dtype's range, NaN giving 0; ``shift`` is
  ignored.

The filter is taken in the accumulator's dtype (``filt.to(int32)`` or
``filt.to(float32)``, as the reference's ``w.astype(acc.dtype)``). int64,
float64 and complex images raise ``TypeError``: with x64 off, JAX narrows
int64 and float64 images to int32 and float32 before the kernel runs,
and the reference's float32 accumulator drops a complex image's
imaginary part, so no image of those dtypes reaches its kernel as such.

On a CUDA tensor the wrapper launches ``csrc/spm_conv2d.cu`` once; on a
CPU tensor it runs :func:`spm_conv2d_plain`. Any F computes on the CPU;
on the card the kernel's shared memory grows linearly in F
(:func:`smem_bytes`), which refuses F above about 2700 (int32). The reference's
``block_rows`` and ``interpret`` have no counterpart.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as tnf

from repro_torch.kernels.build import load_library
from repro_torch.kernels.common import round_up, xla_convert
from repro_torch.kernels.spm_fft import sm_count

#: image dtype -> the kernel's dtype code (csrc/spm_conv2d.cu)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.int32: 3, torch.int8: 4, torch.int16: 5, torch.uint8: 6}
STAGES = 4                         # input-row ring: 3 rows ahead
FILTER_SLOTS = 16                  # filter-row ring (>= 8 + 3)
WARPS_AN_SM = 24                   # rows 8 only where that fills the card
MAX_THREADS, MIN_THREADS = 256, 32
SMEM_LIMIT = 232_448               # bytes of shared memory a block may use
_M32 = 0xFFFFFFFF

#: kernel launches so far (the CUDA path only)
launch_count = 0


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype of an image dtype: int32 or float32."""
    if dtype not in DTYPES:
        raise TypeError(f"spm_conv2d takes {', '.join(map(str, DTYPES))} "
                        f"images, got {dtype} (the reference narrows int64 "
                        f"and float64 first and drops a complex image's "
                        f"imaginary part)")
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
    return int(filt.shape[0])


def rows_per_thread(H: int, W: int, sms: int) -> int:
    """Output rows a thread keeps: 8 (more reuse of each input row) where
    that still gives ``WARPS_AN_SM`` warps an SM, else 4 (twice the
    warps, for images too small to fill the card at 8)."""
    warps = -(-H // 8) * -(-W // 4) / 32
    return 8 if warps >= WARPS_AN_SM * sms else 4


def block_threads(H: int, W: int, rows: int, sms: int) -> int:
    """Threads a block, each keeping 4 columns of ``rows`` output rows:
    no wider than the image needs, then halved (down to a warp) until
    the image has at least two tiles an SM."""
    tx = MAX_THREADS
    while tx > MIN_THREADS and 4 * (tx // 2) >= W:
        tx //= 2
    while tx > MIN_THREADS and tiles(H, W, tx, rows) < 2 * sms:
        tx //= 2
    return tx


def tiles(H: int, W: int, tx: int, rows: int) -> int:
    """Output tiles of ``rows`` rows by ``4 tx`` columns."""
    return -(-H // rows) * -(-W // (4 * tx))


def smem_bytes(dtype: torch.dtype, F: int, tx: int) -> int:
    """Dynamic shared memory of one block (csrc/spm_conv2d.cu): ``STAGES``
    input-row segments of the image's dtype and ``FILTER_SLOTS`` filter
    rows padded to a multiple of 4 words. A segment holds ``4 tx``
    columns and the filter's reach (padded to 4 words), from the 16-byte
    boundary of the image row at or before ``F // 2`` columns left of
    the tile. Linear in F."""
    size = torch.empty((), dtype=dtype).element_size()
    ve = 16 // size                            # elements a 16-byte copy
    fp = round_up(F, 4)
    pad = F // 2
    sw = round_up(round_up(pad, ve) - pad + 4 * tx + fp, ve)
    return STAGES * sw * size + FILTER_SLOTS * fp * 4


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
    sms = sm_count(img.device)
    rows = rows_per_thread(H, W, sms)
    tx = block_threads(H, W, rows, sms)
    smem = smem_bytes(img.dtype, F, tx)
    if smem > SMEM_LIMIT:
        raise ValueError(f"conv2d: a {F} x {F} filter needs {smem} bytes "
                         f"of shared memory a block, above {SMEM_LIMIT}")
    vec = W % (16 // img.element_size()) == 0 and img.data_ptr() % 16 == 0
    rc = _library().spm_conv2d_launch(
        DTYPES[img.dtype], img.data_ptr(), f.data_ptr(), out.data_ptr(), H,
        W, F, shift_count(shift), rows, tx, int(vec), sms,
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
        fn.argtypes = [ci, vp, vp, vp, i64, i64, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def correlate_plain(padded: torch.Tensor, filt: torch.Tensor,
                    shift: int = 0, taps=None) -> torch.Tensor:
    """Valid F x F correlation of a padded image, in the kernel's
    arithmetic, on any device: int32 products summed modulo 2^32 (in
    int64, masked to the low 32 bits after every tap, so nothing
    overflows), wrapped, then shifted; other dtypes summed in float32,
    one rounded product and one rounded sum per tap, in ``(fr, fc)``
    order, then cast back as XLA does (``common.xla_convert``). ``taps``
    = ``(rows, cols)``, two ranges, limits the taps to those (the others
    must add nothing). Returns the input's dtype."""
    F = filt.shape[0]
    H, W = padded.shape[0] - F + 1, padded.shape[1] - F + 1
    rows, cols = taps if taps is not None else (range(F), range(F))
    if acc_dtype(padded.dtype) == torch.int32:
        x, w = padded.long(), filt.to(torch.int32).long()
        acc = torch.zeros((H, W), dtype=torch.int64, device=padded.device)
        for fr in rows:
            for fc in cols:
                acc = (acc + (x[fr:fr + H, fc:fc + W] * w[fr, fc] & _M32)
                       ) & _M32
        acc = acc.to(torch.int32)                    # wraps to int32
        return acc >> shift_count(shift) if shift else acc
    x, w = padded.float(), filt.float()
    acc = torch.zeros((H, W), dtype=torch.float32, device=padded.device)
    for fr in rows:
        for fc in cols:
            acc = acc + x[fr:fr + H, fc:fc + W] * w[fr, fc]
    return xla_convert(acc, padded.dtype)


def live_taps(H: int, W: int, filt: torch.Tensor):
    """``(rows, cols)``: the taps whose shifted window meets the ``[H, W]``
    image; the others read only padding. A padding tap adds 0 * w, which
    leaves an integer sum as it is, and a float32 one too while w is
    finite (the sum starts at +0 and never becomes -0), so those are
    skipped unless the float filter holds an infinity or a NaN. None
    when every tap is live."""
    F = filt.shape[0]
    pad = F // 2
    if F <= min(H, W) or (filt.is_floating_point()
                          and not bool(torch.isfinite(filt).all())):
        return None
    return (range(max(0, pad - H + 1), min(F, pad + H)),
            range(max(0, pad - W + 1), min(F, pad + W)))


def spm_conv2d_plain(img: torch.Tensor, filt: torch.Tensor, *,
                     shift: int = 0) -> torch.Tensor:
    """The plain PyTorch version of :func:`spm_conv2d`: pad as the
    reference does, then :func:`correlate_plain` over the live taps.
    Runs on any device."""
    acc_dtype(img.dtype)
    F = check_filter(filt, img)
    pad = F // 2
    padded = tnf.pad(img, (pad, F - 1 - pad, pad, F - 1 - pad))
    return correlate_plain(padded, filt, shift,
                           live_taps(img.shape[0], img.shape[1], filt))
