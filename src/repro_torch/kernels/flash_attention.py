"""Flash attention with an online softmax, the port of the reference's
``repro/kernels/flash_attention.py::_flash_kernel``.

``flash_attention(q, k, v)`` takes q ``[B, H, Sq, hd]`` and k, v
``[B, KV, Skv, hd]`` (H = KV * G: query head h of batch b reads KV head
``b * KV + h // G``), float32 or bf16, and returns ``[B, H, Sq, hd]`` in
q's dtype: per query row, the softmax over the keys it sees (``causal``:
``q_pos >= k_pos``; ``window``: ``q_pos - k_pos < window``; ``q_pos =
q_offset + i``) of the scaled scores, times v. Scores, m, l and acc are
float32; the output is ``acc / max(l, 1e-30)``, so a row that sees no
key gives 0 (the Pallas kernel's rule; the quadratic oracle
``repro_torch.models.layers.attention_ref`` gives such a row the mean
of v instead).

On a CUDA tensor the wrapper launches one of the two kernels of
``csrc/flash_attention.cu`` once, picked by the dtype: bf16 runs the
tensor-core kernel (mma.sync, P split into two bf16 terms so that P v
keeps float32 accuracy; :data:`tc_launch_count`), float32 the CUDA-core
kernel (float32 on the tensor cores would be TF32). This is a dispatch
on the type, not a fallback: a launch that fails raises. On a CPU
tensor it runs :func:`flash_attention_plain`. hd above :data:`MAX_HD`
raises ``ValueError``: the kernels' shared memory and register blocks
are sized for the configs' head widths (64, 96, 128). The reference's
TPU blocks (``bq``, ``bk``) and ``interpret`` have no counterpart: the
CUDA kernels' tiles are fixed.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.build import load_library
from repro_torch.models.layers import NEG_INF
from repro_torch.models.layers import _block_mask as visible

MAX_HD = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PLAIN_ROWS = 256           # query rows per step of the plain version

#: kernel launches so far (the CUDA path only), both kernels
launch_count = 0
#: of those, launches of the tensor-core kernel (bf16)
tc_launch_count = 0


def uses_tensor_cores(dtype: torch.dtype) -> bool:
    """Whether ``dtype`` operands run the tensor-core kernel on the card
    (bf16) or the CUDA-core one (float32)."""
    return dtype == torch.bfloat16


def scale_of(hd: int) -> float:
    """The score scale 1/sqrt(hd), as float32 (the reference multiplies a
    float32 array by it)."""
    return float(np.float32(1.0 / np.sqrt(hd)))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q [B, H, Sq, hd] and k, v "
                         f"[B, KV, Skv, hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or k.shape[1] < 1 or \
            H % k.shape[1]:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit "
                         f"q {tuple(q.shape)} (H must be a multiple of KV)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("flash_attention: q, k, v lie on different devices")
    if hd > MAX_HD:
        raise ValueError(f"flash_attention: hd = {hd} exceeds {MAX_HD} (the "
                         f"kernel's tiles are sized for hd <= {MAX_HD})")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention (see the module docstring). CUDA tensors launch one
    kernel once; CPU tensors run :func:`flash_attention_plain`."""
    global launch_count, tc_launch_count
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    if Skv == 0:
        return o.zero_()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H,
            KV, Sq, Skv, hd, int(bool(causal)), int(window), int(q_offset),
            scale_of(hd), torch.cuda.current_stream(q.device).cuda_stream)
    tc = uses_tensor_cores(q.dtype)
    lib = _library()
    rc = lib.flash_attention_tc_launch(*args) if tc else \
        lib.flash_attention_launch(DTYPES[q.dtype], *args)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launch_count += 1
    tc_launch_count += tc
    return o


def _library() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        i64, vp, ci = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, vp, i64, i64, i64, i64, i64, i64, ci,
                       i64, i64, ctypes.c_float, vp]
        fn.restype = ci
        tc = lib.flash_attention_tc_launch
        tc.argtypes = fn.argtypes[1:]
        tc.restype = ci
    return lib


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          q_offset: int = 0) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_attention`, on any
    device: the same function with one softmax per row instead of an
    online one, over blocks of :data:`PLAIN_ROWS` query rows so that the
    ``[B, H, Sq, Skv]`` float32 scores are never held whole. Masked
    scores become ``NEG_INF`` and masked probabilities 0, so a row that
    sees no key has l = 0 and gives 0."""
    _check(q, k, v, window)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale_of(hd)
    kf = k.float()[:, :, None]                           # [B, KV, 1, Skv, hd]
    vf = v.float()[:, :, None]
    k_pos = torch.arange(Skv, device=q.device)
    out = torch.empty_like(q)
    for r0 in range(0, Sq, PLAIN_ROWS):
        r1 = min(Sq, r0 + PLAIN_ROWS)
        qb = q[:, :, r0:r1].float().reshape(B, KV, G, r1 - r0, hd)
        s = torch.matmul(qb, kf.transpose(-1, -2)) * scale
        vis = visible(q_offset + torch.arange(r0, r1, device=q.device),
                      k_pos, causal, window)
        s = torch.where(vis, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(vis, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p, vf) / torch.clamp(l, min=1e-30)
        out[:, :, r0:r1] = o.reshape(B, H, r1 - r0, hd).to(q.dtype)
    return out


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int,
                  q_offset: int) -> int:
    """How many (query row, key) pairs one head sees: the work the
    function needs (counted, not the tiles a kernel happens to touch)."""
    n = 0
    for i in range(Sq):
        qp = q_offset + i
        hi = min(Skv, qp + 1) if causal else Skv
        lo = max(0, qp - window + 1) if window else 0
        n += max(0, hi - lo)
    return n

