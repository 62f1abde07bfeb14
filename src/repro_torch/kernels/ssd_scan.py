"""The Mamba-2 SSD chunk scan, the port of the reference's
``repro/kernels/ssd_scan.py::_ssd_kernel``.

``ssd_scan(x, da, dt, B, C, chunk=256)`` takes x ``[Bz, S, H, P]``
(float32 or bf16), da = dt * A and dt ``[Bz, S, H]``, and B, C ``[Bz, S,
H, N]`` already broadcast from their groups to the heads (the op
:func:`repro_torch.kernels.ops.ssd_scan_op` does that), and returns y
``[Bz, S, H, P]`` in x's dtype and the final state ``[Bz, H, N, P]`` in
float32. Chunks of ``cs = min(chunk, S)`` steps: S must be a multiple of
cs (``ValueError``, where the reference asserts). Each chunk computes, in
the reference's order, the intra-chunk term ``(C B^T * seg) (x dt)``
(seg the masked decay ``exp(cum_i - cum_j)``, j <= i), the inter-chunk
term ``exp(cum) * (C h)``, and the state update ``h <- exp(cum_last) h +
(B * exp(cum_last - cum))^T (x dt)``, all in float32.

On a CUDA tensor the wrapper launches ``csrc/ssd_scan.cu`` once (da, dt,
B and C widened to float32 first, which is exact); on a CPU tensor it
runs :func:`ssd_scan_plain`. Shapes whose state, chunk and tiles need
more than a block's 227 KB of shared memory (:func:`smem_bytes`) raise
``ValueError``. The reference's ``interpret`` has no counterpart.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import load_library

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232448          # a block's opt-in shared memory on an H100
TILE = 64                  # the kernel's row tile (csrc/ssd_scan.cu)

#: kernel launches so far (the CUDA path only)
launch_count = 0


def smem_bytes(N: int, P: int, cs: int) -> int:
    """The kernel's shared memory for (N, P, cs): the state, the chunk's
    x dt, cum and dt, two row tiles of B / C and the 64 x 64 scores
    (mirrors ``smem_bytes`` in ``csrc/ssd_scan.cu``)."""
    return 4 * (N * P + cs * P + 2 * cs + 2 * TILE * (N | 1)
                + TILE * (TILE + 1))


def chunk_size(S: int, chunk: int) -> int:
    """``cs = min(chunk, S)``; raises unless S is a multiple of it."""
    cs = min(chunk, S)
    if cs < 1 or S % cs:
        raise ValueError(f"ssd_scan: S = {S} is not a multiple of the chunk "
                         f"{cs}")
    return cs


def _check(x, da, dt, B, C) -> None:
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape or \
            tuple(B.shape[:3]) != tuple(x.shape[:3]) or \
            da.shape != x.shape[:3] or dt.shape != x.shape[:3]:
        raise ValueError(f"ssd_scan takes x [Bz, S, H, P], da, dt [Bz, S, H] "
                         f"and B, C [Bz, S, H, N], got {tuple(x.shape)}, "
                         f"{tuple(da.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    for t in (x, da, dt, B, C):
        if not t.dtype.is_floating_point:
            raise TypeError(f"ssd_scan takes float tensors, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("ssd_scan: inputs lie on different devices")


def ssd_scan(x: torch.Tensor, da: torch.Tensor, dt: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, state) of the chunk scan (see the module docstring). CUDA
    tensors launch the kernel once; CPU tensors run
    :func:`ssd_scan_plain`."""
    global launch_count
    _check(x, da, dt, B, C)
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    cs = chunk_size(S, chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, da, dt, B, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, got {x.dtype}")
    need = smem_bytes(N, P, cs)
    if need > MAX_SMEM:
        raise ValueError(f"ssd_scan: N = {N}, P = {P}, chunk {cs} need "
                         f"{need} bytes of shared memory, above {MAX_SMEM}")
    x = x.contiguous()
    da, dt, B, C = (t.float().contiguous() for t in (da, dt, B, C))
    y = torch.empty_like(x)
    state = torch.empty((Bz, H, N, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0 or state.numel() == 0:
        return y, state.zero_()
    rc = _library().ssd_scan_launch(
        DTYPES[x.dtype], x.data_ptr(), da.data_ptr(), dt.data_ptr(),
        B.data_ptr(), C.data_ptr(), y.data_ptr(), state.data_ptr(), Bz, S, H,
        P, N, cs, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    launch_count += 1
    return y, state


def kernel_inputs(x, dt, A, B, C):
    """What ``ops.ssd_scan_op`` hands the kernel, from the model-facing
    inputs (A [H], B / C [Bz, S, G, N]): (x, da = dt A, dt, B and C
    repeated from their G groups to the H heads)."""
    rep = x.shape[2] // B.shape[2]
    return (x, dt * A[None, None, :], dt,
            torch.repeat_interleave(B, rep, dim=2),
            torch.repeat_interleave(C, rep, dim=2))


def _library() -> ctypes.CDLL:
    lib = load_library("ssd_scan")
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        i64, vp, ci = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, i64, i64, i64, i64,
                       i64, i64, vp]
        fn.restype = ci
    return lib


def ssd_scan_plain(x: torch.Tensor, da: torch.Tensor, dt: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`ssd_scan`, on any device: the
    reference kernel's chunk body, batched over (Bz, H), one chunk after
    another. The decay is masked before its exp, as the kernel's."""
    _check(x, da, dt, B, C)
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    cs = chunk_size(S, chunk)
    dev = x.device
    tril = torch.tril(torch.ones((cs, cs), dtype=torch.bool, device=dev))
    h = torch.zeros((Bz, H, N, P), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    for c0 in range(0, S, cs):
        sl = slice(c0, c0 + cs)
        xs = x[:, sl].float().permute(0, 2, 1, 3)        # [Bz, H, cs, P]
        das = da[:, sl].float().transpose(1, 2)          # [Bz, H, cs]
        dts = dt[:, sl].float().transpose(1, 2)
        Bs = B[:, sl].float().permute(0, 2, 1, 3)        # [Bz, H, cs, N]
        Cs = C[:, sl].float().permute(0, 2, 1, 3)
        cum = torch.cumsum(das, dim=-1)
        diff = cum[..., :, None] - cum[..., None, :]
        seg = torch.where(tril, torch.exp(torch.where(tril, diff, 0.0)), 0.0)
        xdt = xs * dts[..., None]
        yc = torch.matmul(torch.matmul(Cs, Bs.transpose(-1, -2)) * seg, xdt)
        yc = yc + torch.exp(cum)[..., None] * torch.matmul(Cs, h)
        dout = torch.exp(cum[..., -1:] - cum)            # [Bz, H, cs]
        h = torch.exp(cum[..., -1])[..., None, None] * h + torch.matmul(
            (Bs * dout[..., None]).transpose(-1, -2), xdt)
        y[:, sl] = yc.permute(0, 2, 1, 3).to(x.dtype)
    return y, h
