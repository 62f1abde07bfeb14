"""Mamba-1's selective scan for training on the card (hymba's SSM heads),
its forward and backward under one ``autograd.Function``.

``selective_scan(u, dt, A, B, C, initial_state=None)`` takes u and dt
``[Bz, S, d]`` (dt post-softplus), A ``[d, N]`` float32, B and C ``[Bz, S,
N]`` and an initial state ``[Bz, d, N]`` or None, and returns y ``[Bz, S,
d]`` and the final state ``[Bz, d, N]``, both float32, of

    s_t = exp(dt_t A) * s_{t-1} + (dt_t u_t) B_t^T,    y_t = s_t C_t;

the gradients come back in their inputs' types. ``models.ssm.
selective_scan`` runs it on CUDA tensors. The equations and the design
are in the header of ``csrc/selective_scan.cu``: on the card the forward
is :data:`PARTS` (one launch: y, the final state and the state entering
every segment of K positions) and the backward :data:`BWD_PARTS` (the
segments in reverse from their checkpoints, then the channel and row sums
of the partials in a fixed order: two runs give the same bits).
:data:`part_launches` counts every launch by part. On CPU tensors the
Function runs :func:`scan_forward_plain` and :func:`scan_backward_plain`,
the same algorithm in plain PyTorch (float64 for float64 inputs), which
the tests hold to autograd through ``models.ssm.selective_scan_ref``.

The tiling, chosen from N (:func:`tiling_for`): NS = 4 states a lane, Q
neighbouring lanes a channel (4 up to N 16, 8 up to 32), 128 / Q channels
a block, segments of K = 64 / NS = 16 positions (K NS recomputed states a
thread in the backward). N above 32 raises ``ValueError``, as does any
input the kernels do not take.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.build import load_library

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
THREADS = 128                    # a block's threads (csrc's kThr)
#: (NS, Q) by tiling code, as ``by_tiling`` in ``csrc/selective_scan.cu``
TILINGS = ((4, 4), (4, 8))
MAX_N = max(ns * q for ns, q in TILINGS)
#: the forward's launch and the backward's, in order (also their device
#: names, with ``_kernel`` appended)
PARTS = ("selective_scan_fwd",)
BWD_PARTS = ("selective_scan_bwd", "selective_scan_sum")

#: kernel launches so far, forward and backward (the CUDA path only)
launch_count = 0
#: kernel launches so far, by part
part_launches: Dict[str, int] = dict.fromkeys(PARTS + BWD_PARTS, 0)


def geometry(tiling: int) -> Dict[str, int]:
    """The tiling's NS, Q, segment K and channels a block DC."""
    ns, q = TILINGS[tiling]
    return dict(NS=ns, Q=q, K=64 // ns, DC=THREADS // q)


def tiling_for(N: int) -> int:
    """The tiling the kernels take at N states: four lanes of four states a
    channel up to 16, eight lanes up to 32; raises above. (At hymba's cell
    four lanes of four ran the scan forward and backward in 2.44 ms, two
    lanes of eight in 3.00, one lane of 16 in 3.64: ``PERF.md`` §6.)"""
    if not 1 <= N <= MAX_N:
        raise ValueError(f"selective_scan: N = {N} states; the kernels hold "
                         f"1 to {MAX_N} in registers")
    return 0 if N <= 16 else 1


def segments(S: int, tiling: int) -> int:
    return -(-S // geometry(tiling)["K"])


def _check(u, dt, A, B, C, s0) -> None:
    Bz, S, d = u.shape if u.dim() == 3 else (None,) * 3
    N = A.shape[-1] if A.dim() == 2 else None
    if u.dim() != 3 or tuple(dt.shape) != tuple(u.shape) or \
            tuple(A.shape) != (d, N) or tuple(B.shape) != (Bz, S, N) or \
            tuple(C.shape) != (Bz, S, N) or \
            (s0 is not None and tuple(s0.shape) != (Bz, d, N)):
        raise ValueError(
            f"selective_scan takes u, dt [Bz, S, d], A [d, N], B, C [Bz, S, "
            f"N] and an initial state [Bz, d, N], got {tuple(u.shape)}, "
            f"{tuple(dt.shape)}, {tuple(A.shape)}, {tuple(B.shape)}, "
            f"{tuple(C.shape)}, {None if s0 is None else tuple(s0.shape)}")
    ts = (u, dt, A, B, C) + (() if s0 is None else (s0,))
    if any(t.device != u.device for t in ts):
        raise ValueError("selective_scan: inputs lie on different devices")
    if any(not t.dtype.is_floating_point for t in ts):
        raise ValueError(f"selective_scan takes float tensors, got "
                         f"{[t.dtype for t in ts]}")


def _card(u, A, s0) -> bool:
    """Whether the kernels run (CUDA tensors) or the plain versions (CPU
    tensors); raises on what the kernels do not take."""
    if u.device.type == "cpu":
        return False
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {u.device}")
    tiling_for(A.shape[-1])
    if u.numel() == 0:
        raise ValueError(f"selective_scan's kernels take no empty input, got "
                         f"u {tuple(u.shape)}")
    if A.dtype != torch.float32 or (s0 is not None and
                                    s0.dtype not in DTYPES):
        raise ValueError(f"selective_scan's kernels take A in float32 and "
                         f"the initial state in float32, bf16 or float16, "
                         f"got {A.dtype}, {None if s0 is None else s0.dtype}")
    return True


def _codes(*ts) -> list:
    for t in ts:
        if t.dtype not in DTYPES:
            raise ValueError(f"selective_scan's kernels take float32, bf16 "
                             f"or float16 u, dt, B and C, got {t.dtype}")
    return [DTYPES[t.dtype] for t in ts]


def _launched(part: str) -> None:
    global launch_count
    launch_count += 1
    part_launches[part] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, part: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{part} kernel launch failed: CUDA error {rc}")


_I64, _VP, _CI = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
#: the launchers' arguments before the stream
_SIGNATURES = {
    "selective_scan_fwd_launch": [_CI, _VP, _CI, _VP, _CI, _VP, _VP, _CI, _VP,
                                  _CI, _VP, _CI, _VP, _VP, _VP] + [_I64] * 6,
    "selective_scan_bwd_launch": [_CI, _VP, _CI, _VP, _CI, _VP, _VP, _CI, _VP,
                                  _CI] + [_VP] * 8 + [_I64] * 6,
    "selective_scan_sum_launch": [_VP, _VP, _VP, _CI, _VP, _CI, _VP]
    + [_I64] * 5}
_LIB: list = []


def _library() -> ctypes.CDLL:
    """``csrc/selective_scan.cu``'s library, its launchers typed; built at
    first use (a run that never takes the kernels never compiles it)."""
    if not _LIB:
        lib = load_library("selective_scan")
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args + [_VP]        # the stream last
            fn.restype = _CI
        _LIB.append(lib)
    return _LIB[0]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# forward and backward: the kernels on the card, the plain mirrors elsewhere
# ---------------------------------------------------------------------------

def scan_forward(u, dt, A, B, C, s0, save: bool):
    """(y, final state, checkpoints): the checkpoints ``[Bz, S / K, d, N]``
    float32, the state entering each segment of K positions (None unless
    ``save``). One launch of :data:`PARTS` on the card."""
    tiling = tiling_for(A.shape[-1])
    if not _card(u, A, s0):
        return scan_forward_plain(u, dt, A, B, C, s0, geometry(tiling)["K"],
                                  save)
    Bz, S, d = u.shape
    N = A.shape[-1]
    u, dt, A, B, C = (t.contiguous() for t in (u, dt, A, B, C))
    s0 = None if s0 is None else s0.contiguous()
    codes = _codes(u, dt, B, C)
    nseg, dc = segments(S, tiling), geometry(tiling)["DC"]
    f32 = dict(dtype=torch.float32, device=u.device)
    y, last = torch.empty((Bz, S, d), **f32), torch.empty((Bz, d, N), **f32)
    ck = torch.empty((Bz, nseg, d, N), **f32) if save else None
    _raise_on(_library().selective_scan_fwd_launch(
        tiling, u.data_ptr(), codes[0], dt.data_ptr(), codes[1], A.data_ptr(),
        B.data_ptr(), codes[2], C.data_ptr(), codes[3], _ptr(s0),
        DTYPES[s0.dtype] if s0 is not None else 0, y.data_ptr(),
        last.data_ptr(), _ptr(ck), Bz, S, d, N, nseg, -(-d // dc),
        _stream(u)), "selective_scan_fwd")
    _launched("selective_scan_fwd")
    return y, last, ck


def scan_backward(u, dt, A, B, C, ck, gy, glast, want_s0: bool):
    """The gradients (gu, gdt, gA, gB, gC, gs0) from the forward's
    checkpoints and the gradients of y and of the final state (either
    None for zero): gu, gdt, gB, gC in their inputs' types, gA and gs0
    (None unless ``want_s0``) float32. :data:`BWD_PARTS` on the card."""
    tiling = tiling_for(A.shape[-1])
    if not _card(u, A, None):
        return scan_backward_plain(u, dt, A, B, C, ck, gy, glast,
                                   geometry(tiling)["K"], want_s0)
    Bz, S, d = u.shape
    N = A.shape[-1]
    nseg, ncb = ck.shape[1], -(-d // geometry(tiling)["DC"])
    codes = _codes(u, dt, B, C)
    gy = None if gy is None else gy.float().contiguous()
    glast = None if glast is None else glast.float().contiguous()
    f32 = dict(dtype=torch.float32, device=u.device)
    gu, gdt = torch.empty_like(u), torch.empty_like(dt)
    pbc = torch.empty((ncb, Bz, S, 2, N), **f32)
    pA = torch.empty((Bz, d, N), **f32)
    gs0 = torch.empty((Bz, d, N), **f32) if want_s0 else None
    stream = _stream(u)
    _raise_on(_library().selective_scan_bwd_launch(
        tiling, u.data_ptr(), codes[0], dt.data_ptr(), codes[1], A.data_ptr(),
        B.data_ptr(), codes[2], C.data_ptr(), codes[3], _ptr(gy),
        _ptr(glast), ck.data_ptr(), gu.data_ptr(), gdt.data_ptr(),
        pbc.data_ptr(), pA.data_ptr(), _ptr(gs0), Bz, S, d, N, nseg, ncb,
        stream), "selective_scan_bwd")
    _launched("selective_scan_bwd")
    gB, gC = torch.empty_like(B), torch.empty_like(C)
    gA = torch.empty((d, N), **f32)
    _raise_on(_library().selective_scan_sum_launch(
        pbc.data_ptr(), pA.data_ptr(), gB.data_ptr(), codes[2],
        gC.data_ptr(), codes[3], gA.data_ptr(), Bz, S, d, N, ncb, stream),
        "selective_scan_sum")
    _launched("selective_scan_sum")
    return gu, gdt, gA, gB, gC, gs0


def _wd(*ts) -> torch.dtype:
    """The plain mirrors' arithmetic type: float64 if an input is, else
    float32."""
    return (torch.float64 if any(t is not None and t.dtype == torch.float64
                                 for t in ts) else torch.float32)


def scan_forward_plain(u, dt, A, B, C, s0, K: int, save: bool = True):
    """The forward kernel's algorithm in plain PyTorch, on any device: the
    recurrence one position at a time, the state entering every segment of
    K positions kept (as the kernel writes its checkpoints)."""
    Bz, S, d = u.shape
    wd = _wd(u, dt, A, B, C, s0)
    u, dt, A, B, C = (t.to(wd) for t in (u, dt, A, B, C))
    s = (torch.zeros((Bz, d, A.shape[-1]), dtype=wd, device=u.device)
         if s0 is None else s0.to(wd))
    ys, ck = [], []
    for t in range(S):
        if t % K == 0:
            ck.append(s)
        s = torch.exp(dt[:, t, :, None] * A) * s + \
            (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", s, C[:, t]))
    y = torch.stack(ys, 1) if ys else u.new_zeros((Bz, 0, d))
    return y, s, torch.stack(ck, 1) if save and ck else None


def scan_backward_plain(u, dt, A, B, C, ck, gy, glast, K: int,
                        want_s0: bool = True):
    """The backward kernel's algorithm in plain PyTorch, on any device:
    segments from last to first, each recomputing its states from its
    checkpoint, then the adjoint g_t = a_{t+1} g_{t+1} + gy_t C_t walked in
    reverse with every gradient formed on the way (the equations of
    ``csrc/selective_scan.cu``'s header). Returns :func:`scan_backward`'s
    gradients, in the arithmetic type."""
    Bz, S, d = u.shape
    N = A.shape[-1]
    wd = _wd(u, dt, A, B, C, ck, gy, glast)
    u, dt, A, B, C, ck = (t.to(wd) for t in (u, dt, A, B, C, ck))
    z = dict(dtype=wd, device=u.device)
    g = torch.zeros((Bz, d, N), **z) if glast is None else glast.to(wd)
    gy = torch.zeros((Bz, S, d), **z) if gy is None else gy.to(wd)
    gu, gdt = torch.empty((Bz, S, d), **z), torch.empty((Bz, S, d), **z)
    gB, gC = torch.empty((Bz, S, N), **z), torch.empty((Bz, S, N), **z)
    gA, anext = torch.zeros((d, N), **z), torch.ones((Bz, d, N), **z)
    for k in reversed(range(ck.shape[1])):
        t0 = k * K
        states, s = [ck[:, k]], ck[:, k]
        for t in range(t0, min(t0 + K, S)):
            s = torch.exp(dt[:, t, :, None] * A) * s + \
                (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]
            states.append(s)
        for t in reversed(range(t0, min(t0 + K, S))):
            i = t - t0
            g = anext * g + gy[:, t, :, None] * C[:, t, None, :]
            a = torch.exp(dt[:, t, :, None] * A)
            w = g * (a * states[i])                       # g h
            gb = (g * B[:, t, None, :]).sum(-1)
            gu[:, t] = gb * dt[:, t]
            gdt[:, t] = gb * u[:, t] + (w * A).sum(-1)
            gA += (w * dt[:, t, :, None]).sum(0)
            gB[:, t] = torch.einsum("bdn,bd->bn", g, dt[:, t] * u[:, t])
            gC[:, t] = torch.einsum("bdn,bd->bn", states[i + 1], gy[:, t])
            anext = a
    return gu, gdt, gA, gB, gC, anext * g if want_s0 else None


class _SelectiveScanKernel(torch.autograd.Function):
    """y and the final state; saves the inputs and the forward's segment
    checkpoints for the backward (no [Bz, S, d, N] tensor)."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, s0, save):
        y, last, ck = scan_forward(u, dt, A, B, C, s0, save)
        ctx.save_for_backward(u, dt, A, B, C, ck)
        ctx.s0_dtype = None if s0 is None else s0.dtype
        ctx.set_materialize_grads(False)
        return y, last

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy, glast):
        u, dt, A, B, C, ck = ctx.saved_tensors
        gu, gdt, gA, gB, gC, gs0 = scan_backward(
            u, dt, A, B, C, ck, gy, glast, ctx.s0_dtype is not None)
        return (gu.to(u.dtype), gdt.to(dt.dtype), gA.to(A.dtype),
                gB.to(B.dtype), gC.to(C.dtype),
                None if gs0 is None else gs0.to(ctx.s0_dtype), None)


def selective_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *,
                   initial_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan of the module docstring under one ``autograd.Function``:
    on the card one forward launch and two backward launches a call (the
    checkpoints are written only when autograd will call the backward); on
    the CPU the plain mirrors. Raises ``ValueError`` on what the kernels
    do not take."""
    _check(u, dt, A, B, C, initial_state)
    _card(u, A, initial_state)
    ins = (u, dt, A, B, C) + (() if initial_state is None
                              else (initial_state,))
    save = torch.is_grad_enabled() and any(t.requires_grad for t in ins)
    return _SelectiveScanKernel.apply(u, dt, A, B, C, initial_state, save)
