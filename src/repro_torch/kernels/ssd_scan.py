"""The Mamba-2 SSD chunk scan, the port of the reference's
``repro/kernels/ssd_scan.py::_ssd_kernel``, and the scan for training
with its gradient.

``ssd_scan(x, da, dt, B, C, chunk=256)`` takes x ``[Bz, S, H, P]``
(float32, bf16 or float16), da = dt * A and dt ``[Bz, S, H]``, and B, C
``[Bz, S, G, N]`` for G groups that divide the H heads (the op
:func:`repro_torch.kernels.ops.ssd_scan_op` broadcasts them to the heads,
G = H), and returns y ``[Bz, S, H, P]`` in x's dtype and the final state
``[Bz, H, N, P]`` in float32. Chunks of ``cs = min(chunk, S)`` steps: S
must be a multiple of cs (``ValueError``, where the reference asserts).
All arithmetic is float32; with cum the running sum of da within a chunk
and xdt = x dt:

1. :func:`chunk_state` — each chunk's own state from zero, ``s_c =
   (B * exp(cum_last - cum))^T xdt`` ``[Bz, H, S/cs, N, P]``, and cum
   ``[Bz, H, S]`` (the one cum the other two read);
2. :func:`state_pass` — the scan over chunks, ``h_in[c + 1] =
   exp(cum_last) h_in[c] + s_c`` from an initial state (zero by
   default): overwrites the chunk states with ``h_in`` in place and
   returns the final state;
3. :func:`chunk_scan` — y, the intra-chunk term ``(C B^T * seg) xdt``
   (seg the masked decay ``exp(cum_i - cum_j)``, j <= i, masked before
   its exp) plus the inter-chunk term ``exp(cum) * (C h_in)``.

On CUDA tensors each step is one launch of its kernel (the first two in
``csrc/ssd_train.cu``, the third in ``csrc/ssd_scan.cu``), in that order
on the current stream (da, dt, B and C widened to float32 first, which is
exact), so :func:`ssd_scan` launches ``LAUNCHES_PER_CALL`` kernels a
call; on CPU tensors each runs its plain version (``*_plain``), and
:func:`ssd_scan_plain` is their composition. Any N: where the chunk
scan's whole tile of C would pass a block's 227 KB of shared memory (N
above 608 at chunk 256) it streams C (:func:`streams_c`). A chunk whose
per-step vectors pass that (cs above 16469, :func:`smem_bytes`) raises
``ValueError``. The reference's ``interpret`` has no counterpart.

Training. :func:`ssd_train` is ``models.ssm.ssd_chunked``'s scan (its
layouts, B and C per group, an initial state) under one
``autograd.Function``, which ``ssd_chunked`` runs on CUDA tensors: on the
card the zoo's training and prefill SSD run these kernels, while the
reference's zoo differentiates its plain layer. Its forward is
:data:`TRAIN_PARTS` (C B^T once per chunk and group, the chunk states and
the scan over chunks, y from the scores), its backward
:data:`BWD_PARTS`, one launch each, every cs x cs tile kept on chip and
every sum in one order (two runs give the same bits); the equations are
in the headers of ``csrc/ssd_train.cu`` and ``csrc/ssd_grad.cu``. On CPU
tensors the Function runs the plain versions and
:func:`ssd_backward_plain`. :data:`part_launches` counts every launch by
part.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels.build import build, load_library

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_SMEM = 232448          # a block's opt-in shared memory on an H100
TILE = 64                  # the kernels' tile edge (csrc/ssd_tiles.cuh)
SLAB = 32                  # their K slab
LD = TILE + 4              # words per row of a shared tile
STAGES = 3                 # the chunk scan's ring of slabs
#: the three kernels of a call, in launch order (also their device names,
#: with ``_kernel`` appended)
PARTS = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")
LAUNCHES_PER_CALL = len(PARTS)
#: the forward's launches of :func:`ssd_train` on the card, in order: the
#: scores of ``csrc/ssd_train.cu``, the first two kernels of a call, and
#: y from the scores (device name ``ssd_train_scan_kernel``)
TRAIN_PARTS = ("ssd_scores", "ssd_chunk_state", "ssd_state_pass",
               "ssd_train_scan")
#: the backward's launches, in order: the chunk-state and state-pass
#: kernels in their backward forms, then ``csrc/ssd_grad.cu``'s
#: ``ssd_bwd_dx_kernel``, ``ssd_bwd_ds_kernel``, ``ssd_bwd_dbc_kernel``
#: twice (C's gradient, then B's) and ``ssd_bwd_dcum_kernel``
BWD_PARTS = ("ssd_bwd_chunk_state", "ssd_bwd_state_pass", "ssd_bwd_dx",
             "ssd_bwd_ds", "ssd_bwd_dc", "ssd_bwd_db", "ssd_bwd_dcum")

#: kernel launches so far, forward and backward (the CUDA path only)
launch_count = 0
#: kernel launches so far, by part
part_launches: Dict[str, int] = dict.fromkeys(
    PARTS + ("ssd_scores", "ssd_train_scan") + BWD_PARTS, 0)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _scan_resident_bytes(N: int, cs: int) -> int:
    return 4 * (_ceil(N, SLAB) * SLAB * LD + STAGES * SLAB * LD
                + 2 * TILE * LD + 2 * cs)


def streams_c(N: int, cs: int) -> bool:
    """Whether the chunk scan streams C in slabs beside B (``kStreamC``)
    because its whole 64 x N tile of C would pass a block's shared
    memory (mirrors ``scan_streams_c`` in ``csrc/ssd_scan.cu``)."""
    return _scan_resident_bytes(N, cs) > MAX_SMEM


def smem_bytes(N: int, cs: int) -> Dict[str, int]:
    """Each kernel's shared memory at (N, cs) (mirrors ``state_smem`` in
    ``csrc/ssd_train.cu`` and ``scan_smem`` in ``csrc/ssd_scan.cu``): the
    chunk state's two stages of B and of x dt w, and the chunk's cum, dt
    and w (N and P are tiled in the grid); the chunk scan's 64 x N tile of C (or, streaming C,
    three stages of it), three stages of B or h_in, the scores, x, and
    the chunk's cum and dt. P is tiled in the grid and takes none."""
    scan = (4 * (2 * STAGES * SLAB * LD + 2 * TILE * LD + 2 * cs)
            if streams_c(N, cs) else _scan_resident_bytes(N, cs))
    return {"ssd_chunk_state": 4 * (4 * SLAB * LD + 3 * cs),
            "ssd_state_pass": 0,
            "ssd_chunk_scan": scan}


def chunk_size(S: int, chunk: int) -> int:
    """``cs = min(chunk, S)``; raises unless S is a multiple of it."""
    cs = min(chunk, S)
    if cs < 1 or S % cs:
        raise ValueError(f"ssd_scan: S = {S} is not a multiple of the chunk "
                         f"{cs}")
    return cs


def scan_block_order(Bz: int, H: int, S: int, P: int, cs: int
                     ) -> List[Tuple[int, int, int, int, int]]:
    """``(row tile, b, h, chunk, P tile)`` of each block of the chunk scan,
    by ``blockIdx.x`` (the kernel's own decoding): row tile ``it`` does
    ``it + 1`` column tiles, so the heaviest tiles come first."""
    nc, ntile, npt = S // cs, _ceil(cs, TILE), _ceil(P, TILE)
    per = Bz * H * nc * npt
    order = []
    for q in range(per * ntile):
        it, rest = ntile - 1 - q // per, q % per
        pt, rest = rest % npt, rest // npt
        c, bh = rest % nc, rest // nc
        order.append((it, bh // H, bh % H, c, pt))
    return order


def _check(x, da, dt, B, C) -> None:
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape or \
            tuple(B.shape[:2]) != tuple(x.shape[:2]) or B.shape[2] < 1 or \
            x.shape[2] % B.shape[2] or \
            da.shape != x.shape[:3] or dt.shape != x.shape[:3]:
        raise ValueError(f"ssd_scan takes x [Bz, S, H, P], da, dt [Bz, S, H] "
                         f"and B, C [Bz, S, G, N] for G dividing H, got "
                         f"{tuple(x.shape)}, "
                         f"{tuple(da.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    for t in (x, da, dt, B, C):
        if not t.dtype.is_floating_point:
            raise TypeError(f"ssd_scan takes float tensors, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("ssd_scan: inputs lie on different devices")


def _card(*ts) -> bool:
    """Whether the kernels run (CUDA tensors) or the plain versions (CPU
    tensors); raises on any other device."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("ssd_scan: inputs lie on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {dev}")
    return True


def _f32(*ts):
    return [t.float().contiguous() for t in ts]


def _launched(part: str) -> None:
    global launch_count
    launch_count += 1
    part_launches[part] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, part: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{part} kernel launch failed: CUDA error {rc}")


def ssd_scan(x: torch.Tensor, da: torch.Tensor, dt: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, state) of the chunk scan (see the module docstring). CUDA
    tensors launch the three kernels in order; CPU tensors run
    :func:`ssd_scan_plain`."""
    _check(x, da, dt, B, C)
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    cs = chunk_size(S, chunk)
    if not _card(x):
        return ssd_scan_plain(x, da, dt, B, C, chunk=chunk)
    if x.dtype not in DTYPES:
        raise TypeError(f"ssd_scan takes float32, bfloat16 or float16 x, "
                        f"got {x.dtype}")
    need = max(smem_bytes(N, cs).values())
    if need > MAX_SMEM:
        raise ValueError(f"ssd_scan: chunk {cs} needs {need} bytes of "
                         f"shared memory, above {MAX_SMEM}")
    x = x.contiguous()
    da, dt, B, C = _f32(da, dt, B, C)
    if x.numel() == 0 or B.numel() == 0:
        return torch.empty_like(x), torch.zeros(
            (Bz, H, N, P), dtype=torch.float32, device=x.device)
    states, cum = chunk_state(x, da, dt, B, cs)
    h_in, state = state_pass(states, cum, cs)
    return chunk_scan(x, dt, B, C, cum, h_in, cs), state


def chunk_state(x: torch.Tensor, da: torch.Tensor, dt: torch.Tensor,
                B: torch.Tensor, cs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 1: (chunk states ``[Bz, H, S/cs, N, P]``, cum ``[Bz, H, S]``),
    both float32 and non-empty shapes only; one launch of
    ``ssd_chunk_state_kernel`` on the card."""
    if not _card(x, da, dt, B):
        return chunk_state_plain(x, da, dt, B, cs)
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    x = x.contiguous()
    da, dt, B = _f32(da, dt, B)
    states = torch.empty((Bz, H, S // cs, N, P), dtype=torch.float32,
                         device=x.device)
    cum = torch.empty((Bz, H, S), dtype=torch.float32, device=x.device)
    rc = _library().ssd_chunk_state_launch(
        DTYPES[x.dtype], x.data_ptr(), da.data_ptr(), dt.data_ptr(),
        B.data_ptr(), states.data_ptr(), cum.data_ptr(), Bz, S, H, P, N, cs,
        B.shape[2], 0, _stream(x))
    _raise_on(rc, "ssd_chunk_state")
    _launched("ssd_chunk_state")
    return states, cum


def state_pass(states: torch.Tensor, cum: torch.Tensor, cs: int,
               init: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 2, in place: ``states`` (contiguous float32) becomes h_in, the
    state each chunk starts from (the first ``init`` ``[Bz, H, N, P]``, or
    zero); returns it and the final state ``[Bz, H, N, P]``. One launch of
    ``ssd_state_pass_kernel`` on the card."""
    if not _card(states, cum):
        return state_pass_plain(states, cum, cs, init)
    if states.dtype != torch.float32 or not states.is_contiguous():
        raise ValueError("state_pass updates a contiguous float32 tensor")
    Bz, H, nc, N, P = states.shape
    cum = cum.float().contiguous()
    state = torch.empty((Bz, H, N, P), dtype=torch.float32,
                        device=states.device)
    init = _f32(init)[0] if init is not None else None
    rc = _library().ssd_state_pass_launch(
        states.data_ptr(), cum.data_ptr(), state.data_ptr(),
        init.data_ptr() if init is not None else None, Bz, nc * cs, H, P, N,
        cs, 0, _stream(states))
    _raise_on(rc, "ssd_state_pass")
    _launched("ssd_state_pass")
    return states, state


def chunk_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, cum: torch.Tensor, h_in: torch.Tensor,
               cs: int) -> torch.Tensor:
    """Step 3: y ``[Bz, S, H, P]`` in x's dtype from cum and h_in; one
    launch of ``ssd_chunk_scan_kernel`` on the card."""
    if not _card(x, dt, B, C, cum, h_in):
        return chunk_scan_plain(x, dt, B, C, cum, h_in, cs)
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    x = x.contiguous()
    dt, B, C, cum, h_in = _f32(dt, B, C, cum, h_in)
    y = torch.empty_like(x)
    rc = _library("ssd_scan").ssd_chunk_scan_launch(
        DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), B.data_ptr(),
        C.data_ptr(), cum.data_ptr(), h_in.data_ptr(), y.data_ptr(), Bz, S,
        H, P, N, cs, B.shape[2], _stream(x))
    _raise_on(rc, "ssd_chunk_scan")
    _launched("ssd_chunk_scan")
    return y


def kernel_inputs(x, dt, A, B, C):
    """What ``ops.ssd_scan_op`` hands the kernels, from the model-facing
    inputs (A [H], B / C [Bz, S, G, N]): (x, da = dt A, dt, B and C
    repeated from their G groups to the H heads)."""
    rep = x.shape[2] // B.shape[2]
    return (x, dt * A[None, None, :], dt,
            torch.repeat_interleave(B, rep, dim=2),
            torch.repeat_interleave(C, rep, dim=2))


_I64, _VP, _CI = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
_SIZES = [_I64] * 6                           # Bz, S, H, P, N, cs
#: each library's launchers and their arguments before the stream:
#: ``csrc/ssd_scan.cu`` holds the chunk scan, ``csrc/ssd_train.cu`` the
#: chunk states and the scan over chunks (which both paths run) and the
#: training forward, ``csrc/ssd_grad.cu`` the training backward; the
#: training path builds the last two, in parallel
_SIGNATURES = {
    "ssd_scan": {"ssd_chunk_scan_launch": [_CI] + [_VP] * 7 + _SIZES + [_I64]},
    "ssd_train": {
        "ssd_chunk_state_launch": [_CI] + [_VP] * 6 + _SIZES + [_I64, _CI],
        "ssd_state_pass_launch": [_VP] * 4 + _SIZES + [_CI],
        "ssd_scores_launch": [_VP] * 3 + [_I64] * 5,
        "ssd_train_scan_launch": [_CI] + [_VP] * 7 + [_I64] * 7},
    "ssd_grad": {
        "ssd_bwd_dx_launch": [_CI] + [_VP] * 9 + [_I64] * 7,
        "ssd_bwd_ds_launch": [_CI] + [_VP] * 8 + [_I64] * 6,
        "ssd_bwd_dbc_launch": [_CI, _CI] + [_VP] * 10 + [_I64] * 7,
        "ssd_bwd_dcum_launch": [_VP] * 12 + [_I64] * 6}}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _library(name: str = "ssd_train") -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, its launchers typed. The
    first use builds what its path needs at once: the chunk scan's all
    three sources, the training path's ``ssd_train`` and ``ssd_grad``."""
    lib = _LIBS.get(name)
    if lib is None:
        build(tuple(_SIGNATURES) if name == "ssd_scan"
              else ("ssd_train", "ssd_grad"))
        lib = load_library(name)
        for fn_name, args in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = args + [_VP]        # the stream last
            fn.restype = _CI
        _LIBS[name] = lib
    return lib


# ---------------------------------------------------------------------------
# the plain versions: the reference kernel's chunk body, batched over (Bz,
# H, chunk), in the reference's order; float32 arithmetic (float64 for
# float64 inputs)
# ---------------------------------------------------------------------------

def _acc(*ts) -> torch.dtype:
    """The plain versions' arithmetic type: float64 if an input is, else
    float32."""
    return (torch.float64 if any(t.dtype == torch.float64 for t in ts)
            else torch.float32)


def _by_chunk(t: torch.Tensor, cs: int, H: Optional[int] = None
              ) -> torch.Tensor:
    """[Bz, S, G, W] -> [Bz, H, S/cs, cs, W] in :func:`_acc`'s type, the G
    groups repeated to H heads (``H`` defaults to G)."""
    Bz, S, G, W = t.shape
    if H is not None and H != G:
        t = torch.repeat_interleave(t, H // G, dim=2)
    return t.to(_acc(t)).permute(0, 2, 1, 3).reshape(Bz, -1, S // cs, cs, W)


def _from_chunks(t: torch.Tensor) -> torch.Tensor:
    """[Bz, H, nc, cs, W] -> [Bz, S, H, W]."""
    Bz, H, nc, cs, W = t.shape
    return t.reshape(Bz, H, nc * cs, W).permute(0, 2, 1, 3)


def _xdt(x: torch.Tensor, dt: torch.Tensor, cs: int) -> torch.Tensor:
    wd = _acc(x, dt)
    return _by_chunk(x.to(wd) * dt.to(wd)[..., None], cs)


def chunk_state_plain(x: torch.Tensor, da: torch.Tensor, dt: torch.Tensor,
                      B: torch.Tensor, cs: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`chunk_state`, on any device."""
    Bz, S, H, _ = x.shape
    cum = torch.cumsum(da.to(_acc(da)).transpose(1, 2).reshape(
        Bz, H, S // cs, cs), dim=-1)
    dout = torch.exp(cum[..., -1:] - cum)                # [Bz, H, nc, cs]
    states = torch.matmul((_by_chunk(B, cs, H) * dout[..., None]).transpose(
        -1, -2), _xdt(x, dt, cs))
    return states, cum.reshape(Bz, H, S)


def state_pass_plain(states: torch.Tensor, cum: torch.Tensor, cs: int,
                     init: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`state_pass`, on any device (also in
    place)."""
    Bz, H, nc, N, P = states.shape
    last = cum.to(_acc(cum)).reshape(Bz, H, nc, cs)[..., -1]
    h = (torch.zeros((Bz, H, N, P), dtype=states.dtype, device=states.device)
         if init is None else init.to(states.dtype))
    for c in range(nc):
        s_c = states[:, :, c].clone()
        states[:, :, c] = h
        h = torch.exp(last[:, :, c])[..., None, None] * h + s_c
    return states, h


def _decay(cum: torch.Tensor, cs: int) -> torch.Tensor:
    """L = exp(cum_i - cum_j) for j <= i, else 0 ([..., cs, cs], masked
    before the exp)."""
    tril = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                 device=cum.device))
    diff = cum[..., :, None] - cum[..., None, :]
    return torch.where(tril, torch.exp(torch.where(tril, diff, 0.0)), 0.0)


def chunk_scan_plain(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                     C: torch.Tensor, cum: torch.Tensor, h_in: torch.Tensor,
                     cs: int) -> torch.Tensor:
    """The plain version of :func:`chunk_scan`, on any device. The decay
    is masked before its exp, as the kernel's."""
    Bz, S, H, P = x.shape
    cum = cum.to(_acc(cum)).reshape(Bz, H, S // cs, cs)
    Cc = _by_chunk(C, cs, H)
    y = torch.matmul(torch.matmul(Cc, _by_chunk(B, cs, H).transpose(-1, -2))
                     * _decay(cum, cs), _xdt(x, dt, cs))
    y = y + torch.exp(cum)[..., None] * torch.matmul(Cc, h_in.to(_acc(h_in)))
    return _from_chunks(y).to(x.dtype)


def ssd_scan_plain(x: torch.Tensor, da: torch.Tensor, dt: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`ssd_scan`, on any device: the
    three plain steps in order."""
    _check(x, da, dt, B, C)
    cs = chunk_size(x.shape[1], chunk)
    states, cum = chunk_state_plain(x, da, dt, B, cs)
    h_in, state = state_pass_plain(states, cum, cs)
    return chunk_scan_plain(x, dt, B, C, cum, h_in, cs), state


# ---------------------------------------------------------------------------
# training: the scan and its gradient under one autograd.Function
# ---------------------------------------------------------------------------

def ssd_backward_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, cum: torch.Tensor,
                       h_in: torch.Tensor, dy: Optional[torch.Tensor],
                       dfinal: Optional[torch.Tensor], cs: int,
                       abs_terms: bool = False) -> tuple:
    """The gradient of :func:`ssd_train`'s scan, in plain PyTorch on any
    device: from x ``[Bz, S, H, P]``, dt ``[Bz, S, H]``, A ``[H]``, B and C
    ``[Bz, S, G, N]``, the forward's cum ``[Bz, H, S]`` and chunk-start
    states h_in ``[Bz, H, S/cs, N, P]``, and the gradients of y (dy, or
    None for zero) and of the final state ``[Bz, H, N, P]`` (dfinal, or
    None), returns the gradients (dx, ddt, dA, dB, dC, dinit) in
    :func:`_acc`'s type, dinit ``[Bz, H, N, P]``. The equations are those
    of ``csrc/ssd_grad.cu``'s header: a reverse pass over chunks for the
    state gradients sbar, then per chunk the inputs' gradients, with the
    decay's folded into cumbar = C . Cbar - B . Bbar per head. With
    ``abs_terms`` the two parts of cumbar add and A enters as |A|: run on
    absolute inputs, each gradient is then the sum of its terms'
    magnitudes (the checks' error bounds)."""
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc = S // cs
    wd = _acc(x, dt, A, B, C, h_in)
    xc = _by_chunk(x, cs).to(wd)                        # [Bz, H, nc, cs, P]
    dtc = dt.to(wd).transpose(1, 2).reshape(Bz, H, nc, cs)
    Bc, Cc = _by_chunk(B, cs, H).to(wd), _by_chunk(C, cs, H).to(wd)
    dyc = (torch.zeros_like(xc) if dy is None else _by_chunk(dy, cs).to(wd))
    cum = cum.to(wd).reshape(Bz, H, nc, cs)
    h_in = h_in.to(wd)
    last = cum[..., -1]                                 # [Bz, H, nc]
    u = xc * dtc[..., None]
    L = _decay(cum, cs)                                 # [.., i, j]
    Sm = torch.matmul(Cc, Bc.transpose(-1, -2))         # C_i . B_j
    to_end = torch.exp(last[..., None] - cum)           # exp(last - cum_j)

    # the reverse pass: sbar_c = hbar_{c+1}
    terms = torch.matmul((Cc * torch.exp(cum)[..., None]).transpose(-1, -2),
                         dyc)                           # [.., N, P]
    g = (torch.zeros((Bz, H, N, P), dtype=wd, device=x.device)
         if dfinal is None else dfinal.to(wd))
    sbar = torch.empty_like(h_in)
    for c in reversed(range(nc)):
        sbar[:, :, c] = g
        g = torch.exp(last[:, :, c])[..., None, None] * g + terms[:, :, c]

    b_s = to_end[..., None] * torch.matmul(Bc, sbar)    # [.., cs, P]
    du = torch.matmul((Sm * L).transpose(-1, -2), dyc) + b_s
    sl = torch.matmul(dyc, u.transpose(-1, -2)) * L     # (dy_i . u_j) L_ij
    dC = torch.matmul(sl, Bc) + torch.exp(cum)[..., None] * torch.matmul(
        dyc, h_in.transpose(-1, -2))
    dB = torch.matmul(sl.transpose(-1, -2), Cc) + to_end[..., None] * \
        torch.matmul(u, sbar.transpose(-1, -2))
    dcum = (Cc * dC).sum(-1) + (1 if abs_terms else -1) * (Bc * dB).sum(-1)
    dlast = (u * b_s).sum((-1, -2)) + torch.exp(last) * (sbar * h_in).sum(
        (-1, -2))
    dcum[..., -1] += dlast
    da = dcum.flip(-1).cumsum(-1).flip(-1)              # abar
    a = A.to(wd).abs() if abs_terms else A.to(wd)
    ddt = (xc * du).sum(-1) + da * a[None, :, None, None]
    dA = (da * dtc).sum((0, 2, 3))

    def grouped(t):                                     # heads -> groups
        return _from_chunks(t).reshape(Bz, S, G, H // G, N).sum(3)

    return (_from_chunks(du * dtc[..., None]),
            ddt.reshape(Bz, H, S).transpose(1, 2), dA, grouped(dB),
            grouped(dC), g)


def _forward(x, dt, A, B, C, init, cs):
    """(y, final state, cum, h_in, scores) of the scan, kernel layouts:
    :data:`TRAIN_PARTS` on the card (scores ``[Bz, G, S/cs, cs, cs]``, C
    B^T of each chunk and group), the plain versions elsewhere (scores
    None)."""
    wd = _acc(dt, A)
    da = dt.to(wd) * A.to(wd)[None, None, :]
    if not _card(x, dt, A, B, C):
        states, cum = chunk_state_plain(x, da, dt, B, cs)
        h_in, final = state_pass_plain(states, cum, cs, init)
        return (chunk_scan_plain(x, dt, B, C, cum, h_in, cs), final, cum,
                h_in, None)
    if x.dtype not in DTYPES:
        raise TypeError(f"ssd_train takes float32, bfloat16 or float16 x, "
                        f"got {x.dtype}")
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    lib = _library()
    x = x.contiguous()
    da, dt, B, C = _f32(da, dt, B, C)
    scores = torch.empty((Bz, G, S // cs, cs, cs), dtype=torch.float32,
                         device=x.device)
    _raise_on(lib.ssd_scores_launch(B.data_ptr(), C.data_ptr(),
                                    scores.data_ptr(), Bz, S, N, cs, G,
                                    _stream(x)), "ssd_scores")
    _launched("ssd_scores")
    states, cum = chunk_state(x, da, dt, B, cs)
    h_in, final = state_pass(states, cum, cs, init)
    y = torch.empty_like(x)
    _raise_on(lib.ssd_train_scan_launch(
        DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), C.data_ptr(),
        cum.data_ptr(), h_in.data_ptr(), scores.data_ptr(), y.data_ptr(),
        Bz, S, H, P, N, cs, G, _stream(x)), "ssd_train_scan")
    _launched("ssd_train_scan")
    return y, final, cum, h_in, scores


def _backward(x, dt, A, B, C, cum, h_in, scores, dy, dfinal, cs):
    """ssd_backward_plain's gradients, by :data:`BWD_PARTS` on the card."""
    if not _card(x, dt, A, B, C, cum, h_in):
        return ssd_backward_plain(x, dt, A, B, C, cum, h_in, dy, dfinal, cs)
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc, dev = S // cs, x.device
    x = x.contiguous()
    dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
    dt, A, B, C = _f32(dt, A, B, C)
    da = (dt * A[None, None, :]).contiguous()
    lib, code, stream = _library("ssd_grad"), DTYPES[x.dtype], _stream(x)

    def ws(tiles):                  # per-row partial sums [tiles, Bz, H, S]
        return torch.empty((tiles, Bz, H, S), dtype=torch.float32,
                           device=dev)

    def launch(part, rc):
        _raise_on(rc, part)
        _launched(part)

    # the chunk terms sum_i exp(cum_i) C_i^T dy_i, then the reverse pass
    # leaves sbar in their place
    sbar = torch.empty((Bz, H, nc, N, P), dtype=torch.float32, device=dev)
    launch("ssd_bwd_chunk_state", _library().ssd_chunk_state_launch(
        code, dy.data_ptr(), da.data_ptr(), da.data_ptr(), C.data_ptr(),
        sbar.data_ptr(), None, Bz, S, H, P, N, cs, G, 1, stream))
    dinit = torch.empty((Bz, H, N, P), dtype=torch.float32, device=dev)
    dfinal = None if dfinal is None else dfinal.float().contiguous()
    launch("ssd_bwd_state_pass", _library().ssd_state_pass_launch(
        sbar.data_ptr(), cum.data_ptr(), dinit.data_ptr(),
        None if dfinal is None else dfinal.data_ptr(), Bz, S, H, P, N, cs, 1,
        stream))

    ntile, npt, ntn = _ceil(cs, TILE), _ceil(P, TILE), _ceil(N, TILE)
    dx, xu = torch.empty_like(x), ws(npt)
    launch("ssd_bwd_dx", lib.ssd_bwd_dx_launch(
        code, x.data_ptr(), dy.data_ptr(), dt.data_ptr(), B.data_ptr(),
        cum.data_ptr(), sbar.data_ptr(), scores.data_ptr(), dx.data_ptr(),
        xu.data_ptr(), Bz, S, H, P, N, cs, G, stream))
    shat, wrow, wcol = torch.empty_like(scores), ws(ntile), ws(ntile)
    launch("ssd_bwd_ds", lib.ssd_bwd_ds_launch(
        code, x.data_ptr(), dy.data_ptr(), dt.data_ptr(), cum.data_ptr(),
        scores.data_ptr(), shat.data_ptr(), wrow.data_ptr(), wcol.data_ptr(),
        Bz, S, H, P, cs, G, stream))
    # Cbar with the row sums dy . y_inter, Bbar with r
    grads, dots = {}, {}
    for part, is_db, state in (("ssd_bwd_dc", 0, h_in),
                               ("ssd_bwd_db", 1, sbar)):
        grads[part] = torch.empty((Bz, S, G, N), dtype=torch.float32,
                                  device=dev)
        dots[part] = ws(ntn)
        launch(part, lib.ssd_bwd_dbc_launch(
            code, is_db, x.data_ptr(), dy.data_ptr(), dt.data_ptr(),
            B.data_ptr(), C.data_ptr(), cum.data_ptr(), state.data_ptr(),
            shat.data_ptr(), grads[part].data_ptr(), dots[part].data_ptr(),
            Bz, S, H, P, N, cs, G, stream))
    ddt = torch.empty((Bz, S, H), dtype=torch.float32, device=dev)
    dA = torch.empty((Bz, H, nc), dtype=torch.float32, device=dev)
    launch("ssd_bwd_dcum", lib.ssd_bwd_dcum_launch(
        cum.data_ptr(), dt.data_ptr(), A.data_ptr(), xu.data_ptr(),
        dots["ssd_bwd_db"].data_ptr(), wrow.data_ptr(), wcol.data_ptr(),
        dots["ssd_bwd_dc"].data_ptr(),
        sbar.data_ptr(), h_in.data_ptr(), ddt.data_ptr(), dA.data_ptr(), Bz,
        S, H, P, N, cs, stream))
    return (dx, ddt, dA.sum((0, 2)), grads["ssd_bwd_db"],
            grads["ssd_bwd_dc"], dinit)


class _SsdTrain(torch.autograd.Function):
    """y and the final state of the scan (kernel layouts); saves x, dt, A,
    B, C, cum, the chunk-start states and (on the card) the scores for the
    backward."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, init, cs):
        y, final, cum, h_in, scores = _forward(x, dt, A, B, C, init, cs)
        ctx.save_for_backward(x, dt, A, B, C, cum, h_in, scores)
        ctx.cs = cs
        ctx.init_dtype = None if init is None else init.dtype
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C, cum, h_in, scores = ctx.saved_tensors
        dx, ddt, dA, dB, dC, dinit = _backward(x, dt, A, B, C, cum, h_in,
                                               scores, dy, dfinal, ctx.cs)
        return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
                dB.to(B.dtype), dC.to(C.dtype),
                None if ctx.init_dtype is None else dinit.to(ctx.init_dtype),
                None)


def ssd_train(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, *, chunk: int,
              initial_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_chunked``'s scan under one ``autograd.Function``, in its
    layouts: x ``[Bz, S, H, P]``, dt ``[Bz, S, H]``, A ``[H]``, B and C
    ``[Bz, S, G, N]`` as the model makes them (not repeated to the heads),
    the initial state ``[Bz, H, P, N]`` or None; S a multiple of
    ``chunk``. Returns y ``[Bz, S, H, P]`` in x's type and the final state
    ``[Bz, H, P, N]`` in float32. On the card the forward is
    :data:`TRAIN_PARTS` (B and C per group, from the initial state) and
    the backward :data:`BWD_PARTS`, one launch each; on the CPU the plain
    versions and :func:`ssd_backward_plain`."""
    _check(x, dt, dt, B, C)
    Bz, S, H, P = x.shape
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_train: S = {S} is not a multiple of the "
                         f"chunk {chunk} (ssd_chunked pads it)")
    want = (Bz, H, P, B.shape[-1])
    if tuple(A.shape) != (H,) or (initial_state is not None and
                                  tuple(initial_state.shape) != want):
        raise ValueError(f"ssd_train takes A [{H}] and an initial state "
                         f"{list(want)}, got {tuple(A.shape)} and "
                         f"{None if initial_state is None else tuple(initial_state.shape)}")
    init = (None if initial_state is None
            else initial_state.transpose(-1, -2).contiguous())
    _card(x, A, *(() if init is None else (init,)))
    y, final = _SsdTrain.apply(x, dt, A, B, C, init, chunk)
    return y, final.transpose(-1, -2)
