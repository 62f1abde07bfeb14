"""The Mamba-2 SSD chunk scan, the port of the reference's
``repro/kernels/ssd_scan.py::_ssd_kernel``.

``ssd_scan(x, da, dt, B, C, chunk=256)`` takes x ``[Bz, S, H, P]``
(float32, bf16 or float16), da = dt * A and dt ``[Bz, S, H]``, and B, C
``[Bz, S, H, N]`` already broadcast from their groups to the heads (the op
:func:`repro_torch.kernels.ops.ssd_scan_op` does that), and returns y
``[Bz, S, H, P]`` in x's dtype and the final state ``[Bz, H, N, P]`` in
float32. Chunks of ``cs = min(chunk, S)`` steps: S must be a multiple of
cs (``ValueError``, where the reference asserts). All arithmetic is
float32; with cum the running sum of da within a chunk and xdt = x dt:

1. :func:`chunk_state` — each chunk's own state from zero, ``s_c =
   (B * exp(cum_last - cum))^T xdt`` ``[Bz, H, S/cs, N, P]``, and cum
   ``[Bz, H, S]`` (the one cum the other two read);
2. :func:`state_pass` — the scan over chunks, ``h_in[c + 1] =
   exp(cum_last) h_in[c] + s_c`` from zero: overwrites the chunk states
   with ``h_in`` in place and returns the final state;
3. :func:`chunk_scan` — y, the intra-chunk term ``(C B^T * seg) xdt``
   (seg the masked decay ``exp(cum_i - cum_j)``, j <= i, masked before
   its exp) plus the inter-chunk term ``exp(cum) * (C h_in)``.

On CUDA tensors each step is one launch of its kernel in
``csrc/ssd_scan.cu``, in that order on the current stream (da, dt, B and
C widened to float32 first, which is exact), so :func:`ssd_scan`
launches ``LAUNCHES_PER_CALL`` kernels a call; on CPU tensors each runs
its plain version (``*_plain``), and :func:`ssd_scan_plain` is their
composition. Any N: where the chunk scan's whole tile of C would pass a
block's 227 KB of shared memory (N above 608 at chunk 256) it streams C
(:func:`streams_c`). A chunk whose per-step vectors pass that (cs above
16469, :func:`smem_bytes`) raises ``ValueError``. The reference's
``interpret`` has no counterpart.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels.build import load_library

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_SMEM = 232448          # a block's opt-in shared memory on an H100
TILE = 64                  # the kernels' tile edge (csrc/ssd_scan.cu)
SLAB = 32                  # their K slab
LD = TILE + 4              # words per row of a shared tile
STAGES = 3                 # the chunk scan's ring of slabs
#: the three kernels of a call, in launch order (also their device names,
#: with ``_kernel`` appended)
PARTS = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")
LAUNCHES_PER_CALL = len(PARTS)

#: kernel launches so far, all three kernels (the CUDA path only)
launch_count = 0
#: kernel launches so far, by kernel
part_launches: Dict[str, int] = dict.fromkeys(PARTS, 0)


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
    """Each kernel's shared memory at (N, cs) (mirrors ``state_smem`` and
    ``scan_smem`` in ``csrc/ssd_scan.cu``): the chunk state's two stages
    of B and of x dt w, and the chunk's cum, dt and w (N and P are tiled
    in the grid); the chunk scan's 64 x N tile of C (or, streaming C,
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
        _stream(x))
    _raise_on(rc, "ssd_chunk_state")
    _launched("ssd_chunk_state")
    return states, cum


def state_pass(states: torch.Tensor, cum: torch.Tensor, cs: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 2, in place: ``states`` (contiguous float32) becomes h_in, the
    state each chunk starts from; returns it and the final state ``[Bz,
    H, N, P]``. One launch of ``ssd_state_pass_kernel`` on the card."""
    if not _card(states, cum):
        return state_pass_plain(states, cum, cs)
    if states.dtype != torch.float32 or not states.is_contiguous():
        raise ValueError("state_pass updates a contiguous float32 tensor")
    Bz, H, nc, N, P = states.shape
    cum = cum.float().contiguous()
    state = torch.empty((Bz, H, N, P), dtype=torch.float32,
                        device=states.device)
    rc = _library().ssd_state_pass_launch(
        states.data_ptr(), cum.data_ptr(), state.data_ptr(), Bz, nc * cs, H,
        P, N, cs, _stream(states))
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
    rc = _library().ssd_chunk_scan_launch(
        DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), B.data_ptr(),
        C.data_ptr(), cum.data_ptr(), h_in.data_ptr(), y.data_ptr(), Bz, S,
        H, P, N, cs, _stream(x))
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


def _library() -> ctypes.CDLL:
    lib = load_library("ssd_scan")
    i64, vp, ci = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
    sizes = [i64] * 6 + [vp]                  # Bz, S, H, P, N, cs, stream
    for name, args in (("ssd_chunk_state_launch", [ci] + [vp] * 6),
                       ("ssd_state_pass_launch", [vp] * 3),
                       ("ssd_chunk_scan_launch", [ci] + [vp] * 7)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = args + sizes
            fn.restype = ci
    return lib


# ---------------------------------------------------------------------------
# the plain versions: the reference kernel's chunk body, batched over (Bz,
# H, chunk), in the reference's order
# ---------------------------------------------------------------------------

def _by_chunk(t: torch.Tensor, cs: int) -> torch.Tensor:
    """[Bz, S, H, W] -> float32 [Bz, H, S/cs, cs, W]."""
    Bz, S, H, W = t.shape
    return t.float().permute(0, 2, 1, 3).reshape(Bz, H, S // cs, cs, W)


def _xdt(x: torch.Tensor, dt: torch.Tensor, cs: int) -> torch.Tensor:
    return _by_chunk(x.float() * dt.float()[..., None], cs)


def chunk_state_plain(x: torch.Tensor, da: torch.Tensor, dt: torch.Tensor,
                      B: torch.Tensor, cs: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`chunk_state`, on any device."""
    Bz, S, H, _ = x.shape
    cum = torch.cumsum(da.float().transpose(1, 2).reshape(Bz, H, S // cs, cs),
                       dim=-1)
    dout = torch.exp(cum[..., -1:] - cum)                # [Bz, H, nc, cs]
    states = torch.matmul((_by_chunk(B, cs) * dout[..., None]).transpose(
        -1, -2), _xdt(x, dt, cs))
    return states, cum.reshape(Bz, H, S)


def state_pass_plain(states: torch.Tensor, cum: torch.Tensor, cs: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`state_pass`, on any device (also in
    place)."""
    Bz, H, nc, N, P = states.shape
    last = cum.float().reshape(Bz, H, nc, cs)[..., -1]
    h = torch.zeros((Bz, H, N, P), dtype=torch.float32, device=states.device)
    for c in range(nc):
        s_c = states[:, :, c].clone()
        states[:, :, c] = h
        h = torch.exp(last[:, :, c])[..., None, None] * h + s_c
    return states, h


def chunk_scan_plain(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                     C: torch.Tensor, cum: torch.Tensor, h_in: torch.Tensor,
                     cs: int) -> torch.Tensor:
    """The plain version of :func:`chunk_scan`, on any device. The decay
    is masked before its exp, as the kernel's."""
    Bz, S, H, P = x.shape
    tril = torch.tril(torch.ones((cs, cs), dtype=torch.bool, device=x.device))
    cum = cum.float().reshape(Bz, H, S // cs, cs)
    diff = cum[..., :, None] - cum[..., None, :]
    seg = torch.where(tril, torch.exp(torch.where(tril, diff, 0.0)), 0.0)
    Cc = _by_chunk(C, cs)
    y = torch.matmul(torch.matmul(Cc, _by_chunk(B, cs).transpose(-1, -2))
                     * seg, _xdt(x, dt, cs))
    y = y + torch.exp(cum)[..., None] * torch.matmul(Cc, h_in.float())
    return y.reshape(Bz, H, S, P).permute(0, 2, 1, 3).to(x.dtype)


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
