"""Mamba-2 SSD (state-space duality) layer, the port of the reference's
``repro/models/ssm.py``: chunked quadratic-within-chunk /
recurrent-across-chunk training path, O(1)-state decode path.

The chunked algorithm is the oracle for kernels/ssd_scan.py (same math).
On CUDA tensors ``ssd_chunked`` runs the card's kernels instead
(``kernels.ssd_scan.ssd_train``: the scan and its gradient under one
``autograd.Function``), so the zoo's training and prefill SSD take them;
on CPU tensors it is the plain layer below, as the reference's zoo calls
it. The path follows the tensors' device (:func:`ssd_path`).
Hymba's Mamba-1 scan (:func:`selective_scan`, at the end) likewise runs
``kernels.selective_scan``'s kernels on CUDA tensors and its plain
chunked scan on CPU tensors (:func:`selective_scan_path`).
Shapes: x [B,S,H,P] heads x headdim, B/C [B,S,G,N] (G groups, GQA-style),
dt [B,S,H] (post-softplus), A [H] negative. The state here is
[B,H,P,N], as the reference's; the kernel's is [B,H,N,P].
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.compat import (DTensor, Partial, Replicate, Shard,
                                local_map)
from repro_torch.kernels import selective_scan as sscan
from repro_torch.kernels import ssd_scan
from repro_torch.models.sharding import gather_dims


def ssd_path(x: torch.Tensor) -> str:
    """``"kernel"`` where :func:`ssd_chunked` runs the card's kernels (CUDA
    tensors), else ``"plain"``."""
    return "kernel" if x.device.type == "cuda" else "plain"


def _segsum_decay(a: torch.Tensor) -> torch.Tensor:
    """a: [..., cs] per-step log-decay (<=0).
    Returns [..., cs, cs] matrix exp(sum_{t=j+1..i} a_t) for i>=j else 0.
    The mask applies before the exp: for j > i the difference is
    positive and its exp may overflow to inf."""
    cs = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]       # [..., i, j]
    tril = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                 device=a.device))
    return torch.where(tril, torch.exp(torch.where(tril, diff, 0.0)), 0.0)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,H,P], final_state [B,H,P,N]). f32 internals.
    S is padded up to a chunk multiple internally (dt=0 padding is exact:
    zero contribution to outputs and decay-neutral for the state). CUDA
    tensors take ``ssd_scan.ssd_train`` (its kernels raise on a shape
    they refuse); CPU tensors the plain body."""
    if isinstance(x, DTensor):
        return _ssd_on_mesh(x, dt, A, B, C, chunk, initial_state)
    S = x.shape[1]
    if S % chunk:
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        y, state = ssd_chunked(x, dt, A, B, C, chunk=chunk,
                               initial_state=initial_state)
        return y[:, :S], state
    if ssd_path(x) == "kernel":
        return ssd_scan.ssd_train(x, dt, A, B, C, chunk=chunk,
                                  initial_state=initial_state)
    return ssd_chunked_plain(x, dt, A, B, C, chunk=chunk,
                             initial_state=initial_state)


def ssd_chunked_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                      initial_state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain layer: :func:`ssd_chunked` on CPU tensors, S a multiple
    of the chunk, on any device (the card's timings run it there)."""
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc, cs = S // chunk, chunk
    rep = H // G

    x_ = x.float().reshape(Bz, nc, cs, H, P)
    dt_ = dt.float().reshape(Bz, nc, cs, H)
    B_ = B.float().reshape(Bz, nc, cs, G, N)
    C_ = C.float().reshape(Bz, nc, cs, G, N)
    a = dt_ * A.float()                                # [b,c,s,h] <= 0
    a_h = a.permute(0, 1, 3, 2)                        # [b,c,h,s]
    cum = torch.cumsum(a_h, dim=-1)                    # [b,c,h,s]
    xdt = x_ * dt_[..., None]                          # [b,c,s,h,p]

    # ---- intra-chunk (quadratic within cs) ----
    seg = _segsum_decay(a_h)                           # [b,c,h,i,j]
    cb = torch.einsum("bcign,bcjgn->bcgij", C_, B_)    # [b,c,g,i,j]
    cb = cb.repeat_interleave(rep, dim=2)              # g -> h
    y_intra = torch.einsum("bchij,bcjhp->bcihp", cb * seg, xdt)

    # ---- chunk states ----
    decay_to_end = torch.exp(cum[..., -1:] - cum)      # [b,c,h,s]
    Bh = B_.repeat_interleave(rep, dim=3).permute(0, 1, 3, 2, 4)
    states = torch.einsum("bchj,bchjn,bcjhp->bchpn",
                          decay_to_end, Bh, xdt)       # [b,c,h,p,n]

    # ---- inter-chunk recurrence ----
    chunk_decay = torch.exp(cum[..., -1])              # [b,c,h]
    h = (torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)              # [b,c,h,p,n]

    Ch = C_.repeat_interleave(rep, dim=3).permute(0, 1, 3, 2, 4)
    y_inter = torch.einsum("bchin,bchpn->bcihp",
                           Ch * torch.exp(cum)[..., None], h_prevs)

    y = (y_intra + y_inter).reshape(Bz, S, H, P)
    return y.to(x.dtype), h


def _ssd_on_mesh(x, dt, A, B, C, chunk, initial_state):
    """``ssd_chunked`` of DTensors, each rank scanning its own block: the
    scan mixes no two sequences and no two heads, so with the sequence
    and the head width whole (and the heads too when the groups are
    several), a rank's batch rows and heads, and its rows of the groups'
    B and C, give its block of y and of the final state. No collective,
    and none of DTensor's planning of the scan's 5-D products. In the
    backward each rank's gradients of A (over its batch rows) and of B, C
    (over its heads) are partial sums."""
    x = gather_dims(x, 1, 3) if B.shape[2] == 1 else gather_dims(x, 1, 2, 3)
    # per mesh dim: the dim of x it splits (0 batch, 2 heads) or None
    split = [p.dim if p.is_shard() else None for p in x.placements]

    def placed(batch_dim, head_dim, grad=False):
        out = []
        for d in split:
            if d == 0 and batch_dim is not None:
                out.append(Shard(batch_dim))
            elif d == 2 and head_dim is not None:
                out.append(Shard(head_dim))
            else:
                out.append(Partial() if grad and d is not None
                           else Replicate())
        return tuple(out)

    xs, heads, rows, state = (placed(0, 2), placed(None, 0), placed(0, None),
                              placed(0, 1))
    init = None if initial_state is None else state
    if initial_state is not None and not isinstance(initial_state, DTensor):
        # a plain state (a prefill's zeros): the same on every rank
        initial_state = DTensor.from_local(
            initial_state, x.device_mesh,
            [Replicate()] * x.device_mesh.ndim, run_check=False)
    scan = local_map(
        lambda x, dt, A, B, C, s: ssd_chunked(x, dt, A, B, C, chunk=chunk,
                                              initial_state=s),
        out_placements=(xs, state),
        in_placements=(xs, xs, heads, rows, rows, init),
        in_grad_placements=(xs, xs, placed(None, 0, grad=True),
                            placed(0, None, grad=True),
                            placed(0, None, grad=True), init),
        device_mesh=x.device_mesh, redistribute_inputs=True)
    return scan(x, dt, A, B, C, initial_state)


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, A: torch.Tensor, B_t: torch.Tensor,
                    C_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD update. state [B,H,P,N]; x_t [B,H,P]; dt_t [B,H];
    B_t/C_t [B,G,N]. Returns (y [B,H,P], new_state)."""
    H = state.shape[1]
    rep = H // B_t.shape[1]
    a = torch.exp(dt_t.float() * A.float())            # [B,H]
    Bh = B_t.float().repeat_interleave(rep, dim=1)     # [B,H,N]
    Ch = C_t.float().repeat_interleave(rep, dim=1)
    upd = (dt_t.float()[..., None] * x_t.float())[..., None] \
        * Bh[..., None, :]                             # [B,H,P,N]
    new_state = state.float() * a[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x_t.dtype), new_state.to(state.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor,
            initial_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential reference recurrence (oracle for tests; small shapes)."""
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    state = (torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(S):
        y, state = ssd_decode_step(state, x[:, t], dt[:, t], A, B[:, t],
                                   C[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), state


# ---------------------------------------------------------------------------
# depthwise causal conv (the mamba2 short conv)
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, C]; w: [K, C] depthwise taps. If ``state`` ([B, K-1, C]) is
    given, treat x as a continuation (decode/prefill chunk) and return the
    updated state. Returns (y [B,S,C], new_state)."""
    K = w.shape[0]
    Bz, S, Cc = x.shape
    if state is None:
        state = torch.zeros((Bz, K - 1, Cc), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)     # [B, S+K-1, C]
    y = sum(xp[:, k:k + S] * w[k].to(x.dtype) for k in range(K))
    new_state = xp[:, S:] if K > 1 else state
    return y, new_state


# ---------------------------------------------------------------------------
# Mamba-1 selective scan (hymba's SSM heads)
# ---------------------------------------------------------------------------

def _chunk_major(x: torch.Tensor, c: int) -> torch.Tensor:
    """x [B, T, ...] (T a multiple of c) as [c, T // c, B, ...]: the
    position within a chunk outermost, so that every position's slab
    over the chunks, rows and channels is one contiguous block."""
    Bz, T = x.shape[:2]
    return x.reshape(Bz, T // c, c, *x.shape[2:]).movedim(2, 0).movedim(
        2, 1).contiguous()


def _time_major(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_chunk_major`: [c, nc, B, ...] -> [B, T, ...]."""
    c, nc, Bz = x.shape[:3]
    return x.movedim(1, 2).movedim(0, 2).reshape(Bz, nc * c, *x.shape[3:])


def _linear_scan(L: torch.Tensor, b: torch.Tensor,
                 s0: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every state of s_t = exp(la_t) s_{t-1} + w_t from ``s0`` (zeros
    when None), chunk-major (:func:`_chunk_major`): L = la, b = w
    [c, nc, B, ...] with la <= 0, both consumed. Returns (s [c, nc, B,
    ...], the last state).

    Within each chunk the decays are accumulated as sums of la and the
    chunk's states from zero made by log2(c) doubling passes over all
    chunks at once (each position takes the window before it, decayed by
    the exponent of its own window's sum: exp of a sum <= 0, never an
    overflow); then the states entering the chunks are carried from one
    chunk's end to the next, and each position adds its entering state
    decayed by its sum from the chunk's start."""
    c, nc = L.shape[:2]
    spare = torch.empty_like(L) if c > 1 else None
    k = 1
    while k < c:
        t = torch.exp(L[k:])
        b[k:] += t.mul_(b[:-k])
        del t
        spare[:k] = L[:k]
        torch.add(L[k:], L[:-k], out=spare[k:])
        L, spare = spare, L
        k *= 2
    del spare
    e_end, b_end = torch.exp(L[-1]), b[-1]
    entering = torch.empty_like(b_end)
    if s0 is None:
        entering[0] = 0
    else:
        entering[0] = s0
    for z in range(nc - 1):
        torch.addcmul(b_end[z], e_end[z], entering[z], out=entering[z + 1])
    last = torch.addcmul(b_end[-1], e_end[-1], entering[-1])
    return b.add_(L.exp_().mul_(entering)), last


class _SelectiveScan(torch.autograd.Function):
    """The selective scan's states in the forward, recomputed from the
    inputs in the backward (nothing [B, S, d_inner, N] is saved); the
    backward runs the adjoint recurrence g_t = exp(la_{t+1}) g_{t+1} +
    gy_t C_t through the same chunked scan, reversed in time. Every
    [.., d_inner, N] tensor is made chunk-major from the small inputs."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, s0, chunk):
        cd = torch.promote_types(u.dtype, torch.float32)
        S = u.shape[1]
        c = max(1, min(chunk, S))
        pad = (-S) % c
        # dt = 0 past the end: no decay, no input
        u_, dt_, B_, C_ = (F.pad(t.to(cd), (0, 0, 0, pad))
                           for t in (u, dt, B, C))
        dtc, Bc = _chunk_major(dt_, c), _chunk_major(B_, c)
        s, last = _linear_scan(
            dtc[..., None] * A.to(cd),
            _chunk_major(dt_ * u_, c)[..., None] * Bc[..., None, :],
            None if s0 is None else s0.to(cd))
        y = torch.einsum("zkbdn,zkbn->zkbd", s, _chunk_major(C_, c))
        ctx.chunk, ctx.has_s0 = c, s0 is not None
        ctx.save_for_backward(u, dt, A, B, C,
                              s0 if s0 is not None else u.new_empty(0))
        return _time_major(y)[:, :S], last

    @staticmethod
    def backward(ctx, gy, glast):
        u_in, dt_in, A_in, B_in, C_in, s0 = ctx.saved_tensors
        cd = torch.promote_types(u_in.dtype, torch.float32)
        S, c = u_in.shape[1], ctx.chunk
        pad = (-S) % c
        A = A_in.to(cd)
        u, dt, B, C = (F.pad(t.to(cd), (0, 0, 0, pad))
                       for t in (u_in, dt_in, B_in, C_in))
        gy = (torch.zeros_like(u) if gy is None else
              F.pad(gy.to(cd), (0, 0, 0, pad)))
        s0 = s0.to(cd) if ctx.has_s0 else None
        dtc, uc, Bc = (_chunk_major(t, c) for t in (dt, u, B))
        s, _ = _linear_scan(dtc[..., None] * A,
                            (dtc * uc)[..., None] * Bc[..., None, :], s0)
        # the adjoint, reversed in time: decays la_{t+1} (none past the
        # end), inputs gy_t C_t, the final state's gradient entering
        dt_next = torch.cat([dt[:, 1:], torch.zeros_like(dt[:, :1])], 1)
        g, _ = _linear_scan(
            _chunk_major(dt_next.flip(1), c)[..., None] * A,
            _chunk_major(gy.flip(1), c)[..., None] *
            _chunk_major(C.flip(1), c)[..., None, :],
            None if glast is None else glast.to(cd))
        g = g.flip(0, 1)            # back to forward time
        gyc = _chunk_major(gy, c)
        gC = torch.einsum("zkbdn,zkbd->zkbn", s, gyc)
        gs0 = (torch.exp(dtc[0, 0][..., None] * A) * g[0, 0]
               if ctx.has_s0 else None)
        gla = s.sub_((dtc * uc)[..., None] * Bc[..., None, :]).mul_(g)
        gA = torch.einsum("zkbdn,zkbd->dn", gla, dtc)
        gdt = torch.einsum("zkbdn,dn->zkbd", gla, A)
        del gla, s
        gBx = torch.einsum("zkbdn,zkbn->zkbd", g, Bc)   # sum_n g B
        gB = torch.einsum("zkbdn,zkbd->zkbn", g, dtc * uc)
        del g
        grads = (gBx * dtc, gdt + gBx * uc, gB, gC)
        gu, gdt, gB, gC = (_time_major(t)[:, :S] for t in grads)
        return (gu.to(u_in.dtype), gdt.to(dt_in.dtype), gA.to(A_in.dtype),
                gB.to(B_in.dtype), gC.to(C_in.dtype),
                None if gs0 is None else gs0.to(s0.dtype), None)


def selective_scan_path(u: torch.Tensor) -> str:
    """``"kernel"`` where :func:`selective_scan` runs the card's kernels
    (CUDA tensors; not DTensors, which keep the plain Function), else
    ``"plain"``."""
    return ("kernel" if u.device.type == "cuda" and
            not isinstance(u, DTensor) else "plain")


def selective_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                   initial_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1's selective scan, the D skip left to the caller:
    s_t = exp(dt_t A) * s_{t-1} + (dt_t u_t) B_t^T, y_t = s_t C_t.

    u, dt [B,S,d] (dt post-softplus), A [d,N] negative, B, C [B,S,N],
    initial_state [B,d,N]. Returns (y [B,S,d], final state [B,d,N]) in
    float32 (float64 inputs stay float64). CUDA tensors take the card's
    kernels (``kernels.selective_scan``: one forward launch, two backward
    launches under one ``autograd.Function``; they raise on what they do
    not take); CPU tensors and DTensors the plain torch ops: the chunked
    scan of :func:`_linear_scan`, under an ``autograd.Function`` whose
    backward recomputes the states, ``chunk`` the chunk's length (a power
    of two takes the fewest doubling passes). The path follows the
    tensors (:func:`selective_scan_path`)."""
    if selective_scan_path(u) == "kernel":
        return sscan.selective_scan(u, dt, A, B, C,
                                    initial_state=initial_state)
    return _SelectiveScan.apply(u, dt, A, B, C, initial_state, chunk)


def selective_scan_step(state: torch.Tensor, u_t: torch.Tensor,
                        dt_t: torch.Tensor, A: torch.Tensor,
                        B_t: torch.Tensor, C_t: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of :func:`selective_scan`. state [B,d,N]; u_t, dt_t
    [B,d]; B_t, C_t [B,N]. Returns (y [B,d], new state), float32."""
    cd = torch.promote_types(u_t.dtype, torch.float32)
    dt_t = dt_t.to(cd)
    new = state.to(cd) * torch.exp(dt_t[..., None] * A.to(cd)) + \
        (dt_t * u_t.to(cd))[..., None] * B_t.to(cd)[:, None, :]
    return torch.einsum("bdn,bn->bd", new, C_t.to(cd)), new


def selective_scan_ref(u, dt, A, B, C, initial_state=None):
    """The recurrence one position at a time (oracle for tests; small
    shapes)."""
    Bz, S, d = u.shape
    cd = torch.promote_types(u.dtype, torch.float32)
    state = (torch.zeros((Bz, d, A.shape[-1]), dtype=cd, device=u.device)
             if initial_state is None else initial_state.to(cd))
    ys = []
    for t in range(S):
        y, state = selective_scan_step(state, u[:, t], dt[:, t], A, B[:, t],
                                       C[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), state
