"""Mamba-2 SSD (state-space duality) layer, the port of the reference's
``repro/models/ssm.py``: chunked quadratic-within-chunk /
recurrent-across-chunk training path, O(1)-state decode path.

The chunked algorithm is the oracle for kernels/ssd_scan.py (same math).
On CUDA tensors ``ssd_chunked`` runs the card's kernels instead
(``kernels.ssd_scan.ssd_train``: the scan and its gradient under one
``autograd.Function``), so the zoo's training and prefill SSD take them;
on CPU tensors it is the plain layer below, as the reference's zoo calls
it. The path follows the tensors' device (:func:`ssd_path`).
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
