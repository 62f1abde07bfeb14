"""Mixture-of-Experts with gather/scatter (FLOP-free) capacity dispatch,
the port of the reference's ``repro/models/moe.py``.

Dispatch moves tokens with integer scatter/gather instead of a one-hot
einsum, so FLOPs stay proportional to tokens x top_k x 3 x D x F
(capacity overhead = capacity_factor). Token groups are per sequence
([B, S, D]), so routing cumsums never cross sequences.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.compat import DTensor, Replicate
from repro_torch.models.sharding import gather_dims, take_along


def capacity(seq_len: int, num_experts: int, top_k: int, factor: float) -> int:
    c = int(np.ceil(seq_len * top_k * factor / num_experts))
    # padded to 8, as the reference's: the pad decides which tokens drop
    return max(8, int(np.ceil(c / 8)) * 8)


def route(x: torch.Tensor, w_router: torch.Tensor, num_experts: int,
          top_k: int):
    """x: [B, S, D] -> (weights [B,S,k] f32, idx [B,S,k] int64, aux_loss)."""
    logits = torch.einsum("bsd,de->bse", x.float(), w_router.float())
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, top_k, dim=-1, sorted=True)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balancing aux loss
    me = probs.mean(dim=(0, 1))                        # [E]
    flat = idx.reshape(-1)
    if isinstance(idx, DTensor):
        # (DTensor has no sharding strategy for index_add_ in every
        # torch release: the fraction routed per e by a comparison)
        hits = idx[..., None] == torch.arange(num_experts,
                                              device=me.device)
        ce = hits.to(me.dtype).sum(dim=(0, 1, 2)) / flat.numel()
        # (whole on every rank, as index_add_'s is: a partial ce sends
        # partial gradients into the router's product, whose planning
        # then takes minutes on a 3-D mesh)
        ce = ce.redistribute(ce.device_mesh,
                             [Replicate()] * ce.device_mesh.ndim)
    else:
        ce = torch.zeros_like(me).index_add_(         # fraction routed per e
            0, flat, torch.full(flat.shape, 1.0 / flat.numel(),
                                dtype=me.dtype, device=me.device))
    aux = num_experts * torch.sum(me * ce)
    return weights, idx, aux


def dispatch_indices(idx: torch.Tensor, num_experts: int, cap: int):
    """Per-group slot assignment (see ``_dispatch_indices``). On a mesh
    DTensor has no sharding strategy for ``scatter_reduce_``: the groups
    are the sequences, so each rank assigns the slots of the sequences
    it holds, with their seq and choice dims made whole first, and the
    results keep ``idx``'s placements."""
    if not isinstance(idx, DTensor):
        return _dispatch_indices(idx, num_experts, cap)
    idx = gather_dims(idx, 1, 2)
    return tuple(DTensor.from_local(t, idx.device_mesh, idx.placements,
                                    run_check=False)
                 for t in _dispatch_indices(idx.to_local(), num_experts,
                                            cap))


def _dispatch_indices(idx: torch.Tensor, num_experts: int, cap: int):
    """Per-group slot assignment.

    idx: [B, S, k] expert choice per token. Returns
      slot_token [B, E, C] int32 — which flat token (s*k+j expanded) fills
        each (expert, slot); 0 where empty (masked separately),
      slot_valid [B, E, C] bool,
      token_slot [B, S, k] int32 — the slot each (token, choice) landed in
        (>= C means dropped).
    """
    B, S, k = idx.shape
    dev = idx.device
    flat = idx.reshape(B, S * k).long()                 # expert per entry
    onehot = F.one_hot(flat, num_experts)               # [B, S*k, E]
    pos = torch.cumsum(onehot, dim=1) - 1               # pos within expert
    token_slot = torch.gather(pos, -1, flat[..., None])[..., 0]
    keep = token_slot < cap
    # scatter-max: slot_token[b, e, c] = entry t where (flat[t]==e, pos==c)
    entry_ids = torch.arange(S * k, device=dev).expand(B, S * k)
    b_ix = torch.arange(B, device=dev)[:, None].expand(B, S * k)
    c_ix = torch.where(keep, token_slot, cap - 1)       # clamp; masked by valid
    lin = ((b_ix * num_experts + flat) * cap + c_ix).reshape(-1)
    slot_token = torch.zeros(B * num_experts * cap, dtype=torch.int64,
                             device=dev).scatter_reduce_(
        0, lin, torch.where(keep, entry_ids, 0).reshape(-1), "amax")
    slot_valid = torch.zeros(B * num_experts * cap, dtype=torch.int64,
                             device=dev).scatter_reduce_(
        0, lin, keep.long().reshape(-1), "amax")
    return (slot_token.reshape(B, num_experts, cap).int(),
            slot_valid.reshape(B, num_experts, cap).bool(),
            token_slot.reshape(B, S, k).int())


def moe_ffn(x: torch.Tensor, params: dict, *, num_experts: int, top_k: int,
            cap_factor: float, rules=None, whole_batch_group: bool = False):
    """x: [B, S, D]. params: router [D,E], gate/up [E,D,F], down [E,F,D].
    Returns (y [B,S,D], aux_loss).

    ``whole_batch_group`` (decode): with S=1 the per-sequence groups pay
    the per-expert capacity floor E times per token. Regrouping the whole
    batch into ONE routing group makes capacity ~= tokens*top_k*cf/E.
    Exact (same routing, same combine), a different dispatch layout."""
    if whole_batch_group and x.shape[1] == 1 and x.shape[0] > 1:
        y, aux = moe_ffn(x.reshape(1, -1, x.shape[-1]), params,
                         num_experts=num_experts, top_k=top_k,
                         cap_factor=cap_factor, rules=rules)
        return y.reshape(x.shape), aux
    B, S, D = x.shape
    E = num_experts
    dtype = x.dtype
    cap = capacity(S, E, top_k, cap_factor)
    weights, idx, aux = route(x, params["router"], E, top_k)
    slot_token, slot_valid, token_slot = dispatch_indices(idx, E, cap)

    # gather tokens into [B, E, C, D] (token index = entry // k)
    tok_of_entry = (slot_token // top_k).long().reshape(B, E * cap)
    xg = take_along(x, tok_of_entry[..., None].expand(B, E * cap, D), 1
                    ).reshape(B, E, cap, D)
    xg = torch.where(slot_valid[..., None], xg, 0).to(dtype)
    if rules is not None:
        xg = rules.constrain(xg, "batch", "experts", "capacity", None)

    g = torch.einsum("becd,edf->becf", xg, params["w_gate"].to(dtype))
    u = torch.einsum("becd,edf->becf", xg, params["w_up"].to(dtype))
    h = F.silu(g) * u
    if rules is not None:
        h = rules.constrain(h, "batch", "experts", "capacity", "mlp")
    # (contiguous: on a mesh the redistributed h's local block may have
    # strides that einsum's internal view cannot take)
    y_slots = torch.einsum("becf,efd->becd", h.contiguous(),
                           params["w_down"].to(dtype))
    if rules is not None:
        y_slots = rules.constrain(y_slots, "batch", "experts", "capacity",
                                  None)

    # combine: y[b,s] = sum_j w[b,s,j] * y_slots[b, e_j, slot_j]
    flat_slot = (idx * cap + torch.clamp(token_slot.long(), max=cap - 1)
                 ).reshape(B, S * top_k)                # [B, S*k]
    ys = take_along(y_slots.reshape(B, E * cap, D),
                    flat_slot[..., None].expand(B, S * top_k, D), 1
                    ).reshape(B, S, top_k, D)
    dropped = (token_slot >= cap)[..., None]
    ys = torch.where(dropped, 0, ys)
    y = torch.einsum("bskd,bsk->bsd", ys.float(), weights).to(dtype)
    return y, aux
