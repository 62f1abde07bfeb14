"""GPipe-style pipeline parallelism over a mesh axis (the ``pod`` axis),
the port of the reference's ``repro/models/pipeline.py``.

The multi-pod default in this framework is DP-over-pod; this module
provides the PP alternative for models whose weights outgrow one pod:
layers are split into S contiguous stages (stage s owned by pipeline rank
s), a batch is split into M microbatches, and the classic GPipe schedule
runs M + S - 1 ticks: each tick every rank applies its stage to the
microbatch it holds, then activations rotate one rank forward. Bubble
fraction = (S-1)/(M+S-1).

Implementation: each rank of the mesh runs ``pipeline_apply`` (SPMD, as
the reference's ``shard_map`` body); the reference's ``ppermute`` is a
ring ``batch_isend_irecv`` over the process group of the mesh's ``axis``
(every other mesh axis keeps its own independent ring), and its masked
``psum`` an ``all_reduce`` on that group.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.compat import DTensor
from repro_torch.models.params import tree_leaves, tree_map


def _stage_slice(a, rank: int):
    """This rank's stage of a leaf stacked on a leading stage axis: a
    DTensor split over the stage axis holds just its slice."""
    if isinstance(a, DTensor):
        return a.to_local()[0]
    return a[rank]


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh, axis: str = "pod", num_microbatches: int = None):
    """Run x through all pipeline stages.

    stage_fn(params_slice, microbatch) -> microbatch   (one stage's layers)
    stage_params: tree with leading dim = n_stages (each rank uses its
      own slice)
    x: [B, ...] the batch, the same on every rank of the pipeline axis
       (it flows through every stage; DP/TP sharding lives on the OTHER
       mesh axes)

    Returns the final activations on every rank of the pipeline axis.
    """
    group = mesh.get_group(axis)
    S = dist.get_world_size(group)
    rank = dist.get_rank(group)
    M = num_microbatches or S
    B = x.shape[0]
    assert B % M == 0, (B, M)

    p = tree_map(lambda a: _stage_slice(a, rank), stage_params,
                 is_leaf=lambda a: not isinstance(a, dict))
    mb = x.reshape((M, B // M) + tuple(x.shape[1:]))
    nxt = dist.get_global_rank(group, (rank + 1) % S)
    prv = dist.get_global_rank(group, (rank - 1) % S)

    # GPipe schedule: microbatch m enters rank 0 at tick m and leaves
    # rank S-1 at tick m + S - 1; after each tick every rank passes what
    # it computed to the next rank
    buf = torch.zeros_like(mb[0])
    out = torch.zeros_like(mb)
    for t in range(M + S - 1):
        # rank 0 injects microbatch t (the last again once none are left)
        if rank == 0:
            buf = mb[min(t, M - 1)].to(buf.dtype)
        # every rank applies its stage to what it holds
        y = stage_fn(p, buf)
        # the last rank retires microbatch t - (S - 1)
        retire = t - (S - 1)
        if 0 <= retire < M:
            out[retire] = y.to(out.dtype)
        # rotate activations forward one rank
        if S == 1:
            buf = y
            continue
        y = y.contiguous()
        recv = torch.empty_like(y)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, y, nxt, group),
            dist.P2POp(dist.irecv, recv, prv, group)])
        for r in reqs:
            r.wait()
        buf = recv
    # ``out`` is only valid on the LAST rank; broadcast it back so every
    # rank returns the batch (sum of masked contributions)
    mine = out if rank == S - 1 else torch.zeros_like(out)
    dist.all_reduce(mine, op=dist.ReduceOp.SUM, group=group)
    return mine.reshape(x.shape)


def unpipelined_reference(stage_fn: Callable, stage_params, x):
    """Sequentially apply all stages (oracle for tests)."""
    S = next(iter(tree_leaves(stage_params)))[1].shape[0]
    for s in range(S):
        p = tree_map(lambda a, s=s: a[s], stage_params,
                     is_leaf=lambda a: not isinstance(a, dict))
        x = stage_fn(p, x)
    return x
