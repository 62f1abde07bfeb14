"""Logical-axis sharding: the paper's TLP/DLP split mapped onto mesh axes,
the port of the reference's ``repro/models/sharding.py``.

Every parameter / activation dimension carries a *logical* axis name; a
``Rules`` table maps logical names to mesh axes. TLP (the paper's harts)
lands on ``pod``/``data``; DLP (the paper's vector lanes D) lands on
``model``. A divisibility guard silently downgrades to replication when a
dimension does not divide the mesh axis (e.g. hymba's 25 heads on a
16-way model axis) and records the downgrade.

A mesh is a ``DeviceMesh`` (``launch/mesh.py``) or an ``AbstractMesh``
(names and sizes only: ``spec`` and the dry run's estimates). ``spec``
gives the reference's PartitionSpec as a tuple; ``sharding`` gives the
DTensor placements of it (one ``Shard(dim)`` / ``Replicate()`` per mesh
dimension); ``constrain`` redistributes a DTensor to them, the
counterpart of ``with_sharding_constraint``. Without a mesh ``sharding``
is ``None`` and ``constrain`` the identity.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.compat import DTensor, Replicate, Shard
from repro_torch.configs.base import ModelConfig, Parallelism
from repro_torch.launch.mesh import axis_names, axis_sizes


@dataclass
class Rules:
    """logical axis -> mesh axis (str), tuple of mesh axes, or None."""

    mesh: Optional[object]
    mapping: dict
    downgrades: list = field(default_factory=list)

    def axis_size(self, mesh_axes) -> int:
        if self.mesh is None or mesh_axes is None:
            return 1
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        sizes = axis_sizes(self.mesh)
        n = 1
        for a in mesh_axes:
            n *= sizes[a]
        return n

    def spec(self, logical_axes, shape=None) -> tuple:
        """The mesh axes of each dim of a tensor with the given logical
        axes (the reference's PartitionSpec, as a tuple); if ``shape`` is
        given, apply the divisibility guard per dimension."""
        out = []
        for i, name in enumerate(logical_axes):
            mesh_axes = self.mapping.get(name)
            if mesh_axes is None:
                out.append(None)
                continue
            size = self.axis_size(mesh_axes)
            if shape is not None and shape[i] % size != 0:
                self.downgrades.append((name, shape[i], mesh_axes))
                out.append(None)
            else:
                out.append(mesh_axes)
        return tuple(out)

    def sharding(self, logical_axes, shape=None) -> Optional[tuple]:
        """The DTensor placements of ``spec``: ``None`` without a mesh."""
        if self.mesh is None:
            return None
        return placements(self.mesh, self.spec(logical_axes, shape))

    def constrain(self, x, *logical_axes):
        """``x`` redistributed to the placements of its logical axes (the
        identity without a mesh). On a mesh ``x`` must be a DTensor."""
        if self.mesh is None:
            return x
        if not isinstance(x, DTensor):
            raise TypeError(
                f"Rules.constrain on a mesh takes a DTensor, got "
                f"{type(x).__name__} of shape {tuple(x.shape)}")
        want = self.sharding(logical_axes, x.shape)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)


def placements(mesh, spec) -> tuple:
    """One placement per mesh dim for a PartitionSpec-like ``spec``:
    ``Shard(i)`` on each mesh axis that splits tensor dim ``i`` (a tuple
    of mesh axes splits one dim over several, in mesh order, as jax
    does), ``Replicate()`` elsewhere. A mesh axis of size 1 splits
    nothing and stays ``Replicate()`` (the same blocks; DTensor refuses
    to view away a size-1 dim that is "split", as a KV head of one on a
    1x1 mesh)."""
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"mesh axes {axes} split dim {dim} out of "
                             f"the mesh's order {names}")
        for m in order:
            if out[m] != Replicate():
                raise ValueError(f"mesh axis {names[m]!r} splits two dims "
                                 f"of {tuple(spec)}")
            if sizes[names[m]] > 1:
                out[m] = Shard(dim)
    return tuple(out)


def gather_dims(x, *dims):
    """``x`` with the tensor dims ``dims`` whole on every rank: each mesh
    dim that shards one of them becomes ``Replicate()`` (an all-gather,
    what XLA's partitioner inserts before an op it cannot split). The
    identity for a plain tensor. Used before the ops whose DTensor
    sharding strategy is missing or wrong for a sharded dim; each call
    site says which."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.dim() for d in dims}
    want = tuple(Replicate() if p.is_shard() and p.dim in dims else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def whole_unless_divides(x, dim: int, n: int):
    """``x`` with ``dim`` whole on every rank unless the mesh dims that
    shard it divide ``n``: before a view that splits ``dim`` into
    ``(n, dim // n)``, which DTensor cannot make of a shard that cuts
    across the ``n`` groups (GQA's ``[.., KV, G, hd]`` with KV heads
    fewer than the model axis)."""
    if not isinstance(x, DTensor):
        return x
    d = dim % x.dim()
    ways = 1
    for m, p in enumerate(x.placements):
        if p.is_shard() and p.dim == d:
            ways *= x.device_mesh.size(m)
    return x if n % ways == 0 else gather_dims(x, d)


class _GradWhole(torch.autograd.Function):
    """The identity, whose gradient goes through ``whole_unless_divides``."""

    @staticmethod
    def forward(ctx, x, dim, n):
        ctx.dim, ctx.n = dim, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return whole_unless_divides(g, ctx.dim, ctx.n), None, None


def grad_whole_unless_divides(x, dim: int, n: int):
    """``x``, with its gradient made whole along ``dim`` unless the mesh
    dims that shard it divide ``n``: after a view that merges
    ``(n, dim // n)`` into ``dim``, whose backward splits the gradient
    back (``whole_unless_divides`` for the backward). The identity for a
    plain tensor."""
    if not isinstance(x, DTensor):
        return x
    return _GradWhole.apply(x, dim, n)


def take_along(x, index, dim: int):
    """``torch.gather(x, dim, index)``. On a mesh DTensor's gather
    strategy may shard ``dim`` of ``x`` and then fails to mask the
    result (its mask assumes a 2-D embedding table), so each rank
    gathers its own rows: ``index`` whole along ``dim``, ``x`` placed as
    ``index`` is, and the local gather keeps those placements."""
    if not isinstance(x, DTensor):
        return torch.gather(x, dim, index)
    index = gather_dims(index, dim)
    x = x.redistribute(x.device_mesh, index.placements)
    return DTensor.from_local(
        torch.gather(x.to_local(), dim, index.to_local()), x.device_mesh,
        index.placements, run_check=False)


def make_rules(mesh, cfg: ModelConfig, par: Parallelism) -> Rules:
    """Build the logical->mesh table for one (arch, mesh) pair."""
    names = axis_names(mesh) if mesh is not None else ()
    has_pod = "pod" in names
    ep = has_pod and par.expert_parallel
    # EP consumes the pod axis for the expert dim; batch then stays on data
    batch_axes = ("pod", "data") if has_pod and not ep else "data"
    msize = axis_sizes(mesh).get("model", 1) if mesh is not None else 1

    if par.pure_dp:
        # the TLP/DLP rebalance (the paper's Fig-2 lesson at rack scale):
        # for models whose per-shard matmuls are too small to pay for TP
        # all-reduces, fold the model axis into data parallelism and
        # shard the optimizer state ZeRO-style over both axes
        dp_axes = ("pod", "data", "model") if has_pod else ("data", "model")
        return Rules(mesh=mesh, mapping={
            "batch": dp_axes, "seq": None, "seq_sp": None, "embed_act": None,
            "heads": None, "kv_heads": None, "head_dim": None, "window": None,
            "cache_seq": None, "embed": ("data", "model"), "mlp": None,
            "vocab": None, "layers": None, "experts": None, "capacity": None,
            "ssm_heads": None, "ssm_state": None, "ssm_dim": None,
            "conv": None, None: None,
        })

    # KV cache: shard heads over "model" when divisible; otherwise shard
    # the cache sequence dim (flash-decoding style: the softmax sum is
    # then a reduction over "model"). Avoids replicated multi-GiB caches
    # for kv=8 archs.
    kv_shardable = cfg.num_kv_heads and msize and \
        cfg.num_kv_heads % max(msize, 1) == 0

    mapping = {
        # activations
        "batch": batch_axes,
        "seq": None,
        "seq_sp": "model" if par.sequence_parallel else None,
        "embed_act": None,
        # attention
        "heads": "model",
        "kv_heads": "model" if kv_shardable else None,
        "head_dim": None,
        "window": None,
        "cache_seq": None if kv_shardable else "model",
        # params
        "embed": "data" if par.fsdp else None,
        "mlp": None if par.moe_capacity_sharding else "model",
        "vocab": "model",
        "layers": None,
        # moe
        "experts": ("pod" if ep else None),
        "capacity": "model" if par.moe_capacity_sharding else None,
        # ssm
        "ssm_heads": "model",
        "ssm_state": None,
        "ssm_dim": "model",
        "conv": None,
        # scalars / misc
        None: None,
    }
    return Rules(mesh=mesh, mapping=mapping)


def named_sharding(rules: Rules, logical_axes, shape=None):
    return rules.sharding(logical_axes, shape)
