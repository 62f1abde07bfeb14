"""Logical-axis sharding rules, the port's copy of the reference's
``repro/models/sharding.py`` for one device (``mesh=None``).

Every parameter / activation dimension carries a *logical* axis name; a
``Rules`` table maps logical names to mesh axes (TLP on ``pod``/``data``,
DLP on ``model``). Without a mesh no dimension is split: ``spec`` gives
the mesh axes a mesh would take, as a plain tuple, ``sharding`` gives
``None`` and ``constrain`` is the identity, as the reference's are
(``sharding.py:59-62``). A mesh is refused: the DeviceMesh / DTensor
counterpart is ROADMAP queue 1 item 7.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.configs.base import ModelConfig, Parallelism


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the port's sharding rules run on one device (mesh=None); a "
            "mesh waits for the DeviceMesh / DTensor port (ROADMAP.md "
            "queue 1 item 7)")


@dataclass
class Rules:
    """logical axis -> mesh axis (str), tuple of mesh axes, or None."""

    mesh: Optional[object]
    mapping: dict
    downgrades: list = field(default_factory=list)

    def __post_init__(self):
        _refuse_mesh(self.mesh)

    def spec(self, logical_axes, shape=None) -> tuple:
        """The mesh axes of a tensor with the given logical axes. The
        reference's divisibility guard never fires here: without a mesh
        every axis has size 1, and ``downgrades`` stays empty."""
        return tuple(self.mapping.get(name) for name in logical_axes)

    def sharding(self, logical_axes, shape=None):
        return None

    def constrain(self, x, *logical_axes):
        """A sharding constraint by logical axes: a no-op on one device."""
        return x


def make_rules(mesh, cfg: ModelConfig, par: Parallelism) -> Rules:
    """Build the logical->mesh table for one (arch, mesh) pair."""
    _refuse_mesh(mesh)
    if par.pure_dp:
        # the TLP/DLP rebalance: the model axis folded into data
        # parallelism, the optimizer state ZeRO-sharded over both axes
        return Rules(mesh=mesh, mapping={
            "batch": ("data", "model"), "seq": None, "seq_sp": None,
            "embed_act": None, "heads": None, "kv_heads": None,
            "head_dim": None, "window": None, "cache_seq": None,
            "embed": ("data", "model"), "mlp": None, "vocab": None,
            "layers": None, "experts": None, "capacity": None,
            "ssm_heads": None, "ssm_state": None, "ssm_dim": None,
            "conv": None, None: None,
        })

    # KV cache: heads over "model" when divisible (always, on an axis
    # of size 1), else the cache's sequence dim (flash-decoding style)
    kv_shardable = bool(cfg.num_kv_heads)

    mapping = {
        # activations
        "batch": "data",
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
        "experts": None,
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
