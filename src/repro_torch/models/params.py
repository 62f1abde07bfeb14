"""Parameter templates, the port of the reference's
``repro/models/params.py``: one declarative tree per model family.

A template is a nested dict whose leaves are ``P`` specs (shape, logical
axes, init law). From one template we derive:

  * ``abstract(template, rules)`` -> a tree of ``device="meta"`` tensors
    (no allocation), meta DTensors placed by the rules on a mesh
  * ``initialize(template, seed)`` -> the materialized param tree
  * ``shardings(template, rules)`` -> a tree of DTensor placements via the
    logical-axis Rules; ``specs`` -> their PartitionSpecs (tuples)
  * ``place(tree, shardings, mesh)`` -> the tree's tensors as DTensors;
    ``placements_of(tree)`` -> the placements of a tree of DTensors
  * ``from_reference(tree)`` -> the port's tree of a reference tree of
    numpy / JAX arrays, key path for key path

The reference folds each leaf's key from ``hash(name)``, which Python
salts per process; the port seeds each leaf from a stable hash of its
path (``zlib.crc32``) and the caller's seed, so one seed gives the same
weights in every process (ROADMAP.md queue 3 records the difference).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.compat import DeviceMesh, DTensor, distribute_tensor
from repro_torch.kernels.common import resolve_device
from repro_torch.kvi.interop import array_from_reference
from repro_torch.models.sharding import Rules


@dataclass(frozen=True)
class P:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones | embed | fanin | neg1
    dtype: str = "float32"
    fan_in: Optional[int] = None   # explicit fan-in for "fanin" init (4D
    #                                weights: shape[-2] is NOT the fan-in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a template's dtype name (``"bfloat16"``, ...)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def tree_map(fn, tree, is_leaf=lambda x: isinstance(x, P)):
    """``fn`` over the leaves of a nested dict (``P`` specs by default,
    or whatever ``is_leaf`` names); the dict structure is kept."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, path: str = ""):
    """``(path, leaf)`` pairs of a nested dict in insertion order, the
    path ``"a/b/c"`` as the reference spells a leaf's name."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{path}/{k}" if path else str(k))
    else:
        yield path, tree


def abstract(template, rules: Optional[Rules] = None):
    """A tree of ``device="meta"`` tensors: shapes and dtypes, no data;
    meta DTensors placed by ``rules.sharding`` when the rules have a
    ``DeviceMesh`` (an ``AbstractMesh`` has no group to place them on)."""
    def leaf(p: P):
        dtype = torch_dtype(p.dtype)
        if rules is None or not isinstance(rules.mesh, DeviceMesh):
            return torch.empty(p.shape, dtype=dtype, device="meta")
        return meta_dtensor(p.shape, dtype, rules.mesh,
                            rules.sharding(p.axes, p.shape))
    return tree_map(leaf, template)


def meta_dtensor(shape, dtype, mesh, placements) -> DTensor:
    """A DTensor of global ``shape`` on the meta device: each rank's
    local block (each sharded dim divided by its mesh dims' sizes)
    allocates nothing."""
    local = list(shape)
    for m, pl in enumerate(placements):
        if pl.is_shard():
            local[pl.dim] //= mesh.mesh.shape[m]
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"),
                              mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def shardings(template, rules: Rules):
    return tree_map(lambda p: rules.sharding(p.axes, p.shape), template)


def specs(template, rules: Rules):
    return tree_map(lambda p: rules.spec(p.axes, p.shape), template)


def placements_of(tree):
    """The placements of each DTensor of ``tree`` (``None`` for a plain
    tensor): the ``shardings`` of a live tree, e.g. an optimizer state."""
    return tree_map(lambda x: tuple(x.placements)
                    if isinstance(x, DTensor) else None, tree,
                    is_leaf=lambda x: not isinstance(x, dict))


def place(tree, shardings_tree, mesh):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` with the
    placements at the same path of ``shardings_tree`` (``shardings``,
    ``placements_of``; ``None`` leaves the tensor as it is). Every rank
    holds the same full tensors (seeded init, a restore), so each keeps
    its own blocks and nothing moves."""
    if isinstance(tree, dict):
        return {k: place(v, shardings_tree[k], mesh) for k, v in tree.items()}
    if shardings_tree is None:
        return tree
    return distribute_tensor(tree, mesh, shardings_tree, src_data_rank=None)


def leaf_seed(seed: int, name: str) -> int:
    """The seed of one leaf: a stable 32-bit hash of the caller's seed
    and the leaf's path (never ``hash``, which Python salts per process;
    32 bits, all that the CPU generator reads of a seed)."""
    return zlib.crc32(f"{int(seed)}/{name}".encode())


def _init_leaf(p: P, gen: Optional[torch.Generator], device) -> torch.Tensor:
    dtype = torch_dtype(p.dtype)
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "neg1":
        return torch.full(p.shape, -1, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init in ("embed", "normal", "fanin"):
        x = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                        device=device).to(dtype)
        if p.init == "fanin":
            fan_in = p.fan_in or (p.shape[-2] if len(p.shape) >= 2
                                  else p.shape[-1])
            return x / np.sqrt(fan_in)
        return x * 0.02
    if p.init == "ssm_a":
        # mamba2: A_log init so that -exp(A_log) in [-1, -H]
        row = torch.log(torch.arange(1, p.shape[-1] + 1, dtype=dtype,
                                     device=device))
        return row.expand(p.shape).contiguous()
    if p.init == "ssm_dt":
        # dt bias: softplus^-1 of dt in [1e-3, 1e-1], log-uniform
        u = torch.linspace(np.log(1e-3), np.log(1e-1),
                           steps=int(np.prod(p.shape)), dtype=torch.float32,
                           device=device)
        dt = torch.exp(u).reshape(p.shape).to(dtype)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init {p.init!r}")


def initialize(template, generator_or_seed: Union[int, torch.Generator] = 0,
               device=None):
    """Materialize params on ``device`` (the card unless ``"cpu"``).

    Each random leaf draws from its own generator on ``device``, seeded
    by :func:`leaf_seed` from the seed and the leaf's path: a leaf's
    values do not depend on the other leaves, and the same seed gives
    the same weights in every process on one device. A
    ``torch.Generator`` stands for the seed it yields first."""
    dev = resolve_device(device)
    if isinstance(generator_or_seed, torch.Generator):
        g = generator_or_seed
        seed = int(torch.randint(0, 2**31 - 1, (), device=g.device,
                                 generator=g))
    else:
        seed = int(generator_or_seed)
    gen = torch.Generator(device=dev)

    def leaf(name, p):
        if p.init in ("embed", "normal", "fanin"):
            gen.manual_seed(leaf_seed(seed, name))
        return _init_leaf(p, gen, dev)

    return _unflatten(template, {name: leaf(name, p)
                                 for name, p in tree_leaves(template)})


def _unflatten(tree, values: dict, path: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return values[path]


def from_reference(tree, device=None, dtype: Optional[torch.dtype] = None):
    """The port's tree of a reference parameter (or cache) tree of numpy
    or JAX arrays, with the same key paths, on ``device`` (the card
    unless ``"cpu"``). bfloat16 crosses bit for bit; ``dtype``, if
    given, casts the floating leaves."""
    dev = resolve_device(device)

    def leaf(x):
        t = array_from_reference(x)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return tree_map(leaf, tree, is_leaf=lambda x: not isinstance(x, dict))


def count_params(template) -> int:
    return int(sum(np.prod(p.shape) for _, p in tree_leaves(template)))


def bytes_params(template) -> int:
    return int(sum(np.prod(p.shape) * torch_dtype(p.dtype).itemsize
                   for _, p in tree_leaves(template)))
