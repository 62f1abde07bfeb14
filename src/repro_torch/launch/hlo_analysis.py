"""Per-device step accounting, the counterpart of the reference's
``repro/launch/hlo_analysis.py``.

The reference parses the optimized per-device SPMD HLO that XLA compiles
a step into. The port compiles nothing: a step runs eagerly, op by op,
so its counterpart watches one traced run of the step under a
``TorchDispatchMode`` and keeps the reference's result keys and
contracts:

  * dot_flops        — FLOPs of the products (``torch.utils.flop_counter``'s
                       formulas: mm, bmm, addmm, baddbmm, convolutions,
                       attention ops)
  * hbm_bytes        — Σ (input + output bytes) of every op that moves
                       data (views, detach, empty and the like are free,
                       as the reference's ``_FREE_OPS``); an eager step
                       fuses nothing, so this is an upper bound, like the
                       reference's ``t_memory_hlo_upper_s``
  * collective_bytes — per collective kind, operand bytes (wire-byte proxy)

All quantities are per device. On a mesh the step's ops see DTensors;
the mode lets DTensor run first (it returns ``NotImplemented`` for them)
and counts what DTensor runs on each rank: the local ops at the local
shapes and the collectives it inserts, at the local shape too — the
counterpart of reading the per-device SPMD program.

Loops need no trip-count handling here: eager execution runs every
iteration (a loop over layers, the online softmax's blocks, a remat's
recompute in the backward), and each one is counted as it runs.
"""
from __future__ import annotations

import traceback
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.compat import DTensor

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# collective op -> (kind, index of the argument holding the operand)
_COLLECTIVE_OPS = {
    "_c10d_functional::all_reduce": ("all-reduce", 0),
    "_c10d_functional::all_reduce_": ("all-reduce", 0),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional::reduce_scatter_tensor_coalesced":
        ("reduce-scatter", 0),
    "_c10d_functional::all_to_all_single": ("all-to-all", 0),
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0),
    "c10d::allgather_": ("all-gather", 1),
    "c10d::_allgather_base_": ("all-gather", 1),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d::reduce_scatter_": ("reduce-scatter", 1),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d::alltoall_base_": ("all-to-all", 1),
    "c10d::alltoall_": ("all-to-all", 1),
    "c10d::send": ("collective-permute", 0),
}

# ops that move no HBM data (besides every view op)
_FREE_OPS = {
    "aten::detach", "aten::alias", "aten::empty", "aten::empty_like",
    "aten::empty_strided", "aten::new_empty", "aten::new_empty_strided",
    "aten::lift_fresh", "aten::_local_scalar_dense", "aten::sym_size",
    "aten::sym_stride", "aten::sym_numel", "aten::resize_", "aten::set_",
    "_c10d_functional::wait_tensor",
    "_c10d_functional::_wrap_tensor_autograd",
    "c10d::recv_", "c10d::barrier",
}


def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(_tensor_bytes(o) for o in obj.values())
    return 0


def _site() -> str:
    """The innermost frame of the caller's code (not torch's): where a
    collective was asked for, the counterpart of HLO's op_name."""
    for f in reversed(traceback.extract_stack()[:-3]):
        if "/torch/" not in f.filename and __file__ != f.filename:
            return f"{f.filename.rsplit('/src/', 1)[-1]}:{f.lineno} " \
                   f"({f.name})"
    return "?"


@dataclass
class Totals:
    flops: float = 0.0
    # the products' FLOPs of the whole mesh (on one device, ``flops``)
    global_flops: float = 0.0
    on_mesh: bool = False
    hbm_bytes: float = 0.0
    coll: Dict[str, float] = field(default_factory=lambda: {
        k: 0.0 for k in COLLECTIVES})
    # attribution: (kind, bytes, op name and the site that asked for it)
    coll_items: List[tuple] = field(default_factory=list)

    @property
    def coll_total(self) -> float:
        return sum(self.coll.values())


class StepAccountant(TorchDispatchMode):
    """Counts per-device FLOPs, HBM bytes and collective bytes of every
    op dispatched while it is active (see the module docstring)."""

    def __init__(self, attribute: bool = False):
        super().__init__()
        self.totals = Totals()
        self.attribute = attribute

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run first: its local ops and collectives come
            # back here at the per-device shapes; the product's FLOPs at
            # the global shapes are the whole mesh's (FlopCounterMode's)
            packet = func._overloadpacket
            if packet in flop_registry:
                self.totals.global_flops += float(
                    flop_registry[packet](*args, **kwargs, out_val=None))
            self.totals.on_mesh = True
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation runs an op on fake tensors
            # of the global shapes to learn its output's: not a step op
            return out
        name = func._schema.name
        t = self.totals
        coll = _COLLECTIVE_OPS.get(name)
        if coll is not None:
            kind, i = coll
            b = float(_tensor_bytes(args[i] if i < len(args) else ()))
            t.coll[kind] += b
            if self.attribute:
                t.coll_items.append((kind, b, f"{name} {_site()}"))
            t.hbm_bytes += b + _tensor_bytes(out)
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            t.flops += f
            if not t.on_mesh:
                t.global_flops += f
        if func.is_view or name in _FREE_OPS:
            return out
        t.hbm_bytes += _tensor_bytes(args) + _tensor_bytes(kwargs) + \
            _tensor_bytes(out)
        return out


def analyze_step(fn, *args, top_collectives: int = 0, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under the accountant; return the
    reference's ``analyze_hlo`` dict: ``dot_flops``, ``hbm_bytes``,
    ``collective_bytes`` (the five kinds and ``total``) and, if asked,
    the largest ``top_collectives``; also ``global_dot_flops`` (the whole
    mesh's, ``xla_cost_analysis``'s count) and ``fn``'s ``result``."""
    mode = StepAccountant(attribute=bool(top_collectives))
    with mode:
        result = fn(*args, **kwargs)
    t = mode.totals
    out = {
        "dot_flops": t.flops,
        "global_dot_flops": t.global_flops,
        "hbm_bytes": t.hbm_bytes,
        "collective_bytes": dict(t.coll, total=t.coll_total),
        "result": result,
    }
    if top_collectives:
        items = sorted(t.coll_items, key=lambda x: -x[1])[:top_collectives]
        out["top_collectives"] = [
            {"kind": k, "bytes": b, "op": n[-160:]} for k, b, n in items]
    return out


def xla_cost_analysis(fn, *args, **kwargs) -> dict:
    """The counterpart of XLA's ``cost_analysis()``: ``{"flops": ...}``,
    ``FlopCounterMode``'s total over one run of ``fn`` (global FLOPs of
    the whole mesh on DTensors, where ``analyze_step`` counts one
    device's)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}
