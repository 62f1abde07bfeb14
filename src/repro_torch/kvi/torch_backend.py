"""TorchBackend — runs KVI workloads through the port's hand-written CUDA
kernels (the port of ``repro/kvi/pallas_backend.py::PallasBackend``).

A structure's whole walk — every copy, planned
:class:`~repro_torch.kvi.passes.fusion.FusedRegion` and reduction — runs
as ONE launch of the walk kernel
(:func:`repro_torch.kernels.kvi_walk.run_walk`) over all N instances of a
batch: one block per instance, its register files (the Klessydra SPMs) in
shared memory. On ``device="cpu"`` the walk's plain version
(:func:`~repro_torch.kernels.kvi_walk.run_walk_plain`) interprets the
same packed table step by step with the fused-region and reduction
kernels' plain versions.

Per batch, on the device:

* the register files: one ``(N, width)`` file per element width, every
  vreg at a fixed column, so a window is ``(column, length)``; on the
  card they live in the walk kernel's per-instance arena;
* an input stack per host dtype: the ``mem_init`` buffers that some
  ``kmemld`` reads, concatenated on the host and copied to the device
  once per batch;
* a store stack per element width: each ``kmemstr`` gets its own columns
  and stays on the device; the outputs come back in one device-to-host
  copy per width at the end.

The walk over a structure — tensor layout, steps, window descriptors and
its packed table — is compiled once per structural signature and reused.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import kdotp as _kd
from repro_torch.kernels import kvi_walk as _kw
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.fused_vops import Windows, program_words
from repro_torch.kvi.backend import (BackendBase, BackendResult,
                                     register_backend)
from repro_torch.kvi.ir import KviInstr, KviOp, KviProgram, ScalarBlock
from repro_torch.kvi.passes.fusion import (MAX_FUSED_INPUTS, MAX_FUSED_OPS,
                                           META_KEY, FusedRegion, FusionPlan,
                                           plan_fusion_regions)
from repro_torch.kvi.workload import (KviWorkload, WorkloadResult,
                                      structural_signature)

TORCH_DTYPE = {1: torch.int8, 2: torch.int16, 4: torch.int32}

# reduction op -> the post op applied to the sum at flush
_POST = {KviOp.KVRED: _kd.POST_NONE, KviOp.KDOTP: _kd.POST_NONE,
         KviOp.KDOTPPS: _kd.POST_SHIFT, KviOp.KSVADDRF: _kd.POST_ADD,
         KviOp.KSVMULRF: _kd.POST_MUL}


@dataclass
class KernelCache:
    """Launch-record cache: slot-program structure -> its packed slot
    program (``fused_vops.program_words``), or a reduction's flush
    parameters: one lookup per region and per reduction walked. Keys are the reference's
    (``pallas_backend.py``: program, slots, batch shape, block, dtype)
    with the device in place of the interpret flag, so a hit is exactly a
    reused record.

    Scoped to a :class:`TorchBackend` by default, so repeated
    ``run_workload`` calls over the same structures build nothing; pass
    one cache to several backends to share it wider. ``misses`` counts
    builds, ``hits`` reuses."""

    hits: int = 0
    misses: int = 0
    _records: Dict[tuple, object] = field(default_factory=dict)

    def get(self, key: tuple, build: Callable[[], object]) -> object:
        rec = self._records.get(key)
        if rec is None:
            self.misses += 1
            rec = self._records[key] = build()
        else:
            self.hits += 1
        return rec

    def clear(self) -> None:
        """Drop every record and reset the counters."""
        self._records.clear()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._records)

    @property
    def entries(self) -> int:
        return len(self._records)

    @property
    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._records)}


# a tensor of one batch: ("reg" | "st", torch dtype) or ("in", numpy dtype)
_TKey = Tuple[str, object]


@dataclass
class _Walk:
    """One structure's walk, compiled once: tensor widths and steps.

    steps are ``("copy", dst, dst_col, src, src_col, length, overlap)``,
    ``("fused", region, reg, windows)`` or ``("reduce", op, scalar, post,
    length, a, a_col, b_col|None, dst, dst_col)``."""

    reg_width: Dict[torch.dtype, int]
    in_mems: Dict[np.dtype, List[int]]       # host dtype -> mem ids
    in_width: Dict[np.dtype, int]            # host dtype -> their length
    st_width: Dict[torch.dtype, int]
    steps: List[tuple]
    # (name, mem id, (store dtype, column, length) or None: mem_init)
    outputs: List[Tuple[str, int, Optional[Tuple[torch.dtype, int, int]]]]


def _host_dtype(dt: np.dtype) -> np.dtype:
    """The dtype a buffer is stacked in: torch has no uint16/32/64
    tensors to copy from, so those widen to int64 (values kept)."""
    return np.dtype(np.int64) if dt.kind == "u" and dt.itemsize > 1 else dt


@register_backend("torch")
class TorchBackend(BackendBase):
    """Executes KVI workloads on the card (``device=None``) or with the
    kernels' plain PyTorch versions (``device="cpu"``). There is no
    fallback from one to the other.

    ``block`` is kept for the reference's launch keys (the walk kernel
    picks its own block size, ``WalkRecord.threads``).
    ``max_fused_ops`` / ``max_fused_inputs`` bound one region's slot
    program; programs optimized by the default pipeline arrive with a
    :class:`FusionPlan` under the same bounds and run as planned.

    ``verify=True`` (or ``run_workload(verify=True)``) runs the static
    analyzer (:mod:`repro_torch.kvi.analysis`) before anything is
    stacked: a workload with an error-severity diagnostic raises
    ``KviVerificationError`` and launches nothing; the pass pipeline then
    re-verifies after every pass.

    ``obs`` is an optional telemetry bundle
    (:class:`repro_torch.kvi.obs.Obs`): when enabled, every
    ``run_workload`` emits one wall-clock ``("torch", "run_workload")``
    span (args: ``entries``, ``groups``, ``kernel_launches`` and
    ``walk_launches``, the run's walk-kernel launches) and feeds the
    ``torch.runs`` / ``torch.kernel_launches`` / ``torch.walk_launches``
    counters, ``torch.compile_cache.{hits,misses}`` and the
    ``torch.run_wall_s`` histogram.

    Counts: ``fused_calls`` / ``reduce_calls`` count the regions and
    reductions walked, one each per batch of N instances — the
    reference's ``pallas_calls``, on both devices; ``walk_calls`` counts
    launches of the walk kernel, one per structural group on the card and
    0 on the CPU. ``meta`` of a run holds ``groups``, ``kernel_launches``
    (fused_calls + reduce_calls: the counterpart of the reference's
    ``pallas_calls``), ``compile_cache`` (this call's hit/miss deltas,
    one lookup per region and reduction) and ``wall_s``. ``host_s`` holds
    the last run's host split, summed over its groups: ``stack_s`` (input
    stacks to the device), ``walk_s`` (the walk, synchronized on the
    card) and ``unpack_s`` (outputs back to the host); and, when the run
    verified, ``verify_s`` (the analyzer and the self-checking pipeline)."""

    def __init__(self, device=None, block: int = 256,
                 max_fused_ops: int = MAX_FUSED_OPS,
                 max_fused_inputs: int = MAX_FUSED_INPUTS,
                 passes=None, verify: bool = False,
                 kernel_cache: Optional[KernelCache] = None, obs=None):
        if block % 32 or not 32 <= block <= 1024:
            raise ValueError(f"block must be a multiple of 32 in [32, 1024],"
                             f" got {block}")
        self.device = resolve_device(device)
        self.block = block
        self.max_fused_ops = max_fused_ops
        self.max_fused_inputs = max_fused_inputs
        self.passes = passes
        self.verify = verify
        self.obs = obs
        self.kernel_cache = kernel_cache if kernel_cache is not None \
            else KernelCache()
        self.fused_calls = 0
        self.reduce_calls = 0
        self.walk_calls = 0
        self.host_s: Dict[str, float] = {}
        self._walks: Dict[tuple, Tuple[_Walk, _kw.WalkRecord]] = {}

    # -- fusion plan -------------------------------------------------------
    def _plan(self, program: KviProgram) -> FusionPlan:
        """The program's attached fusion plan, or a fresh one when absent
        (``passes=()``) / planned under different slot-file bounds."""
        plan = program.meta.get(META_KEY)
        if (isinstance(plan, FusionPlan)
                and plan.max_ops == self.max_fused_ops
                and plan.max_inputs == self.max_fused_inputs):
            return plan
        return plan_fusion_regions(program, self.max_fused_ops,
                                   self.max_fused_inputs)

    # -- compiling a structure's walk --------------------------------------
    def _compile(self, proto: KviProgram) -> _Walk:
        reg_at: Dict[int, Tuple[_TKey, int]] = {}
        reg_width: Dict[torch.dtype, int] = {}
        for r in proto.vregs:
            dt = TORCH_DTYPE[r.elem_bytes]
            reg_at[r.id] = (("reg", dt), reg_width.get(dt, 0))
            reg_width[dt] = reg_width.get(dt, 0) + r.length

        def window(rid: int, off: int, n: int) -> Tuple[_TKey, int]:
            if off + n > proto.vregs[rid].length:
                raise IndexError(
                    f"{proto.name!r}: window [{off}:{off + n}) outside vreg "
                    f"{proto.vregs[rid].name!r} of length "
                    f"{proto.vregs[rid].length}")
            key, col = reg_at[rid]
            return key, col + off

        in_width: Dict[np.dtype, int] = {}
        in_mems: Dict[np.dtype, List[int]] = {}
        st_width: Dict[torch.dtype, int] = {}
        # where each buffer's current contents live (None: mem_init only)
        cur: Dict[int, Optional[Tuple[_TKey, int, int]]] = {
            m.id: None for m in proto.mems}
        plan = self._plan(proto)
        region_at = {r.items[0]: r for r in plan.regions}
        fused = plan.member_items()
        steps: List[tuple] = []
        for idx, it in enumerate(proto.items):
            if isinstance(it, ScalarBlock) or (idx in fused
                                               and idx not in region_at):
                continue
            if idx in region_at:
                steps.append(self._region_step(region_at[idx], window))
                continue
            i: KviInstr = it
            if i.op is KviOp.KMEMLD:
                mid = i.src1.id
                if cur[mid] is None:            # first read of mem_init
                    hdt = _host_dtype(np.asarray(proto.mem_init[mid]).dtype)
                    cur[mid] = (("in", hdt), in_width.get(hdt, 0),
                                proto.mems[mid].length)
                    in_width[hdt] = cur[mid][1] + proto.mems[mid].length
                    in_mems.setdefault(hdt, []).append(mid)
                skey, scol, n = cur[mid]
                # Mfu semantics: the whole buffer lands in the window
                dkey, dcol = window(i.dst.id, i.dst.offset, n)
                steps.append(("copy", dkey, dcol, skey, scol, n, False))
            elif i.op is KviOp.KMEMSTR:
                skey, scol = window(i.src1.id, i.src1.offset, i.length)
                dt = skey[1]
                dcol = st_width.get(dt, 0)
                st_width[dt] = dcol + i.length
                steps.append(("copy", ("st", dt), dcol, skey, scol,
                              i.length, False))
                cur[i.dst.id] = (("st", dt), dcol, i.length)
            elif i.op is KviOp.KVCP:
                n = i.length
                skey, scol = window(i.src1.id, i.src1.offset, n)
                dkey, dcol = window(i.dst.id, i.dst.offset, n)
                overlap = (dkey == skey and dcol != scol
                           and dcol < scol + n and scol < dcol + n)
                steps.append(("copy", dkey, dcol, skey, scol, n, overlap))
            else:
                n = i.length
                akey, acol = window(i.src1.id, i.src1.offset, n)
                bcol = None
                if i.src2 is not None:
                    bkey, bcol = window(i.src2.id, i.src2.offset, n)
                    if bkey != akey:
                        raise ValueError(
                            f"{proto.name!r}: {i.op.value} over operands of "
                            f"two element widths")
                dkey, dcol = window(i.dst.id, i.dst.offset, 1)
                steps.append(("reduce", i.op.value, i.scalar, _POST[i.op],
                              n, akey, acol, bcol, dkey, dcol))
        outputs = []
        for m in proto.outputs:
            loc = cur[m.id]
            outputs.append((m.name, m.id, (loc[0][1], loc[1], loc[2])
                            if loc is not None and loc[0][0] == "st"
                            else None))
        return _Walk(reg_width, in_mems, in_width, st_width, steps,
                     outputs)

    def _region_step(self, region: FusedRegion, window) -> tuple:
        reg = ("reg", TORCH_DTYPE[region.elem_bytes])
        cols = []
        for wins in (region.inputs, region.outputs):
            cols.append([])
            for (rid, off, n), _slot in wins:
                key, col = window(rid, off, n)
                if key != reg:
                    raise ValueError(
                        f"fused region over {region.elem_bytes}-byte lanes "
                        f"touches a vreg of another element width")
                cols[-1].append(col)
        return ("fused", region, reg, Windows(cols[0], cols[1],
                                              region.length))

    # -- batched walk ------------------------------------------------------
    def _run_batch(self, sig: tuple, programs: Sequence[KviProgram]
                   ) -> List[Dict[str, np.ndarray]]:
        """Execute N structurally identical programs (different data) in
        one batched walk: one launch on the card."""
        proto = programs[0]
        N = len(programs)
        compiled = self._walks.get(sig)
        if compiled is None:
            walk = self._compile(proto)
            compiled = self._walks[sig] = (walk, _kw.pack_walk(walk))
        walk, record = compiled
        dev = self.device
        t0 = time.perf_counter()
        inputs = []
        for (_, hdt), mids in zip(record.in_keys, walk.in_mems.values()):
            pad = np.zeros(record.width(("in", hdt)) - walk.in_width[hdt],
                           hdt)
            host = np.concatenate(
                [a for p in programs for a in
                 [np.asarray(p.mem_init[mid]).reshape(-1) for mid in mids]
                 + [pad]], dtype=hdt, casting="unsafe").reshape(N, -1)
            inputs.append(torch.from_numpy(host).to(dev))
        stores = [torch.empty((N, record.width(k)), dtype=k[1], device=dev)
                  for k in record.st_keys]
        t1 = time.perf_counter()
        self._lookups(walk, N)
        if dev.type == "cuda":
            _kw.run_walk(record, inputs, stores, N)
            self.walk_calls += 1
            torch.cuda.synchronize(dev)
        else:
            _kw.run_walk_plain(record, inputs, stores, N)
        t2 = time.perf_counter()

        host_st = {k[1]: t.cpu().numpy()               # one D2H per width
                   for k, t in zip(record.st_keys, stores)}
        results = []
        for b, p in enumerate(programs):
            outs = {}
            for name, mid, loc in walk.outputs:
                shape = p.mem_init[mid].shape
                if loc is None:
                    outs[name] = np.asarray(p.mem_init[mid]).reshape(
                        shape).copy()
                else:
                    dt, col, n = loc
                    outs[name] = host_st[dt][b, col:col + n].reshape(
                        shape).copy()
            results.append(outs)
        for key, dt in (("stack_s", t1 - t0), ("walk_s", t2 - t1),
                        ("unpack_s", time.perf_counter() - t2)):
            self.host_s[key] = self.host_s.get(key, 0.0) + dt
        return results

    def _lookups(self, walk: _Walk, N: int) -> None:
        """One launch-record lookup per region and per reduction walked,
        under the reference's keys (``pallas_backend.py``), and the counts
        of both."""
        for step in walk.steps:
            if step[0] == "fused":
                _, region, reg, _ = step
                in_slots = tuple(s for _, s in region.inputs)
                out_slots = tuple(s for _, s in region.outputs)
                key = ("fused", region.ops, in_slots, out_slots,
                       region.n_slots, N, region.length, self.block,
                       str(reg[1]), str(self.device))
                self.kernel_cache.get(key, lambda r=region, i=in_slots,
                                      o=out_slots: program_words(
                                          r.ops, i, o, r.n_slots))
                self.fused_calls += 1
            elif step[0] == "reduce":
                _, op, scalar, post, n, akey, _, _, _, _ = step
                self.kernel_cache.get(("red", op, scalar, N, n,
                                       str(akey[1]), str(self.device)),
                                      lambda p=post, s=scalar: (p, s))
                self.reduce_calls += 1

    def run_workload(self, workload: KviWorkload,
                     verify: Optional[bool] = None) -> WorkloadResult:
        """Group entries by program structure; each group runs as one
        batched walk (one walk-kernel launch for the whole group on the
        card). Hart assignments carry no timing meaning here:
        the batch is the hart-level parallelism."""
        t0 = time.perf_counter()
        workload = self.optimize_workload(workload, verify=verify)
        self.host_s = {}
        if self.verify if verify is None else verify:
            self.host_s["verify_s"] = time.perf_counter() - t0
        calls_before = self.fused_calls + self.reduce_calls
        walks_before = self.walk_calls
        cc_before = (self.kernel_cache.hits, self.kernel_cache.misses)
        groups = _group(workload.entries)
        entry_outputs: List[Optional[Dict[str, np.ndarray]]] = \
            [None] * len(workload.entries)
        for sig, idxs in groups.items():
            outs = self._run_batch(
                sig, [workload.entries[i].program for i in idxs])
            for i, out in zip(idxs, outs):
                entry_outputs[i] = out
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall_s = round(time.perf_counter() - t0, 6)
        calls = self.fused_calls + self.reduce_calls - calls_before
        cc = {"hits": self.kernel_cache.hits - cc_before[0],
              "misses": self.kernel_cache.misses - cc_before[1]}
        if self.obs is not None and self.obs.enabled:
            walks = self.walk_calls - walks_before
            tr = self.obs.tracer
            start_us = tr.wall_us() - wall_s * 1e6
            tr.span(("torch", "run_workload"), "run_workload",
                    round(max(0.0, start_us), 3), round(wall_s * 1e6, 3),
                    cat="wall", clock="wall",
                    args={"entries": len(workload.entries),
                          "groups": len(groups), "kernel_launches": calls,
                          "walk_launches": walks})
            m = self.obs.metrics
            m.counter("torch.runs").inc()
            m.counter("torch.kernel_launches").inc(calls)
            m.counter("torch.walk_launches").inc(walks)
            m.absorb("torch.compile_cache", cc)
            m.histogram("torch.run_wall_s").observe(wall_s)
        return WorkloadResult(
            self.name, workload,
            tuple(BackendResult(self.name, out) for out in entry_outputs),
            meta={"groups": len(groups), "kernel_launches": calls,
                  "compile_cache": cc, "wall_s": wall_s})


def _group(entries) -> Dict[tuple, List[int]]:
    """Entry indices grouped by structural signature, in first-seen
    order. Instances minted from one prototype share its item, vreg and
    buffer tuples, so the (large) signature is built and hashed once per
    distinct set of tuples rather than once per entry."""
    groups: Dict[tuple, List[int]] = {}
    by_ids: Dict[Tuple[int, int, int], List[int]] = {}
    for idx, e in enumerate(entries):
        p = e.program
        ids = (id(p.items), id(p.vregs), id(p.mems))
        members = by_ids.get(ids)
        if members is None:
            members = by_ids[ids] = groups.setdefault(
                structural_signature(p), [])
        members.append(idx)
    return groups
