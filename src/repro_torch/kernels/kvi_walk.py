"""The KVI walk as one kernel: a compiled structure's whole walk — its
copies, fused element-wise regions and reductions — runs as ONE launch
of ``csrc/kvi_walk.cu`` for all N instances of a batch, one block per
instance, with the instance's register files (the Klessydra SPMs) in
shared memory.

It takes over, on the KVI path, the two TPU kernels that the reference
launches once per step: ``repro/kvi/pallas_backend.py::_fused_kernel``
(one ``pallas_call`` per fused region) and
``repro/kernels/kdotp.py::_reduce_kernel`` (one per reduction). The
per-step kernels stay for the intrinsics (``fused_vops``, ``kdotp``).

Three pieces:

* :func:`pack_walk` encodes a compiled walk (``TorchBackend._compile``'s
  ``_Walk``) as a :class:`WalkRecord`: a flat int64 step table of
  ``STEP_WORDS`` words a step, a pool of slot programs and prefetch
  entries, the buffers (register files at 16-byte aligned offsets of one
  per-instance arena, the input stacks by host dtype, the store stacks
  by element width) and, for each step, whether a barrier must follow
  it. Nothing in it depends on N.
* :func:`run_walk` — the CUDA path: one launch over a batch.
* :func:`run_walk_plain` — the plain version: interprets the same
  packed table step by step with ``fused_vops_plain`` and
  ``reduce_rows_plain``, so every CPU run checks the encoding too.

:func:`run_walk_per_step` replays the table through the per-step
kernels, the route the walk kernel replaced; ``chip_smoke.py`` times it
beside the walk.

A step is ``[kind | flags | elem a << 16 | elem b << 24, w1 .. w7]``:

* copy:   ``dst buffer, dst col, src buffer, src col, n, prefetch k|-1,
  the source of prefetch k + ring - 1|-1`` (elems: dst, src; ``kmemld`` /
  ``kmemstr`` / ``kvcp``; an integer cast that wraps);
* fused:  ``reg buffer, pool offset, n_ops, n_in, n_out, n, n_slots``
  (elem a: the register file's; the pool holds
  ``fused_vops.program_words`` then the input and output window
  columns);
* reduce: ``operand buffer, a col, b col|-1, n, dst buffer | post << 8,
  dst col, scalar`` (elems: operands, dst; the oracle's flush into the
  dst's width).

A prefetch source is one word, ``buffer | elem << 4 | n << 8 | col <<
36``; the pool ends with the first ``lead`` of them (``ring - 1``, or 1
for a ring of one), and copy k carries prefetch ``k + ring - 1``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import kdotp as kd
from repro_torch.kernels.build import load_library
from repro_torch.kernels.fused_vops import (MAX_INPUTS, MAX_OPS, MAX_OUTPUTS,
                                            NO_SLOT, OPS_BY_CODE, FusedRecord,
                                            Windows, fused_vops,
                                            fused_vops_plain, program_words)

# the table's layout; csrc/kvi_walk.cu mirrors every constant here
STEP_WORDS = 8
COPY, FUSED, REDUCE = 0, 1, 2
BARRIER, OVERLAP, PREFETCH, HAZARD, PARITY = (1 << 8, 1 << 9, 1 << 10,
                                              1 << 11, 1 << 12)
ARENA, GLOBAL = 0, 1
# element codes of the buffers
I8, I16, I32, I64, U8, F32, F64 = range(7)
ELEM_BYTES = {I8: 1, I16: 2, I32: 4, I64: 8, U8: 1, F32: 4, F64: 8}
TORCH_ELEM = {torch.int8: I8, torch.int16: I16, torch.int32: I32}
NP_ELEM = {np.dtype(np.int8): I8, np.dtype(np.int16): I16,
           np.dtype(np.int32): I32, np.dtype(np.int64): I64,
           np.dtype(np.uint8): U8, np.dtype(np.bool_): U8,
           np.dtype(np.float32): F32, np.dtype(np.float64): F64}
MAX_BUFFERS = 16
CHUNK = 64                     # steps staged in shared memory at a time
PROG_WORDS = 2 * MAX_OPS + 2 * MAX_INPUTS + 2 * MAX_OUTPUTS
MAX_SMEM = 232448              # an H100 block's dynamic shared memory

#: the largest arena (register files + hazard scratch) an instance keeps
#: in shared memory; above it the arena is a row of a global workspace.
#: 96 KB leaves two blocks an SM at the cap.
ARENA_SMEM_CAP = 96 * 1024
#: the prefetch ring: a power of two of at most MAX_RING slots within
#: RING_BUDGET bytes; a kmemld whose source span exceeds SLOT_CAP reads
#: global memory directly
MAX_RING, RING_BUDGET, SLOT_CAP = 8, 32 * 1024, 16 * 1024
#: the block size: within 3 % of the best of 32, 64 and 128 on every
#: main-path structure, and the best at matmul64 and pipeline_demo
#: (``chip_smoke.time_walks``' sweep on an H100)
THREADS = 128
MAX_GRID = 132 * 8             # blocks; more rows stride over the grid

#: kernel launches so far (the CUDA path only)
launch_count = 0


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(arena_bytes: int, arena_shared: bool, ring: int,
               slot: int) -> int:
    """Dynamic shared memory of one block (``kvi_walk.cu::layout``): the
    table chunk, two staged slot programs, two sets of warp partials, the
    row pointers, the prefetch ring and, in the shared layout, the
    arena."""
    return (CHUNK * STEP_WORDS * 8 + 2 * PROG_WORDS * 8 + 2 * 32 * 8
            + MAX_BUFFERS * 8 + ring * slot
            + (arena_bytes if arena_shared else 0))


@dataclass(frozen=True)
class Buffer:
    """A tensor of the walk: ``key`` is ``("reg" | "st", torch dtype)``
    or ``("in", numpy dtype)``; register files live in the ``ARENA`` at
    byte ``offset``, stacks are ``GLOBAL`` ``(N, width)`` tensors."""

    key: tuple
    space: int
    elem: int
    offset: int
    width: int


@dataclass
class WalkRecord:
    """A packed walk (see the module docstring). ``table`` is
    ``(n_steps, STEP_WORDS)`` and ``pool`` 1-D, both int64 on the CPU;
    :meth:`on` gives (and keeps) their copies on a device. Inputs and
    stores are passed in the order of ``in_keys`` / ``st_keys``, as
    ``(N, width)`` tensors of the widths in ``buffers``."""

    table: torch.Tensor
    pool: torch.Tensor
    buffers: Tuple[Buffer, ...]
    arena_bytes: int
    scratch_off: int
    layout: str                     # "shared" or "global"
    threads: int
    ring: int
    slot_bytes: int
    pf_off: int
    n_prefetch: int
    counts: Dict[str, int]
    _device: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=dict, repr=False)

    @property
    def n_steps(self) -> int:
        return self.table.shape[0]

    @property
    def smem_bytes(self) -> int:
        return smem_bytes(self.arena_bytes, self.layout == "shared",
                          self.ring, self.slot_bytes)

    def keys(self, space: str) -> Tuple[tuple, ...]:
        return tuple(b.key for b in self.buffers if b.key[0] == space)

    @property
    def in_keys(self) -> Tuple[tuple, ...]:
        return self.keys("in")

    @property
    def st_keys(self) -> Tuple[tuple, ...]:
        return self.keys("st")

    def width(self, key: tuple) -> int:
        return next(b.width for b in self.buffers if b.key == key)

    def on(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        d = self._device.get(str(device))
        if d is None:
            d = self._device[str(device)] = (self.table.to(device),
                                             self.pool.to(device))
        return d


def _elem(key: tuple) -> int:
    if key[0] == "in":
        dt = np.dtype(key[1])
        if dt not in NP_ELEM:
            raise TypeError(f"the walk kernel reads no {dt} buffers")
        return NP_ELEM[dt]
    return TORCH_ELEM[key[1]]


def _prefetch_word(b: int, elem: int, n: int, col: int) -> int:
    if not (0 < n < 1 << 28 and 0 <= col < 1 << 28):
        raise ValueError(f"a kmemld of {n} lanes at column {col} exceeds "
                         f"the walk kernel's 2^28")
    return b | elem << 4 | n << 8 | col << 36


def _overlaps(a: tuple, b: tuple) -> bool:
    return a[0] == b[0] and a[1] < b[2] and b[1] < a[2]


def conflicts(a: tuple, b: tuple) -> bool:
    """Whether two accesses ``(buffer, lo, hi, lane)`` of different steps
    need a sync between them: they overlap, unless both are lane-parallel
    (element e at thread e % threads) from the same column, so every
    shared element is one thread's."""
    return _overlaps(a, b) and not (a[3] and b[3] and a[1] == b[1])


def pack_walk(walk, smem_cap: int = ARENA_SMEM_CAP,
              threads: int = THREADS) -> WalkRecord:
    """Encode a compiled walk (``reg_width``, ``in_mems``, ``in_width``,
    ``st_width``, ``steps`` as ``TorchBackend._compile`` builds them) as a
    :class:`WalkRecord`. ``smem_cap`` bounds the arena kept in shared
    memory (above it the global layout is packed); ``threads`` overrides
    the block size (``THREADS``)."""
    keys: List[tuple] = [("reg", dt) for dt in (torch.int8, torch.int16,
                                                torch.int32)
                         if dt in walk.reg_width]
    keys += [("st", dt) for dt in (torch.int8, torch.int16, torch.int32)
             if dt in walk.st_width]
    keys += [("in", np.dtype(h)) for h in walk.in_mems]
    if len(keys) > MAX_BUFFERS:
        raise ValueError(f"a walk of {len(keys)} buffers exceeds "
                         f"{MAX_BUFFERS}")
    buf_id = {k: i for i, k in enumerate(keys)}
    # input stack rows padded to 16 bytes: the prefetch reads whole words
    in_width = {np.dtype(h): _align16(w * np.dtype(h).itemsize)
                // np.dtype(h).itemsize for h, w in walk.in_width.items()}

    words: List[List[int]] = []
    pool: List[int] = []
    prefetch: List[int] = []          # packed sources
    pf_step: List[int] = []           # the table row of each prefetch
    acc: List[Tuple[List[tuple], List[tuple]]] = []   # (reads, writes)
    scratch = 0
    fused_seen = reduce_seen = 0
    pf_spans = []
    for step in walk.steps:
        kind = step[0]
        if kind == "copy":
            _, dkey, dcol, skey, scol, n, overlap = step
            db, sb = buf_id[dkey], buf_id[skey]
            flags, k = COPY | _elem(dkey) << 16 | _elem(skey) << 24, -1
            if overlap:
                flags |= OVERLAP
            span = 4 * ((3 + n * ELEM_BYTES[_elem(skey)] + 3) // 4)
            if skey[0] == "in" and span <= SLOT_CAP:
                flags |= PREFETCH
                k = len(prefetch)
                prefetch.append(_prefetch_word(sb, _elem(skey), n, scol))
                pf_step.append(len(words))
                pf_spans.append(span)
            words.append([flags, db, dcol, sb, scol, n, k, -1])
            lane = not overlap
            reads = [] if skey[0] == "in" else [(sb, scol, scol + n, lane)]
            acc.append((reads, [(db, dcol, dcol + n, lane)]))
        elif kind == "fused":
            _, region, reg, win = step
            rb = buf_id[reg]
            in_slots = [s for _, s in region.inputs]
            out_slots = [s for _, s in region.outputs]
            outs = [(rb, c, c + win.n, not win.hazard)
                    for c in win.out_cols.tolist()]
            if any(_overlaps(a, b) for i, a in enumerate(outs)
                   for b in outs[i + 1:]):
                raise ValueError("fused region with overlapping output "
                                 "windows")
            flags = FUSED | (PARITY if fused_seen % 2 else 0) \
                | _elem(reg) << 16
            if win.hazard:
                flags |= HAZARD
                scratch = max(scratch, len(out_slots) * win.n
                              * reg[1].itemsize)
            off = len(pool)
            pool += program_words(region.ops, in_slots, out_slots,
                                  region.n_slots)
            pool += win.in_cols.tolist() + win.out_cols.tolist()
            words.append([flags, rb, off, len(region.ops), len(in_slots),
                          len(out_slots), win.n, region.n_slots])
            acc.append(([(rb, c, c + win.n, True)
                         for c in win.in_cols.tolist()], outs))
            fused_seen += 1
        else:
            _, _op, scalar, post, n, akey, acol, bcol, dkey, dcol = step
            ab, db = buf_id[akey], buf_id[dkey]
            flags = REDUCE | (PARITY if reduce_seen % 2 else 0) \
                | _elem(akey) << 16 | _elem(dkey) << 24
            words.append([flags, ab, acol, -1 if bcol is None else bcol, n,
                          db | post << 8, dcol, scalar])
            reads = [(ab, acol, acol + n, True)]
            if bcol is not None:
                reads.append((ab, bcol, bcol + n, True))
            acc.append((reads, [(db, dcol, dcol + 1, False)]))  # thread 0
            reduce_seen += 1

    # barriers: after step i when step i+1 could touch what another
    # thread touched since the last sync (read after write, write after
    # read or write); prefetched copies and fused steps open with a sync
    # of their own
    pend_r: List[tuple] = []
    pend_w: List[tuple] = []
    for i, w in enumerate(words):
        kind, flags = w[0] & 0xff, w[0]
        reads, writes = acc[i]
        if flags & PREFETCH or kind == FUSED:
            pend_r, pend_w = [], []
        elif i and (any(conflicts(x, y) for x in writes
                        for y in pend_r + pend_w)
                    or any(conflicts(x, y) for x in reads for y in pend_w)):
            words[i - 1][0] |= BARRIER
            pend_r, pend_w = [], []
        pend_r += reads
        pend_w += writes

    # the arena: register files (widest first) at 16-byte aligned offsets,
    # then the hazard regions' staging scratch
    offsets, off = {}, 0
    for dt in (torch.int32, torch.int16, torch.int8):
        if dt in walk.reg_width:
            offsets[dt] = off
            off = _align16(off + walk.reg_width[dt] * dt.itemsize)
    scratch_off = off
    arena_bytes = _align16(off + scratch)
    buffers = []
    for k in keys:
        if k[0] == "reg":
            buffers.append(Buffer(k, ARENA, _elem(k), offsets[k[1]],
                                  walk.reg_width[k[1]]))
        elif k[0] == "st":
            buffers.append(Buffer(k, GLOBAL, _elem(k), 0, walk.st_width[k[1]]))
        else:
            buffers.append(Buffer(k, GLOBAL, _elem(k), 0, in_width[k[1]]))

    slot = _align16(max(pf_spans, default=0))
    ring = min(MAX_RING, len(prefetch),
               max(1, RING_BUDGET // slot) if slot else 0)
    ring = 1 << (ring.bit_length() - 1) if ring else 0   # a power of two
    lead = ring - 1 if ring > 1 else ring
    pf_off = len(pool)
    pool += prefetch[:lead]
    for k, row in enumerate(pf_step):      # copy k issues k + ring - 1
        if ring > 1 and k + lead < len(prefetch):
            words[row][7] = prefetch[k + lead]
    if threads % 32 or not 32 <= threads <= 256:
        raise ValueError(f"threads must be a multiple of 32 in [32, 256], "
                         f"got {threads}")
    table = torch.tensor(words or [[0] * STEP_WORDS],
                         dtype=torch.int64).reshape(-1, STEP_WORDS)
    if not words:
        table = table[:0]
    counts = {"copy": sum(w[0] & 0xff == COPY for w in words),
              "fused": fused_seen, "reduce": reduce_seen,
              "prefetched": len(prefetch),
              "barriers": sum(bool(w[0] & BARRIER) for w in words)}
    return WalkRecord(table, torch.tensor(pool, dtype=torch.int64),
                      tuple(buffers), arena_bytes, scratch_off,
                      "shared" if arena_bytes <= smem_cap else "global",
                      threads, ring, slot, pf_off, len(prefetch), counts)


def decode_steps(record: WalkRecord) -> List[tuple]:
    """The packed table read back: ``("copy", dkey, dcol, skey, scol, n,
    overlap)``, ``("fused", ops, in_slots, out_slots, n_slots, key,
    in_cols, out_cols, n)`` and ``("reduce", post, scalar, n, akey, acol,
    bcol|None, dkey, dcol)``, keys as in the walk."""
    key = [b.key for b in record.buffers]
    pool = record.pool.tolist()
    out = []
    for w in record.table.tolist():
        kind = w[0] & 0xff
        if kind == COPY:
            out.append(("copy", key[w[1]], w[2], key[w[3]], w[4], w[5],
                        bool(w[0] & OVERLAP)))
        elif kind == FUSED:
            off, n_ops, n_in, n_out = w[2], w[3], w[4], w[5]
            ops = []
            for i in range(n_ops):
                word, imm = pool[off + 2 * i], pool[off + 2 * i + 1]
                s2 = (word >> 24) & 0xff
                ops.append((OPS_BY_CODE[word & 0xff], (word >> 8) & 0xff,
                            (word >> 16) & 0xff,
                            None if s2 == NO_SLOT else s2, imm))
            p = off + 2 * n_ops
            slots = pool[p:p + n_in + n_out]
            cols = pool[p + n_in + n_out:p + 2 * (n_in + n_out)]
            out.append(("fused", tuple(ops), tuple(slots[:n_in]),
                        tuple(slots[n_in:]), w[7], key[w[1]],
                        tuple(cols[:n_in]), tuple(cols[n_in:]), w[6]))
        else:
            out.append(("reduce", (w[5] >> 8) & 0xff, w[7], w[4], key[w[1]],
                        w[2], None if w[3] < 0 else w[3],
                        key[w[5] & 0xff], w[6]))
    return out


def _check(record: WalkRecord, inputs: Sequence[torch.Tensor],
           stores: Sequence[torch.Tensor], N: int) -> torch.device:
    want = [(k, record.width(k)) for k in record.in_keys + record.st_keys]
    given = list(inputs) + list(stores)
    if len(given) != len(want):
        raise ValueError(f"the walk takes {len(record.in_keys)} input and "
                         f"{len(record.st_keys)} store tensors, got "
                         f"{len(inputs)} and {len(stores)}")
    devices = {t.device for t in given}
    if len(devices) > 1:
        raise ValueError(f"walk tensors on several devices: {devices}")
    for (key, width), t in zip(want, given):
        dt = (torch.from_numpy(np.empty(0, key[1])).dtype
              if key[0] == "in" else key[1])
        if t.dtype != dt or tuple(t.shape) != (N, width) \
                or not t.is_contiguous():
            raise ValueError(f"walk buffer {key}: want a contiguous "
                             f"({N}, {width}) {dt} tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
    return devices.pop() if devices else None


def run_walk(record: WalkRecord, inputs: Sequence[torch.Tensor],
             stores: Sequence[torch.Tensor], N: int,
             max_grid: int = MAX_GRID) -> None:
    """Run the packed walk over N instances: ONE launch of
    ``kvi_walk_kernel`` on the tensors' card (CUDA tensors only; a CPU
    caller takes :func:`run_walk_plain`). Reads ``inputs`` (the input
    stacks), writes ``stores``. ``max_grid`` caps the blocks; more
    instances stride over them. A launch error raises."""
    global launch_count
    dev = _check(record, inputs, stores, N)
    if dev is not None and dev.type != "cuda":
        raise ValueError(f"run_walk launches on a CUDA device, got {dev}; "
                         f"the plain version is run_walk_plain")
    if N <= 0 or record.n_steps == 0:
        return
    if dev is None:
        raise ValueError("run_walk needs a CUDA tensor to find the device")
    table, pool = record.on(dev)
    grid = max(1, min(N, max_grid))
    shared = record.layout == "shared"
    ws = None if shared else torch.empty((grid, record.arena_bytes),
                                         dtype=torch.uint8, device=dev)
    tensors = dict(zip(record.in_keys + record.st_keys,
                       list(inputs) + list(stores)))
    desc = np.array([[b.offset, 0] if b.space == ARENA else
                     [0, tensors[b.key].stride(0) * ELEM_BYTES[b.elem]]
                     for b in record.buffers], dtype=np.int64)
    ptrs = np.array([0 if b.space == ARENA else tensors[b.key].data_ptr()
                     for b in record.buffers], dtype=np.int64)
    rc = _library().kvi_walk_launch(
        table.data_ptr(), record.n_steps, pool.data_ptr(), record.pf_off,
        record.n_prefetch, desc.ctypes.data, ptrs.ctypes.data,
        len(record.buffers), record.arena_bytes, int(shared),
        record.scratch_off, None if ws is None else ws.data_ptr(),
        record.ring, record.slot_bytes, N, grid, record.threads,
        record.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kvi_walk kernel launch failed: CUDA error {rc}")
    launch_count += 1


def _library() -> ctypes.CDLL:
    lib = load_library("kvi_walk")
    fn = lib.kvi_walk_launch
    if fn.argtypes is None:
        i64, vp, ci = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i64, vp, i64, i64, vp, vp, ci, i64, ci, i64, vp,
                       ci, i64, i64, ci, ci, i64, vp]
        fn.restype = ci
        sm = lib.kvi_walk_smem_bytes
        sm.argtypes = [i64, ci, ci, i64]
        sm.restype = i64
    return lib


def run_walk_plain(record: WalkRecord, inputs: Sequence[torch.Tensor],
                   stores: Sequence[torch.Tensor], N: int) -> None:
    """The plain PyTorch version of :func:`run_walk`: interprets the
    packed table step by step — copies with ``copy_`` (a cast that
    wraps; an overlapping ``kvcp`` through a clone), fused steps with
    :func:`fused_vops_plain`, reductions with
    :func:`kdotp.reduce_rows_plain` in oracle mode. Runs on any device;
    the CPU backend and the on-card comparison use it."""
    _interpret(record, inputs, stores, N, per_step_kernels=False)


def run_walk_per_step(record: WalkRecord, inputs: Sequence[torch.Tensor],
                      stores: Sequence[torch.Tensor], N: int) -> None:
    """The route the walk kernel replaced, for timing beside it: the same
    table with one ``fused_vops`` launch per fused step, one ``kdotp``
    launch per reduction and one device copy per copy step."""
    _interpret(record, inputs, stores, N, per_step_kernels=True)


def _interpret(record: WalkRecord, inputs: Sequence[torch.Tensor],
               stores: Sequence[torch.Tensor], N: int,
               per_step_kernels: bool) -> None:
    dev = _check(record, inputs, stores, N) or torch.device("cpu")
    arena = torch.zeros((N, record.arena_bytes), dtype=torch.uint8,
                        device=dev)
    tensors = dict(zip(record.in_keys + record.st_keys,
                       list(inputs) + list(stores)))
    view = []
    for b in record.buffers:
        if b.space == ARENA:
            dt = b.key[1]
            view.append(arena[:, b.offset:b.offset + b.width * dt.itemsize]
                        .view(dt))
        else:
            view.append(tensors[b.key])
    pool = record.pool.tolist()
    if per_step_kernels:
        pool_t = record.on(dev)[1]
        fused, reduce = fused_vops, kd.reduce_rows
    else:
        pool_t = record.pool
        fused, reduce = fused_vops_plain, kd.reduce_rows_plain
    for w in record.table.tolist():
        kind = w[0] & 0xff
        if kind == COPY:
            _, db, dcol, sb, scol, n, _, _ = w
            src = view[sb][:, scol:scol + n]
            view[db][:, dcol:dcol + n].copy_(
                src.clone() if w[0] & OVERLAP else src)
        elif kind == FUSED:
            _, rb, off, n_ops, n_in, n_out, n, n_slots = w
            end = off + 2 * n_ops + n_in + n_out
            rec = FusedRecord(pool_t[off:end], n_ops, n_in, n_out, n_slots)
            win = Windows(pool[end:end + n_in],
                          pool[end + n_in:end + n_in + n_out], n)
            fused(rec, win, view[rb], view[rb])
        else:
            _, ab, acol, bcol, n, dpost, dcol, scalar = w
            a = view[ab]
            reduce(view[dpost & 0xff][:, dcol], a[:, acol:acol + n],
                   None if bcol < 0 else a[:, bcol:bcol + n],
                   post=(dpost >> 8) & 0xff, scalar=scalar, mode=kd.ORACLE)
