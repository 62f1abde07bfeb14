#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card, ``nvcc`` and this checkout (``src/repro_torch``);
imports nothing of JAX or of the reference package ``repro``. Phases:

1. build   — compile the nine CUDA sources of ``src/repro_torch/csrc/``
   for sm_90a, one ``nvcc`` per source, in parallel; print each kernel's
   registers and spills, and the conv2d kernel's rows a thread, threads,
   tiles and dynamic shared memory a block at each phase-4 workload;
2. check   — each kernel against its plain PyTorch version on the same
   CUDA tensors: the KVI walk kernel (``kvi_walk``) against
   ``run_walk_plain`` bit for bit on every main-path structure, on
   random programs at eb 1/2/4, on the walk's edge programs (overlapping
   kvcp, hazard regions, a kmemld after a kmemstr, unsigned buffers,
   narrow reduction dsts) and in both arena layouts (a register file
   above the shared-memory cap); slice 1's per-step kernels at the KVI
   path's shapes, bit for bit; the
   four compute kernels (conv2d bit for bit in every image dtype: int32
   at shifts 0 / 4 / 31 / 35 / 40, float32, bf16, float16, int8, int16,
   uint8, sums that wrap or saturate; F up to 1024), flash attention and
   the SSD scan at odd shapes
   (no dimension a multiple of a tile; one matmul of whole tiles),
   integers bit for bit, floats within error bounds, with the per-path
   launch counters showing the bf16 / int8 products and bf16 attention
   on the tensor-core kernels and float32 on the CUDA-core ones; each
   of the SSD scan's three kernels alone against its plain version (odd
   shapes, bf16 x, and the mamba2 row), and the scan at odd shapes
   against a float64 numpy recurrence; an
   int8 product whose int32 sums wrap (no saturation); ``spm_fft`` bit
   for bit against its plain version at every n = 1 .. 16384; then TF32
   products (cuBLAS with TF32 allowed), which the float32 matmul check
   must reject; then the inputs the reference takes past the first
   kernels' limits (``checks.EDGE_CHECKS``, one ``[edge]`` line each:
   attention at hd 160 / 176 / 256 / 320, in float16 and with negative
   windows; matmul on int16 / int32 / uint8 / float16 and int8 into
   float outputs, XLA's casts at their edges; FFTs of 32768 and 131072
   points; uint8 kdotp / kvred / fused_vops at the intrinsics' sizes;
   the SSD scan at N 1024 and with float16 x; a 161 x 161 composite
   filter), each against its plain version with its launch counter
   moved;
3. slice 1 — the KVI main path at the paper's sizes through
   ``get_backend("torch").run_workload``: conv2d 32x32 (F = 3 and 11),
   FFT-256, streamed matmul 64x64 (kdotp and kdotpps), pipeline_demo and
   the composite conv / FFT / matmul workload on 3 harts; outputs held
   bit for bit against numpy formulas and against the CPU backend on the
   first 4 instances; every run must be one ``kvi_walk`` launch per
   structural group and no ``fused_vops`` or ``kdotp`` launch; the warm
   run's host split (input stacking, the walk, output unpacking) is
   printed; then the KVI intrinsics (``ops`` element-wise and reduction
   calls), one ``fused_vops`` / ``kdotp`` launch each;
3b. serve  — the request-driven server (``python -m
   repro_torch.kvi.serving``'s default: ``DEFAULT_MIX``, 256 Poisson
   requests, 3 harts, max_batch 8) through ``ServeEngine.run`` on
   ``get_backend("torch", passes=())``: three rounds of two batched runs
   and one unbatched, each on a fresh backend (canonical reports
   byte-identical within each kind); the launch-record cache hit-only in
   the loop; exactly one ``kvi_walk`` launch per bucket and per prewarm
   batch (59 batched, 260 unbatched at seed 0), no ``fused_vops`` or
   ``kdotp`` launch; every run's 256 served outputs equal to the first
   run's, and those equal to the oracle request by request; a profiled
   batched run for the walk's device ms by bucket size; every template's
   instances batched on the card at 1, 2, 4 and 8 equal to the oracle and
   the CPU backend bit for bit (92 entries). A ``[serve]`` line holds
   ``execute_s`` of every run, the batching speed-up (the least over all
   batched runs) beside the reference's 2x gate, ``prewarm_s``,
   ``req_per_s``, p50 / p99 cycles, the cache counts, the walk launches
   and each run's split: the backend's calls, their host split (stack /
   walk / unpack) and the garbage collector's seconds and collections;
3t. telemetry — the same server with ``Obs.on()`` on the backend and the
   engine (three rounds of a run with telemetry off and one with it on,
   each on a fresh backend): canonical reports byte-equal with telemetry
   on and off; trace and metrics valid (kvi-trace-v1, kvi-metrics-v1);
   256 request flows; ``torch.walk_launches`` equal to the ``kvi_walk``
   launches of the run (59 at seed 0); ``scheduler.admitted`` 256; the
   latency histogram's p50 / p99 the report's; the card's canonical
   trace byte-equal to the CPU backend's. Then ``python -m
   repro_torch.kvi.serving``'s ``main`` with ``--trace-out`` /
   ``--metrics-out`` (``python -m repro_torch.kvi.obs validate`` gives 0,
   ``view`` prints the report's makespan); one live ``Obs`` on phase 3's
   backend over every phase-3 workload (one ``("torch", "run_workload")``
   span a run, its args the run's ``meta`` and walk launches, the
   ``torch.*`` counters their sums); the disabled path
   (``obs=NULL_OBS`` against ``obs=None`` on warm ``pipeline_demo`` runs,
   the least of 15 paired ratios at most 1.02); the enabled cost
   (traced over untraced ``execute_s``, the least of 3 each). A
   ``[telemetry]`` line holds the counts of trace events and metrics,
   the ratios and the trace's bytes;
3v. verify — every phase-3 workload at phase 3's widths again, through
   ``TorchBackend(verify=True)`` (the static analyzer over every
   instance, then the walk) beside phase 3's ``verify=False`` backend:
   outputs equal entry by entry and to the numpy formulas, the same walk
   launches (one a group), the first 4 entries of each group equal to
   the oracle's; a ``[verify]`` line each with the analyzer's host
   seconds beside phase 3's warm wall; every prototype through the
   default pass pipeline in its self-checking mode, its plan unchanged;
   a mutant of the verifier fuzz catalog refused with
   ``KviVerificationError`` before any ``kvi_walk`` launch;
4. slice 2 — the paper's compute kernels at card scale through the
   intrinsics layer ``repro_torch.kernels.ops`` (matmul bf16 / int8 /
   f32, f16 4096^3 and int32 2048^3, conv2d int32 F = 3, 11 and 161,
   f32 F = 3 and 11, bf16 and int8 F = 3, FFT 16384 x 256, 4096 x 1024
   and 256 x 65536, the het-MIMD composite at the paper's size, at 1024
   and at 512 with F = 161, and the 1024 composite's three parts alone),
   each output held against its plain version on the same tensors and
   against an independent numpy formula (int64 sums, float64 products
   and FFTs); the launch counters must show one launch per call, on the
   tensor-core kernel for every bf16 and int8 product;
   slice 3 — ``ops.attention_op`` and ``ops.ssd_scan_op`` (three
   launches a call: chunk states, the scan over chunks, the chunk scan)
   at the widths of the repo's configs (llama3.2-1b causal 4096,
   hymba-1.5b window 2048 over 8192, a mixtral prefill continuation,
   pixtral-12b's head width 160 causal at 4096, mamba2-1.3b's SSD at
   4096), driven likewise with the counters set to
   0 just before, each output against its plain version and a float64
   numpy formula on sampled heads and rows;
5. time    — each kernel at main-path shapes with ``torch.profiler`` and
   CUDA events, beside its plain version, its bound and (where one
   exists) a PyTorch library call computing the same function; the walk
   kernel per main-path structure beside the per-step route it replaced;
   for the compute and LM kernels every workload of phase 4, with the
   path that ran and, for a tensor-core product, the time of its operand
   glue; composite_1024 with its conv hart staging the whole window and
   streaming rows, in turns.

Any failed check raises, and the script exits non-zero. The last lines
are the card's name and power limit, a JSON object of kernel numbers
(``spm_matmul`` and ``flash_attention`` with their main-path launches by
path; the SSD scan as its three kernels, each with the whole call under
``scan``; ``kvi_walk`` with every main-path structure under
``workloads``, serving's launches and device ms by bucket size under
``serving``, phase 3t's numbers under ``telemetry`` and phase 3v's
launches and analyzer seconds under ``verified``) and ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_CHECK = 4                      # instances re-run on the CPU backend
FORMULA_ROWS = 16                # matmul rows checked against numpy, each end


# ---------------------------------------------------------------------------
# workloads of the main path and their independent numpy references
# ---------------------------------------------------------------------------

def conv_instances(rng, N, S=32, F=3, shift=4):
    from repro_torch.kvi import optimize_program
    from repro_torch.kvi.programs import conv2d_program
    filt = rng.integers(-(1 << 10), 1 << 10, (F, F))
    proto = optimize_program(conv2d_program(
        rng.integers(-(1 << 20), 1 << 20, (S, S)), filt, shift=shift))
    pad = F // 2
    imgs = np.zeros((N, S + 2 * pad, S + 2 * pad), np.int32)
    imgs[:, pad:pad + S, pad:pad + S] = rng.integers(
        -(1 << 20), 1 << 20, (N, S, S))
    progs = [proto.replace(mem_init={**proto.mem_init, 0: imgs[b]})
             for b in range(N)]
    # direct convolution; int32 wraps commute with the sum, then the
    # arithmetic post-shift of the wrapped accumulator
    acc = np.zeros((N, S, S), np.int64)
    for fr in range(F):
        for fc in range(F):
            acc += imgs[:, fr:fr + S, fc:fc + S].astype(np.int64) \
                * int(filt[fr, fc])
    want = acc.astype(np.int32) >> shift
    return progs, [{f"row{i}": want[b, i] for i in range(S)}
                   for b in range(N)]


def fft_instances(rng, N, n=256):
    from repro_torch.kvi import optimize_program
    from repro_torch.kvi.programs import _twiddles, fft_program
    proto = optimize_program(fft_program(rng.integers(-4096, 4096, n),
                                         rng.integers(-4096, 4096, n)))
    re = rng.integers(-4096, 4096, (N, n)).astype(np.int32)
    im = rng.integers(-4096, 4096, (N, n)).astype(np.int32)
    progs = [proto.replace(mem_init={**proto.mem_init, 0: re[b], 1: im[b]})
             for b in range(N)]
    # the Q15 radix-2 DIF butterflies in int32 wrap-around arithmetic
    w32 = lambda x: x.astype(np.int64).astype(np.int32)    # noqa: E731
    are, aim = re.copy(), im.copy()
    m = n
    t = lambda a, w: w32(a * w) >> 15                         # noqa: E731
    while m >= 2:
        h = m // 2
        wre, wim = (w.astype(np.int64) for w in _twiddles(m))
        for base in range(0, n, m):
            lo, hi = slice(base, base + h), slice(base + h, base + m)
            dre = w32(are[:, lo].astype(np.int64) - are[:, hi])
            dim = w32(aim[:, lo].astype(np.int64) - aim[:, hi])
            are[:, lo] = w32(are[:, lo].astype(np.int64) + are[:, hi])
            aim[:, lo] = w32(aim[:, lo].astype(np.int64) + aim[:, hi])
            are[:, hi] = w32(t(dre, wre).astype(np.int64) - t(dim, wim))
            aim[:, hi] = w32(t(dre, wim).astype(np.int64) + t(dim, wre))
        m //= 2
    nb = n.bit_length() - 1
    rev = [int(f"{i:0{nb}b}"[::-1], 2) for i in range(n)]
    out_re, out_im = np.empty_like(are), np.empty_like(aim)
    out_re[:, rev], out_im[:, rev] = are, aim
    return progs, [{"out_re": out_re[b], "out_im": out_im[b]}
                   for b in range(N)]


def matmul_instances(rng, N, n=64, shift=0):
    from repro_torch.kvi import optimize_program
    from repro_torch.kvi.programs import matmul_program
    lim = 1 << 15              # row sums reach 2^36: int32 overflows
    proto = optimize_program(matmul_program(
        rng.integers(-lim, lim, (n, n)), rng.integers(-lim, lim, (n, n)),
        shift=shift, resident=False))
    A = rng.integers(-lim, lim, (N, n, n)).astype(np.int32)
    B = rng.integers(-lim, lim, (N, n, n)).astype(np.int32)
    Bt = np.ascontiguousarray(B.transpose(0, 2, 1))
    ids = {m.name: m.id for m in proto.mems}
    progs = []
    for b in range(N):
        init = dict(proto.mem_init)
        for i in range(n):
            init[ids[f"arow{i}"]] = A[b, i]
            for j in range(n):
                init[ids[f"bcol{i}_{j}"]] = Bt[b, j]
        progs.append(proto.replace(mem_init=init))
    # the exact int64 product sum, shifted, then wrapped to int32
    want = (np.einsum("bik,bkj->bij", A.astype(np.int64),
                      B.astype(np.int64)) >> shift).astype(np.int32)
    return progs, [{f"row{i}": want[b, i] for i in range(n)}
                   for b in range(N)]


def demo_instances(rng, N, n=1024, stages=6):
    from repro_torch.kvi import optimize_program
    from repro_torch.kvi.programs import (pipeline_demo_oracle,
                                          pipeline_demo_program)
    proto = optimize_program(pipeline_demo_program(
        rng.integers(-128, 128, n), stages=stages))
    xs = rng.integers(-128, 128, (N, n)).astype(np.int32)
    progs = [proto.replace(mem_init={**proto.mem_init, 0: xs[b]})
             for b in range(N)]
    return progs, [{"y": pipeline_demo_oracle(xs[b], stages)}
                   for b in range(N)]


def main_path_workloads(rng, scale: int = 1):
    """(name, workload, expected outputs per entry). ``scale`` divides
    the batch sizes (a rehearsal on the CPU runs with a large one)."""
    from repro_torch.kvi import KviWorkload
    wls = []
    for name, (progs, want) in (
            ("conv32_f3", conv_instances(rng, 1024 // scale, F=3)),
            ("conv32_f11", conv_instances(rng, 1024 // scale, F=11)),
            ("fft256", fft_instances(rng, 1024 // scale)),
            ("matmul64_kdotp", matmul_instances(rng, 128 // scale)),
            ("matmul64_kdotpps", matmul_instances(rng, 128 // scale,
                                                  shift=8)),
            ("pipeline_demo", demo_instances(rng, 1024 // scale))):
        wls.append((name, KviWorkload.homogeneous(progs, name=name), want))
    parts = [conv_instances(rng, 128 // scale), fft_instances(
        rng, 128 // scale), matmul_instances(rng, 128 // scale, shift=8)]
    wl = KviWorkload.composite({h: p for h, (p, _) in enumerate(parts)},
                               name="composite_3harts")
    wls.append(("composite_3harts", wl, [w for _, ws in parts for w in ws]))
    return wls


def check_outputs(name, res, want):
    """Bit-exact against the numpy formulas, int32 throughout."""
    for b, exp in enumerate(want):
        got = res.entry_results[b].outputs
        for key, arr in exp.items():
            if got[key].dtype != np.int32 or not np.array_equal(got[key],
                                                                arr):
                raise AssertionError(f"{name}: entry {b} output {key} "
                                     f"differs from the numpy reference")


def check_against_cpu(name, workload, res, cpu):
    """The first ``N_CHECK`` entries of each structural group, re-run on
    the CPU backend (the kernels' plain versions), must agree bit for
    bit with the card's outputs for the same entries."""
    from repro_torch.kvi import KviWorkload
    seen, idx = {}, []
    for i, e in enumerate(workload.entries):
        key = (id(e.program.items), e.hart)
        if seen.get(key, 0) < N_CHECK:
            seen[key] = seen.get(key, 0) + 1
            idx.append(i)
    ref = cpu.run_workload(KviWorkload(workload.name, tuple(
        workload.entries[i] for i in idx)))
    for j, i in enumerate(idx):
        for key, arr in ref.entry_results[j].outputs.items():
            if not np.array_equal(res.entry_results[i].outputs[key], arr):
                raise AssertionError(f"{name}: entry {i} output {key} "
                                     f"differs from the CPU backend")


def device_time_ms(fn, *args):
    """``fn(*args)`` under ``torch.profiler``: its result, and its device
    time by kind — the walk kernel, memcpy (host <-> device) and other
    device work — or None when the
    trace holds no device time (the profiler may not see the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.micro import device_us
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = fn(*args)
        torch.cuda.synchronize()
    by = {"kvi_walk": 0.0, "memcpy": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        us = device_us(ev)
        if not us:
            continue
        kind = ("kvi_walk" if "kvi_walk_kernel" in ev.key else
                "memcpy" if ev.key.startswith("Memcpy") else "other")
        by[kind] += us / 1e3
    total = sum(by.values())
    return result, (dict(by, total=total) if total else None)


def run_slice(device, rng, scale=1, log=print):
    """Phase 3: drive every main-path workload twice (cold, then warm)
    through ``get_backend("torch").run_workload`` on ``device`` and check
    both runs. The prototypes are optimized once and their instances run
    with ``passes=()``, as serving templates do. Returns the backend, one
    record per workload and the ``(name, workload)`` pairs."""
    import torch
    from repro_torch.kvi import get_backend
    be = get_backend("torch", device=device, passes=())
    cpu = get_backend("torch", device="cpu", passes=())
    on_card = torch.device(device).type == "cuda"
    records, workloads = [], []
    for name, wl, want in main_path_workloads(rng, scale):
        workloads.append((name, wl))
        walks = [be.walk_calls]

        def run(wl=wl, walks=walks):
            r = be.run_workload(wl)
            walks.append(be.walk_calls)
            return r
        cold = run()
        warm = run()
        host = {k: round(v, 6) for k, v in be.host_s.items()}
        for r in (cold, warm):
            check_outputs(name, r, want)
            if r.meta["kernel_launches"] <= 0:
                raise AssertionError(f"{name}: no regions or reductions")
        check_against_cpu(name, wl, cold, cpu)
        if warm.meta["compile_cache"]["misses"]:
            raise AssertionError(f"{name}: the warm run rebuilt records")
        runs = [cold, warm]
        dev_ms = None
        if on_card:
            profiled, dev_ms = device_time_ms(run)
            runs.append(profiled)
        per_run = [b - a for a, b in zip(walks, walks[1:])]
        want_walks = cold.meta["groups"] if on_card else 0
        if per_run != [want_walks] * len(runs):
            raise AssertionError(f"{name}: walk launches per run {per_run}, "
                                 f"want {want_walks} (one per group)")
        rec = dict(phase=name, N=len(wl.entries),
                   groups=cold.meta["groups"],
                   walk_launches=sum(per_run),
                   kernel_launches=cold.meta["kernel_launches"],
                   host_split_warm_s=host,
                   compile_cache_cold=cold.meta["compile_cache"],
                   compile_cache_warm=warm.meta["compile_cache"],
                   cold_wall_s=cold.meta["wall_s"],
                   warm_wall_s=warm.meta["wall_s"],
                   profiled_wall_s=runs[-1].meta["wall_s"],
                   device_ms=dev_ms,
                   device_idle_share=None if dev_ms is None else
                   1 - dev_ms["total"] / 1e3 / warm.meta["wall_s"])
        records.append(rec)
        log(f"[slice] {json.dumps(rec)}")
        del cold, warm, runs
        if on_card:
            torch.cuda.empty_cache()
    return be, records, workloads


def mutant_workload(rng, n: int = 8):
    """A workload the static analyzer must refuse: ``n`` conv32_f3
    instances, the first carrying the first mutant of the verifier fuzz
    catalog (``oob:<i>:dst``: the first vector instruction's destination
    moved one register length on), rebuilt with the port's IR. Returns
    the workload and the mutant's label."""
    import dataclasses
    from repro_torch.kvi import KviInstr, KviWorkload
    progs, _ = conv_instances(rng, n, F=3)
    p = progs[0]
    idx, it = next((i, it) for i, it in enumerate(p.items)
                   if isinstance(it, KviInstr) and it.dst is not None
                   and it.dst.space == "vreg")
    reg = p.vregs[it.dst.id]
    items = list(p.items)
    items[idx] = dataclasses.replace(it, dst=dataclasses.replace(
        it.dst, offset=it.dst.offset + reg.length))
    bad = dataclasses.replace(p, items=tuple(items))
    return (KviWorkload.composite({0: [bad] + progs[1:]},
                                  name="conv32_f3_mutant"),
            f"oob:{idx}:dst")


def same_results(name, got, want):
    """Two runs of one workload: every entry's outputs equal, dtype and
    all."""
    for i, (g, w) in enumerate(zip(got.entry_results, want.entry_results)):
        for key, arr in w.outputs.items():
            if g.outputs[key].dtype != arr.dtype or \
                    not np.array_equal(g.outputs[key], arr):
                raise AssertionError(f"{name}: entry {i} output {key} "
                                     f"differs between verify=True and "
                                     f"verify=False")
    if len(got.entry_results) != len(want.entry_results):
        raise AssertionError(f"{name}: entry counts differ")


def run_verify(device, rng, be_off, warm_walls, scale=1, log=print):
    """Phase 3v: every main-path workload at phase 3's widths through
    ``TorchBackend(verify=True)`` (the static analyzer over every
    instance, then the walk), against the same workload through phase
    3's ``verify=False`` backend ``be_off``: outputs equal entry by
    entry, the same walk launches (one a structural group). The oracle
    (``get_backend("oracle")``) re-runs the first ``N_CHECK`` entries of
    each group: the outputs must equal its. Each prototype also goes
    through the default pass pipeline in its self-checking mode
    (``PassPipeline(verify=True)``: the analyzer after every pass) and
    must come out planned as it went in. Last, a mutant workload must be
    refused with ``KviVerificationError`` before any ``kvi_walk``
    launch. ``warm_walls`` are phase 3's warm walls by workload."""
    import torch
    from repro_torch.kernels import kvi_walk as kw
    from repro_torch.kvi import KviWorkload, get_backend
    from repro_torch.kvi.analysis import KviVerificationError
    from repro_torch.kvi.passes import META_KEY, PassPipeline
    be = get_backend("torch", device=device, passes=(), verify=True)
    oracle = get_backend("oracle", passes=())
    on_card = torch.device(device).type == "cuda"
    records = []
    for name, wl, want in main_path_workloads(rng, scale):
        w0 = be_off.walk_calls
        off = be_off.run_workload(wl)
        w1 = be.walk_calls
        on = be.run_workload(wl)
        walks = (be_off.walk_calls - w0, be.walk_calls - w1)
        same_results(name, on, off)
        check_outputs(name, on, want)
        if walks[0] != walks[1] or walks[1] != (on.meta["groups"]
                                                if on_card else 0):
            raise AssertionError(f"{name}: walk launches {walks} "
                                 f"(verify=False, verify=True), want one "
                                 f"per group each")
        seen, idx = {}, []
        for i, e in enumerate(wl.entries):
            key = (id(e.program.items), e.hart)
            if seen.get(key, 0) < N_CHECK:
                seen[key] = seen.get(key, 0) + 1
                idx.append(i)
        ref = oracle.run_workload(KviWorkload(wl.name, tuple(
            wl.entries[i] for i in idx)))
        for j, i in enumerate(idx):
            for key, arr in ref.entry_results[j].outputs.items():
                if not np.array_equal(on.entry_results[i].outputs[key], arr):
                    raise AssertionError(f"{name}: entry {i} output {key} "
                                         f"differs from the oracle")
        rec = dict(phase=name, N=len(wl.entries), walk_launches=walks[1],
                   analyzer_host_s=round(be.host_s["verify_s"], 6),
                   verified_wall_s=on.meta["wall_s"],
                   warm_wall_s=warm_walls.get(name),
                   unverified_wall_s=off.meta["wall_s"],
                   oracle_entries=len(idx))
        records.append(rec)
        log(f"[verify] {json.dumps(rec)}")
        del off, on
    protos = 0
    for name, proto, _ in main_path_structures(rng, scale):
        out = PassPipeline.from_spec(None, verify=True).run(proto)
        if out.meta.get(META_KEY) != proto.meta.get(META_KEY):
            raise AssertionError(f"{name}: the verified pipeline planned "
                                 f"the prototype anew")
        protos += 1
    bad, label = mutant_workload(rng)
    before = kw.launch_count
    try:
        be.run_workload(bad)
    except KviVerificationError as e:
        refusal = str(e).splitlines()[0]
    else:
        raise AssertionError("the mutant workload ran under verify=True")
    if kw.launch_count != before:
        raise AssertionError("the refused workload launched kvi_walk")
    log(f"[verify] {protos} prototypes through the self-checking pass "
        f"pipeline unchanged; mutant {label} refused before any kvi_walk "
        f"launch: {refusal}")
    return records


def main_path_structures(rng, scale: int = 1):
    """(name, prototype, N) of the main path's six structures, N as
    phase 3 runs them (divided by ``scale``)."""
    return [("conv32_f3", conv_instances(rng, 1, F=3)[0][0], 1024 // scale),
            ("conv32_f11", conv_instances(rng, 1, F=11)[0][0],
             1024 // scale),
            ("fft256", fft_instances(rng, 1)[0][0], 1024 // scale),
            ("matmul64_kdotp", matmul_instances(rng, 1)[0][0], 128 // scale),
            ("matmul64_kdotpps", matmul_instances(rng, 1, shift=8)[0][0],
             128 // scale),
            ("pipeline_demo", demo_instances(rng, 1)[0][0], 1024 // scale)]


def check_walks(rng, device, scale: int = 1, big_lanes: int = 30000):
    """Phase 2 for the walk kernel: ``checks.check_walk`` (the kernel
    against ``run_walk_plain`` on the same tensors, every store stack
    bit for bit) on every main-path structure at its batch, conv32_f3
    again in the global layout over a grid of 7 blocks (rows stride over
    it), random programs at eb 1/2/4 (one over a grid of 5), and every
    edge program of ``checks.walk_edge_programs`` (the hazard one in
    both layouts). Returns the number of cases and the layouts seen."""
    from repro_torch.kernels import checks
    from repro_torch.kvi.ir import KviProgramBuilder
    cases = []
    for name, proto, N in main_path_structures(rng, scale):
        walk = checks.compile_walk(proto)
        cases.append((name, walk, N, {}))
        if name == "conv32_f3":
            cases.append((name + " global", walk, N,
                          dict(smem_cap=0, max_grid=7)))
    for eb in (1, 2, 4):
        for seed in range(2):
            walk = checks.compile_walk(checks.random_kvi_program(
                KviProgramBuilder, np.random.default_rng(100 * eb + seed), eb))
            cases.append((f"random eb{eb} #{seed}", walk, 37,
                          dict(max_grid=5) if seed else {}))
    for name, prog in checks.walk_edge_programs(
            KviProgramBuilder, rng, big_lanes).items():
        walk = checks.compile_walk(prog)
        cases.append((name, walk, 33, {}))
        if name == "hazard":
            cases.append((name + " global", walk, 33, dict(smem_cap=0)))
    layouts = set()
    for _name, walk, N, opts in cases:
        layouts.add(checks.check_walk(rng, walk, max(2, N), device,
                                      **opts).layout)
    return {"cases": len(cases), "layouts": layouts}


def run_intrinsics(rng, device):
    """The KVI intrinsics of ``repro_torch.kernels.ops`` on the device at
    the main path's widths (1024 instances of 1024 int32 lanes for the
    element-wise calls, a 65536-element dot product for the reductions),
    each against a numpy formula bit for bit. Returns the number of
    element-wise and reduction calls."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.checks import random_ints
    a, w, b = (random_ints(rng, (1024, 1024), torch.int32, device)
               for _ in range(3))
    x, y = (random_ints(rng, (65536,), torch.int32, device)
            for _ in range(2))
    A, W, B = (t.cpu().numpy().astype(np.int64) for t in (a, w, b))
    X, Y = (t.cpu().numpy().astype(np.int64) for t in (x, y))
    w32 = lambda v: v.astype(np.int32)                       # noqa: E731
    ew = {"fused_mac_relu": (ops.fused_mac_relu(a, w, b, 5),
                             np.maximum(w32(w32(A * W) + B) >> 5, 0)),
          "kaddv": (ops.kaddv(a, b), w32(A + B)),
          "ksvmulsc": (ops.ksvmulsc(a, 77), w32(A * 77))}
    red = {"kdotp": (ops.kdotp(x, y), w32(np.sum(X * Y))),
           "kdotpps": (ops.kdotpps(x, y, 8), w32(np.sum(X * Y)) >> 8),
           "kvred": (ops.kvred(x), w32(np.sum(X)))}
    for name, (got, want) in {**ew, **red}.items():
        if not np.array_equal(got.cpu().numpy(), want):
            raise AssertionError(f"ops.{name} differs from its numpy formula")
    return len(ew), len(red)


def walk_cost(walk, record, N):
    """Bytes (each input stack read once, each store stack written once)
    and 32-bit integer operations (an op a lane of a fused step, two a
    lane pair of a dot product, one a lane of a sum) of one walk over N
    instances."""
    nbytes = N * sum(w * np.dtype(h).itemsize
                     for h, w in walk.in_width.items())
    nbytes += N * sum(w * dt.itemsize for dt, w in walk.st_width.items())
    ops = 0
    for step in walk.steps:
        if step[0] == "fused":
            ops += len(step[1].ops) * step[3].n
        elif step[0] == "reduce":
            ops += step[4] * (2 if step[7] is not None else 1)
    return nbytes, ops * N


def events_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn`` over ``reps`` back-to-back calls
    after one warm-up, from CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_walks(rng, device, sweep=(32, 64, 128)):
    """The walk kernel per main-path structure at its batch (one launch),
    beside the per-step route it replaced (``run_walk_per_step``: one
    ``fused_vops`` / ``kdotp`` launch per step, one device copy per copy
    step; its device total from a profiler trace of one call), its plain
    version (CUDA events) and its bound, and at each block size of
    ``sweep``. The walk's ``ms`` is its CUDA-event time over back-to-back
    launches (the launch is all its call does); ``profiler_ms`` is what a
    profiler trace of as many launches holds, which can miss launches of
    the longer walks. Launch counters are set back afterwards."""
    import torch
    from repro_torch.kernels import checks, micro
    from repro_torch.kernels import fused_vops as fv
    from repro_torch.kernels import kdotp as kd
    from repro_torch.kernels import kvi_walk as kw
    saved = (fv.launch_count, kd.launch_count, kw.launch_count)
    out = {}
    for name, proto, N in main_path_structures(rng):
        walk = checks.compile_walk(proto)
        record = kw.pack_walk(walk)
        ins = [checks.random_stack(rng, k, N, record.width(k), device)
               for k in record.in_keys]
        sts = [torch.empty((N, record.width(k)), dtype=k[1], device=device)
               for k in record.st_keys]

        def call(f, rec=record, ins=ins, sts=sts, N=N):
            return lambda: f(rec, ins, sts, N)
        walk_fn = call(kw.run_walk)
        reps = micro.reps_for(walk_fn)
        prof = micro.timed(walk_fn, reps, "kvi_walk_kernel")
        ms = prof["call_ms"]
        step = micro.timed(call(kw.run_walk_per_step), 1)
        plain_ms = events_ms(call(kw.run_walk_plain), 1)
        nbytes, ops = walk_cost(walk, record, N)
        b = micro.bound(nbytes, [(ops, "int32")])
        out[name] = dict(
            ms=ms, ms_source="events", call_ms=ms,
            profiler_ms=prof["device_ms"], plain_ms=plain_ms,
            plain_call_ms=plain_ms, library_ms=None, library_call_ms=None,
            **b, per_step_ms=step["device_ms"],
            per_step_call_ms=step["call_ms"], N=N, steps=record.n_steps,
            threads=record.threads, smem_bytes=record.smem_bytes,
            layout=record.layout, ring=record.ring,
            barriers=record.counts["barriers"],
            threads_sweep_ms={t: events_ms(call(kw.run_walk, kw.pack_walk(
                walk, threads=t)), reps) for t in sweep})
        del ins, sts
        torch.cuda.empty_cache()
    fv.launch_count, kd.launch_count, kw.launch_count = saved
    return out


# ---------------------------------------------------------------------------
# serving: python -m repro_torch.kvi.serving's default configuration
# ---------------------------------------------------------------------------

#: the CLI's default (the reference's full serving setting): DEFAULT_MIX,
#: 256 Poisson requests, mean gap 40 cycles, 1000 clients, 3 harts,
#: max_batch 8
SERVE = dict(requests=256, gap=40.0, clients=1000, harts=3, max_batch=8)
#: rounds of timed serving runs (two batched, one unbatched each): the
#: batching speed-up is read from the slowest batched run of all
SERVE_ROUNDS = 3


def _watch(be):
    """Wrap ``be.run_workload`` to record each call's batch size, and for
    the serving loop's calls (workloads named ``serve.*``; prewarm batches
    are ``prewarm.*``) their workloads and results, their wall seconds
    (``backend_s``) and their summed host split (``TorchBackend.host_s``).
    Raises when a result holds another number of entries than its
    workload."""
    log = {"sizes": [], "host_s": {}, "backend_s": 0.0, "served": []}
    run = be.run_workload

    def run_workload(wl, verify=None):
        t0 = time.perf_counter()
        res = run(wl, verify)
        dt = time.perf_counter() - t0
        if len(res.entry_results) != len(wl.entries):
            raise AssertionError(f"{wl.name}: {len(res.entry_results)} "
                                 f"results for {len(wl.entries)} entries")
        log["sizes"].append(len(wl.entries))
        if wl.name.startswith("serve."):
            log["backend_s"] += dt
            log["served"].append((wl, res))
            for k, v in be.host_s.items():
                log["host_s"][k] = log["host_s"].get(k, 0.0) + v
        return res
    be.run_workload = run_workload
    return log


@contextlib.contextmanager
def gc_clock():
    """Seconds spent in Python's garbage collector, and its collections by
    generation, while the block runs (``gc.callbacks``)."""
    rec = {"gc_s": 0.0, "collections": [0, 0, 0]}
    start = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            rec["gc_s"] += time.perf_counter() - start[0]
            rec["collections"][info["generation"]] += 1
    gc.callbacks.append(on_gc)
    try:
        yield rec
    finally:
        gc.callbacks.remove(on_gc)


def served_outputs(watch):
    """The outputs of every request a serving run executed, in execution
    order (the same request order batched and unbatched)."""
    return [(e.program, r.outputs) for wl, res in watch["served"]
            for e, r in zip(wl.entries, res.entry_results)]


def same_outputs(got, want):
    """True when two output dicts hold the same arrays bit for bit, dtype
    included."""
    return got.keys() == want.keys() and all(
        got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
        for k in want)


def walk_launch_ms(prof):
    """Device ms of each ``kvi_walk`` launch in a profiler trace, in
    launch order (empty when the trace holds no device time)."""
    evs = [e for e in prof.events() if str(e.device_type).endswith("CUDA")
           and "kvi_walk_kernel" in e.name]
    evs.sort(key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in evs]


def run_serve(device, seed, log=print):
    """Phase 3b: ``ServeEngine.run`` over ``get_backend("torch",
    passes=())`` on ``device`` at :data:`SERVE`, in :data:`SERVE_ROUNDS`
    rounds of two batched runs and one unbatched, each on a fresh backend,
    with every launch counter set to 0 just before and read just after.
    Asserts byte-identical canonical reports (batched with batched,
    unbatched with unbatched), a steady hit rate of 1.0 with no rebuild in
    the loop, exactly one ``kvi_walk`` launch per bucket and per prewarm
    batch and no ``fused_vops`` / ``kdotp`` launch, every run's served
    outputs equal to the first run's and those equal to the oracle, request
    by request; then a batched run under the profiler (device ms by bucket
    size) and the oracle gate: 8 instances of every template, batched on
    the device at 1, 2, 4 and 8, equal to the oracle and to the CPU backend
    bit for bit. The batching speed-up is each round's unbatched
    ``execute_s`` over each of its batched ones, and the least of them is
    held against the reference's 2x; each run's split (the backend's
    calls, their host split, the garbage collector) stands beside it.
    Returns the record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import fused_vops as fv
    from repro_torch.kernels import kdotp as kd
    from repro_torch.kernels import kvi_walk as kw
    from repro_torch.kvi import get_backend
    from repro_torch.kvi.serving import (DEFAULT_MIX, ServeEngine,
                                         canonical_report, make_templates,
                                         poisson_arrivals)
    from repro_torch.kvi.serving.checks import (CHECK_SIZES,
                                                check_against_oracle)
    templates = make_templates(DEFAULT_MIX, smoke=False, seed=seed)
    specs = poisson_arrivals(templates, SERVE["requests"], SERVE["gap"],
                             n_clients=SERVE["clients"], seed=seed)

    def serve(batching):
        be = get_backend("torch", passes=(), device=device)
        watch = _watch(be)
        with gc_clock() as gcr:
            rep = ServeEngine(templates, n_harts=SERVE["harts"], backend=be,
                              batching=batching, max_batch=SERVE["max_batch"],
                              seed=seed).run(specs)
        prewarm = len(templates) * (SERVE["max_batch"].bit_length()
                                    if batching else 1)
        want = sum(rep["batch_sizes"].values()) + prewarm
        if be.walk_calls != want or len(watch["sizes"]) != want:
            raise AssertionError(
                f"serve (batching={batching}): {be.walk_calls} walk "
                f"launches over {len(watch['sizes'])} batches, want {want}"
                f" (one per bucket and per prewarm batch)")
        cc = rep["compile_cache"]
        if cc["steady_hit_rate"] != 1.0 or cc["loop_misses"]:
            raise AssertionError(f"serve (batching={batching}): records "
                                 f"rebuilt in the loop: {cc}")
        split = dict(batching=batching,
                     execute_s=rep["throughput"]["execute_s"],
                     backend_s=round(watch["backend_s"], 6),
                     host_s={k: round(v, 6)
                             for k, v in watch["host_s"].items()},
                     gc_s=round(gcr["gc_s"], 6),
                     gc_collections=gcr["collections"])
        return rep, be.walk_calls, watch, split

    fv.launch_count = kd.launch_count = kw.launch_count = 0
    rounds = [[serve(True), serve(True), serve(False)]
              for _ in range(SERVE_ROUNDS)]
    torch.cuda.synchronize()
    runs = [r for rnd in rounds for r in rnd]
    launches = kw.launch_count
    if fv.launch_count or kd.launch_count:
        raise AssertionError(f"serving launched per-step kernels: fused_vops"
                             f" {fv.launch_count}, kdotp {kd.launch_count}")
    if launches != sum(r[1] for r in runs):
        raise AssertionError(f"kvi_walk launches {launches} disagree with "
                             f"the backends' {[r[1] for r in runs]}")
    batched = [r for r in runs if r[3]["batching"]]
    unbatched = [r for r in runs if not r[3]["batching"]]
    for group in (batched, unbatched):
        if len({canonical_report(r[0]) for r in group}) != 1:
            raise AssertionError("serving runs of one kind gave different "
                                 "canonical reports")
    rep_a, walks_a, watch_a, _ = batched[0]
    rep_u, walks_u, _, _ = unbatched[0]
    if seed == 0 and {(r[1], r[3]["batching"]) for r in runs} != {
            (59, True), (260, False)}:
        raise AssertionError(f"walk launches {[r[1] for r in runs]}; the "
                             f"seed-0 stream needs 59 batched, 260 unbatched")

    # every run served the same outputs, and they are the oracle's
    oracle = get_backend("oracle")
    first = served_outputs(watch_a)
    if len(first) != SERVE["requests"]:
        raise AssertionError(f"the batched run served {len(first)} requests"
                             f" of {SERVE['requests']}")
    for j, (_, _, watch, split) in enumerate(runs):
        outs = served_outputs(watch)
        if len(outs) != len(first) or not all(
                same_outputs(o, f) for (_, o), (_, f) in zip(outs, first)):
            raise AssertionError(f"serving run {j} (batching="
                                 f"{split['batching']}) served other outputs "
                                 f"than run 0")
    for i, (prog, outs) in enumerate(first):
        if not same_outputs(outs, oracle.run(prog).outputs):
            raise AssertionError(f"served request {i} ({prog.name}) differs "
                                 f"from the oracle")

    # the device time of each launch of one more batched run, by bucket
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, watch_p, _ = serve(True)
        torch.cuda.synchronize()
    per_launch = walk_launch_ms(prof)
    by_bucket = None
    if per_launch:
        if len(per_launch) != len(watch_p["sizes"]):
            raise AssertionError(f"the profiler holds {len(per_launch)} "
                                 f"walk launches of {len(watch_p['sizes'])}")
        by_bucket = {}
        for size, ms in zip(watch_p["sizes"], per_launch):
            b = by_bucket.setdefault(str(size), {"launches": 0, "ms": 0.0})
            b["launches"] += 1
            b["ms"] += ms
        for b in by_bucket.values():
            b["ms_per_launch"] = b["ms"] / b["launches"]

    compared = check_against_oracle(
        templates, seed, get_backend("torch", passes=(), device=device),
        others=(get_backend("torch", passes=(), device="cpu"),))
    want = len(templates) * (sum(CHECK_SIZES) + max(CHECK_SIZES))
    if compared != want:
        raise AssertionError(f"the oracle gate compared {compared} entries, "
                             f"want {want}")
    splits = []
    for rnd in rounds:
        t_u = rnd[2][3]["execute_s"]
        for _, _, _, split in rnd:
            if split["batching"]:
                split["speedup_x"] = t_u / max(split["execute_s"], 1e-9)
            splits.append(split)
    speedup = min(s["speedup_x"] for s in splits if s["batching"])
    tb, tu = rep_a["throughput"], rep_u["throughput"]
    cc = rep_a["compile_cache"]
    rec = dict(
        config=dict(SERVE, mix=sorted(templates), seed=seed,
                    rounds=SERVE_ROUNDS),
        n_steps=rep_a["n_steps"], batch_sizes=rep_a["batch_sizes"],
        execute_s=dict(batched=[r[3]["execute_s"] for r in batched],
                       unbatched=[r[3]["execute_s"] for r in unbatched]),
        batching_speedup_x=speedup, speedup_ge_2x=speedup >= 2.0,
        prewarm_s=tb["prewarm_s"], req_per_s=dict(
            batched=tb["req_per_s"], unbatched=tu["req_per_s"]),
        latency_cycles={k: rep_a["latency_cycles"][k] for k in ("p50",
                                                                 "p99")},
        compile_cache={k: cc[k] for k in ("hits", "misses", "entries",
                                          "loop_misses", "steady_hit_rate")},
        walk_launches=dict(batched=walks_a, unbatched=walks_u, total=launches),
        runs=splits, deterministic=True, served_equal_oracle=len(first),
        oracle_entries=compared, device_ms_by_bucket=by_bucket)
    log(f"[serve] {json.dumps(rec)}")
    return rec


#: phase 3t's disabled-path gates: ``TorchBackend(obs=NULL_OBS)`` against
#: ``obs=None`` on warm runs of one phase-3 workload. The reference's form:
#: the least of ``pairs`` back-to-back paired ratios, each side ``runs``
#: runs. On the card also the median of ``rounds`` interleaved ratios,
#: each round one run a side in the order None, NULL_OBS, NULL_OBS, None
#: (drift cancels), which resolves a 2 % overhead; the same rounds of
#: ``obs=None`` against a second ``obs=None`` backend are the control
TELEMETRY_GATE = dict(workload="pipeline_demo", pairs=15, runs=5,
                      rounds=200, bound=1.02)


def _backend_spans(obs, be, workloads):
    """Phase 3t's backend span: one live ``obs`` on ``be`` (phase 3's
    warm backend) over every phase-3 workload. Each run must add exactly
    one ``("torch", "run_workload")`` span whose args equal the run's
    ``meta`` and walk launches, and the ``torch.*`` counters must sum
    over the runs. Returns the runs' walk launches."""
    from repro_torch.kvi.obs import validate_trace
    tr = obs.tracer
    sums = {"runs": 0, "kernel_launches": 0, "walk_launches": 0,
            "compile_cache.hits": 0, "compile_cache.misses": 0}
    walls = []
    be.obs = obs
    try:
        for name, wl in workloads:
            n0, w0 = len(tr.events), be.walk_calls
            res = be.run_workload(wl)
            walks = be.walk_calls - w0
            new = tr.events[n0:]
            want = {"entries": len(wl.entries),
                    "groups": res.meta["groups"],
                    "kernel_launches": res.meta["kernel_launches"],
                    "walk_launches": walks}
            if len(new) != 1 or new[0]["name"] != "run_workload" or \
                    new[0]["clock"] != "wall" or new[0].get("args") != want:
                raise AssertionError(f"{name}: backend spans {new}, want one "
                                     f"run_workload span with args {want}")
            sums["runs"] += 1
            sums["kernel_launches"] += res.meta["kernel_launches"]
            sums["walk_launches"] += walks
            for k in ("hits", "misses"):
                sums[f"compile_cache.{k}"] += res.meta["compile_cache"][k]
            walls.append(res.meta["wall_s"])
            del res
    finally:
        be.obs = None
    trace = tr.to_chrome()
    errs = validate_trace(trace)
    tracks = {(ev["args"]["name"]) for ev in trace["traceEvents"]
              if ev["ph"] == "M"}
    snap = obs.metrics.snapshot()
    got = {k: snap["counters"].get(f"torch.{k}") for k in sums}
    hist = snap["histograms"]["torch.run_wall_s"]
    if errs or tracks != {"torch", "run_workload"} or got != sums or \
            hist["count"] != len(walls) or sorted(
                float(k) for k, n in hist["buckets"].items()
                for _ in range(n)) != sorted(walls):
        raise AssertionError(f"backend telemetry over phase 3: {errs[:3]}, "
                             f"tracks {tracks}, counters {got} against "
                             f"{sums}, wall histogram {hist['count']} of "
                             f"{len(walls)}")
    return sums["walk_launches"]


def _disabled_ratios(device, wl, rounds):
    """The disabled path's cost on warm runs of ``wl``
    (:data:`TELEMETRY_GATE`): ``pairs`` paired ratios of
    ``TorchBackend(obs=NULL_OBS)`` over ``TorchBackend(obs=None)``, each
    side ``runs`` runs back to back (as the reference's 2 % gate times
    its cycle simulator), whose least must be within the bound; then
    ``rounds`` interleaved ratios, NULL_OBS and the control (a second
    ``obs=None`` backend) each over ``obs=None``, whose NULL_OBS median
    must be within the bound on the card (a shared CPU host swings too
    far for it). Returns the three lists of ratios."""
    import torch
    from repro_torch.kvi import get_backend
    from repro_torch.kvi.obs import NULL_OBS, NULL_TRACER
    base = get_backend("torch", device=device, passes=())
    nul = get_backend("torch", device=device, passes=(), obs=NULL_OBS)
    twin = get_backend("torch", device=device, passes=())
    for b in (base, nul, twin, base, nul, twin):    # build the walks, warm
        b.run_workload(wl)

    def sample(be, runs):
        t0 = time.perf_counter()
        for _ in range(runs):
            be.run_workload(wl)
        return time.perf_counter() - t0

    def interleaved(other):
        out = []
        for _ in range(rounds):
            t = [sample(be, 1) for be in (base, other, other, base)]
            out.append((t[1] + t[2]) / (t[0] + t[3]))
        return out
    runs = TELEMETRY_GATE["runs"]
    pairs = [sample(nul, runs) / sample(base, runs)
             for _ in range(TELEMETRY_GATE["pairs"])]
    inter, control = interleaved(nul), interleaved(twin)
    if NULL_TRACER.events or NULL_OBS.metrics.snapshot()["counters"]:
        raise AssertionError("the disabled bundle recorded something")
    bound = TELEMETRY_GATE["bound"]
    on_card = torch.device(device).type == "cuda"
    if min(pairs) > bound or (on_card and np.median(inter) > bound):
        raise AssertionError(f"obs=NULL_OBS over obs=None: least paired "
                             f"ratio {min(pairs)}, median interleaved "
                             f"{np.median(inter)} (control "
                             f"{np.median(control)}), bound {bound}")
    return pairs, inter, control


def run_telemetry(device, seed, workloads, be, requests=None, rounds=3,
                  gate_rounds=TELEMETRY_GATE["rounds"], log=print):
    """Phase 3t: telemetry on the card. Serving at :data:`SERVE`
    (``requests`` cuts the stream) in ``rounds`` rounds of a run with
    telemetry off and one with ``Obs.on()`` on ``get_backend("torch",
    obs=...)`` and the engine, each on a fresh backend: the canonical
    reports byte-equal; every traced run's trace and metrics valid, its
    flows one a request, ``torch.walk_launches`` equal to the walk
    kernel's launch count over the run (one per bucket and prewarm batch:
    59 at seed 0), ``scheduler.admitted`` every request, the latency
    histogram's p50 / p99 the report's, and its canonical trace byte-equal
    to the same run's on the CPU backend. Then the CLI with
    ``--trace-out`` / ``--metrics-out`` (``python -m repro_torch.kvi.obs
    validate`` gives 0 on both files; ``view`` prints the report's
    makespan; the trace canonically the engine run's); the backend span
    over every phase-3 ``workloads`` entry on ``be``; the disabled-path
    gates (:data:`TELEMETRY_GATE`, ``gate_rounds`` interleaved rounds);
    and the enabled cost, the least traced ``execute_s`` over the least
    untraced one. Returns the record: every number in it measured or
    counted by this run."""
    import tempfile

    import torch

    from repro_torch.kernels import kvi_walk as kw
    from repro_torch.kvi import get_backend
    from repro_torch.kvi.obs import (Obs, canonical_trace, validate_metrics,
                                     validate_trace)
    from repro_torch.kvi.obs.__main__ import flow_summary
    from repro_torch.kvi.obs.__main__ import main as obs_main
    from repro_torch.kvi.serving import (DEFAULT_MIX, ServeEngine,
                                         canonical_report, make_templates,
                                         poisson_arrivals)
    from repro_torch.kvi.serving.__main__ import main as serve_main
    n = SERVE["requests"] if requests is None else requests
    on_card = torch.device(device).type == "cuda"
    templates = make_templates(DEFAULT_MIX, smoke=False, seed=seed)
    specs = poisson_arrivals(templates, n, SERVE["gap"],
                             n_clients=SERVE["clients"], seed=seed)

    def serve(obs, dev=device):
        b = get_backend("torch", passes=(), obs=obs, device=dev)
        w0 = kw.launch_count
        rep = ServeEngine(templates, n_harts=SERVE["harts"], backend=b,
                          max_batch=SERVE["max_batch"], seed=seed,
                          obs=obs).run(specs)
        if on_card:
            torch.cuda.synchronize()
        return rep, kw.launch_count - w0

    def canon(obs):
        return json.dumps(canonical_trace(obs.tracer.to_chrome()),
                          sort_keys=True)

    off_s, on_s, traced = [], [], None
    for _ in range(rounds):
        rep_off, _ = serve(None)
        obs = Obs.on()
        rep, walks = serve(obs)
        off_s.append(rep_off["throughput"]["execute_s"])
        on_s.append(rep["throughput"]["execute_s"])
        if canonical_report(rep) != canonical_report(rep_off):
            raise AssertionError("telemetry changed the canonical report")
        trace, snap = obs.tracer.to_chrome(), obs.metrics.snapshot()
        errs = validate_trace(trace) + validate_metrics(snap)
        flows = flow_summary(trace["traceEvents"])
        prewarm = len(templates) * SERVE["max_batch"].bit_length()
        want_walks = (sum(rep["batch_sizes"].values()) + prewarm
                      if on_card else 0)
        lat = snap["histograms"]["serving.latency_cycles"]
        got = dict(errors=errs[:3], flows=flows["requests"],
                   walk_launches=snap["counters"]["torch.walk_launches"],
                   admitted=snap["counters"]["scheduler.admitted"],
                   p50_p99=(lat["p50"], lat["p99"]))
        want = dict(errors=[], flows=n, walk_launches=walks,
                    admitted=n, p50_p99=(rep["latency_cycles"]["p50"],
                                         rep["latency_cycles"]["p99"]))
        if got != want or walks != want_walks or (
                on_card and seed == 0 and n == 256 and walks != 59):
            raise AssertionError(f"served telemetry {got}, want {want} and "
                                 f"{want_walks} walk launches")
        if traced is None:
            traced = (rep, obs, trace, snap, walks)
    rep, obs, trace, snap, walks = traced
    cpu_obs = Obs.on()
    serve(cpu_obs, "cpu")
    if canon(cpu_obs) != canon(obs):
        raise AssertionError("the card's canonical trace differs from the "
                             "CPU backend's")

    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: str(Path(tmp) / f"{k}.json")
                 for k in ("trace", "metrics", "report")}
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = serve_main(["--device", str(device), "--requests", str(n),
                             "--seed", str(seed), "--trace-out",
                             paths["trace"], "--metrics-out",
                             paths["metrics"], "--out", paths["report"]])
            rc_valid = obs_main(["validate", paths["trace"], "--metrics",
                                 paths["metrics"]])
            mark = out.tell()
            rc_view = obs_main(["view", paths["trace"], "--metrics",
                                paths["metrics"]])
        viewed = out.getvalue()[mark:]
        cli_rep = json.loads(Path(paths["report"]).read_text())
        makespan = cli_rep["throughput"]["makespan_cycles"]
        with open(paths["trace"]) as f:
            cli_canon = json.dumps(canonical_trace(json.load(f)),
                                   sort_keys=True)
        trace_bytes = Path(paths["trace"]).stat().st_size
    if (rc, rc_valid, rc_view) != (0, 0, 0) or \
            f"makespan={makespan} cycles" not in viewed or \
            makespan != rep["throughput"]["makespan_cycles"] or \
            cli_canon != canon(obs):
        raise AssertionError(f"the CLI with --trace-out / --metrics-out: "
                             f"exit codes {rc, rc_valid, rc_view}, makespan "
                             f"{makespan} in view: "
                             f"{f'makespan={makespan} cycles' in viewed}, "
                             f"trace canonically the engine run's: "
                             f"{cli_canon == canon(obs)}")

    w0 = kw.launch_count
    span_walks = _backend_spans(Obs.on(), be, workloads)
    if kw.launch_count - w0 != span_walks:
        raise AssertionError(f"backend spans count {span_walks} walk "
                             f"launches, the kernel {kw.launch_count - w0}")
    gate_wl = dict(workloads)[TELEMETRY_GATE["workload"]]
    pairs, inter, control = _disabled_ratios(device, gate_wl, gate_rounds)
    rec = dict(
        events=len(trace["traceEvents"]),
        metrics=sum(len(snap[k]) for k in ("counters", "gauges",
                                           "histograms")),
        trace_bytes=trace_bytes, flows=n, walk_launches=walks,
        backend_runs=len(workloads), backend_walk_launches=span_walks,
        disabled_ratio=min(pairs),
        disabled_ratio_median=float(np.median(pairs)),
        disabled_interleaved_median=float(np.median(inter)),
        control_interleaved_median=float(np.median(control)),
        execute_s=dict(off=off_s, on=on_s),
        enabled_over_disabled=min(on_s) / max(min(off_s), 1e-9))
    log(f"[telemetry] {json.dumps(rec)}")
    return rec


# ---------------------------------------------------------------------------
# slice 2: the paper's compute kernels, and their independent numpy formulas
# ---------------------------------------------------------------------------

def _np(t):
    import torch
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _within(name, got, want, tol) -> float:
    err = np.abs(got.astype(np.float64) - want)
    if not np.all(err <= tol):
        raise AssertionError(f"{name}: differs from the numpy formula by "
                             f"up to {err.max()} (allowed {np.min(tol)} "
                             f"and up)")
    return float(err.max()) if err.size else 0.0


def _np_correlate(padded, filt, rows=None):
    """Valid correlation in float64, or exact in int64 for integers; of
    the output ``rows`` only, where given."""
    F = filt.shape[0]
    H, W = padded.shape[0] - F + 1, padded.shape[1] - F + 1
    rows = np.arange(H) if rows is None else rows
    wide = np.int64 if padded.dtype.kind in "iu" else np.float64
    acc = np.zeros((len(rows), W), wide)
    for fr in range(F):
        for fc in range(F):
            acc += padded[rows + fr, fc:fc + W].astype(wide) \
                * wide(filt[fr, fc])
    return acc


def _formula_matmul(name, got, a, b, step):
    """The first and last ``FORMULA_ROWS`` rows: int8 as an int64 sum
    wrapped to int32, exactly; other operands against the float64
    product, within the probabilistic bound of one float32 sum
    (``checks.dot_tolerance``) plus ``step`` of the output's rounding
    (exact for integer operands whose sums float32 holds exactly)."""
    import torch
    from repro_torch.kernels.checks import dot_tolerance
    a, b, got = _np(a), _np(b), _np(got)
    M, K = a.shape
    rows = np.unique(np.r_[0:min(FORMULA_ROWS, M),
                           max(0, M - FORMULA_ROWS):M])
    if a.dtype == np.int8:
        want = (a[rows].astype(np.int64) @ b.astype(np.int64)).astype(
            np.int32)
        if not np.array_equal(got[rows], want):
            raise AssertionError(f"{name}: differs from the int64 sum")
        return 0.0
    a64, b64 = a[rows].astype(np.float64), b.astype(np.float64)
    want = a64 @ b64
    tol = dot_tolerance(torch.from_numpy(a64), torch.from_numpy(b64),
                        sums=1).numpy()
    return _within(name, got[rows], want, tol + step * np.abs(want))


def _formula_conv(name, got, img, filt, shift, pad, limit=1 << 30):
    """int32: the int64 sum wrapped to int32, then shifted, exactly;
    int8 / int16 / uint8: the int64 sum saturated to the dtype, exactly
    where every float32 partial sum is exact (sum of |terms| below 2^24),
    else within gamma(F^2) of the absolute terms plus 1 (the truncation);
    floats: the float64 sum within gamma(F^2) of the absolute terms, plus
    a bf16 step for a bf16 output. Past ``limit`` multiply-adds only the
    first and last ``FORMULA_ROWS`` output rows are formed."""
    from repro_torch.kernels.checks import gamma
    bf16 = str(got.dtype).endswith("bfloat16")
    img, filt, got = _np(img), _np(filt), _np(got)
    F = filt.shape[0]
    lo = F // 2 if pad else 0
    hi = F - 1 - F // 2 if pad else 0
    padded = np.pad(img, ((lo, hi), (lo, hi)))
    H = padded.shape[0] - F + 1
    rows = None
    if F * F * got.size > limit:
        rows = np.unique(np.r_[0:min(FORMULA_ROWS, H),
                               max(0, H - FORMULA_ROWS):H])
        got = got[rows]
    acc = _np_correlate(padded, filt, rows)
    if img.dtype == np.int32:
        want = acc.astype(np.int32) >> (shift if 0 <= shift <= 31 else 31)
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: differs from the int64 sum")
        return 0.0
    terms = _np_correlate(np.abs(padded.astype(np.float64)),
                          np.abs(filt.astype(np.float64)), rows)
    if img.dtype.kind in "iu":
        info = np.iinfo(img.dtype)
        tol = np.where(terms < 2.0 ** 24, 0.0, gamma(F * F) * terms + 1)
        return _within(name, got, np.clip(acc, info.min, info.max), tol)
    tol = gamma(F * F) * terms
    if bf16:
        tol = tol + 2.0 ** -7 * np.abs(acc)
    return _within(name, got, acc, tol)


def _formula_fft(name, got_re, got_im, re, im):
    """numpy's float64 FFT, within the reference test's tolerance
    (rtol 1e-3, atol 1e-3 n)."""
    want = np.fft.fft(_np(re).astype(np.float64)
                      + 1j * _np(im).astype(np.float64), axis=-1)
    n = want.shape[-1]
    return max(_within(f"{name} re", _np(got_re), want.real,
                       1e-3 * n + 1e-3 * np.abs(want.real)),
               _within(f"{name} im", _np(got_im), want.imag,
                       1e-3 * n + 1e-3 * np.abs(want.imag)))


def _formula_attention(name, got, q, k, v, causal, window, q_offset):
    """float64 softmax attention on the first and last ``FORMULA_ROWS``
    query rows of the first and the last head (a row that sees no key
    gives 0), within the JAX test's tolerance (2e-3 relative and
    absolute) plus one bf16 step of the output's rounding."""
    from repro_torch.kernels.checks import output_step
    B, H, Sq, hd = q.shape
    G = H // k.shape[1]
    rows = np.unique(np.r_[0:min(FORMULA_ROWS, Sq),
                           max(0, Sq - FORMULA_ROWS):Sq])
    k_pos = np.arange(k.shape[2])
    err = 0.0
    for b, h in {(0, 0), (B - 1, H - 1)}:
        qh = _np(q[b, h])[rows].astype(np.float64)
        kh = _np(k[b, h // G]).astype(np.float64)
        vh = _np(v[b, h // G]).astype(np.float64)
        s = qh @ kh.T / np.sqrt(hd)
        q_pos = q_offset + rows[:, None]
        vis = np.ones(s.shape, bool)
        if causal:
            vis &= q_pos >= k_pos[None, :]
        if window:
            vis &= q_pos - k_pos[None, :] < window
        s = np.where(vis, s, -np.inf)
        m = np.max(s, axis=1, keepdims=True)
        p = np.where(vis, np.exp(s - np.where(np.isfinite(m), m, 0.0)), 0.0)
        l = p.sum(axis=1, keepdims=True)
        want = (p @ vh) / np.where(l > 0, l, 1.0)
        tol = 2e-3 * (1 + np.abs(want))
        if got.dtype != q.dtype or got.shape != q.shape:
            raise AssertionError(f"{name}: output {got.dtype} "
                                 f"{tuple(got.shape)}")
        tol = tol + output_step(got.dtype) * np.abs(want)
        err = max(err, _within(f"{name} b{b} h{h}", _np(got[b, h])[rows],
                               want, tol))
    return err


def _formula_ssd(name, got, x, dt, A, B, C):
    """The SSD recurrence, one step at a time in float64 numpy, for the
    first and the last (batch, head): y and the final state within the
    JAX test's tolerance (3e-3 relative and absolute), plus one bf16 step
    for a bf16 y."""
    from repro_torch.kernels.checks import output_step
    Bz, S, H, P = x.shape
    rep = H // B.shape[2]
    y, state = got
    err = 0.0
    for b, h in {(0, 0), (Bz - 1, H - 1)}:
        xs = _np(x[b, :, h]).astype(np.float64)
        dts = _np(dt[b, :, h]).astype(np.float64)
        a = np.exp(dts * float(_np(A)[h]))
        Bs = _np(B[b, :, h // rep]).astype(np.float64)
        Cs = _np(C[b, :, h // rep]).astype(np.float64)
        st = np.zeros((P, Bs.shape[1]))
        want = np.empty((S, P))
        for t in range(S):
            st = st * a[t] + np.outer(dts[t] * xs[t], Bs[t])
            want[t] = st @ Cs[t]
        tol = (3e-3 + output_step(y.dtype)) * np.abs(want) + 3e-3
        err = max(err, _within(f"{name} y b{b} h{h}", _np(y[b, :, h]), want,
                               tol),
                  _within(f"{name} state b{b} h{h}", _np(state[b, h]), st.T,
                          3e-3 * (1 + np.abs(st.T))))
    return err


def formula_check(w, x, out) -> float:
    """The workload's output against a numpy formula that shares no code
    with the kernel or its plain version; the largest absolute
    difference."""
    from repro_torch.kernels.checks import output_step
    if w.kernel == "spm_matmul":
        return _formula_matmul(w.name, out, x["a"], x["b"],
                               output_step(out.dtype))
    if w.kernel == "spm_conv2d":
        return _formula_conv(w.name, out, x["img"], x["filt"], x["shift"],
                             pad=True)
    if w.kernel == "spm_fft":
        return _formula_fft(w.name, *out, x["re"], x["im"])
    if w.kernel == "flash_attention":
        return _formula_attention(w.name, out, x["q"], x["k"], x["v"],
                                  x["causal"], x["window"], x["q_offset"])
    if w.kernel == "ssd_scan":
        return _formula_ssd(w.name, out, x["x"], x["dt"], x["A"], x["B"],
                            x["C"])
    conv, ore, oim, mm = out
    return max(_formula_conv(f"{w.name} conv", conv, x["img"], x["filt"],
                             0, pad=False),
               _formula_fft(f"{w.name} fft", ore, oim, x["fre"], x["fim"]),
               _formula_matmul(f"{w.name} matmul", mm, x["A"], x["B"], 0.0))


def path_counts():
    """Launches of the two kernels with a tensor-core path, by path."""
    from repro_torch.kernels import micro
    return {k: {"tensor_cores": micro.MODULES[k].tc_launch_count,
                "cuda_cores": micro.MODULES[k].launch_count
                - micro.MODULES[k].tc_launch_count} for k in TC_KERNELS}


def run_compute_slice(device, rng, workloads, log=print, tag="slice2"):
    """Phase 4: every workload once through the intrinsics layer on
    ``device``, with the compute kernels' launch counters set to 0 just
    before and read just after; then each output against its plain
    version and its numpy formula. On the card each call must be one
    launch of its kernel (the SSD scan's three, one of each of its
    kernels), and each bf16 / int8 product and bf16 attention call one
    of the tensor-core kernel (float32 the CUDA-core one). Returns
    ``(inputs by name, launches, largest difference from the plain
    version by kernel, launches by path)``; ``tag`` heads the log lines
    (``slice2``: the paper's kernels, ``slice3``: attention and the SSD
    scan)."""
    import torch
    from repro_torch.kernels import micro
    from repro_torch.kernels import ssd_scan as ss
    inputs = {w.name: micro.make_inputs(w, rng, device) for w in workloads}
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    micro.reset_counts()
    outs = {w.name: micro.run_kernel(w, inputs[w.name]) for w in workloads}
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    launches = {k: mod.launch_count for k, mod in micro.MODULES.items()}
    ssd_launches = dict(ss.part_launches)
    paths = path_counts()
    calls = {k: sum(w.kernel == k for w in workloads) for k in micro.MODULES}
    tc_calls = {k: sum(w.kernel == k and micro.tensor_core_call(w)
                       for w in workloads) for k in TC_KERNELS}
    if torch.device(device).type == "cuda":
        want = {k: sum(micro.launches_per_call(k, w.shape) for w in workloads
                       if w.kernel == k) for k in micro.MODULES}
        if launches != want:
            raise AssertionError(f"launches {launches} are not the calls' "
                                 f"{want}")
        if ssd_launches != dict.fromkeys(ss.PARTS, calls["ssd_scan"]):
            raise AssertionError(f"SSD kernel launches {ssd_launches} are "
                                 f"not one of each per call")
        for k, n in tc_calls.items():
            if paths[k]["tensor_cores"] != n:
                raise AssertionError(f"{k}: {paths[k]} launches by path, "
                                     f"but {n} calls take the tensor cores")
    err = dict.fromkeys(micro.MODULES, 0.0)
    for w in workloads:
        x, out = inputs[w.name], outs.pop(w.name)
        e_plain = micro.compare_plain(w, x, out)
        e_formula = formula_check(w, x, out)
        err[w.kernel] = max(err[w.kernel], e_plain)
        log(f"[{tag}] {w.name}: {w.use}; {json.dumps(w.shape)}; equals "
            f"its plain version (max abs diff {e_plain}) and its numpy "
            f"formula (max abs diff {e_formula})")
        del out
    return inputs, launches, err, paths


def check_ssd_kernels(rng, device, row_shape):
    """Phase 2 for the SSD scan's three kernels: each against its plain
    version alone (``checks.check_ssd_parts``) at the odd shapes of
    ``checks.ssd_part_cases`` (float32 and bf16 x) and at the main
    path's row ``row_shape`` (float32), one launch of each per check;
    then the whole scan at the odd shapes against the float64 numpy
    recurrence. Returns the largest difference from the plain version
    by kernel."""
    import torch
    from repro_torch.kernels import checks, ops
    from repro_torch.kernels import ssd_scan as ss
    err = dict.fromkeys(ss.PARTS, 0.0)
    runs = [(shape, dt) for shape in checks.ssd_part_cases()
            for dt in checks.LM_TYPES] + [(row_shape, torch.float32)]
    before = dict(ss.part_launches)
    for shape, dt in runs:
        for k, e in checks.check_ssd_parts(rng, device=device, dtype=dt,
                                           **shape).items():
            err[k] = max(err[k], e)
    torch.cuda.synchronize()
    if ss.part_launches != {k: n + len(runs) for k, n in before.items()}:
        raise AssertionError(f"SSD kernel launches {ss.part_launches}, "
                             f"want {len(runs)} more of each than {before}")
    for shape in checks.ssd_part_cases():
        for dt in checks.LM_TYPES:
            args = checks.ssd_operands(rng, shape["Bz"], shape["S"],
                                       shape["H"], shape["P"], shape["N"], 1,
                                       device, dt)
            _formula_ssd(f"ssd_scan {json.dumps(shape)} {dt}",
                         ops.ssd_scan_op(*args, chunk=shape["chunk"]), *args)
    return err


# ---------------------------------------------------------------------------
# kernel timing
# ---------------------------------------------------------------------------

def time_ssd_parts(w, x):
    """Each of the SSD scan's three kernels alone at the workload's
    shapes, beside its plain version and its bound
    (``micro.ssd_part_costs``). The scan over chunks is timed on one
    workspace, updated in place call after call (its values grow, its
    work does not). Launch counters are set back afterwards."""
    from repro_torch.kernels import micro
    from repro_torch.kernels import ssd_scan as ss
    saved = micro.save_counts()
    xx, da, dt, B, C = ss.kernel_inputs(x["x"], x["dt"], x["A"], x["B"],
                                        x["C"])
    da, dt, B, C = (t.float().contiguous() for t in (da, dt, B, C))
    cs = ss.chunk_size(xx.shape[1], x["chunk"])
    states, cum = ss.chunk_state(xx, da, dt, B, cs)
    work = states.clone()
    h_in, _ = ss.state_pass(states, cum, cs)
    runs = {"ssd_chunk_state": (
                lambda: ss.chunk_state(xx, da, dt, B, cs),
                lambda: ss.chunk_state_plain(xx, da, dt, B, cs)),
            "ssd_state_pass": (
                lambda: ss.state_pass(work, cum, cs),
                lambda: ss.state_pass_plain(work, cum, cs)),
            "ssd_chunk_scan": (
                lambda: ss.chunk_scan(xx, dt, B, C, cum, h_in, cs),
                lambda: ss.chunk_scan_plain(xx, dt, B, C, cum, h_in, cs))}
    costs = micro.ssd_part_costs(w.shape)
    out = {}
    for name, (kern, plain) in runs.items():
        t = micro.times(micro.timed(kern, micro.reps_for(kern),
                                    f"{name}_kernel"),
                        micro.timed(plain, micro.reps_for(plain)))
        out[name] = dict(t, **micro.bound(*costs[name]))
    micro.restore_counts(saved)
    return out


def time_conv_harts(w, x):
    """The composite's kernel time with its conv hart staging the whole
    (31 + F)^2 window (``conv_tile``, the route at F up to
    ``het_mimd.STREAM_F``) and streaming the input rows
    (``conv_rows_tile``, forced by setting ``STREAM_F`` to 0), in turns
    staged, streamed, streamed, staged; each route's two readings and
    the outputs of both routes held equal."""
    import torch
    from repro_torch.kernels import het_mimd as hm
    from repro_torch.kernels import micro
    out = {"staged": [], "streamed": []}
    keep = hm.STREAM_F
    try:
        for route in ("staged", "streamed", "streamed", "staged"):
            hm.STREAM_F = keep if route == "staged" else 0
            out[route].append(micro.time_kernel(w, x)["ms"])
        hm.STREAM_F = 0
        streamed = micro.run_kernel(w, x)[0]
    finally:
        hm.STREAM_F = keep
    staged = micro.run_kernel(w, x)[0]
    if not torch.equal(streamed, staged):
        raise AssertionError("the two conv harts differ")
    return out


def time_fused(rng, device):
    """fused_vops on the first region of conv2d 32x32 F = 3 (the
    conv32_f3 phase), N = 1024, in the backend's own register file."""
    import torch
    from repro_torch.kernels import fused_vops as fv
    from repro_torch.kernels.checks import random_ints
    from repro_torch.kernels.micro import timed, times
    from repro_torch.kvi import get_backend
    progs, _ = conv_instances(rng, 1)
    walk = get_backend("torch", device=device)._compile(progs[0])
    _, region, reg, win = next(s for s in walk.steps if s[0] == "fused")
    N = 1024
    rf = random_ints(rng, (N, walk.reg_width[reg[1]]), reg[1], device)
    record = fv.pack_program(region.ops, [s for _, s in region.inputs],
                             [s for _, s in region.outputs],
                             region.n_slots, torch.device(device))
    before = fv.launch_count
    t = times(timed(lambda: fv.fused_vops(record, win, rf, rf), 200,
                    "fused_vops_kernel"),
              timed(lambda: fv.fused_vops_plain(record, win, rf, rf), 10))
    fv.launch_count = before          # timing launches are not the path's
    n_io = len(region.inputs) + len(region.outputs)
    return dict(t, bytes=n_io * N * region.length * 4
                + record.prog.numel() * 8,
                ops=len(region.ops) * N * region.length,
                shape=f"conv32_f3 region 0: {len(region.ops)} ops, "
                      f"{len(region.inputs)} in, {len(region.outputs)} out, "
                      f"N={N}, n={region.length}, int32")


def time_kdotp(rng, device):
    """reduce_rows as the streamed matmul64 issues it: 128 rows of 64
    int32 pairs into one int32 column (no one PyTorch call computes an
    integer row dot product on the card); and the kvred form at the same
    shape beside torch.sum, the one library call computing it."""
    import torch
    from repro_torch.kernels import kdotp as kd
    from repro_torch.kernels.checks import random_ints
    from repro_torch.kernels.micro import timed, times
    N, n = 128, 64
    rf = random_ints(rng, (N, 3 * n + 1), torch.int32, device)
    a, b, out = rf[:, :n], rf[:, n:2 * n], rf[:, 3 * n]
    before = kd.launch_count
    t = times(timed(lambda: kd.reduce_rows(out, a, b), 500,
                    "reduce_rows_kernel"),
              timed(lambda: kd.reduce_rows_plain(out, a, b), 50))
    x = a.contiguous()
    red = times(timed(lambda: kd.reduce_rows(out, a), 500,
                      "reduce_rows_kernel"),
                timed(lambda: kd.reduce_rows_plain(out, a), 50),
                timed(lambda: torch.sum(x, dim=1, dtype=torch.int64), 500))
    got = torch.empty(N, dtype=torch.int32, device=device)
    kd.reduce_rows(got, a)
    if not torch.equal(got, torch.sum(a, dim=1, dtype=torch.int64).to(
            torch.int32)):
        raise AssertionError("kvred differs from torch.sum")
    kd.launch_count = before
    return dict(t, bytes=2 * N * n * 4 + N * 4, ops=2 * N * n,
                kvred={k: red[k] for k in ("ms", "call_ms", "library_ms",
                                           "library_call_ms")},
                shape=f"matmul64 kdotp: N={N} rows, n={n}, int32")


def conv_blocks(device):
    """Rows a thread, threads a block, tiles and dynamic shared memory a
    block (bytes) of each ``spm_conv2d`` workload of phase 4, as the
    wrapper launches them."""
    from repro_torch.kernels import micro
    from repro_torch.kernels import spm_conv2d as sc
    sms = sc.sm_count(device)
    out = {}
    for w in micro.CARD:
        if w.kernel == "spm_conv2d":
            H, W, F = w.shape["H"], w.shape["W"], w.shape["F"]
            rows = sc.rows_per_thread(H, W, sms)
            tx = sc.block_threads(H, W, rows, sms)
            out[w.name] = dict(rows=rows, threads=tx,
                               tiles=sc.tiles(H, W, tx, rows),
                               smem_bytes=sc.smem_bytes(
                                   micro.DTYPES[w.shape["dtype"]], F, tx))
    return out


def _bound(t):
    """Slice 1's kernels run 32-bit integer operations."""
    from repro_torch.kernels.micro import bound
    b = bound(t["bytes"], [(t["ops"], "int32")])
    return b["bound_ms"], b["bound_by"]


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch; run it from "
              f"the repository checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, checks, micro
    from repro_torch.kernels import fused_vops as fv
    from repro_torch.kernels import kdotp as kd
    from repro_torch.kernels import kvi_walk as kw
    from repro_torch.kernels import ssd_scan as ss

    device = torch.device("cuda", torch.cuda.current_device())
    micro.card_settings()
    card = micro.card_line()
    t0 = time.perf_counter()
    t_phase = [t0]

    def stamp(phase):
        now = time.perf_counter()
        print(f"[phase] {phase}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    # 1. build -------------------------------------------------------------
    nvcc = build.nvcc_path()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True, timeout=60
                              ).stdout.strip().splitlines()[-1]
    print(f"[build] torch {torch.__version__} (CUDA {torch.version.cuda}),"
          f" {nvcc_ver}; card: {card}")
    tb = time.perf_counter()
    paths = build.build()
    print(f"[build] {len(paths)} libraries in "
          f"{time.perf_counter() - tb:.1f} s: "
          + ", ".join(p.name for p in paths.values()))
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] spm_conv2d blocks: {json.dumps(conv_blocks(device))}")

    stamp("build")

    # 2. kernel vs plain on the card ---------------------------------------
    rng = np.random.default_rng(args.seed)
    before = kw.launch_count
    walk_checks = check_walks(rng, device)
    torch.cuda.synchronize()
    if kw.launch_count - before != walk_checks["cases"] or \
            walk_checks["layouts"] != {"shared", "global"}:
        raise AssertionError(f"walk checks {walk_checks}: "
                             f"{kw.launch_count - before} launches")
    print(f"[check] kvi_walk equals run_walk_plain bit for bit in "
          f"{walk_checks['cases']} cases (main-path structures, random "
          f"programs at eb 1/2/4, edge programs; layouts "
          f"{sorted(walk_checks['layouts'])}); card: {card}")
    err = {"kvi_walk": 0.0, "fused_vops": 0.0, "kdotp": 0.0}
    for label, shape in checks.main_path_cases():
        if label.startswith("fused"):
            for dt in (torch.int8, torch.int16, torch.int32):
                err["fused_vops"] = max(err["fused_vops"], checks.check_fused(
                    rng, dt, device=device, **shape))
                if shape["n"] >= 2:
                    checks.check_fused(rng, dt, device=device, hazard=True,
                                       **shape)
        else:
            for dt in (torch.int8, torch.int16, torch.int32):
                for post, s in ((kd.POST_NONE, 0), (kd.POST_SHIFT, 8),
                                (kd.POST_ADD, -(1 << 33)),
                                (kd.POST_MUL, 2_000_000_011)):
                    err["kdotp"] = max(err["kdotp"], checks.check_reduce(
                        rng, dt, device=device, post=post, scalar=s,
                        dot=post in (kd.POST_NONE, kd.POST_SHIFT), **shape))
                checks.check_reduce(rng, dt, device=device, post=kd.POST_SHIFT,
                                    scalar=8, mode=kd.WRAP32, **shape)
            err["kdotp"] = max(err["kdotp"], checks.check_reduce(
                rng, torch.float32, device=device, post=kd.POST_SHIFT,
                scalar=3, mode=kd.WRAP32, **shape))
    checks.check_overflow_kdotpps(device)
    odd = dict.fromkeys(micro.MODULES, 0.0)
    for k in TC_KERNELS:
        micro.MODULES[k].launch_count = micro.MODULES[k].tc_launch_count = 0
    want = {k: {"tensor_cores": 0, "cuda_cores": 0} for k in TC_KERNELS}
    for k, shape in checks.compute_kernel_cases():
        odd[k] = max(odd[k], checks.check_compute_case(rng, k, shape,
                                                       device))
        if k in TC_KERNELS:
            for path, n in checks.case_paths(k).items():
                want[k][path] += n
    torch.cuda.synchronize()
    odd_paths = path_counts()
    if odd_paths != want:
        raise AssertionError(f"launches by path at odd shapes {odd_paths}, "
                             f"want {want}")
    wrapped = checks.check_int8_wrap(device)
    exact = checks.check_fft_exact(rng, device)
    row = next(w for w in micro.CARD if w.name == SHOWN["ssd_scan"])
    ssd_err = check_ssd_kernels(rng, device, {
        k: row.shape[k] for k in ("Bz", "S", "H", "P", "N", "chunk")})
    print(f"[check] kernels equal their plain versions on the card: "
          f"max abs err {err}; compute kernels at odd shapes {odd}; "
          f"the SSD scan's three kernels alone {ssd_err} (odd shapes and "
          f"{row.name}), the scan at odd shapes within its numpy formula; "
          f"spm_fft bit for bit at {exact} shapes, n = 1 .. 16384; "
          f"launches by path there {json.dumps(odd_paths)}; int8 "
          f"{checks.WRAP_M}x{checks.WRAP_K}x{checks.WRAP_N} of -128 wraps "
          f"to {wrapped} (no saturation)")
    controls = []
    for M, K, N in TF32_CONTROLS:
        a, b = checks.matmul_operands(rng, M, K, N, torch.float32, device)
        controls.append(checks.reject_tf32(checks.tf32_product(a, b), a, b))
    print(f"[check] the float32 matmul check rejects TF32 products "
          f"(cuBLAS, TF32 allowed): {json.dumps(controls)}; card: {card}")
    for name in checks.EDGE_CHECKS:
        kernel = checks.EDGE_CHECKS[name][0].__name__.rsplit(".", 1)[1]
        r = checks.check_edge(rng, name, device)
        into = odd if kernel in odd else err
        into[kernel] = max(into[kernel], r["max_abs_err"])
        print(f"[edge] {name}: equals its plain version (max abs diff "
              f"{r['max_abs_err']}), {r['launches']} launches of "
              f"{kernel}; card: {card}")

    inputs = {}

    stamp("check")

    # 3. slice 1 on the card -----------------------------------------------
    fv.launch_count = kd.launch_count = kw.launch_count = 0
    be_off, records, phase3 = run_slice(
        device, rng, log=lambda m: print(f"{m}; card: {card}"))
    launches = {"kvi_walk": kw.launch_count}
    walked = sum(r["walk_launches"] for r in records)
    if fv.launch_count or kd.launch_count:
        raise AssertionError(f"the KVI path launched per-step kernels: "
                             f"fused_vops {fv.launch_count}, kdotp "
                             f"{kd.launch_count}")
    if not 0 < launches["kvi_walk"] == walked:
        raise AssertionError(f"kvi_walk launches {launches['kvi_walk']} "
                             f"disagree with the groups walked {walked}")
    print(f"[slice] launches over the main path (cold, warm and "
          f"profiled runs): {launches}, none of fused_vops or kdotp; "
          f"card: {card}")
    fv.launch_count = kd.launch_count = 0
    n_ew, n_red = run_intrinsics(rng, device)
    torch.cuda.synchronize()
    launches.update(fused_vops=fv.launch_count, kdotp=kd.launch_count)
    if (fv.launch_count, kd.launch_count) != (n_ew, n_red):
        raise AssertionError(f"KVI intrinsics: {launches}, want one launch "
                             f"a call ({n_ew} element-wise, {n_red} "
                             f"reductions)")
    print(f"[intrinsics] ops element-wise and reduction calls equal their "
          f"numpy formulas, one launch each: fused_vops {n_ew}, kdotp "
          f"{n_red}; card: {card}")

    stamp("slice 1")

    # 3b. serving on the card ----------------------------------------------
    serving = run_serve(device, args.seed,
                        log=lambda m: print(f"{m}; card: {card}"))

    stamp("serve")

    # 3t. telemetry on the card --------------------------------------------
    fv.launch_count = kd.launch_count = kw.launch_count = 0
    telemetry = run_telemetry(device, args.seed, phase3, be_off,
                              log=lambda m: print(f"{m}; card: {card}"))
    torch.cuda.synchronize()
    del phase3
    if fv.launch_count or kd.launch_count or not kw.launch_count:
        raise AssertionError(f"phase 3t: kvi_walk {kw.launch_count}, "
                             f"fused_vops {fv.launch_count}, kdotp "
                             f"{kd.launch_count} launches")
    telemetry["phase_walk_launches"] = kw.launch_count

    stamp("telemetry")

    # 3v. slice 1 under verify=True ---------------------------------------
    kw.launch_count = 0
    verified = run_verify(device, rng, be_off, {
        r["phase"]: r["warm_wall_s"] for r in records},
        log=lambda m: print(f"{m}; card: {card}"))
    launches["kvi_walk_verified"] = kw.launch_count
    if kw.launch_count != 2 * sum(r["walk_launches"] for r in verified):
        raise AssertionError(f"phase 3v: {kw.launch_count} kvi_walk "
                             f"launches")

    stamp("slice 1 verified")

    # 4. slices 2 and 3 on the card ----------------------------------------
    paths = {}
    for tag, kernels in (("slice2", SLICE2), ("slice3", SLICE3)):
        workloads = [w for w in micro.CARD if w.kernel in kernels]
        ins, run_launches, run_err, run_paths = run_compute_slice(
            device, rng, workloads, tag=tag,
            log=lambda m: print(f"{m}; card: {card}"))
        inputs.update(ins)
        if "ssd_scan" in kernels:
            ssd_launches = dict(ss.part_launches)   # no launch since the run
        for k in kernels:
            launches[k] = run_launches[k]
            err[k] = max(run_err[k], odd[k])
            if k in TC_KERNELS:
                paths[k] = run_paths[k]
        print(f"[{tag}] launches over the path (one per call): "
              f"{ {k: run_launches[k] for k in kernels} }, by path "
              f"{ {k: run_paths[k] for k in kernels if k in TC_KERNELS} }; "
              f"card: {card}")

    stamp("slices 2 and 3")

    # 5. kernel times --------------------------------------------------------
    walk_times = time_walks(rng, device)
    for name, t in walk_times.items():
        print(f"[time] kvi_walk {name}: {json.dumps(t)}; card: {card}")
    times = {"fused_vops": time_fused(rng, device),
             "kdotp": time_kdotp(rng, device)}
    for name, t in times.items():
        t["bound_ms"], t["bound_by"] = _bound(t)
    times["kvi_walk"] = dict(walk_times[WALK_SHOWN], shape=WALK_SHOWN,
                             workloads=walk_times,
                             also_replaces=WALK_ALSO_REPLACES,
                             serving=dict(
                                 launches=serving["walk_launches"],
                                 device_ms_by_bucket=serving[
                                     "device_ms_by_bucket"]),
                             telemetry=telemetry,
                             verified=dict(
                                 launches=launches["kvi_walk_verified"],
                                 analyzer_host_s={
                                     r["phase"]: r["analyzer_host_s"]
                                     for r in verified}))
    by_kernel = {k: {} for k in micro.MODULES}
    for w in micro.CARD:
        x = inputs.pop(w.name)
        t = micro.time_workload(w, x)
        by_kernel[w.kernel][w.name] = t
        print(f"[time] {w.name}: {json.dumps(t)}; card: {card}")
        if w.name == SHOWN["ssd_scan"]:
            ssd_times = time_ssd_parts(w, x)
            print(f"[time] {w.name} by kernel: {json.dumps(ssd_times)}; "
                  f"card: {card}")
        if w.name == SHOWN["het_mimd"]:
            t["conv_hart"] = time_conv_harts(w, x)
            print(f"[time] {w.name} conv hart, staged window vs streamed "
                  f"rows: {json.dumps(t['conv_hart'])}; card: {card}")
        del x
        torch.cuda.empty_cache()
    for k, ws in by_kernel.items():
        times[k] = dict(ws[SHOWN[k]], shape=SHOWN[k], workloads={
            name: {key: t[key] for key in (
                "ms", "call_ms", "plain_ms", "library_ms", "library_kernel",
                "bound_ms", "bound_by", "path", "glue_ms", "glue_call_ms",
                "device_ms_by", "conv_hart") if key in t}
            for name, t in ws.items()})
    # the SSD scan stands as its three kernels, each with the whole call
    # beside it
    scan = dict(times.pop("ssd_scan"), max_abs_err=err["ssd_scan"],
                launches=launches["ssd_scan"])
    for part in ss.PARTS:
        times[part] = dict(ssd_times[part], shape=SHOWN["ssd_scan"],
                           scan=scan)
        launches[part] = ssd_launches[part]
        err[part] = ssd_err[part]
    kernels = []
    for name, source, replaces in [WALK] + json_rows(ss.PARTS):
        t = times[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": err[name], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        entry.update({k: t[k] for k in ("ms_source", "call_ms",
                                        "plain_call_ms", "library_call_ms",
                                        "shape")})
        for extra in ("kvred", "workloads", "scan", "also_replaces",
                      "serving", "telemetry", "verified"):
            if extra in t:
                entry[extra] = t[extra]
        if name in paths:
            entry["paths"] = paths[name]
        kernels.append(entry)
        print(f"[time] {name} {t['shape']}: {json.dumps(entry)}; "
              f"card: {card}")
    stamp("time")
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


#: the KVI walk kernel: it replaces both TPU kernels of the KVI path
#: there (the per-step kernels below stay for the intrinsics)
WALK = ("kvi_walk", "src/repro_torch/csrc/kvi_walk.cu",
        "src/repro/kvi/pallas_backend.py:134")
WALK_ALSO_REPLACES = "src/repro/kernels/kdotp.py:21"
#: the main-path structure whose walk numbers stand in its JSON entry
WALK_SHOWN = "matmul64_kdotp"
#: (kernel, source, the TPU kernel it replaces), in the order of the JSON
KERNELS = (
    ("fused_vops", "src/repro_torch/csrc/fused_vops.cu",
     "src/repro/kvi/pallas_backend.py:134"),
    ("kdotp", "src/repro_torch/csrc/kdotp.cu",
     "src/repro/kernels/kdotp.py:21"),
    ("spm_matmul", "src/repro_torch/csrc/spm_matmul.cu",
     "src/repro/kernels/spm_matmul.py:22"),
    ("spm_conv2d", "src/repro_torch/csrc/spm_conv2d.cu",
     "src/repro/kernels/spm_conv2d.py:25"),
    ("spm_fft", "src/repro_torch/csrc/spm_fft.cu",
     "src/repro/kernels/spm_fft.py:29"),
    ("het_mimd", "src/repro_torch/csrc/het_mimd.cu",
     "src/repro/kernels/het_mimd.py:25"),
    ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:29"),
    ("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
     "src/repro/kernels/ssd_scan.py:24"),
)


def json_rows(ssd_parts):
    """``KERNELS`` as the JSON lists them: the SSD scan as its kernels
    ``ssd_parts``, each with the scan's source and TPU kernel."""
    return [(part, source, replaces) for name, source, replaces in KERNELS
            for part in (ssd_parts if name == "ssd_scan" else (name,))]


#: the kernels of phase 4's two driven runs
SLICE2 = ("spm_matmul", "spm_conv2d", "spm_fft", "het_mimd")
SLICE3 = ("flash_attention", "ssd_scan")
#: the kernels with a tensor-core path beside the CUDA-core one
TC_KERNELS = ("spm_matmul", "flash_attention")
#: float32 matmul shapes (M, K, N) of the TF32 controls: odd, the paper
#: composite's, composite_1024's and matmul_f32_2048's
TF32_CONTROLS = ((33, 65, 17), (64, 64, 64), (1024, 1024, 1024),
                 (2048, 2048, 2048))
#: the workload whose numbers stand in a compute kernel's JSON entry
#: (every workload's are under "workloads")
SHOWN = {"spm_matmul": "matmul_bf16_4096", "spm_conv2d": "conv_int32_2048_f3",
         "spm_fft": "fft_16384x256", "het_mimd": "composite_1024",
         "flash_attention": "attn_llama3.2-1b_causal_4096",
         "ssd_scan": "ssd_mamba2-1.3b_4096"}


if __name__ == "__main__":
    sys.exit(main())
