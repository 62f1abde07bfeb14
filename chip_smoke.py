#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card, ``nvcc`` and this checkout (``src/repro_torch``);
imports nothing of JAX or of the reference package ``repro``. Phases:

1. build   — compile the eleven CUDA sources of ``src/repro_torch/csrc/``
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
3d. dse    — the design-space exploration's walltime stage
   (``repro_torch.kvi.dse``): ``sweep`` over ``shared`` M1 F1 D4 at 8,
   16 and 32 bits (three measurement classes) with the paper's kernels
   at full width (conv 32x32 F 3, FFT-256, the SPM-resident matmul 64,
   their 3-hart composite) and ``measure_device=True``, once on the card
   and once with ``device="cpu"``: canonical JSONs byte-equal,
   ``kernel_launches`` equal in every class; each class's workloads
   again on the card against the oracle, bit for bit; then ``python -m
   repro_torch.kvi.dse --smoke --measure-device``'s ``main`` twice on one
   store: exit 0 and every check True both times, the second run every
   point and class from the store with no ``kvi_walk`` launch, the two
   canonical JSONs byte-equal; and one process-executor worker's spawn
   against the same job run serially. One ``[dse]`` line per class and
   kernel (``device_compile_s``, ``device_steady_s`` unrounded,
   ``kernel_launches``), then the phase's summary;
3v. verify — every phase-3 workload at phase 3's widths again, a quarter
   of its instances (``VERIFY_SCALE``: the analyzer's host cost is
   linear in them), through
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
   hymba-1.5b's heads with a window of 2048 over 8192, a mixtral
   prefill continuation,
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
   streaming rows, in turns;
6. lm      — the LM model zoo and LM serving (``repro_torch.models``,
   ``repro_torch.serving``; plain PyTorch, as the reference's zoo calls
   no kernel, but for the SSM layers' SSD scan, which runs the card's
   training kernels, phase 9's): (a) every arch at
   ``reduced_model`` size in float32 and in its config's bfloat16, one
   set of seed-made weights on the CPU and the card, a prefill of 64
   tokens of a batch of 2 and 4 decode steps, logits and caches equal
   (1e-4 at float32 with TF32 off; 5e-2 at bfloat16, 1 % of the
   elements allowed up to twice it; the MoE archs take the CPU's routes,
   every token routed apart a near-tie; mixtral's window of 32 wraps,
   and hymba's ring of 16 after its 4 meta tokens' slots); (b) at full
   width, llama3.2-1b, mamba2-1.3b and seamless-m4t-medium at full
   depth, hymba-1.5b at full depth with a prompt of 1536 (its ring of
   1024 after the 128 meta tokens wraps), mixtral-8x7b and
   pixtral-12b cut to 2 layers (mixtral's prompt one window, 4096, so
   its ring wraps at the decode step; the MoE dropless, as
   ``reduced_model``; pixtral's prompt 1024 patches + 512 tokens; the
   others 512 tokens): prefill a batch of 2, one decode step, its logits
   against the forward over the extended stream, within 5e-2 with
   float32 activations and recorded with the config's bfloat16 (audio:
   shaped and finite); (c) ``python -m
   repro_torch.launch.serve``'s ``main`` at full width and depth
   (llama3.2-1b, 16 requests, 4 slots, max-seq 128, 24 new tokens):
   every request 24 tokens, request 0's equal to a teacher-forced
   decode loop through the same step, one prompt in two slots one
   output. The ``[lm]`` line holds the server's tokens, seconds, tok/s
   and TTFT p50 / p99, the median decode step ms, the peak device
   memory, (b)'s seconds and the card. ``--only-lm`` runs this phase
   alone (no kernel or ok line);
7. train   — LM training (``repro_torch.optim``, the train step of
   ``repro_torch.models.steps``, ``repro_torch.launch.train``; plain
   PyTorch under autograd, no kernel of the port but the SSD scan's for
   the SSM layers): (a) llama3.2-1b, mixtral-8x7b,
   mamba2-1.3b (remat "block" on the card), hymba-1.5b (int8 moments),
   seamless-m4t-medium and pixtral-12b (grad_accum 2 on the card against
   the whole batch on the CPU) at ``reduced_model`` size in float32 (TF32
   off), one set of seed-made weights on the CPU and the card, two steps
   on ``DataPipeline.batch_at`` batches: loss, grad norm and the first
   batch's gradients within 1e-4, every param within 1e-4 but for at
   most 0.1 % of them (Adam's per-element normalisation amplifies the
   rounding of a gradient near zero; with int8 moments a flipped code
   too), counted; (b) ``python -m repro_torch.launch.train``'s ``main``
   at full width and depth (llama3.2-1b, batch 4 x 1024, 8 steps, bf16
   activations over f32 masters): every loss and grad norm finite, the
   params moved, step 0's loss within 5e-2 of float32 activations'; the
   median step ms, tok/s, the device ms a step (profiler) and peak
   memory; (c) ``launch.train`` at
   llama100m's full config, 6 steps with a checkpoint every 3 against 3
   steps then ``--resume`` for 3 more: params and optimizer state bit for
   bit; (d) the deprecated ``run_vops`` at 1 M int32 lanes, one
   ``fused_vops`` launch a call, bit for bit its plain version, and the
   backends of ``examples/torch_quickstart.py`` on the card. One
   ``[train]`` line per part and one JSON ``[train]`` line; ``--only-train``
   runs this phase alone (builds only what (d) and the SSD launch; no
   kernel or ok line);
8. mesh    — the mesh paths (``repro_torch.launch.mesh``, DTensor
   placements from ``models.sharding``, ``models.pipeline``; no kernel
   but the SSD scan's)
   on a one-rank NCCL group (``file://`` rendezvous in a temporary
   directory) and a 1x1 ("data", "model") ``DeviceMesh``: (a)
   ``build_trainer(mesh=)`` for llama3.2-1b, mixtral-8x7b and
   mamba2-1.3b at ``reduced_model`` size in float32, 2 steps, losses and
   the first batch's gradients within 1e-4 of ``mesh=None`` on the card;
   (b) ``build_trainer(mesh=)`` for llama3.2-1b at phase 7 (b)'s batch
   (4 x 1024) with the arch's own remat, 3 steps, step 0's loss within
   1e-4 (relative) of the one-device loss and of phase 7 (b)'s; step ms,
   tok/s and peak memory beside phase 7 (b)'s; (c) (b)'s params and step
   count saved from the mesh and restored with ``shardings=``, bit for
   bit; (d) ``cross_pod_mean(mesh=)`` on a 1x1x1 pod mesh equal to
   ``mesh=None`` bit for bit; (e) ``pipeline_apply`` with one stage
   within 1e-5 of ``unpipelined_reference``; (f) ``analyze_step`` over
   one more step of (b): its dot FLOPs equal to ``FlopCounterMode``'s
   on the step after, and their ratio to 6·N·T. One ``[mesh]`` line a
   part and one JSON ``[mesh]`` line; the group is destroyed at the end;
   ``--only-mesh`` runs this phase alone (no kernel or ok line);
9. ssd_train — the SSD scan for training (``ssd_scan.ssd_train``, which
   ``ssd_chunked`` runs on the card): (a) y, the final state and every
   gradient against the plain version at seven shapes (one and two
   groups, P and N past a tile), float32 and bf16, one launch of each part a
   check; (b) two runs bit for bit; (c) the forward and the forward and
   backward at the benchmark cell's row (``micro.SSD_TRAIN_CELL``) beside
   the plain layer and the bound. ``[ssd_train]`` lines and one JSON
   ``[ssd_train]`` line; ``--only-ssd-train`` runs this phase alone (no
   kernel or ok line);
10. selective_scan — Mamba-1's scan for training (``kernels.
   selective_scan``, which ``models.ssm.selective_scan`` runs on the
   card): (a) y, the final state and every gradient against the plain
   scan at five shapes (S past a segment, d past a block, N 3, 13, 16, 24;
   the last the benchmark cell's 8 x 1152, d 3200), float32 and bf16 u, B
   and C, one launch of each part a check; (b) two runs bit for bit; (c)
   the forward and the forward and backward at the cell's shape
   (``micro.SELECTIVE_SCAN_CELL``), beside the plain scan and the bounds;
   (d) the scan's launches in one train step of
   hymba-1.5b at full width and depth, blocks recomputed.
   ``[selective_scan]`` lines and one JSON ``[selective_scan]`` line;
   ``--only-selective-scan`` runs this phase alone (no kernel or ok
   line).

Any failed check raises, and the script exits non-zero. The last lines
are the card's name and power limit, a JSON object of kernel numbers
(``spm_matmul`` and ``flash_attention`` with their main-path launches by
path; the SSD scan as its three kernels, each with the whole call under
``scan``; ``kvi_walk`` with every main-path structure under
``workloads``, serving's launches and device ms by bucket size under
``serving``, phase 3t's numbers under ``telemetry``, phase 3d's under
``dse`` and phase 3v's launches and analyzer seconds under
``verified``; ``fused_vops`` with phase 7's ``run_vops`` calls under
``run_vops``; phase 7's numbers under ``train``, phase 8's under
``mesh``) and ``{"ok": true, "device": {...}}``.
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
# 3d: the design-space exploration's walltime stage on the card
# ---------------------------------------------------------------------------

#: phase 3d (a)'s points: one measurement class each (8, 16, 32 bits)
DSE_BITS = (8, 16, 32)


def _class_workloads(kernels, harts=3):
    """A measurement class's workloads as the walltime stage builds
    them: each kernel on every hart, and the composite."""
    from repro_torch.kvi import KviWorkload
    wls = {name: KviWorkload.replicate(prog, harts)
           for name, prog in kernels.items()}
    wls["composite"] = KviWorkload.composite(
        {h: [p] for h, p in enumerate(kernels.values())},
        name="composite")
    return wls


def _canonical_file(path):
    """A sweep JSON written by the CLI, volatile-scrubbed, as bytes."""
    from repro_torch.kvi.obs.scrub import DSE_VOLATILE, scrub
    return json.dumps(scrub(json.loads(Path(path).read_text()),
                            DSE_VOLATILE), indent=2, sort_keys=True)


def run_dse_phase(device, seed, log=print):
    """Phase 3d: (a) ``sweep`` over ``shared`` M1 F1 D4 at 8, 16 and 32
    bits with the full-width kernels (conv 32x32 F 3, FFT-256, resident
    matmul 64, their composite) and ``measure_device=True``, once on the
    card and once with ``device="cpu"`` (one temporary point cache, so
    the CPU run re-measures only the device classes): canonical JSONs
    byte-equal, launches equal per class; each class's workloads once
    more through the card's backend against the oracle, bit for bit.
    (b) ``python -m repro_torch.kvi.dse --smoke --measure-device`` twice
    through its ``main``: cold, then every point and class from the
    store with no ``kvi_walk`` launch, canonical JSON byte-equal, exit 0
    both times. Also the spawn cost of one process-executor worker.
    ``device`` may be the CPU (a rehearsal: both runs there)."""
    import tempfile

    import torch

    from repro_torch.kernels import kvi_walk as kw
    from repro_torch.kvi import get_backend
    from repro_torch.kvi.dse import (DesignPoint, PointCache, PointJob,
                                     ProcessExecutor, SerialExecutor,
                                     paper_kernel_factory, sweep)
    from repro_torch.kvi.dse.__main__ import main as dse_main
    from repro_torch.kvi.dse.sweep import optimize_kernels

    pts = [DesignPoint("shared", 1, 1, 4, precision_bits=b)
           for b in DSE_BITS]
    factory = paper_kernel_factory(smoke=False, seed=seed)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with tempfile.TemporaryDirectory() as tmp:
        emitted = []
        kw.launch_count = 0
        t = time.perf_counter()
        card_res = sweep(pts, factory, executor="serial",
                         measure_device=True, device=device,
                         cache=PointCache(cache_dir=f"{tmp}/cache"),
                         emit=emitted.append)
        card_s = time.perf_counter() - t
        sync()
        walk_launches = kw.launch_count
        t = time.perf_counter()
        cpu_res = sweep(pts, factory, executor="serial",
                        measure_device=True, device="cpu",
                        cache=PointCache(cache_dir=f"{tmp}/cache"))
        cpu_s = time.perf_counter() - t
        card_meta, cpu_meta = card_res.meta["device"], cpu_res.meta["device"]
        if card_res.canonical_json() != cpu_res.canonical_json():
            raise AssertionError("phase 3d: the card's canonical sweep JSON "
                                 "differs from the CPU's")
        launches = [{k: m["kernel_launches"] for k, m in c["kernels"].items()}
                    for c in card_meta["classes"]]
        if launches != [{k: m["kernel_launches"]
                         for k, m in c["kernels"].items()}
                        for c in cpu_meta["classes"]]:
            raise AssertionError(f"phase 3d: kernel_launches differ, card "
                                 f"{card_meta['classes']} cpu "
                                 f"{cpu_meta['classes']}")
        if card_meta["n_measurement_classes"] != len(DSE_BITS) or \
                (device.type == "cuda") != (walk_launches > 0):
            raise AssertionError(f"phase 3d: {card_meta}, {walk_launches} "
                                 f"kvi_walk launches")
        build_line = [ln for ln in emitted if ln.startswith("device build")]
        classes = []
        for c in card_meta["classes"]:
            for name, m in c["kernels"].items():
                row = dict(bits=c["precision_bits"], kernel=name, **m)
                classes.append(row)
                log(f"[dse] b{c['precision_bits']} {name}: device_compile_s "
                    f"{m['device_compile_s']!r} device_steady_s "
                    f"{m['device_steady_s']!r} kernel_launches "
                    f"{m['kernel_launches']}")
        # each class's workloads again on the card, against the oracle
        be = get_backend("torch", device=device, passes=())
        oracle = get_backend("oracle", passes=())
        kw.launch_count = 0
        checked = 0
        for b in DSE_BITS:
            kernels = optimize_kernels(factory(b), None)
            for name, wl in _class_workloads(kernels).items():
                got, want = be.run_workload(wl), oracle.run_workload(wl)
                for i, (g, w) in enumerate(zip(got.outputs, want.outputs)):
                    for key, arr in w.items():
                        if g[key].dtype != arr.dtype or \
                                not np.array_equal(g[key], arr):
                            raise AssertionError(
                                f"phase 3d: b{b} {name} entry {i} output "
                                f"{key} differs from the oracle")
                    checked += 1
        sync()
        oracle_launches = kw.launch_count

        # (b) the CLI, cold then warm
        runs = []
        for run in ("cold", "warm"):
            kw.launch_count = 0
            t = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = dse_main(["--smoke", "--measure-device", "--quiet",
                               "--device", device.type,
                               "--out-dir", f"{tmp}/{run}", "--cache-dir",
                               f"{tmp}/cli-cache", "--cache-stats"])
            sync()
            bench = json.loads(
                Path(f"{tmp}/{run}/BENCH_torch_kvi_dse.json").read_text())
            stats = json.loads(
                Path(f"{tmp}/{run}/dse_cache_stats.json").read_text())
            runs.append(dict(
                run=run, rc=rc, wall_s=time.perf_counter() - t,
                walk_launches=kw.launch_count, checks=bench["checks"],
                hits=stats["hits"], misses=stats["misses"],
                device_hits=stats["device_hits"],
                device_misses=stats["device_misses"]))
            if rc != 0 or not all(v for v in bench["checks"].values()
                                  if isinstance(v, bool)):
                raise AssertionError(f"phase 3d: the DSE CLI ({run}) gave "
                                     f"{rc}, checks {bench['checks']}:\n"
                                     f"{buf.getvalue()}")
        cold, warm = runs
        if (device.type == "cuda") != (cold["walk_launches"] > 0) or \
                cold["device_misses"] != 3:
            raise AssertionError(f"phase 3d: the cold CLI run {cold}")
        if warm["walk_launches"] or warm["misses"] or \
                warm["device_misses"] or warm["device_hits"] != 3 or \
                warm["hits"] != bench["meta"]["n_points"]:
            raise AssertionError(f"phase 3d: the warm CLI run {warm}")
        if _canonical_file(f"{tmp}/cold/dse_sweep.json") != \
                _canonical_file(f"{tmp}/warm/dse_sweep.json"):
            raise AssertionError("phase 3d: the CLI's cold and warm "
                                 "canonical JSONs differ")

        # what one spawned worker costs beside running its job here
        job = PointJob(pts[0], optimize_kernels(factory(8), None), True)
        t = time.perf_counter()
        list(SerialExecutor().imap_jobs([job]))
        serial_job_s = time.perf_counter() - t
        t = time.perf_counter()
        list(ProcessExecutor(max_workers=1).imap_jobs([job]))
        spawned_job_s = time.perf_counter() - t
    out = dict(
        points=[p.name for p in pts], walk_launches=walk_launches,
        card_sweep_s=card_s, cpu_sweep_s=cpu_s,
        build_line=build_line[0] if build_line else None,
        compile_cache=card_meta["compile_cache"], classes=classes,
        oracle_checked_entries=checked,
        oracle_check_walk_launches=oracle_launches, cli=runs,
        serial_job_s=serial_job_s, spawned_job_s=spawned_job_s)
    summary = {k: v for k, v in out.items() if k != "classes"}
    log(f"[dse] {json.dumps(summary)}")
    return out


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
    ssd_launches = {k: ss.part_launches[k] for k in ss.PARTS}
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
    before = {k: ss.part_launches[k] for k in ss.PARTS}
    for shape, dt in runs:
        for k, e in checks.check_ssd_parts(rng, device=device, dtype=dt,
                                           **shape).items():
            err[k] = max(err[k], e)
    torch.cuda.synchronize()
    if {k: ss.part_launches[k] for k in ss.PARTS} != {
            k: n + len(runs) for k, n in before.items()}:
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

# ---------------------------------------------------------------------------
# phase 6: the LM model zoo and LM serving
# ---------------------------------------------------------------------------

#: phase 6 (a): every arch at reduced size — a prefill of S tokens of a
#: batch of B, then decode steps
LM_S, LM_B, LM_DECODES = 64, 2, 4
LM_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
#: bfloat16 on two devices rounds apart: the share of elements allowed
#: past the tolerance (none past twice it), as the CPU tests hold the
#: port against the reference
LM_BF16_OUTLIERS = 1e-2
#: a router probability gap below which rounding may reorder two experts
LM_NEAR_TIE = 2e-2
#: phase 6 (b): one arch of each family at full width — (arch, layers
#: kept or None for full depth, prompt tokens)
LM_FULL = (("llama3.2-1b", None, 512), ("mamba2-1.3b", None, 512),
           ("seamless-m4t-medium", None, 512),
           ("hymba-1.5b", None, 1024 + 512),     # window + 512: the ring wraps
           # 2 of 32 layers; a prompt of one window: a sliding-window cache
           # holds min(prompt, window) slots and no headroom (the
           # reference's cache_slots), so after a shorter prompt the first
           # decode step overwrites the prompt's last token
           ("mixtral-8x7b", 2, 4096),
           ("pixtral-12b", 2, 1024 + 512))       # 2 of 40; 1024 patches
#: one attention block over the whole prompt (the configs' 2048 divides
#: none of hymba's 128 + 1536 and 128 + 1537, 4096 + 1 and 2561)
LM_BLOCK = 8192
#: phase 6 (c): python -m repro_torch.launch.serve at full width
LM_SERVE = ["--arch", "llama3.2-1b", "--requests", "16", "--slots", "4",
            "--max-seq", "128", "--max-new", "24"]


def _lm_np(tree):
    """A tree of tensors as numpy on the host (bfloat16 as float32)."""
    import torch
    if isinstance(tree, dict):
        return {k: _lm_np(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _lm_close(path, got, want, dtype) -> float:
    """Trees equal: integers exactly, floats within ``LM_TOL[dtype]``
    (rtol and atol; bfloat16 as ``LM_BF16_OUTLIERS`` says). Returns the
    largest error in units of the tolerance."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{path}: keys {sorted(got)} != "
                                 f"{sorted(want)}")
        return max([_lm_close(f"{path}/{k}", got[k], want[k], dtype)
                    for k in want] or [0.0])
    if got.shape != want.shape:
        raise AssertionError(f"{path}: shape {got.shape} != {want.shape}")
    if np.issubdtype(want.dtype, np.integer):
        if not np.array_equal(got, want):
            raise AssertionError(f"{path}: integers differ")
        return 0.0
    tol = LM_TOL[dtype]
    err = np.abs(got.astype(np.float64) - want) / (tol * (1 + np.abs(want)))
    worst = float(err.max()) if err.size else 0.0
    outliers = float(np.mean(err > 1)) if err.size else 0.0
    if not np.isfinite(got).all() or (
            worst > 1 if dtype == "float32" else
            worst > 2 or outliers > LM_BF16_OUTLIERS):
        raise AssertionError(f"{path}: {worst} x the tolerance {tol} "
                             f"({outliers} of the elements past it)")
    return worst


@contextlib.contextmanager
def lm_routes(record=None, force=None, flips=None):
    """The port's MoE routes, per call in order: recorded (``record``)
    on one device, or forced (``force``, the recorded ones) on another,
    where every token routed apart must be a near-tie of its own
    probabilities (counted in ``flips``)."""
    import torch
    from repro_torch.models import moe
    orig = moe.route

    def route(x, w, num_experts, top_k):
        weights, idx, aux = orig(x, w, num_experts, top_k)
        if force is None:
            record.append(idx.cpu())
            return weights, idx, aux
        want = force.pop(0).to(idx.device)
        probs = torch.softmax(torch.einsum("bsd,de->bse", x.float(),
                                           w.float()), dim=-1)
        apart = (idx.sort(-1).values != want.sort(-1).values).any(-1)
        for b, s in apart.nonzero().tolist():
            p = probs[b, s]
            kth = p[idx[b, s]].min()
            other = [e for e in want[b, s].tolist()
                     if e not in idx[b, s].tolist()]
            gap = float((p[other] - kth).abs().max())
            if gap >= LM_NEAR_TIE:
                raise AssertionError(f"MoE route apart at ({b}, {s}) with "
                                     f"a gap of {gap}")
            flips.append(gap)
        forced = torch.gather(probs, -1, want)
        forced = forced / torch.clamp(forced.sum(-1, keepdim=True), min=1e-9)
        return forced, want, aux

    moe.route = route
    try:
        yield
    finally:
        moe.route = orig


def _lm_batch(cfg, kind, seq, batch, rng, device):
    """A batch of ``batch_template``'s shapes from ``rng`` (tokens below
    min(vocab, 100), float inputs standard normal) on ``device``."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import params as params_lib
    from repro_torch.models import steps
    out = {}
    for k, p in steps.batch_template(
            cfg, ShapeConfig(kind, kind, seq, batch)).items():
        if p.dtype == "int32":
            x = torch.from_numpy(rng.integers(0, min(cfg.vocab_size, 100),
                                              p.shape).astype(np.int32))
        else:
            x = torch.from_numpy(rng.normal(size=p.shape).astype(
                np.float32)).to(params_lib.torch_dtype(p.dtype))
        out[k] = x.to(device)
    return out


def _lm_steps(cfg, par, params, prefill_batch, next_tokens, device):
    """Prefill, then one decode step per token of ``next_tokens``, on
    ``device``: every step's logits and the caches, as numpy."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import steps
    from repro_torch.models.sharding import make_rules
    rules = make_rules(None, cfg, par)
    prefill = steps.make_prefill_step(
        cfg, rules, par, ShapeConfig("p", "prefill", LM_S, LM_B))
    decode = steps.make_decode_step(
        cfg, rules, par, ShapeConfig("d", "decode", LM_S, LM_B))
    batch = {k: v.to(device) for k, v in prefill_batch.items()}
    logits, cache = prefill(params, batch)
    out = {"prefill": _lm_np(logits), "prefill_cache": _lm_np(cache)}
    for i, tok in enumerate(next_tokens):
        logits, cache = decode(params, cache, {"tokens": tok.to(device)})
        out[f"decode{i}"] = _lm_np(logits)
    out["decode_cache"] = _lm_np(cache)
    return out


def run_lm_reduced(device, seed, log=print) -> dict:
    """Phase 6 (a): every arch at ``reduced_model`` size in float32 and
    its config's bfloat16, one set of seed-made weights on the CPU and
    the card: prefill, ``LM_DECODES`` decode steps, logits and caches
    equal. The MoE archs take the CPU's routes on the card, every token
    routed apart a near-tie. Returns the worst error a dtype (in units of
    its tolerance) and the flips."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import params as params_lib
    worst = {d: 0.0 for d in LM_TOL}
    flips = {d: [] for d in LM_TOL}
    for arch in configs.list_archs() + ["llama100m"]:
        spec = configs.get_spec(arch)
        par = spec.parallelism.replace(remat="none", fsdp=False,
                                       sequence_parallel=False)
        for dtype in LM_TOL:
            cfg = configs.reduced_model(spec.model).replace(dtype=dtype)
            rng = np.random.default_rng(seed)
            cpu_params = params_lib.initialize(zoo.param_template(cfg), seed,
                                               device="cpu")
            batch = _lm_batch(cfg, "prefill", LM_S, LM_B, rng, "cpu")
            nxt = [torch.from_numpy(rng.integers(1, 90, (LM_B, 1)).astype(
                np.int32)) for _ in range(LM_DECODES)]
            routes = []
            with lm_routes(record=routes):
                want = _lm_steps(cfg, par, cpu_params, batch, nxt, "cpu")
            card_params = params_lib.tree_map(
                lambda x: x.to(device), cpu_params,
                is_leaf=lambda x: not isinstance(x, dict))
            apart = []
            with lm_routes(force=routes, flips=apart):
                got = _lm_steps(cfg, par, card_params, batch, nxt, device)
            if routes or (dtype == "float32" and apart):
                raise AssertionError(f"{arch} {dtype}: {len(routes)} routes "
                                     f"left, {len(apart)} apart")
            err = _lm_close(f"{arch} {dtype}", got, want, dtype)
            worst[dtype] = max(worst[dtype], err)
            flips[dtype] += apart
            log(f"[lm] (a) {arch} {dtype}: the card equals the CPU (prefill "
                f"{LM_S} x {LM_B}, {LM_DECODES} decode steps, logits and "
                f"caches) within {err:.4f} x {LM_TOL[dtype]}; MoE tokens "
                f"routed apart {len(apart)}")
    return {"worst": worst, "routed_apart": {d: len(f) for d, f in
                                             flips.items()}}


def _lm_decode_vs_forward(cfg, par, params, seq, batch, nxt) -> dict:
    """Prefill ``batch`` (the prefill shape of ``seq`` tokens), decode
    ``nxt``; the decode logits against the
    forward's last over the extended stream (audio: shaped and finite).
    Returns the seconds of each and the error, max |d - f| / (1 + |f|)
    (None for audio)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import steps
    from repro_torch.models.sharding import make_rules
    rules = make_rules(None, cfg, par)
    t0 = time.perf_counter()
    _, cache = steps.make_prefill_step(
        cfg, rules, par, configs.ShapeConfig("p", "prefill", seq, 2))(
        params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dlogits, _ = steps.make_decode_step(
        cfg, rules, par, configs.ShapeConfig("d", "decode", seq, 2))(
        params, cache, {"tokens": nxt})
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    got = _lm_np(dlogits)
    if got.shape != (2, 1, zoo.padded_vocab(cfg.vocab_size)) or \
            not np.isfinite(got).all():
        raise AssertionError(f"{cfg.name}: decode logits {got.shape}, "
                             f"finite {np.isfinite(got).all()}")
    err = None
    if cfg.family != "audio":
        ext = {"tokens": torch.cat([batch["tokens"], nxt], dim=1)}
        if cfg.family == "vlm":
            ext["patch_embeds"] = batch["patch_embeds"]
        with torch.inference_mode():
            x, pos = steps._embed_inputs(params, cfg, rules, ext, "prefill")
            hid, _, _ = zoo.decoder_forward(params, cfg, rules, par, x, pos)
            want = _lm_np(zoo.logits_fn(params, cfg, hid[:, -1:]))
        err = float(np.max(np.abs(got - want) / (1 + np.abs(want))))
    torch.cuda.synchronize()
    slots = cache["layers"]["k"].shape[2] if "k" in cache["layers"] else None
    return {"prefill_s": t1 - t0, "decode_s": t2 - t1,
            "forward_s": time.perf_counter() - t2, "err_vs_forward": err,
            "cache_slots": slots}


def run_lm_full(device, seed, log=print) -> dict:
    """Phase 6 (b): one arch of each family at full width (``LM_FULL``),
    one set of seed-made weights (float32) each: prefill a batch of 2,
    one decode step, against the forward over the extended stream, with
    float32 activations (held to 5e-2) and with the config's bfloat16
    (recorded: over 16–48 layers the two paths' bfloat16 rounding alone
    reaches 5e-2). Returns each arch's seconds, cuts and errors."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import params as params_lib
    out = {}
    for arch, layers, seq in LM_FULL:
        t0 = time.perf_counter()
        spec = configs.get_spec(arch)
        cfg, cuts = spec.model, []
        if layers:
            cfg = cfg.replace(num_layers=layers)
            cuts.append(f"{layers} of {spec.model.num_layers} layers")
        if cfg.num_experts:
            # dropless, as reduced_model's ample capacity: the check
            # holds decode (no drop) against the forward (drops)
            cfg = cfg.replace(capacity_factor=cfg.num_experts /
                              cfg.num_experts_per_tok)
            cuts.append(f"capacity_factor {cfg.capacity_factor} (dropless)")
        par = spec.parallelism.replace(
            remat="none", fsdp=False, sequence_parallel=False,
            attn_q_block=LM_BLOCK, attn_kv_block=LM_BLOCK)
        rng = np.random.default_rng(seed)
        params = params_lib.initialize(zoo.param_template(cfg), seed,
                                       device=device)
        batch = _lm_batch(cfg, "prefill", seq, 2, rng, device)
        nxt = torch.from_numpy(rng.integers(1, 90, (2, 1)).astype(
            np.int32)).to(device)
        torch.cuda.synchronize()
        rec = {"init_s": time.perf_counter() - t0, "prompt": seq,
               "layers": cfg.num_layers, "cuts": cuts}
        for dtype in ("float32", cfg.dtype):
            rec[dtype] = _lm_decode_vs_forward(
                cfg.replace(dtype=dtype), par, params, seq, batch, nxt)
        err = rec["float32"]["err_vs_forward"]
        if err is not None and err > 5e-2:
            raise AssertionError(f"{arch}: decode after a prefill of {seq} "
                                 f"against the forward (float32): {err} > "
                                 f"5e-2")
        rec["seconds"] = time.perf_counter() - t0
        out[arch] = rec
        log(f"[lm] (b) {arch} at full width: {json.dumps(rec)}")
        del params, batch
        torch.cuda.empty_cache()
    return out


def run_lm_serve(device, seed, log=print) -> dict:
    """Phase 6 (c): ``repro_torch.launch.serve.main`` at full width and
    depth (``LM_SERVE``): 16 requests of 24 tokens; the first request's
    tokens equal a manual teacher-forced decode loop through the same
    step on a fresh cache (the reference's greedy check); two requests
    of one prompt give one output (slot reuse); then the median of 20
    timed decode steps of the engine."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.serving import Request, ServingEngine
    report = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(LM_SERVE + ["--seed", str(seed)], report=report)
    line = buf.getvalue().strip()
    log(f"[lm] (c) {line}")
    eng, done = report["engine"], report["done"]
    if rc != 0 or len(done) != 16 or \
            any(len(r.out_tokens) != 24 for r in done):
        raise AssertionError(f"launch.serve: rc {rc}, {len(done)} served, "
                             f"{[len(r.out_tokens) for r in done]}")
    served = {"requests": len(done), "tokens": report["tokens"],
              "seconds": report["seconds"],
              "tok_per_s": report["tokens"] / report["seconds"],
              "ttft_p50_s": float(np.percentile(report["ttft_s"], 50)),
              "ttft_p99_s": float(np.percentile(report["ttft_s"], 99))}
    first = next(r for r in done if r.rid == 0)
    # request 0 sat in slot 0 from the engine's first step; the other
    # slots' rows do not reach row 0 of the step
    cache = ServingEngine(eng.cfg, eng.params, slots=eng.slots,
                          max_seq=eng.max_seq, device=device).cache
    toks = np.zeros((eng.slots, 1), np.int32)

    def step(tok):
        nonlocal cache
        toks[0, 0] = tok
        logits, cache = eng._decode(eng.params, cache, {
            "tokens": torch.from_numpy(toks).to(device)})
        return int(logits[0, -1].argmax())

    for tok in first.prompt:
        nxt = step(tok)
    manual = [nxt]
    while len(manual) < first.max_new_tokens:
        manual.append(step(manual[-1]))
    if manual != first.out_tokens:
        raise AssertionError(f"request 0 served {first.out_tokens}, the "
                             f"decode loop gives {manual}")
    for rid in (100, 101):
        eng.submit(Request(rid=rid, prompt=first.prompt.copy(),
                           max_new_tokens=first.max_new_tokens))
    again = [r.out_tokens for r in eng.run_until_drained() if r.rid >= 100]
    if len(again) != 2 or again[0] != again[1]:
        raise AssertionError(f"one prompt in two slots served {again}")
    # the engine's decode step, timed alone (its batch of 4 slots), then
    # its device time in a profiler trace of 5 more
    ms = []
    for i in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(manual[i % len(manual)])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.micro import device_us
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(5):
            step(manual[i])
        torch.cuda.synchronize()
    device_ms = sum(device_us(ev) for ev in prof.key_averages()
                    ) / 1e3 / 5 or None     # None: the trace saw no card
    return dict(served, decode_step_ms_median=float(np.median(ms[3:])),
                decode_step_device_ms=device_ms,
                greedy_equals_decode_loop=True, slot_reuse_equal=True,
                reuse_equals_request_0=again[0] == first.out_tokens,
                line=line)


def kernel_launches() -> int:
    """Launches of every kernel of the port so far (their counters)."""
    from repro_torch.kernels import fused_vops, kdotp, kvi_walk, micro
    return (fused_vops.launch_count + kdotp.launch_count +
            kvi_walk.launch_count +
            sum(m.launch_count for m in micro.MODULES.values()))


def other_launches() -> int:
    """Launches of every kernel of the port but the SSD scan's, which the
    zoo's SSM layers run on the card (``ssd_chunked`` on CUDA tensors)."""
    from repro_torch.kernels import ssd_scan as ss
    return kernel_launches() - ss.launch_count


def ssd_parts(since=None) -> dict:
    """The SSD's launches by part (``ssd_scan.part_launches``), or those
    since ``since`` (an earlier reading)."""
    from repro_torch.kernels import ssd_scan as ss
    parts = ss.TRAIN_PARTS + ss.BWD_PARTS
    now = {k: ss.part_launches[k] for k in parts}
    return now if since is None else {k: now[k] - since[k] for k in parts}


def ssd_step_launches(cfg, par) -> dict:
    """The SSD's launches a train step on the card by part: every SSM
    layer, and every hybrid one with Mamba-2 heads, runs the forward's
    parts once, twice with its block recomputed (``remat="block"``), and
    the backward's once (hymba's Mamba-1 scan is plain torch)."""
    from repro_torch.kernels import ssd_scan as ss
    L = cfg.num_layers if cfg.family == "ssm" or (
        cfg.family == "hybrid" and cfg.ssm_kind == "mamba2") else 0
    fwd = L * (2 if par.remat == "block" else 1)
    return {**dict.fromkeys(ss.TRAIN_PARTS, fwd),
            **dict.fromkeys(ss.BWD_PARTS, L)}


#: phase 9 (d): the benchmark cell's model (mamba2-1.3b at full width and
#: depth, blocks recomputed) for one train step of this batch x seq
SSD_STEP_ARCH, SSD_STEP_B, SSD_STEP_S = "mamba2-1.3b", 2, 4096


def run_ssd_step(device, seed, log=print) -> dict:
    """Phase 9 (d): one train step of ``SSD_STEP_ARCH`` at full width and
    depth through ``launch.train.build_trainer`` with the blocks
    recomputed, as the benchmark cell runs it: the SSD's launches by part
    in that step, held to :func:`ssd_step_launches`."""
    import torch
    from repro_torch.launch import train
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import params as params_lib
    from repro_torch.optim.optimizer import adamw_init
    cfg, par, shape, rules, step, data, opt = train.build_trainer(
        SSD_STEP_ARCH, reduced=False, seq=SSD_STEP_S, batch=SSD_STEP_B,
        steps=10, overrides={"remat": "block"})
    params = params_lib.initialize(zoo.param_template(cfg), seed,
                                   device=device)
    state = adamw_init(params, opt)
    batch = train.place_batch(data.batch_at(0), cfg, shape, rules, device)
    data.close()
    before = ssd_parts()
    _, _, met = step(params, state, batch)
    torch.cuda.synchronize()
    got, want = ssd_parts(since=before), ssd_step_launches(cfg, par)
    loss = float(met["loss"])
    if got != want or not np.isfinite(loss):
        raise AssertionError(f"{SSD_STEP_ARCH} step: SSD launches {got}, "
                             f"want {want}; loss {loss}")
    del params, state, batch, step
    torch.cuda.empty_cache()
    rec = dict(arch=SSD_STEP_ARCH, batch=SSD_STEP_B, seq=SSD_STEP_S,
               layers=cfg.num_layers, remat=par.remat, loss=loss,
               ssd_launches=got, ssd_launches_total=sum(got.values()))
    log(f"[ssd_train] (d) {SSD_STEP_ARCH} {SSD_STEP_B} x {SSD_STEP_S}, "
        f"{cfg.num_layers} layers, remat {par.remat}: one train step "
        f"launched the SSD's parts {json.dumps(got)}, "
        f"{rec['ssd_launches_total']} in all")
    return rec


#: phase 10 (d): the benchmark cell's model (hymba-1.5b at full width and
#: depth, blocks recomputed) for one train step of this batch x seq
SCAN_STEP_ARCH, SCAN_STEP_B, SCAN_STEP_S = "hymba-1.5b", 2, 1024


def scan_parts(since=None) -> dict:
    """The Mamba-1 scan's launches by part (``selective_scan.
    part_launches``), or those since ``since`` (an earlier reading)."""
    from repro_torch.kernels import selective_scan as sk
    now = dict(sk.part_launches)
    return now if since is None else {k: now[k] - since[k] for k in now}


def run_scan_step(device, seed, log=print) -> dict:
    """Phase 10 (d): one train step of ``SCAN_STEP_ARCH`` at full width and
    depth through ``launch.train.build_trainer`` with the blocks
    recomputed, as the benchmark cell runs it: the scan's launches by
    part, each forward part twice a layer (the forward and its recompute)
    and each backward part once."""
    import torch
    from repro_torch.kernels import selective_scan as sk
    from repro_torch.launch import train
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import params as params_lib
    from repro_torch.optim.optimizer import adamw_init
    cfg, par, shape, rules, step, data, opt = train.build_trainer(
        SCAN_STEP_ARCH, reduced=False, seq=SCAN_STEP_S, batch=SCAN_STEP_B,
        steps=10, overrides={"remat": "block"})
    params = params_lib.initialize(zoo.param_template(cfg), seed,
                                   device=device)
    state = adamw_init(params, opt)
    batch = train.place_batch(data.batch_at(0), cfg, shape, rules, device)
    data.close()
    before = scan_parts()
    _, _, met = step(params, state, batch)
    torch.cuda.synchronize()
    L = cfg.num_layers
    got = scan_parts(since=before)
    want = {**dict.fromkeys(sk.PARTS, 2 * L), **dict.fromkeys(sk.BWD_PARTS,
                                                              L)}
    loss = float(met["loss"])
    if got != want or not np.isfinite(loss):
        raise AssertionError(f"{SCAN_STEP_ARCH} step: scan launches {got}, "
                             f"want {want}; loss {loss}")
    del params, state, batch, step
    torch.cuda.empty_cache()
    rec = dict(arch=SCAN_STEP_ARCH, batch=SCAN_STEP_B, seq=SCAN_STEP_S,
               layers=L, remat=par.remat, loss=loss, scan_launches=got,
               scan_launches_total=sum(got.values()))
    log(f"[selective_scan] (d) {SCAN_STEP_ARCH} {SCAN_STEP_B} x "
        f"{SCAN_STEP_S}, {L} layers, remat {par.remat}: one train step "
        f"launched the scan's parts {json.dumps(got)}, "
        f"{rec['scan_launches_total']} in all")
    return rec


def run_selective_scan(device, seed, card, log=print) -> dict:
    """Phase 10: Mamba-1's scan for training (``kernels.selective_scan``,
    the zoo's Mamba-1 scan on the card): (a) y, the final state and every
    gradient against the plain scan (``checks.check_selective_scan``) at
    ``checks.selective_scan_card_cases()`` (the last at the benchmark
    cell's shape), float32 and bf16, one launch of each part a check; (b)
    two runs at the cell's shape equal bit for bit; (c) the timings at the
    cell's shape (``micro.time_selective_scan``); (d) the scan's launches
    in one train step of the cell's model (:func:`run_scan_step`)."""
    import torch
    from repro_torch.kernels import checks, micro
    from repro_torch.kernels import selective_scan as sk
    rng = np.random.default_rng(seed)
    cases = checks.selective_scan_card_cases()
    err = dict.fromkeys(checks.SELECTIVE_SCAN_OUTPUTS, 0.0)
    for shape in cases:
        for dt in checks.LM_TYPES:
            before = scan_parts()
            got = checks.check_selective_scan(rng, device=device, dtype=dt,
                                              **shape)
            torch.cuda.synchronize()
            if scan_parts(since=before) != dict.fromkeys(
                    sk.PARTS + sk.BWD_PARTS, 1):
                raise AssertionError(f"selective_scan launches at {shape}: "
                                     f"{scan_parts(since=before)}")
            err = {k: max(err[k], got[k]) for k in err}
        torch.cuda.empty_cache()
    log(f"[selective_scan] (a) outputs and gradients within the plain "
        f"scan's error at {len(cases)} shapes (the last "
        f"{json.dumps(cases[-1])}), float32 and bf16, max abs difference "
        f"{json.dumps(err)}")
    ops = checks.selective_scan_operands(rng, device=device,
                                         dtype=torch.bfloat16, **cases[-1])
    first, second = (checks.selective_scan_outputs(sk.selective_scan, *ops)
                     for _ in range(2))
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("selective_scan: two runs differ")
    del ops, first, second
    torch.cuda.empty_cache()
    log("[selective_scan] (b) two runs equal bit for bit")
    timing = micro.time_selective_scan(micro.SELECTIVE_SCAN_CELL, rng,
                                       device)
    for label, t in timing.items():
        log(f"[selective_scan] (c) {label} "
            f"{json.dumps(micro.SELECTIVE_SCAN_CELL)}: {json.dumps(t)}")
    step = run_scan_step(device, seed, log)
    return dict(max_abs_diff=err, cases=len(cases), times=timing,
                shape=micro.SELECTIVE_SCAN_CELL, step=step, card=card)


def run_ssd_train(device, seed, card, log=print) -> dict:
    """Phase 9: the SSD scan for training (``ssd_scan.ssd_train``, the
    zoo's SSD on the card): (a) y, the final state and every gradient
    against the plain version on the same tensors
    (``checks.check_ssd_train``) at ``checks.ssd_train_card_cases()``
    (the last at the benchmark cell's widths), float32 and bf16 x (B and
    C in x's type), one launch of every part a check; (b) two runs at 2 x
    1024 tokens of 64 heads equal bit for bit; (c) the forward and the
    forward and backward at ``micro.SSD_TRAIN_CELL`` (the benchmark
    cell's row) beside the plain layer and the bound
    (``micro.time_ssd_train``); (d) the SSD's launches in one train step
    of the cell's model (:func:`run_ssd_step`)."""
    import torch
    from repro_torch.kernels import checks, micro
    from repro_torch.kernels import ssd_scan as ss
    rng = np.random.default_rng(seed)
    parts = ss.TRAIN_PARTS + ss.BWD_PARTS
    cases = checks.ssd_train_card_cases()
    err = dict.fromkeys(checks.SSD_TRAIN_OUTPUTS, 0.0)
    for shape in cases:
        for dt in checks.LM_TYPES:
            before = ssd_parts()
            got = checks.check_ssd_train(rng, device=device, dtype=dt,
                                         bc_dtype=dt, **shape)
            torch.cuda.synchronize()
            if ssd_parts(since=before) != dict.fromkeys(parts, 1):
                raise AssertionError(f"ssd_train launches at {shape}: "
                                     f"{ss.part_launches}")
            err = {k: max(err[k], got[k]) for k in err}
        torch.cuda.empty_cache()
    log(f"[ssd_train] (a) outputs and gradients equal the plain version "
        f"at {len(cases)} shapes (the last {json.dumps(cases[-1])}), "
        f"float32 and bf16 x, max abs err {json.dumps(err)}")
    ops = checks.ssd_train_operands(rng, 2, 1024, 64, 64, 128, 1, device,
                                    torch.bfloat16, torch.bfloat16)
    first, second = (checks.ssd_train_outputs(*ops, 256) for _ in range(2))
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("ssd_train: two runs differ")
    log("[ssd_train] (b) two runs equal bit for bit")
    timing = micro.time_ssd_train(micro.SSD_TRAIN_CELL, rng, device)
    for label, t in timing.items():
        log(f"[ssd_train] (c) {label} {json.dumps(micro.SSD_TRAIN_CELL)}: "
            f"{json.dumps(t)}")
    step = run_ssd_step(device, seed, log)
    return dict(max_abs_err=err, cases=len(cases), times=timing,
                shape=micro.SSD_TRAIN_CELL, step=step, card=card)


def run_lm(device, seed, card, log=print) -> dict:
    """Phase 6: (a) every reduced arch, the card against the CPU; (b)
    one arch of each family at full width, decode after prefill against
    the forward; (c) LM serving at full width. The zoo calls the plain
    layers, as the reference's does, but for ``ssd_chunked``, which runs
    the SSD's training kernels on the card (the line counts the launches).
    Returns the ``[lm]`` line's numbers."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reduced = run_lm_reduced(device, seed, log)
    t1 = time.perf_counter()
    full = run_lm_full(device, seed, log)
    t2 = time.perf_counter()
    served = run_lm_serve(device, seed, log)
    t3 = time.perf_counter()
    return {"serve": {k: v for k, v in served.items() if k != "line"},
            "decode_step_ms_median": served["decode_step_ms_median"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "full_width_s": {a: r["seconds"] for a, r in full.items()},
            "full_width": full, "reduced": reduced,
            "phase_s": {"reduced": t1 - t0, "full_width": t2 - t1,
                        "serve": t3 - t2},
            "card": card}


# ---------------------------------------------------------------------------
# phase 7: LM training
# ---------------------------------------------------------------------------

#: phase 7 (a): one reduced arch of each family, two train steps on the
#: card and on the CPU — (arch, Parallelism overrides on the card, the
#: optimizer's moment dtype); grad_accum=2 on the card is held against
#: the whole batch (grad_accum 1) on the CPU
TRAIN_REDUCED = (("llama3.2-1b", {}, "float32"),
                 ("mixtral-8x7b", {}, "float32"),
                 ("mamba2-1.3b", {"remat": "block"}, "float32"),
                 ("hymba-1.5b", {}, "int8"),          # grok's moment_dtype
                 ("seamless-m4t-medium", {}, "float32"),
                 ("pixtral-12b", {"grad_accum": 2}, "float32"))
TRAIN_S, TRAIN_B, TRAIN_STEPS = 64, 4, 2
#: an lr that moves the reduced weights well past the tolerance
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100)
#: Adam's g / (sqrt(v) + eps) normalises each element, so the float32
#: rounding of a gradient near zero can move its update by up to lr: at
#: most TRAIN_ILL_SHARE of the params may land past the tolerance (the
#: gradients themselves are held to it), each within TRAIN_STEP_BOUND x
#: lr a step
TRAIN_ILL_SHARE, TRAIN_STEP_BOUND = 1e-3, 4.0
#: with int8 moments, a param whose m or v code differs between the two
#: runs, or whose v code is within 1 of 0 (Adam then divides by a v
#: quantized to about 0), may move by far more than lr: such params are
#: counted with the others, and exempt from the step bound
#: phase 7 (b): python -m repro_torch.launch.train at full width and depth
#: (the config's bf16 activations over f32 master params)
TRAIN_FULL = ["--arch", "llama3.2-1b", "--batch", "4", "--seq", "1024",
              "--steps", "8", "--log-every", "1"]
#: phase 7 (c): resume at llama100m's full config
TRAIN_RESUME = ["--arch", "llama100m", "--batch", "4", "--seq", "1024",
                "--ckpt-interval", "3", "--log-every", "3"]
#: phase 7 (d): run_vops at 1 M int32 lanes, these slot programs
VOPS_LANES = 1 << 20
VOPS_PROGRAMS = ([("kvmul", 2, 0, 1, 0), ("ksrav", 2, 2, None, 9),
                  ("krelu", 2, 2, None, 0)],
                 [("kaddv", 2, 0, 1, 0), ("ksvmulsc", 3, 2, None, -7),
                  ("kvslt", 4, 3, 0, 0), ("ksubv", 5, 4, 1, 0)],
                 [("ksvaddsc", 0, 0, None, 300), ("ksrlv", 1, 0, None, 2),
                  ("ksvslt", 2, 1, None, 5), ("kvcp", 3, 2, None, 0)])


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _codes_apart(got_o, want_o) -> dict:
    """int8 moments: each param path's mask of the elements whose m or v
    code differs between two optimizer states, or whose v code is within
    1 of 0 in either."""
    from repro_torch.models import params as params_lib
    out = {}
    for which in ("m", "v"):
        got = dict(params_lib.tree_leaves(got_o[which]))
        for path, w in params_lib.tree_leaves(want_o[which]):
            if not path.endswith("/q"):
                continue
            g, key = got[path], path[:-2]
            mask = g != w
            if which == "v":
                mask |= (g.abs() <= 1) | (w.abs() <= 1)
            out[key] = out[key] | mask if key in out else mask
    return out


def _train_close(name, got, want, steps: int, lr: float,
                 exempt=None) -> dict:
    """Params of two runs within ``LM_TOL["float32"]`` (rtol and atol) but
    for at most TRAIN_ILL_SHARE of them (counted), each within the move
    ``steps`` Adam steps can make unless ``exempt`` (int8 moments: a mask
    a path, ``_codes_apart``) marks it. Returns the worst error of the
    rest in units of the tolerance and the count past it."""
    from repro_torch.models import params as params_lib
    tol = LM_TOL["float32"]
    got = dict(params_lib.tree_leaves(got))
    worst, past, total = 0.0, 0, 0
    for path, w in params_lib.tree_leaves(want):
        diff = (got[path] - w).abs()
        far = diff > TRAIN_STEP_BOUND * lr * steps * (1 + w.abs())
        if exempt is not None:
            far &= ~exempt[path]
        if far.any():
            raise AssertionError(f"{name} {path}: params apart by "
                                 f"{float(diff[far].max())}")
        bad = diff > tol * (1 + w.abs())
        if (~bad).any():
            worst = max(worst, float((diff / (tol * (1 + w.abs())))[~bad]
                                     .max()))
        past += int(bad.sum())
        total += w.numel()
    if past > TRAIN_ILL_SHARE * total:
        raise AssertionError(f"{name}: {past} of {total} params past the "
                             f"tolerance")
    return {"worst": worst, "params_past_tol": past, "params": total}


def _train_run(cfg, par, opt_cfg, params, data, device, routes=None,
               force=None, flips=None, ssd_launches=None):
    """The first batch's gradients, then TRAIN_STEPS train steps, on
    ``device`` from ``params`` (CPU tensors) on ``data``'s batches:
    the gradients, per-step metrics, params and optimizer state on the
    CPU. MoE
    routes are recorded (``routes``) or forced (``force``), as phase 6
    (a) does; each step's launches of the SSD's parts are appended to
    ``ssd_launches`` when it is a list."""
    import torch
    from repro_torch.models import steps
    from repro_torch.models.sharding import make_rules
    from repro_torch.optim import adamw_init
    rules = make_rules(None, cfg, par)
    step = steps.make_train_step(cfg, rules, par, opt_cfg)
    p = _tree_to(params, device)
    o = adamw_init(p, opt_cfg)
    metrics = []
    ctx = (lm_routes(record=routes, force=force, flips=flips)
           if cfg.num_experts else contextlib.nullcontext())
    with ctx:
        _, grads = steps.value_and_grad(
            steps.make_loss_fn(cfg, rules, par), p,
            {k: torch.from_numpy(v).to(device)
             for k, v in data.batch_at(0).items()})
        for s in range(TRAIN_STEPS):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in data.batch_at(s).items()}
            before = ssd_parts()
            p, o, m = step(p, o, batch)
            if ssd_launches is not None:
                ssd_launches.append(ssd_parts(since=before))
            metrics.append({k: float(v) for k, v in m.items()})
    return _tree_to(grads, "cpu"), metrics, _tree_to(p, "cpu"), \
        _tree_to(o, "cpu")


def run_train_reduced(device, seed, log=print) -> dict:
    """Phase 7 (a): one reduced arch of each family in float32 (TF32
    off), TRAIN_STEPS steps on the CPU and on the card from one set of
    seed-made weights on ``DataPipeline.batch_at`` batches: loss, grad
    norm, the first batch's gradients and every updated param within
    1e-4 (params as ``_train_close`` says); on the card, each step's
    launches of the SSD's parts (``ssd_step_launches``: 2 L forward and L
    backward for mamba2's recomputed blocks, none elsewhere)."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import params as params_lib
    from repro_torch.optim import OptimizerConfig
    out = {}
    for arch, card_par, moments in TRAIN_REDUCED:
        t0 = time.perf_counter()
        spec = configs.get_spec(arch)
        cfg = configs.reduced_model(spec.model).replace(dtype="float32")
        par = spec.parallelism.replace(remat="none", fsdp=False,
                                       sequence_parallel=False)
        opt_cfg = OptimizerConfig(moment_dtype=moments, **TRAIN_OPT)
        params = params_lib.initialize(zoo.param_template(cfg), seed,
                                       device="cpu")
        data = DataPipeline(cfg, configs.ShapeConfig(
            "t", "train", TRAIN_S, TRAIN_B), DataConfig(seed=seed))
        routes, apart = [], []
        want_g, want_m, want_p, want_o = _train_run(
            cfg, par, opt_cfg, params, data, "cpu", routes=routes)
        on_card = par.replace(**card_par)
        launches = []
        got_g, got_m, got_p, got_o = _train_run(
            cfg, on_card, opt_cfg, params, data, device, force=routes,
            flips=apart, ssd_launches=launches)
        want_launches = ssd_step_launches(cfg, on_card)
        if any(n != want_launches for n in launches):
            raise AssertionError(f"{arch}: the SSD's launches a step "
                                 f"{launches}, want {want_launches}")
        if routes or apart:
            raise AssertionError(f"{arch}: {len(routes)} routes left, "
                                 f"{len(apart)} routed apart in float32")
        keys = ("total_loss", "grad_norm") if "grad_accum" in card_par \
            else ("loss", "total_loss", "grad_norm")
        for i, (g, w) in enumerate(zip(got_m, want_m)):
            for k in keys:
                if not np.isfinite(g[k]) or \
                        abs(g[k] - w[k]) > 1e-4 * (1 + abs(w[k])):
                    raise AssertionError(f"{arch} step {i} {k}: card {g[k]}, "
                                         f"CPU {w[k]}")
        grad_err = _lm_close(f"{arch} grads", _lm_np(got_g), _lm_np(want_g),
                             "float32")
        exempt = _codes_apart(got_o, want_o) if moments == "int8" else None
        close = _train_close(arch, got_p, want_p, TRAIN_STEPS,
                             TRAIN_OPT["lr"], exempt)
        if exempt is not None:
            close["int8_codes_apart_or_near_0"] = int(sum(
                x.sum() for x in exempt.values()))
        rec = dict(close, grad_worst=grad_err,
                   card=dict(card_par, moment_dtype=moments),
                   loss=[m["loss"] for m in got_m],
                   grad_norm=[m["grad_norm"] for m in got_m],
                   ssd_launches_per_step=launches,
                   seconds=time.perf_counter() - t0)
        out[arch] = rec
        log(f"[train] (a) {arch}: the card equals the CPU over "
            f"{TRAIN_STEPS} steps ({json.dumps(rec['card'])}"
            f"{' against the whole batch' if 'grad_accum' in card_par else ''}"
            f"): loss, grad norm and the first batch's grads within "
            f"{grad_err:.4f} x 1e-4; params within {close['worst']:.4f} x "
            f"1e-4 but {close['params_past_tol']} of {close['params']} "
            f"(Adam-amplified rounding)")
    return out


def run_train_full(device, seed, log=print) -> dict:
    """Phase 7 (b): ``python -m repro_torch.launch.train``'s ``main`` at
    full width and depth (``TRAIN_FULL``): every loss and grad norm
    finite, the params moved, step 0's loss within 5e-2 (relative) of
    the same step with float32 activations; the median step ms, tok/s,
    the device ms a step (profiler, two more steps), peak memory and the
    ten device events that take most of a step (recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.micro import device_us
    from repro_torch.launch import train
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import params as params_lib
    from repro_torch.models import steps as steps_lib
    from repro_torch.models.sharding import make_rules
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    report, buf = {}, io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train.main(TRAIN_FULL + ["--seed", str(seed), "--device",
                                      str(device)], report=report)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    lines = buf.getvalue().splitlines()
    steps = report["steps"]
    if rc != 0 or len(steps) != 8 or not all(
            np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
            for s in steps):
        raise AssertionError(f"launch.train: rc {rc}, steps {steps}")
    cfg, data = report["cfg"], report["data"]
    B, S = 4, 1024
    # step 0 with float32 activations on the initial weights
    par = train.build_trainer("llama3.2-1b", reduced=False, seq=S, batch=B,
                              steps=8)[1]
    init = params_lib.initialize(zoo.param_template(cfg), seed,
                                 device=device)
    moved = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        params_lib.tree_leaves(init),
        params_lib.tree_leaves(report["params"])))
    if not moved > 0:
        raise AssertionError("launch.train: the params did not move")
    cfg32 = cfg.replace(dtype="float32")
    batch0 = {k: torch.from_numpy(v).to(device)
              for k, v in data.batch_at(0).items()}
    with torch.no_grad():
        _, m32 = steps_lib.make_loss_fn(
            cfg32, make_rules(None, cfg32, par), par)(init, batch0)
    loss32 = float(m32["loss"])
    rel = abs(steps[0]["loss"] - loss32) / abs(loss32)
    if rel > 5e-2:
        raise AssertionError(f"step 0 loss {steps[0]['loss']} against "
                             f"{loss32} with float32 activations: {rel}")
    del init, m32, batch0
    # two more steps in a profiler trace: the device's time a step
    step_fn, p, o = report["train_step"], report["params"], \
        report["opt_state"]
    del report
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in data.batch_at(s).items()} for s in (8, 9)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches:
            p, o, _ = step_fn(p, o, b)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_ms = sum(device_us(ev) for ev in events) / 1e3 / 2 \
        or None                                 # None: the trace saw no card
    top = sorted(((device_us(ev) / 1e3 / 2, ev.key) for ev in events),
                 reverse=True)[:10]
    del p, o, step_fn, batches
    step_ms = [s["seconds"] * 1e3 for s in steps]
    median_ms = float(np.median(step_ms[1:]))
    n_params = zoo.param_count(cfg)
    rec = {"step_ms": step_ms, "step_ms_median": median_ms,
           "tok_per_s": B * S / (median_ms / 1e3),
           "device_ms_per_step": device_ms,
           "max_memory_allocated": peak,
           "params": n_params, "batch": B, "seq": S,
           "loss": [s["loss"] for s in steps],
           "grad_norm": [s["grad_norm"] for s in steps],
           "step0_loss_float32": loss32, "step0_rel_err": rel,
           "params_moved_max": moved, "main_s": main_s,
           "top_device_ms_per_step": [[k, ms] for ms, k in top if ms],
           "first_line": lines[0], "last_line": lines[-1]}
    log(f"[train] (b) {lines[0]}; {lines[-1]}")
    torch.cuda.empty_cache()
    return rec


def run_train_resume(device, seed, log=print) -> dict:
    """Phase 7 (c): ``launch.train`` at llama100m's full config, 6 steps
    with a checkpoint every 3, against 3 steps then ``--resume`` for 3
    more: params and optimizer state equal bit for bit."""
    import shutil
    import torch
    from repro_torch.launch import train
    from repro_torch.models import params as params_lib
    ck = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ck, ignore_errors=True)
    runs, secs, outs = {}, {}, {}
    for name, extra in (("straight", ["--steps", "6", "--ckpt-dir",
                                      str(ck / "a")]),
                        ("first", ["--steps", "3", "--ckpt-dir",
                                   str(ck / "b")]),
                        ("resumed", ["--steps", "6", "--ckpt-dir",
                                     str(ck / "b"), "--resume"])):
        report, buf = {}, io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = train.main(TRAIN_RESUME + ["--seed", str(seed), "--device",
                                            str(device)] + extra,
                            report=report)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        outs[name] = buf.getvalue().splitlines()
        if rc != 0:
            raise AssertionError(f"launch.train {name}: rc {rc}")
        if name != "first":
            runs[name] = {"params": report["params"],
                          "opt": report["opt_state"],
                          "start": report["start_step"],
                          "steps": report["steps"]}
        del report
    a, b = runs["straight"], runs["resumed"]
    if b["start"] != 3 or "resumed from step 3" not in outs["resumed"]:
        raise AssertionError(f"resume started at {b['start']}")
    want = dict(params_lib.tree_leaves({"params": a["params"],
                                        "opt": a["opt"]}))
    got = dict(params_lib.tree_leaves({"params": b["params"],
                                       "opt": b["opt"]}))
    unequal = [k for k in want if not torch.equal(got[k], want[k])]
    if set(got) != set(want) or unequal:
        raise AssertionError(f"resumed state differs from the straight "
                             f"run at {unequal[:5]}")
    ckpt_bytes = sum(f.stat().st_size for f in (ck / "a").rglob("*")
                     if f.is_file())
    rec = {"leaves_bit_equal": len(want), "seconds": secs,
           "losses_straight": [s["loss"] for s in a["steps"]],
           "losses_resumed": [s["loss"] for s in b["steps"]],
           "checkpoint_bytes": ckpt_bytes}
    log(f"[train] (c) llama100m: 6 steps straight = 3 + --resume 3, "
        f"{len(want)} leaves of params and optimizer state bit for bit; "
        f"seconds {json.dumps(secs)}")
    del runs, a, b, want, got
    shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


def run_train_vops(device, seed, log=print) -> dict:
    """Phase 7 (d): the deprecated ``run_vops`` shim at VOPS_LANES int32
    lanes, one ``fused_vops`` launch a call, bit for bit the plain
    version on the same card tensors and on the CPU; then the backends of
    ``examples/torch_quickstart.py`` on the card."""
    import importlib.util
    import warnings
    import torch
    from repro_torch.kernels import fused_vops as fv
    from repro_torch.kernels import kvi_walk as kw
    from repro_torch.kernels import ref
    from repro_torch.kernels.kvi_vops import run_vops
    rng = np.random.default_rng(seed)
    a, b = (torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, VOPS_LANES,
                                          dtype=np.int64).astype(np.int32))
            for _ in range(2))
    ac, bc = a.to(device), b.to(device)
    fv.launch_count = kw.launch_count = 0
    times = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for prog in VOPS_PROGRAMS:
            got = run_vops(prog, [ac, bc])
            torch.cuda.synchronize()
            if not (torch.equal(got, ref.vops_ref(prog, [ac, bc])) and
                    torch.equal(got.cpu(), run_vops(prog, [a, b]))):
                raise AssertionError(f"run_vops {prog}: the card differs "
                                     f"from the plain version")
        launches = fv.launch_count
        for prog in VOPS_PROGRAMS:
            times.append({"ms": events_ms(lambda: run_vops(prog, [ac, bc]),
                                          20),
                          "plain_ms": events_ms(
                              lambda: ref.vops_ref(prog, [ac, bc]), 20)})
    if launches != len(VOPS_PROGRAMS):
        raise AssertionError(f"run_vops: {launches} fused_vops launches for "
                             f"{len(VOPS_PROGRAMS)} calls")
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    kw.launch_count = 0
    with contextlib.redirect_stdout(io.StringIO()):
        outs = qs.write_once_run_everywhere(device)
        qs.conv_differential(device)        # asserts the three agree
    torch.cuda.synchronize()
    if not all(np.array_equal(v, outs["oracle"]) for v in outs.values()) \
            or not kw.launch_count:
        raise AssertionError(f"quickstart on the card: {outs}, "
                             f"{kw.launch_count} kvi_walk launches")
    rec = {"lanes": VOPS_LANES, "programs": len(VOPS_PROGRAMS),
           "fused_vops_launches": launches, "times": times,
           "quickstart_kvi_walk_launches": kw.launch_count}
    log(f"[train] (d) run_vops at {VOPS_LANES} int32 lanes equals its "
        f"plain version bit for bit, {launches} fused_vops launches for "
        f"{len(VOPS_PROGRAMS)} calls; quickstart's oracle / cyclesim / "
        f"torch backends agree on the card ({kw.launch_count} kvi_walk "
        f"launches)")
    return rec


def run_train(device, seed, card, log=print) -> dict:
    """Phase 7: (a) one reduced arch of each family, the card against the
    CPU; (b) ``launch.train`` at full width; (c) resume bit for bit; (d)
    ``run_vops`` and the quickstart's backends. (a)-(c) launch no kernel
    of the port but the SSD scan's (``ssd_chunked`` on the card): the zoo
    calls the plain layers otherwise, as the reference's does. Returns the
    ``[train]`` line's numbers."""
    t = [time.perf_counter()]
    phase_s = {}

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - t[0]
        t[0] = now

    before = other_launches()
    reduced = run_train_reduced(device, seed, log)
    lap("reduced")
    full = run_train_full(device, seed, log)
    lap("full_width")
    resume = run_train_resume(device, seed, log)
    lap("resume")
    if other_launches() != before:
        raise AssertionError("the training path launched a kernel of the "
                             "port other than the SSD scan's")
    vops = run_train_vops(device, seed, log)
    lap("run_vops")
    keys = ("step_ms_median", "tok_per_s", "device_ms_per_step",
            "max_memory_allocated")
    return dict({k: full[k] for k in keys}, full_width=full, reduced=reduced,
                resume=resume, run_vops=vops, phase_s=phase_s, card=card)


# ---------------------------------------------------------------------------
# phase 8: the mesh paths
# ---------------------------------------------------------------------------

#: phase 8 (a): reduced archs trained on the card's 1x1 mesh against
#: ``mesh=None`` (float32; the mesh takes the arch's own Parallelism)
MESH_REDUCED = ("llama3.2-1b", "mixtral-8x7b", "mamba2-1.3b")
#: phase 8 (b): llama3.2-1b at phase 7 (b)'s batch (B, S) on the mesh,
#: the arch's own remat ("block"), these many steps
MESH_FULL_BATCH, MESH_FULL_STEPS = (4, 1024), 3
#: phase 8 (d), (e): a gradient tree for cross_pod_mean, the pipeline's
#: stage width and batch
MESH_CROSS = {"w": (2048, 8192), "b": (8192,)}
MESH_PIPE_D, MESH_PIPE_B = 1024, 64


@contextlib.contextmanager
def one_rank_group(device):
    """A default process group of one rank (NCCL on the card, gloo on the
    CPU) over a ``file://`` rendezvous in a temporary directory, destroyed
    with the directory on exit."""
    import shutil
    import tempfile
    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="chip_smoke_group_")
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/rendezvous", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _whole(x):
    from repro_torch.compat import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _mesh_train(arch, mesh, device, seed, *, reduced, batch, seq, steps,
                overrides=None):
    """``build_trainer(mesh=)``'s state and step run ``steps`` steps on
    ``DataPipeline.batch_at`` batches: the first batch's gradients, the
    losses and each step's seconds, the final state and the trainer."""
    import torch
    from repro_torch.compat import implicit_replication
    from repro_torch.launch import train
    from repro_torch.models import steps as steps_lib
    cfg, par, shape, rules, step, data, opt_cfg = train.build_trainer(
        arch, reduced=reduced, seq=seq, batch=batch, steps=steps, mesh=mesh,
        seed=seed, overrides=overrides)
    params, opt = train.init_state(cfg, rules, opt_cfg, seed, device)
    grads = None
    if reduced:
        b0 = train.place_batch(data.batch_at(0), cfg, shape, rules, device)
        with implicit_replication():
            _, grads = steps_lib.value_and_grad(
                steps_lib.make_loss_fn(cfg, rules, par), params, b0)
    losses, seconds = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        b = train.place_batch(data.batch_at(i), cfg, shape, rules, device)
        params, opt, m = step(params, opt, b)
        losses.append(float(_whole(m["loss"])))
        seconds.append(time.perf_counter() - t0)
    del b, m
    return dict(cfg=cfg, par=par, shape=shape, rules=rules, step=step,
                data=data, grads=grads, losses=losses, seconds=seconds,
                params=params, opt=opt)


def run_mesh_reduced(device, seed, mesh, log=print) -> dict:
    """Phase 8 (a): each of MESH_REDUCED at ``reduced_model`` size in
    float32, 2 steps through ``build_trainer(mesh=)`` on the 1x1 mesh
    and through ``mesh=None`` on the same device: losses and the first
    batch's gradients within 1e-4."""
    from repro_torch.models import params as params_lib
    out = {}
    for arch in MESH_REDUCED:
        t0 = time.perf_counter()
        kw = dict(reduced=True, batch=TRAIN_B, seq=TRAIN_S, steps=2,
                  overrides={"dtype": "float32"})
        one = _mesh_train(arch, None, device, seed, **kw)
        on = _mesh_train(arch, mesh, device, seed, **kw)
        for i, (g, w) in enumerate(zip(on["losses"], one["losses"])):
            if abs(g - w) > 1e-4 * (1 + abs(w)):
                raise AssertionError(f"{arch} step {i}: mesh loss {g}, one "
                                     f"device {w}")
        got = dict(params_lib.tree_leaves(on["grads"]))
        worst = 0.0
        for path, w in params_lib.tree_leaves(one["grads"]):
            err = float(((_whole(got[path]) - w).abs() /
                         (1e-4 * (1 + w.abs()))).max())
            if err > 1:
                raise AssertionError(f"{arch} grad {path}: {err} x 1e-4")
            worst = max(worst, err)
        out[arch] = {"loss_mesh": on["losses"], "loss_one": one["losses"],
                     "grad_worst": worst, "par": {
                         k: getattr(on["par"], k) for k in
                         ("fsdp", "sequence_parallel", "remat")},
                     "seconds": time.perf_counter() - t0}
        log(f"[mesh] (a) {arch}: build_trainer(mesh=1x1) equals mesh=None "
            f"over 2 steps: losses {on['losses']}, first grads within "
            f"{worst:.4f} x 1e-4 ({json.dumps(out[arch]['par'])})")
    return out


def run_mesh_full(device, seed, mesh, train7=None, log=print) -> dict:
    """Phase 8 (b), (c), (f): llama3.2-1b at phase 7 (b)'s batch through
    ``build_trainer(mesh=)`` with the arch's own remat, MESH_FULL_STEPS
    steps: step 0's loss equal (1e-4 relative) to the one-device loss of
    the same weights and batch and to phase 7 (b)'s (when it ran); the
    step ms, tok/s and peak memory. (c) the params and step count saved
    from the mesh and restored with ``shardings=``, bit for bit. (f) one
    more step under ``analyze_step``: per-device dot FLOPs against
    ``FlopCounterMode`` on a step after it and against 6·N·T."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import manager
    from repro_torch.launch.hlo_analysis import (analyze_step,
                                                 xla_cost_analysis)
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import params as params_lib
    from repro_torch.models import steps as steps_lib
    from repro_torch.models.sharding import make_rules
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    B, S = MESH_FULL_BATCH
    t0 = time.perf_counter()
    run = _mesh_train("llama3.2-1b", mesh, device, seed, reduced=False,
                      batch=B, seq=S, steps=MESH_FULL_STEPS)
    cfg, par, rules = run["cfg"], run["par"], run["rules"]
    peak = torch.cuda.max_memory_allocated() if cuda else None
    # step 0's loss on one device: the same seeded weights and batch
    init = params_lib.initialize(zoo.param_template(cfg), seed,
                                 device=device)
    with torch.no_grad():
        _, m1 = steps_lib.make_loss_fn(cfg, make_rules(None, cfg, par), par)(
            init, {k: torch.from_numpy(v).to(device)
                   for k, v in run["data"].batch_at(0).items()})
    del init
    loss_one = float(m1["loss"])
    rel = abs(run["losses"][0] - loss_one) / abs(loss_one)
    want7 = train7["full_width"]["loss"][0] if train7 else None
    rel7 = None if want7 is None else abs(run["losses"][0] - want7) / \
        abs(want7)
    if rel > 1e-4 or (rel7 is not None and rel7 > 1e-4):
        raise AssertionError(f"mesh step 0 loss {run['losses'][0]}: one "
                             f"device {loss_one}, phase 7 (b) {want7}")
    step_ms = [s * 1e3 for s in run["seconds"]]
    median_ms = float(np.median(step_ms[1:]))
    rec = {"steps": MESH_FULL_STEPS, "batch": B, "seq": S,
           "remat": par.remat, "loss": run["losses"],
           "step0_loss_one_device": loss_one, "step0_rel_err": rel,
           "step0_loss_phase7": want7, "step0_rel_err_phase7": rel7,
           "step_ms": step_ms, "step_ms_median": median_ms,
           "tok_per_s": B * S / (median_ms / 1e3),
           "max_memory_allocated": peak,
           "phase7": None if not train7 else {
               k: train7[k] for k in ("step_ms_median", "tok_per_s",
                                      "max_memory_allocated")},
           "seconds": time.perf_counter() - t0}
    log(f"[mesh] (b) llama3.2-1b on the 1x1 mesh, batch {B} x {S}, remat "
        f"{par.remat}: step 0 loss {run['losses'][0]} (one device "
        f"{loss_one}, phase 7 (b) {want7}); {median_ms:.1f} ms a step, "
        f"{rec['tok_per_s']:.1f} tok/s, peak {(peak or 0) / 1e9:.2f} GB"
        + ("" if not train7 else
           f" (phase 7 (b): {train7['step_ms_median']:.1f} ms, "
           f"{train7['tok_per_s']:.1f} tok/s, peak "
           f"{train7['max_memory_allocated'] / 1e9:.2f} GB)"))

    # (c) a shardings= save and restore, bit for bit
    t0 = time.perf_counter()
    tree = {"params": run["params"], "count": run["opt"]["count"]}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        manager.save(tmp, MESH_FULL_STEPS, tree)
        back, step = manager.restore(tmp, tree, shardings=params_lib
                                     .placements_of(tree), device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want, got = dict(params_lib.tree_leaves(tree)), \
        dict(params_lib.tree_leaves(back))
    for path, w in want.items():
        g = got[path]
        if str(getattr(g, "placements", None)) != \
                str(getattr(w, "placements", None)) or \
                not torch.equal(_whole(g), _whole(w)):
            raise AssertionError(f"restored {path} differs")
    del back, got
    nbytes = sum(_whole(w).numel() * _whole(w).element_size()
                 for w in want.values())
    rec["checkpoint"] = {"leaves": len(want), "bytes": nbytes,
                         "step": step,
                         "seconds": time.perf_counter() - t0}
    log(f"[mesh] (c) shardings= save and restore of (b)'s params and step "
        f"count: {len(want)} leaves, {nbytes / 1e9:.2f} GB, bit for bit, "
        f"{rec['checkpoint']['seconds']:.1f} s")

    # (f) the step accountant over one more step
    t0 = time.perf_counter()
    shape, data, step_fn = run["shape"], run["data"], run["step"]
    from repro_torch.launch import train
    p, o = run["params"], run["opt"]
    del run, tree, want
    b = train.place_batch(data.batch_at(MESH_FULL_STEPS), cfg, shape, rules,
                          device)
    acct = analyze_step(step_fn, p, o, b)
    p, o, _ = acct.pop("result")
    counter = xla_cost_analysis(step_fn, p, o, b)["flops"]
    n_params = zoo.param_count(cfg)
    six_nt = 6 * n_params * B * S
    if abs(acct["dot_flops"] - counter) > 1e-6 * counter:
        raise AssertionError(f"analyze_step dot_flops {acct['dot_flops']} "
                             f"against FlopCounterMode {counter}")
    rec["accountant"] = {
        "dot_flops": acct["dot_flops"], "flop_counter": counter,
        "six_nt": six_nt, "over_six_nt": acct["dot_flops"] / six_nt,
        "hbm_bytes": acct["hbm_bytes"],
        "collective_bytes": acct["collective_bytes"]["total"],
        "seconds": time.perf_counter() - t0}
    log(f"[mesh] (f) analyze_step over a step: dot_flops "
        f"{acct['dot_flops']:.6e} = FlopCounterMode {counter:.6e}; "
        f"{rec['accountant']['over_six_nt']:.4f} x 6NT ({six_nt:.6e}); "
        f"hbm_bytes {acct['hbm_bytes']:.6e}; collective bytes "
        f"{acct['collective_bytes']['total']:.0f}")
    del p, o, b
    if cuda:
        torch.cuda.empty_cache()
    return rec


def run_mesh_small(device, seed, mesh3, log=print) -> dict:
    """Phase 8 (d): ``cross_pod_mean(mesh=)`` on a 1x1x1 pod mesh equal
    bit for bit to ``mesh=None``; (e) ``pipeline_apply`` with one stage
    against ``unpipelined_reference``."""
    import torch
    from repro_torch.models.pipeline import (pipeline_apply,
                                             unpipelined_reference)
    from repro_torch.optim.grad_compress import cross_pod_mean
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    g = {k: randn(s) for k, s in MESH_CROSS.items()}
    e = {k: randn(s, 1e-3) for k, s in MESH_CROSS.items()}
    one = cross_pod_mean(g, e)
    on = cross_pod_mean(g, e, mesh=mesh3, axis_name="pod")
    for i, name in enumerate(("mean", "error")):
        for k in MESH_CROSS:
            if not torch.equal(on[i][k], one[i][k]):
                raise AssertionError(f"cross_pod_mean {name} {k} differs")
    D, Bp = MESH_PIPE_D, MESH_PIPE_B
    params = {"w": randn((1, D, D), D ** -0.5), "b": randn((1, D), 0.1)}
    x = randn((Bp, D))

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    got = pipeline_apply(stage, params, x, mesh=mesh3, axis="pod",
                         num_microbatches=4)
    want = unpipelined_reference(stage, params, x)
    err = float((got - want).abs().max())
    if err > 1e-5:
        raise AssertionError(f"pipeline_apply: {err} from the reference")
    rec = {"cross_pod_bit_equal": True, "cross_pod_leaves": len(MESH_CROSS),
           "pipeline_max_err": err, "pipeline_microbatches": 4}
    log(f"[mesh] (d) cross_pod_mean on the 1x1x1 pod mesh equals mesh=None "
        f"bit for bit ({len(MESH_CROSS)} leaves); (e) pipeline_apply, one "
        f"stage, 4 microbatches: {err:.3e} from unpipelined_reference")
    return rec


def run_mesh(device, seed, card, train7=None, log=print) -> dict:
    """Phase 8: a one-rank process group and a 1x1 ("data", "model") mesh
    on the card, then (a)-(f) (see the module docstring). Returns the
    ``[mesh]`` line's numbers; the group is destroyed at the end."""
    from repro_torch.compat import init_device_mesh
    t = [time.perf_counter()]
    phase_s = {}

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - t[0]
        t[0] = now

    before = other_launches()
    with one_rank_group(device):
        mesh = init_device_mesh(device.type, (1, 1),
                                mesh_dim_names=("data", "model"))
        mesh3 = init_device_mesh(device.type, (1, 1, 1),
                                 mesh_dim_names=("pod", "data", "model"))
        reduced = run_mesh_reduced(device, seed, mesh, log)
        lap("reduced")
        small = run_mesh_small(device, seed, mesh3, log)
        lap("cross_pod_pipeline")
        full = run_mesh_full(device, seed, mesh, train7, log)
        lap("full_width")
    if other_launches() != before:
        raise AssertionError("the mesh paths launched a kernel of the port "
                             "other than the SSD scan's")
    keys = ("step_ms_median", "tok_per_s", "max_memory_allocated")
    return dict({k: full[k] for k in keys}, full_width=full, reduced=reduced,
                cross_pod_pipeline=small, phase_s=phase_s,
                seconds=sum(phase_s.values()), card=card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only-lm", action="store_true",
                    help="run phase 6 alone (no kernel or ok line)")
    ap.add_argument("--only-train", action="store_true",
                    help="run phase 7 alone (builds only fused_vops, "
                         "kvi_walk and the SSD's training sources; no "
                         "kernel or ok line)")
    ap.add_argument("--only-mesh", action="store_true",
                    help="run phase 8 alone (no kernel or ok line)")
    ap.add_argument("--only-ssd-train", action="store_true",
                    help="run phase 9 alone (builds the SSD's training "
                         "source; no kernel or ok line)")
    ap.add_argument("--only-selective-scan", action="store_true",
                    help="run phase 10 alone (builds the Mamba-1 scan's "
                         "source; no kernel or ok line)")
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

    def lm_phase():
        before = kernel_launches()
        lm = run_lm(device, args.seed, card,
                    log=lambda m: print(f"{m}; card: {card}"))
        lm["kernel_launches"] = kernel_launches() - before
        print(f"[lm] {json.dumps(lm)}")
        stamp("lm")

    def train_phase():
        train = run_train(device, args.seed, card,
                          log=lambda m: print(f"{m}; card: {card}"))
        print(f"[train] {json.dumps(train)}; card: {card}")
        stamp("train")
        return train

    def mesh_phase(train7=None):
        mesh = run_mesh(device, args.seed, card, train7,
                        log=lambda m: print(f"{m}; card: {card}"))
        print(f"[mesh] {json.dumps(mesh)}; card: {card}")
        stamp("mesh")
        return mesh

    if args.only_lm:
        lm_phase()
        return 0
    if args.only_train:
        train_phase()
        return 0
    if args.only_mesh:
        mesh_phase()
        return 0

    def ssd_train_phase():
        out = run_ssd_train(device, args.seed, card,
                            log=lambda m: print(f"{m}; card: {card}"))
        print(f"[ssd_train] {json.dumps(out)}")
        stamp("ssd_train")
        return out

    if args.only_ssd_train:
        ssd_train_phase()
        return 0

    def scan_phase():
        out = run_selective_scan(device, args.seed, card,
                                 log=lambda m: print(f"{m}; card: {card}"))
        print(f"[selective_scan] {json.dumps(out)}")
        stamp("selective_scan")
        return out

    if args.only_selective_scan:
        scan_phase()
        return 0

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

    # 3d. the DSE's walltime stage on the card -----------------------------
    fv.launch_count = kd.launch_count = kw.launch_count = 0
    dse = run_dse_phase(device, args.seed,
                        log=lambda m: print(f"{m}; card: {card}"))
    if fv.launch_count or kd.launch_count:
        raise AssertionError(f"phase 3d: fused_vops {fv.launch_count}, "
                             f"kdotp {kd.launch_count} launches")

    stamp("dse")

    # 3v. slice 1 under verify=True ---------------------------------------
    kw.launch_count = 0
    verified = run_verify(device, rng, be_off, {
        r["phase"]: r["warm_wall_s"] for r in records}, scale=VERIFY_SCALE,
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
                                     for r in verified}),
                             dse=dse)
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
                      "serving", "telemetry", "verified", "dse"):
            if extra in t:
                entry[extra] = t[extra]
        if name in paths:
            entry["paths"] = paths[name]
        kernels.append(entry)
        print(f"[time] {name} {t['shape']}: {json.dumps(entry)}; "
              f"card: {card}")
    stamp("time")

    # 6. the LM model zoo and LM serving ------------------------------------
    lm_phase()

    # 7. LM training, run_vops ----------------------------------------------
    train = train_phase()
    fused = next(k for k in kernels if k["name"] == "fused_vops")
    fused["run_vops"] = {"launches": train["run_vops"]["fused_vops_launches"],
                         "lanes": VOPS_LANES,
                         "times": train["run_vops"]["times"]}
    # 8. the mesh paths ------------------------------------------------------
    mesh = mesh_phase(train)
    # 9. the SSD scan for training --------------------------------------------
    ssd_train = ssd_train_phase()
    # 10. the Mamba-1 scan for training ----------------------------------------
    scan = scan_phase()
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels, "train": {
        k: v for k, v in train.items() if k not in ("reduced", "full_width",
                                                      "resume")},
        "mesh": {k: v for k, v in mesh.items() if k != "reduced"},
        "ssd_train": ssd_train, "selective_scan": scan}))
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


#: phase 3v's batches are phase 3's over this: the analyzer takes about
#: 0.1 s an instance on the card's host, and at full batches the phase
#: took 262-267 s of a script held to 1200 s
VERIFY_SCALE = 4
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
