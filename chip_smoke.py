#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card, ``nvcc`` and this checkout (``src/repro_torch``);
imports nothing of JAX or of the reference package ``repro``. Phases:

1. build  — compile both CUDA sources of ``src/repro_torch/csrc/`` for
   sm_90a, one ``nvcc`` per source, in parallel;
2. check  — each kernel against its plain PyTorch version on the same
   CUDA tensors at the main path's shapes, bit for bit for integers;
3. slice  — the KVI main path at the paper's sizes through
   ``get_backend("torch").run_workload``: conv2d 32x32 (F = 3 and 11),
   FFT-256, streamed matmul 64x64 (kdotp and kdotpps), pipeline_demo and
   the composite conv / FFT / matmul workload on 3 harts; outputs held
   bit for bit against numpy formulas and against the CPU backend on the
   first 4 instances; the kernels' launch counters must show both kernels
   ran;
4. time   — each kernel at a main-path shape with CUDA events, beside its
   plain version, its bound and (where one exists) a PyTorch library
   call computing the same function.

Any failed check raises, and the script exits non-zero. The last lines
are the card's name and power limit, a JSON object of kernel numbers and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
INT32_OPS_PER_S = 67e12          # 32-bit peak outside the tensor cores
N_CHECK = 4                      # instances re-run on the CPU backend


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


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
    time by kind — the two kernels, memcpy (host <-> device) and other
    device work (the walk's device copies, fills) — or None when the
    trace holds no device time (the profiler may not see the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = fn(*args)
        torch.cuda.synchronize()
    by = {"fused_vops": 0.0, "kdotp": 0.0, "memcpy": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        us = _device_us(ev)
        if not us:
            continue
        kind = ("fused_vops" if "fused_vops_kernel" in ev.key else
                "kdotp" if "reduce_rows_kernel" in ev.key else
                "memcpy" if ev.key.startswith("Memcpy") else "other")
        by[kind] += us / 1e3
    total = sum(by.values())
    return result, (dict(by, total=total) if total else None)


def run_slice(device, rng, scale=1, log=print):
    """Phase 3: drive every main-path workload twice (cold, then warm)
    through ``get_backend("torch").run_workload`` on ``device`` and check
    both runs. The prototypes are optimized once and their instances run
    with ``passes=()``, as serving templates do. Returns the backend and
    one record per workload."""
    import torch
    from repro_torch.kvi import get_backend
    be = get_backend("torch", device=device, passes=())
    cpu = get_backend("torch", device="cpu", passes=())
    records = []
    for name, wl, want in main_path_workloads(rng, scale):
        cold = be.run_workload(wl)
        warm = be.run_workload(wl)
        for r in (cold, warm):
            check_outputs(name, r, want)
            if r.meta["kernel_launches"] <= 0:
                raise AssertionError(f"{name}: no kernel launches")
        check_against_cpu(name, wl, cold, cpu)
        if warm.meta["compile_cache"]["misses"]:
            raise AssertionError(f"{name}: the warm run rebuilt records")
        runs = [cold, warm]
        dev_ms = None
        if torch.device(device).type == "cuda":
            profiled, dev_ms = device_time_ms(be.run_workload, wl)
            runs.append(profiled)
        rec = dict(phase=name, N=len(wl.entries),
                   groups=cold.meta["groups"],
                   kernel_launches=cold.meta["kernel_launches"],
                   launches_all_runs=sum(r.meta["kernel_launches"]
                                         for r in runs),
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
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return be, records


# ---------------------------------------------------------------------------
# kernel timing
# ---------------------------------------------------------------------------

def _timed(fn, reps: int, match=None) -> dict:
    """Two times per call of ``fn`` after a warm-up: ``call_ms`` from
    CUDA events around ``reps`` back-to-back calls (what a caller pays;
    host-bound when the host enqueues slower than the card runs), and
    ``device_ms`` from a ``torch.profiler`` trace of ``reps`` more calls:
    the device time of events whose name contains ``match`` (every
    device event when None), or None when the trace holds no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(_device_us(ev) for ev in prof.key_averages()
             if match is None or match in ev.key)
    return dict(call_ms=call_ms, device_ms=us / 1e3 / reps or None)


def _device_us(ev) -> float:
    """Device time of one averaged profiler event: counted on the device
    events themselves (kernels, memcpy, memset) only — a CPU op reports
    its kernels' time as well, which would count them twice."""
    if (not str(ev.device_type).endswith("CUDA")
            or getattr(ev, "is_user_annotation", False)):
        return 0.0
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0.0))


def _times(kernel: dict, plain: dict, library=None) -> dict:
    """The JSON's times: the kernel's device time (its call time when
    the profiler sees no device time), the plain version's and the
    library call's likewise, each beside its call time."""
    out = dict(ms=kernel["device_ms"] or kernel["call_ms"],
               ms_source="profiler" if kernel["device_ms"] else "events",
               call_ms=kernel["call_ms"],
               plain_ms=plain["device_ms"] or plain["call_ms"],
               plain_call_ms=plain["call_ms"], library_ms=None,
               library_call_ms=None)
    if library is not None:
        out.update(library_ms=library["device_ms"] or library["call_ms"],
                   library_call_ms=library["call_ms"])
    return out


def time_fused(rng, device):
    """fused_vops on the first region of conv2d 32x32 F = 3 (the
    conv32_f3 phase), N = 1024, in the backend's own register file."""
    import torch
    from repro_torch.kernels import fused_vops as fv
    from repro_torch.kernels.checks import random_ints
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
    t = _times(_timed(lambda: fv.fused_vops(record, win, rf, rf), 200,
                      "fused_vops_kernel"),
               _timed(lambda: fv.fused_vops_plain(record, win, rf, rf), 10))
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
    N, n = 128, 64
    rf = random_ints(rng, (N, 3 * n + 1), torch.int32, device)
    a, b, out = rf[:, :n], rf[:, n:2 * n], rf[:, 3 * n]
    before = kd.launch_count
    t = _times(_timed(lambda: kd.reduce_rows(out, a, b), 500,
                      "reduce_rows_kernel"),
               _timed(lambda: kd.reduce_rows_plain(out, a, b), 50))
    x = a.contiguous()
    red = _times(_timed(lambda: kd.reduce_rows(out, a), 500,
                        "reduce_rows_kernel"),
                 _timed(lambda: kd.reduce_rows_plain(out, a), 50),
                 _timed(lambda: torch.sum(x, dim=1, dtype=torch.int64), 500))
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


def _bound(t):
    t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = t["ops"] / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    from repro_torch.kernels import build, checks
    from repro_torch.kernels import fused_vops as fv
    from repro_torch.kernels import kdotp as kd

    device = torch.device("cuda", torch.cuda.current_device())
    card = _card_line()
    t0 = time.perf_counter()

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

    # 2. kernel vs plain on the card ---------------------------------------
    rng = np.random.default_rng(args.seed)
    err = {"fused_vops": 0.0, "kdotp": 0.0}
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
    torch.cuda.synchronize()
    print(f"[check] kernels equal their plain versions on the card: "
          f"max abs err {err}")

    # 3. the slice on the card ---------------------------------------------
    fv.launch_count = 0
    kd.launch_count = 0
    _, records = run_slice(device, rng,
                           log=lambda m: print(f"{m}; card: {card}"))
    launches = {"fused_vops": fv.launch_count, "kdotp": kd.launch_count}
    total = sum(r["launches_all_runs"] for r in records)
    if launches["fused_vops"] <= 0 or launches["kdotp"] <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if sum(launches.values()) != total:
        raise AssertionError(f"launch counters {launches} disagree with "
                             f"the backend's kernel_launches {total}")
    print(f"[slice] launches over the main path (cold, warm and "
          f"profiled runs): "
          f"{launches}; card: {card}")

    # 4. kernel times --------------------------------------------------------
    times = {"fused_vops": time_fused(rng, device),
             "kdotp": time_kdotp(rng, device)}
    kernels = []
    for name, source, replaces in (
            ("fused_vops", "src/repro_torch/csrc/fused_vops.cu",
             "src/repro/kvi/pallas_backend.py:134"),
            ("kdotp", "src/repro_torch/csrc/kdotp.cu",
             "src/repro/kernels/kdotp.py:21")):
        t = times[name]
        bound_ms, bound_by = _bound(t)
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": err[name], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": t["library_ms"]}
        entry.update({k: t[k] for k in ("ms_source", "call_ms",
                                        "plain_call_ms", "library_call_ms",
                                        "shape")})
        if "kvred" in t:
            entry["kvred"] = t["kvred"]
        kernels.append(entry)
        print(f"[time] {name} {t['shape']}: {json.dumps(entry)}; "
              f"card: {card}")
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
