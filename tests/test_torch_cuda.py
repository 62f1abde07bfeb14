"""Card tests: each CUDA kernel against its plain PyTorch version on the
same CUDA tensors, at the main path's shapes (and, for the compute
kernels, at odd shapes and one card-scale shape each; for the KVI walk
kernel, its edge programs, random programs and both arena layouts), and
the backend on the card against the backend on the CPU (and, serving
the CLI's default stream, against the oracle and the CPU server, with
telemetry on as well).
Marked ``cuda``; they skip with a reason where no card (or no nvcc) is
present — decided in a fixture, never at import, so every worker
collects the same tests. Run them on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import json

import numpy as np
import pytest
import torch

import repro_torch.kvi as tk
from repro_torch.kernels import checks
from repro_torch.kernels import fused_vops as fv
from repro_torch.kernels import kdotp as kd
from repro_torch.kernels import kvi_walk as kw
from repro_torch.kernels import micro
from repro_torch.kernels.build import nvcc_path
from repro_torch.kvi.obs import Obs, canonical_trace, validate_trace
from repro_torch.kvi.obs.__main__ import flow_summary
from repro_torch.kvi.programs import conv2d_program, fft_program
from repro_torch.kvi.serving import (DEFAULT_MIX, ServeEngine,
                                     canonical_report, make_templates,
                                     poisson_arrivals)
from repro_torch.kvi.serving.checks import check_against_oracle
from repro_torch.kvi.torch_backend import TorchBackend

pytestmark = pytest.mark.cuda

INT_TYPES = (torch.int8, torch.int16, torch.int32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("hazard", [False, True])
@pytest.mark.parametrize("dtype", INT_TYPES)
@pytest.mark.parametrize("case", [c for c in checks.main_path_cases()
                                  if c[0].startswith("fused")],
                         ids=lambda c: c[0])
def test_fused_kernel_equals_plain(card, case, dtype, hazard):
    rng = np.random.default_rng(3)
    before = fv.launch_count
    shape = dict(case[1])
    if hazard and shape["n"] < 2:
        shape["n"] = 2
    assert checks.check_fused(rng, dtype, device=card, hazard=hazard,
                              **shape) == 0
    torch.cuda.synchronize()
    assert fv.launch_count == before + 1


INT_FLUSHES = [(kd.POST_NONE, 0, kd.ORACLE, True),
               (kd.POST_SHIFT, 9, kd.ORACLE, True),
               (kd.POST_SHIFT, 70, kd.ORACLE, True),
               (kd.POST_NONE, 0, kd.ORACLE, False),
               (kd.POST_ADD, -(1 << 40), kd.ORACLE, False),
               (kd.POST_MUL, 2_000_000_011, kd.ORACLE, False),
               (kd.POST_SHIFT, 7, kd.WRAP32, True),
               (kd.POST_SHIFT, 40, kd.WRAP32, True)]
FLOAT_FLUSHES = [(kd.POST_NONE, 0, kd.WRAP32, True),
                 (kd.POST_SHIFT, 3, kd.WRAP32, True),
                 (kd.POST_NONE, 0, kd.WRAP32, False)]
REDUCE_CASES = [(dt, *f) for dt in INT_TYPES for f in INT_FLUSHES] + \
    [(torch.float32, *f) for f in FLOAT_FLUSHES]


@pytest.mark.parametrize("dtype,post,scalar,mode,dot", REDUCE_CASES)
def test_reduce_kernel_equals_plain(card, dtype, post, scalar, mode, dot):
    rng = np.random.default_rng(4)
    shape = dict(checks.main_path_cases())["kdotp matmul64"]
    before = kd.launch_count
    out_dtypes = (None,) if dtype == torch.float32 else (None, torch.int8)
    for out_dtype in out_dtypes:
        checks.check_reduce(rng, dtype, shape["rows"], shape["n"], card,
                            dot=dot, post=post, scalar=scalar, mode=mode,
                            out_dtype=out_dtype)
    # one long row per block: the strided accumulation and the tree
    checks.check_reduce(rng, dtype, 3, 5000, card, dot=dot, post=post,
                        scalar=scalar, mode=mode)
    assert kd.launch_count == before + len(out_dtypes) + 1


def test_overflowing_kdotpps_on_the_card(card):
    checks.check_overflow_kdotpps(card)


def test_backend_on_the_card_equals_cpu(card):
    """The KVI path on the card is one walk-kernel launch per structural
    group and no per-step launch; ``kernel_launches`` still counts the
    regions and reductions (the reference's ``pallas_calls``), as the
    CPU run does."""
    rng = np.random.default_rng(5)
    protos = [tk.optimize_program(conv2d_program(
        rng.integers(-99, 99, (16, 16)), rng.integers(-5, 5, (3, 3)),
        shift=4)), tk.optimize_program(fft_program(
            rng.integers(-99, 99, 64), rng.integers(-99, 99, 64)))]
    progs = [p.replace(mem_init={k: rng.permutation(v)
                                 for k, v in p.mem_init.items()})
             for p in protos for _ in range(8)]
    wl = tk.KviWorkload("mix", tuple(tk.WorkloadEntry(p) for p in progs))
    f0, r0, w0 = fv.launch_count, kd.launch_count, kw.launch_count
    be = TorchBackend(passes=())
    got = be.run_workload(wl)
    assert kw.launch_count - w0 == be.walk_calls == got.meta["groups"] == 2
    assert (fv.launch_count, kd.launch_count) == (f0, r0)
    want = TorchBackend(device="cpu", passes=()).run_workload(wl)
    assert got.kernel_launches == want.kernel_launches > 0
    for g, w in zip(got.entry_results, want.entry_results):
        for name, arr in w.outputs.items():
            np.testing.assert_array_equal(g.outputs[name], arr)


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_served_requests_on_the_card_equal_the_oracle(card, size):
    """Serving's four templates (``DEFAULT_MIX``), ``size`` instances a
    batch: one walk launch each, outputs bit for bit the oracle's and the
    CPU backend's."""
    templates = make_templates(DEFAULT_MIX, smoke=False, seed=0)
    be = TorchBackend(passes=())
    w0 = kw.launch_count
    n = check_against_oracle(templates, 0, be, sizes=(size,), others=(
        TorchBackend(device="cpu", passes=()),))
    assert n == 2 * len(templates) * size
    assert kw.launch_count - w0 == be.walk_calls == len(templates)


@pytest.mark.parametrize("batching", [True, False])
def test_server_on_the_card_equals_the_cpu_server(card, batching):
    """The CLI's default stream (256 requests) on the card: one walk
    launch per bucket and per prewarm batch, no per-step launch, the
    cache hit-only in the loop, and the CPU backend's canonical report."""
    templates = make_templates(DEFAULT_MIX, smoke=False, seed=0)
    specs = poisson_arrivals(templates, 256, 40.0, seed=0)
    f0, r0 = fv.launch_count, kd.launch_count
    be = TorchBackend(passes=())
    rep = ServeEngine(templates, backend=be, batching=batching).run(specs)
    want = ServeEngine(templates, backend=TorchBackend(
        device="cpu", passes=()), batching=batching).run(specs)
    assert canonical_report(rep) == canonical_report(want)
    assert be.walk_calls == (59 if batching else 260)
    assert (fv.launch_count, kd.launch_count) == (f0, r0)
    assert rep["compile_cache"]["steady_hit_rate"] == 1.0
    assert rep["compile_cache"]["loop_misses"] == 0


def test_served_run_with_telemetry_on_the_card_equals_the_cpu_trace(card):
    """The CLI's default stream with ``Obs.on()`` on the backend and the
    engine: a valid trace, 256 request flows, ``torch.walk_launches`` the
    walk kernel's 59 launches, and the canonical trace and cycle-domain
    metrics byte-equal to the CPU backend's run."""
    templates = make_templates(DEFAULT_MIX, smoke=False, seed=0)
    specs = poisson_arrivals(templates, 256, 40.0, seed=0)
    runs = []
    for device in (None, "cpu"):
        obs = Obs.on()
        w0 = kw.launch_count
        rep = ServeEngine(templates, backend=TorchBackend(
            device=device, passes=(), obs=obs), obs=obs).run(specs)
        runs.append((rep, obs, kw.launch_count - w0))
    (rep, obs, walks), (cpu_rep, cpu_obs, cpu_walks) = runs
    trace = obs.tracer.to_chrome()
    assert validate_trace(trace) == []
    assert flow_summary(trace["traceEvents"])["requests"] == 256
    snap, cpu_snap = obs.metrics.snapshot(), cpu_obs.metrics.snapshot()
    assert snap["counters"]["torch.walk_launches"] == walks == 59
    assert cpu_snap["counters"]["torch.walk_launches"] == cpu_walks == 0
    assert canonical_report(rep) == canonical_report(cpu_rep)
    assert json.dumps(canonical_trace(trace), sort_keys=True) == json.dumps(
        canonical_trace(cpu_obs.tracer.to_chrome()), sort_keys=True)
    for k in ("counters", "gauges"):
        assert {n: v for n, v in snap[k].items() if n != "torch.walk_launches"
                } == {n: v for n, v in cpu_snap[k].items()
                      if n != "torch.walk_launches"}


def test_backend_span_on_the_card_equals_meta(card):
    """One live ``Obs`` over three runs on the card: one ``("torch",
    "run_workload")`` span a run, its args the run's ``meta`` and its walk
    launches (one a structural group), counters summed over the runs."""
    rng = np.random.default_rng(6)
    proto = tk.optimize_program(conv2d_program(
        rng.integers(-99, 99, (16, 16)), rng.integers(-5, 5, (3, 3)),
        shift=4))
    wl = tk.KviWorkload.homogeneous([proto.replace(mem_init={
        k: rng.permutation(v) for k, v in proto.mem_init.items()})
        for _ in range(8)])
    obs = Obs.on()
    be = TorchBackend(passes=(), obs=obs)
    metas = [be.run_workload(wl).meta for _ in range(3)]
    spans = [ev for ev in obs.tracer.events if ev["name"] == "run_workload"]
    assert [ev["args"] for ev in spans] == [
        {"entries": 8, "groups": 1, "kernel_launches": m["kernel_launches"],
         "walk_launches": 1} for m in metas]
    assert validate_trace(obs.tracer.to_chrome()) == []
    c = obs.metrics.snapshot()["counters"]
    assert (c["torch.runs"], c["torch.walk_launches"]) == (3, 3)
    assert c["torch.kernel_launches"] == sum(m["kernel_launches"]
                                             for m in metas)
    assert c["torch.compile_cache.misses"] == sum(
        m["compile_cache"]["misses"] for m in metas) > 0


def _walk_cases():
    """(id, program maker, N, check_walk options) of the walk-kernel card
    tests: every edge program, random programs at eb 1/2/4, the hazard
    and a random program in the global layout, rows striding over a
    small grid."""
    edges = checks.walk_edge_programs(tk.KviProgramBuilder,
                                      np.random.default_rng(0))
    cases = [(name, prog, 33, {}) for name, prog in edges.items()]
    cases.append(("hazard-global", edges["hazard"], 33, dict(smem_cap=0)))
    for eb in (1, 2, 4):
        prog = checks.random_kvi_program(tk.KviProgramBuilder,
                                         np.random.default_rng(eb), eb)
        cases.append((f"random-eb{eb}", prog, 37, {}))
        cases.append((f"random-eb{eb}-global-grid5", prog, 37,
                       dict(smem_cap=0, max_grid=5)))
    return cases


WALK_CASES = _walk_cases()


@pytest.mark.parametrize("case", WALK_CASES, ids=lambda c: c[0])
def test_walk_kernel_equals_plain(card, case):
    """The walk kernel against ``run_walk_plain`` on the same tensors:
    every store stack bit for bit, one launch."""
    name, prog, N, opts = case
    before = kw.launch_count
    record = checks.check_walk(np.random.default_rng(9),
                               checks.compile_walk(prog), N, card, **opts)
    torch.cuda.synchronize()
    assert kw.launch_count == before + 1
    want = "global" if "global" in name or name == "big_regfile" \
        else "shared"
    assert record.layout == want


def test_walk_kernel_on_the_main_path_structures(card):
    """conv32 F 3 / 11, FFT-256, matmul64 (kdotp, kdotpps) and
    pipeline_demo at a batch of 40, in the shared layout and in the
    global one."""
    from repro_torch.kvi.programs import (matmul_program,
                                          pipeline_demo_program)
    rng = np.random.default_rng(10)
    protos = [conv2d_program(rng.integers(-99, 99, (32, 32)),
                             rng.integers(-9, 9, (f, f)), shift=4)
              for f in (3, 11)]
    protos.append(fft_program(rng.integers(-99, 99, 256),
                              rng.integers(-99, 99, 256)))
    protos += [matmul_program(rng.integers(-99, 99, (64, 64)),
                              rng.integers(-99, 99, (64, 64)), shift=s,
                              resident=False) for s in (0, 8)]
    protos.append(pipeline_demo_program(rng.integers(-99, 99, 1024)))
    before = kw.launch_count
    for proto in protos:
        walk = checks.compile_walk(tk.optimize_program(proto))
        for cap in (kw.ARENA_SMEM_CAP, 0):
            checks.check_walk(rng, walk, 40, card, smem_cap=cap)
    torch.cuda.synchronize()
    assert kw.launch_count == before + 2 * len(protos)


def test_walk_launch_errors_raise(card):
    """A launch the walk kernel refuses returns the CUDA error, and the
    wrapper raises with it; nothing falls back to the plain walk."""
    prog = checks.walk_edge_programs(tk.KviProgramBuilder,
                                     np.random.default_rng(1),
                                     big_lanes=60000)["big_regfile"]
    walk = checks.compile_walk(prog)
    lib = kw._library()
    for cap in (kw.ARENA_SMEM_CAP, 1 << 20):
        record = kw.pack_walk(walk, smem_cap=cap)
        assert lib.kvi_walk_smem_bytes(
            record.arena_bytes, int(record.layout == "shared"), record.ring,
            record.slot_bytes) == record.smem_bytes
    # a 480 KB register file forced into shared memory: past 227 KB
    assert record.layout == "shared" and record.smem_bytes > kw.MAX_SMEM
    ins = [torch.zeros((2, record.width(k)), dtype=torch.int32, device=card)
           for k in record.in_keys]
    sts = [torch.zeros((2, record.width(k)), dtype=torch.int32, device=card)
           for k in record.st_keys]
    before = kw.launch_count
    with pytest.raises(RuntimeError, match="kvi_walk kernel launch failed"):
        kw.run_walk(record, ins, sts, 2)
    assert kw.launch_count == before
    stream = torch.cuda.current_stream().cuda_stream
    table, pool = record.on(card)
    desc = np.zeros((1, 2), np.int64)
    ptrs = np.zeros(1, np.int64)
    # 48 threads (not a warp multiple), then no buffer
    for threads, n_buf in ((48, 1), (64, 0)):
        assert lib.kvi_walk_launch(
            table.data_ptr(), record.n_steps, pool.data_ptr(), 0, 0,
            desc.ctypes.data, ptrs.ctypes.data, n_buf, 16, 1, 0, None, 0, 0,
            1, 1, threads, kw.smem_bytes(16, True, 0, 0), stream) != 0


@pytest.mark.parametrize("case", checks.compute_kernel_cases(),
                         ids=lambda c: f"{c[0]}-" + "-".join(
                             f"{k}{v}" for k, v in c[1].items()))
def test_compute_kernel_equals_plain_at_odd_shapes(card, case):
    """Each variant one launch; bf16 and int8 products and bf16
    attention on the tensor-core kernels, float32 on the CUDA-core ones
    (the shapes that need padding too)."""
    kernel, shape = case
    mod = micro.MODULES[kernel]
    before = mod.launch_count
    tc_before = getattr(mod, "tc_launch_count", 0)
    checks.check_compute_case(np.random.default_rng(6), kernel, shape, card)
    torch.cuda.synchronize()
    paths = checks.case_paths(kernel)
    assert mod.launch_count == before + sum(paths.values())
    assert getattr(mod, "tc_launch_count", 0) == \
        tc_before + paths["tensor_cores"]


def test_fft_equals_plain_bit_for_bit(card):
    """The register-pass FFT rounds every butterfly as the plain version
    does: equal bit for bit at every n = 2^0 .. 2^14, at B = 3, 1000 and
    a B whose last block is partial."""
    from repro_torch.kernels import spm_fft as sf
    before = sf.launch_count
    done = checks.check_fft_exact(np.random.default_rng(10), card)
    torch.cuda.synchronize()
    assert done == len(checks.fft_exact_cases(sf.sm_count(card))) \
        == sf.launch_count - before


def test_int8_product_wraps_on_the_card(card):
    """2^17 + 4096 terms of (-128)(-128) wrap in the tensor cores' s32
    accumulator (no .satfinite), as the plain version's int32 does."""
    from repro_torch.kernels import spm_matmul as sm
    before = sm.tc_launch_count
    assert checks.check_int8_wrap(card) == -2080374784
    assert sm.tc_launch_count == before + 1


@pytest.mark.parametrize("F", [3, 161, 1024])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32,
                                   torch.bfloat16, torch.float16, torch.int8,
                                   torch.int16, torch.uint8],
                         ids=lambda d: str(d).split(".")[1])
def test_conv_kernel_every_dtype_and_large_filters(card, dtype, F):
    """The conv kernel equals its plain version bit for bit in every image
    dtype (sums that wrap or saturate), with filters past the old
    kernel's shared-memory limit, one launch a call."""
    from repro_torch.kernels import spm_conv2d as sc
    rng = np.random.default_rng(F)
    before = sc.launch_count
    for H, W in ((37, 45), (20, 64)):
        checks.check_conv(rng, H, W, F, dtype, card, shift=4)
    torch.cuda.synchronize()
    assert sc.launch_count == before + 2


def test_conv_refuses_a_filter_past_shared_memory(card):
    """F = 3000 needs more than a block's 227 KB of rings: the wrapper
    raises before any launch; nothing falls back."""
    from repro_torch.kernels import spm_conv2d as sc
    before = sc.launch_count
    assert sc.smem_bytes(torch.float32, 3000, 32) > sc.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        sc.spm_conv2d(torch.zeros((4, 4), device=card),
                      torch.zeros((3000, 3000), device=card))
    assert sc.launch_count == before


@pytest.mark.parametrize("name", ["matmul_f32_2048", "matmul_int8_4096",
                                  "conv_int32_2048_f11",
                                  "conv_int8_2048_f3", "conv_int32_512_f161",
                                  "fft_4096x1024", "composite_1024",
                                  "attn_hymba1.5b_swa_8192",
                                  "attn_mixtral_prefill_cont",
                                  "ssd_mamba2-1.3b_4096",
                                  "attn_pixtral12b_causal_4096",
                                  "fft_256x65536", "matmul_f16_4096",
                                  "matmul_int32_2048", "composite_512_f161"])
def test_compute_kernel_equals_plain_at_card_scale(card, name):
    w = next(w for w in micro.CARD if w.name == name)
    x = micro.make_inputs(w, np.random.default_rng(7), card)
    mod = micro.MODULES[w.kernel]
    before = mod.launch_count
    tc_before = getattr(mod, "tc_launch_count", 0)
    out = micro.run_kernel(w, x)
    torch.cuda.synchronize()
    # one launch a call (the composite too: ONE); the SSD scan's three;
    # an FFT above 16384 points its stage passes, transform and gather
    assert mod.launch_count == before + micro.launches_per_call(w.kernel,
                                                                w.shape)
    assert getattr(mod, "tc_launch_count", 0) == \
        tc_before + micro.tensor_core_call(w)
    micro.compare_plain(w, x, out)


@pytest.mark.parametrize("shape", [(33, 65, 17), (1024, 1024, 1024),
                                   (2048, 2048, 2048)],
                         ids=lambda s: "x".join(map(str, s)))
def test_float32_matmul_check_rejects_a_tf32_product(card, shape):
    """cuBLAS with TF32 allowed must fail the check the kernel's float32
    products (standalone and in the composite) pass."""
    a, b = checks.matmul_operands(np.random.default_rng(8), *shape,
                                  torch.float32, card)
    out = checks.reject_tf32(checks.tf32_product(a, b), a, b)
    assert out["max_err_over_tol"] > 1
    assert not torch.backends.cuda.matmul.allow_tf32


def test_compute_kernel_launch_errors_raise(card):
    """A launch the kernel refuses raises with the CUDA error; nothing
    falls back to the plain version."""
    from repro_torch.kernels import spm_fft as sf
    lib = sf._library()
    x = torch.zeros((1, 4), device=card)
    stream = torch.cuda.current_stream().cuda_stream
    # n = 2^15; a plan that does not cover log2(n) = 2; rows past 227 KB
    for log2n, plan, rows in ((15, sf.pass_plan(16384).packed, 1),
                              (2, sf.pass_plan(8).packed, 1),
                              (2, sf.pass_plan(4).packed, 1 << 14)):
        rc = lib.spm_fft_launch(x.data_ptr(), x.data_ptr(), x.data_ptr(),
                                x.data_ptr(), x.data_ptr(), 1, log2n, plan,
                                rows, stream)
        assert rc != 0
    # n = 2^15 itself is taken, through the large route (three launches)
    before = sf.launch_count
    re = torch.ones((1, 32768), device=card)
    got = sf.spm_fft(re, torch.zeros_like(re))
    torch.cuda.synchronize()
    assert sf.launch_count == before + sf.launches_for(32768) == before + 3
    assert got[0][0, 0].item() == 32768.0 and got[0][0, 1:].abs().max() == 0


def test_lm_kernel_launch_errors_raise(card):
    """Launches the attention and SSD kernels refuse return the CUDA
    error, and the wrappers raise before them; nothing falls back."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    x = torch.zeros((1, 3, 8, 200), device=card)
    stream = torch.cuda.current_stream().cuda_stream
    # an unknown dtype; H 3 not a multiple of KV 2; hd 300 on the
    # tensor-core kernel (its tiles stop at 256)
    for launch, dtype, H, KV, hd in (
            (fa._library().flash_attention_launch, 7, 2, 1, 64),
            (fa._library().flash_attention_launch, 0, 3, 2, 64),
            (fa._library().flash_attention_tc_launch, 1, 2, 1, 300)):
        assert launch(dtype, x.data_ptr(), x.data_ptr(), x.data_ptr(),
                      x.data_ptr(), 1, H, KV, 8, 8, hd, 1, 0, 0, 0.1,
                      stream) != 0
    before = fa.launch_count
    with pytest.raises(ValueError, match="multiple of KV"):
        fa.flash_attention(x, x[:, :2], x[:, :2])
    assert fa.launch_count == before
    lib, scan, p = ss._library(), ss._library("ssd_scan"), x.data_ptr()
    grad = ss._library("ssd_grad")
    # S not a multiple of cs, for each of the three kernels, and for the
    # training kernels; G not dividing H
    assert lib.ssd_chunk_state_launch(0, p, p, p, p, p, p, 1, 100, 1, 4, 4,
                                      32, 1, 0, stream) != 0
    assert lib.ssd_chunk_state_launch(0, p, p, p, p, p, p, 1, 96, 3, 4, 4,
                                      32, 2, 0, stream) != 0
    assert lib.ssd_state_pass_launch(p, p, p, None, 1, 100, 1, 4, 4, 32, 0,
                                     stream) != 0
    assert scan.ssd_chunk_scan_launch(0, p, p, p, p, p, p, p, 1, 100, 1, 4,
                                      4, 32, 1, stream) != 0
    assert lib.ssd_scores_launch(p, p, p, 1, 100, 4, 32, 1, stream) != 0
    assert lib.ssd_train_scan_launch(0, p, p, p, p, p, p, p, 1, 100, 1, 4, 4,
                                     32, 1, stream) != 0
    assert grad.ssd_bwd_dx_launch(0, p, p, p, p, p, p, p, p, p, 1, 100, 1,
                                  4, 4, 32, 1, stream) != 0
    assert grad.ssd_bwd_ds_launch(0, p, p, p, p, p, p, p, p, 1, 100, 1, 4,
                                  32, 1, stream) != 0
    assert grad.ssd_bwd_dbc_launch(0, 1, p, p, p, p, p, p, p, p, p, p, 1,
                                   100, 1, 4, 4, 32, 1, stream) != 0
    assert grad.ssd_bwd_dcum_launch(p, p, p, p, p, p, p, p, p, p, p, p, 1,
                                    100, 1, 4, 4, 32, stream) != 0
    # a chunk whose per-step vectors pass 227 KB (cs 32768); N 656 is
    # taken (the chunk scan streams C)
    assert max(ss.smem_bytes(656, 32768).values()) > ss.MAX_SMEM
    assert ss.streams_c(656, 256)
    assert lib.ssd_chunk_state_launch(0, p, p, p, p, p, p, 1, 32768, 1, 4,
                                      4, 32768, 1, 0, stream) != 0
    assert scan.ssd_chunk_scan_launch(0, p, p, p, p, p, p, p, 1, 32768, 1, 4,
                                      656, 32768, 1, stream) != 0
    big = torch.zeros((1, 32768, 1, 4), device=card)
    dt = torch.zeros((1, 32768, 1), device=card)
    before = ss.launch_count
    with pytest.raises(ValueError, match="shared memory"):
        ss.ssd_scan(big, dt, dt, big, big, chunk=32768)
    assert ss.launch_count == before


@pytest.mark.parametrize("name", sorted(checks.EDGE_CHECKS))
def test_inputs_past_the_first_limits_equal_plain(card, name):
    """Head widths above 128, float16, negative windows, the whole matmul
    domain, FFTs above 16384 points, uint8 intrinsics, N 1024 SSD
    states and a 161 x 161 composite filter: each against its plain
    version on the card, each launching its kernel."""
    out = checks.check_edge(np.random.default_rng(21), name, card)
    assert out["launches"] == checks.EDGE_CHECKS[name][2]


def test_verify_on_the_card(card):
    """TorchBackend(verify=True) on the card: the analyzer, then the same
    walk launches and outputs as verify=False; a mutant of the fuzz
    catalog is refused before any kvi_walk launch."""
    import dataclasses

    from repro_torch.kvi.analysis import KviVerificationError
    rng = np.random.default_rng(5)
    progs = [conv2d_program(rng.integers(-64, 64, (8, 8)),
                            np.ones((3, 3), np.int64), shift=2)
             for _ in range(6)]
    wl = tk.KviWorkload.homogeneous(progs)
    off = TorchBackend(device=card).run_workload(wl)
    be = TorchBackend(device=card, verify=True)
    on = be.run_workload(wl)
    assert be.walk_calls == 1 and "verify_s" in be.host_s
    for g, w in zip(on.entry_results, off.entry_results):
        for key, arr in w.outputs.items():
            np.testing.assert_array_equal(g.outputs[key], arr)
    p = progs[0]
    idx, it = next((i, it) for i, it in enumerate(p.items)
                   if isinstance(it, tk.KviInstr) and it.dst is not None
                   and it.dst.space == "vreg")
    items = list(p.items)
    items[idx] = dataclasses.replace(it, dst=dataclasses.replace(
        it.dst, offset=it.dst.offset + p.vregs[it.dst.id].length))
    before = kw.launch_count
    with pytest.raises(KviVerificationError):
        be.run_workload(tk.KviWorkload.single(
            dataclasses.replace(p, items=tuple(items))))
    assert kw.launch_count == before


@pytest.mark.parametrize("dtype", checks.LM_TYPES, ids=str)
@pytest.mark.parametrize("shape", checks.ssd_part_cases(),
                         ids=lambda s: "-".join(f"{k}{v}"
                                                for k, v in s.items()))
def test_ssd_kernels_equal_their_plain_versions(card, shape, dtype):
    """Each of the three SSD kernels alone, one launch each, against its
    plain version on the same CUDA tensors."""
    from repro_torch.kernels import ssd_scan as ss
    before = dict(ss.part_launches)
    err = checks.check_ssd_parts(np.random.default_rng(11), device=card,
                                 dtype=dtype, **shape)
    torch.cuda.synchronize()
    assert set(err) == set(ss.PARTS)
    assert ss.part_launches == {k: n + (k in ss.PARTS)
                                for k, n in before.items()}


def test_ssd_scan_of_a_wide_state(card):
    """N 256 with P 128 (which the single-block kernel refused for shared
    memory) against the plain version, float32 and bf16 x."""
    from repro_torch.kernels import ssd_scan as ss
    before = ss.launch_count
    for dt in checks.LM_TYPES:
        checks.check_ssd(np.random.default_rng(12), 1, 512, 2, 128, 256, 1,
                         256, card, dt)
    torch.cuda.synchronize()
    assert ss.launch_count == before + 2 * ss.LAUNCHES_PER_CALL


# ---------------------------------------------------------------------------
# The DSE's walltime stage on the card (chip_smoke.py phase 3d (a))
# ---------------------------------------------------------------------------

DSE_POINTS_BITS = (8, 16, 32)


def _dse_class_workloads(bits):
    from repro_torch.kvi.dse import paper_kernel_factory
    from repro_torch.kvi.dse.sweep import optimize_kernels
    kernels = optimize_kernels(
        paper_kernel_factory(smoke=False, seed=0)(bits), None)
    wls = {name: tk.KviWorkload.replicate(p, 3)
           for name, p in kernels.items()}
    wls["composite"] = tk.KviWorkload.composite(
        {h: [p] for h, p in enumerate(kernels.values())}, name="composite")
    return wls


@pytest.mark.parametrize("bits", DSE_POINTS_BITS)
def test_dse_class_on_the_card_equals_the_oracle(card, bits):
    """A walltime class's workloads at the paper's sizes (conv 32x32 F 3,
    FFT-256 with Q15 twiddles, the SPM-resident matmul 64, their 3-hart
    composite) at 8, 16 and 32 bits: every output on the card equals the
    oracle's, dtype and all, one walk launch a structural group."""
    be = TorchBackend(device=card, passes=())
    oracle = tk.get_backend("oracle", passes=())
    for name, wl in _dse_class_workloads(bits).items():
        before = kw.launch_count
        got = be.run_workload(wl)
        torch.cuda.synchronize(card)
        assert kw.launch_count - before == got.meta["groups"], name
        want = oracle.run_workload(wl)
        for g, w in zip(got.outputs, want.outputs):
            assert set(g) == set(w)
            for key, arr in w.items():
                assert g[key].dtype == arr.dtype, (name, key)
                np.testing.assert_array_equal(g[key], arr,
                                              err_msg=f"{name} {key}")


def test_dse_walltime_stage_on_the_card_equals_the_cpu(card, tmp_path):
    """``sweep(measure_device=True)`` over shared M1 F1 D4 at 8, 16 and
    32 bits on the card and with ``device="cpu"``: canonical JSON byte
    for byte, the same launches per class and kernel, and the class keys
    apart (the CPU run re-measures every class)."""
    from repro_torch.kvi.dse import (DesignPoint, PointCache,
                                     paper_kernel_factory, sweep)
    pts = [DesignPoint("shared", 1, 1, 4, precision_bits=b)
           for b in DSE_POINTS_BITS]
    factory = paper_kernel_factory(smoke=False, seed=0)
    kw.launch_count = 0
    on_card = sweep(pts, factory, executor="serial", measure_device=True,
                    cache=PointCache(cache_dir=str(tmp_path)))
    assert kw.launch_count > 0
    cache = PointCache(cache_dir=str(tmp_path))
    on_cpu = sweep(pts, factory, executor="serial", measure_device=True,
                   device="cpu", cache=cache)
    assert (cache.hits, cache.device_hits, cache.device_misses) == (3, 0, 3)
    assert on_card.canonical_json() == on_cpu.canonical_json()
    card_meta, cpu_meta = on_card.meta["device"], on_cpu.meta["device"]
    assert card_meta["device_name"] == torch.cuda.get_device_name(card)
    assert cpu_meta["device_name"] == "cpu"
    assert [{k: m["kernel_launches"] for k, m in c["kernels"].items()}
            for c in card_meta["classes"]] == \
        [{k: m["kernel_launches"] for k, m in c["kernels"].items()}
         for c in cpu_meta["classes"]]


# ---------------------------------------------------------------------------
# the LM model zoo and LM serving on the card (plain PyTorch, no kernel)
# ---------------------------------------------------------------------------

def _lm_parts(arch, dtype="float32"):
    from repro_torch import configs
    from repro_torch.models import model_zoo, params
    spec = configs.get_spec(arch)
    cfg = configs.reduced_model(spec.model).replace(dtype=dtype)
    par = spec.parallelism.replace(remat="none", fsdp=False,
                                   sequence_parallel=False)
    return cfg, par, params.initialize(model_zoo.param_template(cfg), 0,
                                       device="cpu")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b",
                                  "mamba2-1.3b", "hymba-1.5b",
                                  "seamless-m4t-medium", "pixtral-12b"])
def test_lm_steps_on_the_card_equal_the_cpu(card, arch):
    """Prefill (64 tokens, batch 2) and three decode steps of a reduced
    arch in float32 on one set of weights: the card's logits and caches
    within 1e-4 of the CPU's, integer cache fields equal."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import steps
    from repro_torch.models.sharding import make_rules
    cfg, par, params = _lm_parts(arch)
    rules = make_rules(None, cfg, par)
    rng = np.random.default_rng(0)
    batch = {}
    for k, p in steps.batch_template(
            cfg, ShapeConfig("p", "prefill", 64, 2)).items():
        batch[k] = (torch.from_numpy(rng.integers(0, 100, p.shape).astype(
            np.int32)) if p.dtype == "int32" else torch.from_numpy(
            rng.normal(size=p.shape).astype(np.float32)))
    nxt = [torch.from_numpy(rng.integers(1, 90, (2, 1)).astype(np.int32))
           for _ in range(3)]
    outs = []
    for device in ("cpu", card):
        prefill = steps.make_prefill_step(cfg, rules, par,
                                          ShapeConfig("p", "prefill", 64, 2))
        decode = steps.make_decode_step(cfg, rules, par,
                                        ShapeConfig("d", "decode", 64, 2))
        p = _to(params, device)
        logits, cache = prefill(p, _to(batch, device))
        got = [logits.cpu()]
        for tok in nxt:
            logits, cache = decode(p, cache, {"tokens": tok.to(device)})
            got.append(logits.cpu())
        outs.append((got, _to(cache, "cpu")))
    (want, want_cache), (got, got_cache) = outs
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)
    for k, w in want_cache["layers"].items():
        g = got_cache["layers"][k]
        if w.dtype in (torch.int32, torch.int64):
            assert torch.equal(g, w), k
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    assert torch.equal(got_cache["pos"], want_cache["pos"])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hymba-1.5b"])
def test_lm_engine_on_the_card_serves_the_cpus_tokens(card, arch):
    """The reduced engine in float32 on the card gives the CPU engine's
    tokens request by request (more requests than slots)."""
    from repro_torch.serving import Request, ServingEngine
    cfg, _, params = _lm_parts(arch)
    rng = np.random.default_rng(1)
    ps = [rng.integers(1, 90, int(rng.integers(3, 12))).astype(np.int32)
          for _ in range(6)]
    served = []
    for device in ("cpu", card):
        eng = ServingEngine(cfg, params, slots=3, max_seq=48, device=device)
        assert eng.cache["pos"].device.type == torch.device(device).type
        for i, p in enumerate(ps):
            eng.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=6))
        served.append({r.rid: r.out_tokens
                       for r in eng.run_until_drained(500)})
    assert len(served[1]) == 6 and served[1] == served[0]


def test_lm_initialize_on_the_card_is_the_same_in_two_processes(card):
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = ("import hashlib\n"
            "from repro_torch.configs import get_spec, reduced_model\n"
            "from repro_torch.models import model_zoo, params\n"
            "cfg = reduced_model(get_spec('hymba-1.5b').model)\n"
            "p = params.initialize(model_zoo.param_template(cfg), 0)\n"
            "h = hashlib.sha256()\n"
            "for _, x in params.tree_leaves(p):\n"
            "    assert x.is_cuda\n"
            "    h.update(x.cpu().numpy().tobytes())\n"
            "print(h.hexdigest())\n")
    digests = set()
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed,
                   PYTHONPATH=str(root / "src"))
        digests.add(subprocess.run(
            [sys.executable, "-c", code], cwd=root, capture_output=True,
            text=True, check=True, timeout=300, env=env).stdout.strip())
    assert len(digests) == 1 and len(next(iter(digests))) == 64


#: the train step's card-vs-CPU check: Adam's g / (sqrt(v) + eps)
#: normalises each element, so float32 rounding of a gradient near zero
#: can move its update by up to lr; at most this share of the params may
#: land past 1e-4 (each within 4 x lr a step), the gradients are held
#: to 1e-4
LM_ILL_SHARE = 1e-3


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b"])
def test_lm_train_step_on_the_card_equals_the_cpu(card, arch):
    """Two train steps of a reduced arch in float32 from one set of
    weights on DataPipeline batches: the first batch's gradients, loss,
    grad norm and every updated param on the card within 1e-4 of the
    CPU's (params as above); the optimizer's count equal."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.models import params as params_lib
    from repro_torch.models import steps
    from repro_torch.models.sharding import make_rules
    from repro_torch.optim import OptimizerConfig, adamw_init
    cfg, par, params = _lm_parts(arch)
    rules = make_rules(None, cfg, par)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    data = DataPipeline(cfg, ShapeConfig("t", "train", 64, 2), DataConfig())
    runs = []
    for device in ("cpu", card):
        step = steps.make_train_step(cfg, rules, par, opt_cfg)
        p = _to(params, device)
        o = adamw_init(p, opt_cfg)
        _, grads = steps.value_and_grad(
            steps.make_loss_fn(cfg, rules, par), p,
            {k: torch.from_numpy(v).to(device)
             for k, v in data.batch_at(0).items()})
        metrics = []
        for s in range(2):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in data.batch_at(s).items()}
            p, o, m = step(p, o, batch)
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        runs.append((metrics, _to(p, "cpu"), _to(o, "cpu"),
                     _to(grads, "cpu")))
    (want_m, want_p, want_o, want_g), (got_m, got_p, got_o, got_g) = runs
    for name, w in params_lib.tree_leaves(want_g):
        np.testing.assert_allclose(dict(params_lib.tree_leaves(got_g))[
            name].numpy(), w.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
    for g, w in zip(got_m, want_m):
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-4), k
    assert int(got_o["count"]) == int(want_o["count"]) == 2
    past = total = 0
    got_leaves = dict(params_lib.tree_leaves(got_p))
    for name, w in params_lib.tree_leaves(want_p):
        diff = (got_leaves[name] - w).abs()
        assert (diff <= 4 * opt_cfg.lr * 2 * (1 + w.abs())).all(), name
        past += int((diff > 1e-4 * (1 + w.abs())).sum())
        total += w.numel()
    assert past <= LM_ILL_SHARE * total, (past, total)


def test_run_vops_on_the_card_equals_plain(card):
    """The deprecated run_vops shim at 1 M int32 lanes: one fused_vops
    launch on the card, bit for bit its CPU (plain) result."""
    import warnings
    from repro_torch.kernels.kvi_vops import run_vops
    rng = np.random.default_rng(11)
    a, b = (torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, 1 << 20,
                                          dtype=np.int64).astype(np.int32))
            for _ in range(2))
    prog = [("kvmul", 2, 0, 1, 0), ("ksrav", 2, 2, None, 5),
            ("kaddv", 3, 2, 0, 0), ("krelu", 3, 3, None, 0)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = run_vops(prog, [a, b])
        before = fv.launch_count
        got = run_vops(prog, [a.to(card), b.to(card)])
        torch.cuda.synchronize()
    assert fv.launch_count == before + 1
    assert got.is_cuda and torch.equal(got.cpu(), want)
