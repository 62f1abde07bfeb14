"""The port's intrinsics layer (repro_torch.kernels.ops) and oracles
(repro_torch.kernels.ref) against the reference's (repro.kernels.ops in
interpret mode on the CPU, repro.kernels.ref), the carry-across of
arrays, the on-card microbenchmark's cost model, and a CPU rehearsal of
``chip_smoke.py``'s compute-kernel phase at a tiny size."""
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import micro
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kvi import array_from_reference

ROOT = Path(__file__).resolve().parents[1]
INT_TYPES = [np.int8, np.int16, np.int32]
BINARY = ["kaddv", "ksubv", "kvmul", "kvslt"]
UNARY = [("krelu", None), ("kvcp", None), ("ksvaddsc", 7),
         ("ksvmulsc", -3), ("ksrlv", 3), ("ksrav", 5), ("ksvslt", 0)]


def _vec(rng, dtype, n=40):
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, n).astype(dtype)


@pytest.mark.parametrize("dtype", INT_TYPES, ids=lambda d: d.__name__)
def test_elementwise_intrinsics_bit_exact(dtype):
    """Full-range operands, so add, sub and mul wrap."""
    rng = np.random.default_rng(np.dtype(dtype).itemsize)
    a, b = _vec(rng, dtype), _vec(rng, dtype)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in BINARY:
        want = np.asarray(getattr(jops, name)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(ops, name)(ta, tb)
        assert got.dtype == ta.dtype, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    for name, imm in UNARY:
        args = () if imm is None else (imm,)
        want = np.asarray(getattr(jops, name)(jnp.asarray(a), *args))
        np.testing.assert_array_equal(getattr(ops, name)(ta, *args).numpy(),
                                      want, err_msg=name)


@pytest.mark.parametrize("dtype", INT_TYPES, ids=lambda d: d.__name__)
def test_fused_mac_relu_bit_exact(dtype):
    rng = np.random.default_rng(5)
    a, w, b = (_vec(rng, dtype, (3, 16)) for _ in range(3))
    want = np.asarray(jops.fused_mac_relu(jnp.asarray(a), jnp.asarray(w),
                                          jnp.asarray(b), 3))
    got = ops.fused_mac_relu(torch.from_numpy(a), torch.from_numpy(w),
                             torch.from_numpy(b), 3)
    assert tuple(got.shape) == (3, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tref.vops_ref([("kvmul", 3, 0, 1, 0), ("kaddv", 3, 3, 2, 0),
                       ("ksrav", 3, 3, None, 3), ("krelu", 3, 3, None, 0)],
                      [torch.from_numpy(x) for x in (a, w, b)]).numpy(),
        want)


@pytest.mark.parametrize("dtype", INT_TYPES + [np.float32],
                         ids=lambda d: d.__name__)
def test_reductions_and_their_oracles(dtype):
    rng = np.random.default_rng(6)
    if dtype == np.float32:
        a, b = (rng.normal(0, 1, 512).astype(np.float32) for _ in range(2))
    else:
        a, b = _vec(rng, dtype, 512), _vec(rng, dtype, 512)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), \
        torch.from_numpy(b)
    pairs = [(ops.kdotp(ta, tb), jops.kdotp(ja, jb)),
             (ops.kdotpps(ta, tb, 5), jops.kdotpps(ja, jb, 5)),
             (ops.kvred(ta), jops.kvred(ja)),
             (tref.kdotp_ref(ta, tb, 5), jref.kdotp_ref(ja, jb, 5)),
             (tref.kvred_ref(ta), jref.kvred_ref(ja))]
    for got, want in pairs:
        if dtype == np.float32:
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        else:
            assert got.dtype == torch.int32 and int(got) == int(want)


def test_compute_intrinsics_are_the_kernels():
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.normal(0, 1, (9, 7)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, (7, 5)).astype(np.float32))
    np.testing.assert_allclose(ops.matmul_op(a, b).numpy(),
                               tref.matmul_ref(a, b).numpy(), rtol=1e-5,
                               atol=1e-5)
    img = torch.from_numpy(rng.integers(-99, 99, (9, 8)).astype(np.int32))
    filt = torch.from_numpy(rng.integers(-5, 5, (3, 3)).astype(np.int32))
    assert torch.equal(ops.conv2d_op(img, filt, shift=2),
                       tref.conv2d_ref(img, filt, shift=2))
    re, im = a[:, :4].contiguous(), b[:4, :4].repeat(3, 1)[:9].contiguous()
    for got, want in zip(ops.fft_op(re, im), tref.fft_ref(re, im)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32, jnp.int8,
                                   jnp.int32])
def test_array_from_reference_round_trips_bit_for_bit(dtype):
    x = jnp.asarray(np.random.default_rng(1).normal(0, 50, (5, 7)), dtype)
    t = array_from_reference(x)
    assert str(t.dtype) == f"torch.{jnp.dtype(dtype).name}"
    assert tuple(t.shape) == x.shape
    bits = {2: np.int16, 4: np.int32, 1: np.int8}[jnp.dtype(dtype).itemsize]
    tbits = {2: torch.int16, 4: torch.int32, 1: torch.int8}[
        jnp.dtype(dtype).itemsize]
    np.testing.assert_array_equal(t.view(tbits).numpy(),
                                  np.asarray(x).view(bits))
    t.zero_()                                   # a copy, not a view
    assert np.asarray(x).any()


def test_roofline_terms():
    """The bound is the larger of bytes / 3.35 TB/s and operations /
    peak; INT32 runs at half the FP32 rate."""
    assert micro.PEAK_OPS_PER_S["int32"] * 2 == micro.PEAK_OPS_PER_S["fp32"]
    by = {w.name: micro.bound(*micro.cost(w)) for w in micro.CARD}
    assert by["matmul_bf16_4096"]["bound_by"] == "operations"
    assert by["matmul_bf16_4096"]["ops"] == 2 * 4096 ** 3
    np.testing.assert_allclose(by["matmul_bf16_4096"]["bound_ms"],
                               2 * 4096 ** 3 / 989e12 * 1e3)
    assert by["conv_int32_2048_f3"]["bound_by"] == "bytes"
    assert by["conv_int32_2048_f11"]["bound_by"] == "operations"
    np.testing.assert_allclose(by["fft_16384x256"]["bytes"],
                               16 * 16384 * 256 + 8 * 255)
    assert by["composite_1024"]["ops"] == (2 * 9 * 1024 ** 2
                                           + 5 * 1024 * 256 * 8
                                           + 2 * 1024 ** 3)


def test_roofline_terms_of_attention_and_the_ssd_scan():
    """Attention counts its two products over the visible pairs at the
    bf16 tensor-core rate; the SSD scan its four float32 products, the
    two cs x cs ones over j <= i, at the FP32 rate."""
    by = {w.name: micro.bound(*micro.cost(w)) for w in micro.CARD}
    llama = by["attn_llama3.2-1b_causal_4096"]
    assert llama["ops"] == 4 * 2 * 32 * (4096 * 4097 // 2) * 64
    assert llama["bytes"] == (2 * 2 * 32 * 4096 + 2 * 2 * 8 * 4096) * 64 * 2
    assert llama["bound_by"] == "operations"
    np.testing.assert_allclose(llama["bound_ms"], llama["ops"] / 989e12 * 1e3)
    hymba = by["attn_hymba1.5b_swa_8192"]
    assert hymba["ops"] == 4 * 25 * (2048 * 2049 // 2 + 6144 * 2048) * 64
    mixtral = by["attn_mixtral_prefill_cont"]
    assert mixtral["ops"] == 4 * 32 * sum(range(3585, 4097)) * 128
    ssd = by["ssd_mamba2-1.3b_4096"]
    per_chunk = 2 * (256 * 257 // 2) * (128 + 64) + 4 * 256 * 128 * 64
    assert ssd["ops"] == 2 * 64 * 16 * per_chunk
    assert ssd["bytes"] == 2 * 4096 * 64 * (2 * 64 * 4 + 8 + 2 * 128 * 4) \
        + 2 * 64 * 128 * 64 * 4
    assert ssd["bound_by"] == "operations"
    np.testing.assert_allclose(ssd["bound_ms"], ssd["ops"] / 67e12 * 1e3)


def test_micro_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "-m", "repro_torch.kernels.micro"],
                       capture_output=True, text=True, timeout=120,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 2 and r.stdout == ""
    assert "no CUDA device" in r.stderr


def test_chip_smoke_compute_phase_rehearsed_on_the_cpu(capsys):
    """``chip_smoke.run_compute_slice`` at tiny shapes on the CPU (the
    plain versions): every output equals its plain version and its
    numpy formula, and nothing counts as a launch."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    W = micro.Workload
    tiny = [W(f"mm_{dt}", "spm_matmul", dict(M=40, K=70, N=33, dtype=dt), "")
            for dt in ("bfloat16", "int8", "float32")] + [
        W("conv_i32", "spm_conv2d", dict(H=37, W=29, F=11, dtype="int32",
                                         shift=4), ""),
        W("conv_f32", "spm_conv2d", dict(H=37, W=29, F=3, dtype="float32"),
          ""),
        W("conv_bf16", "spm_conv2d", dict(H=37, W=29, F=3,
                                          dtype="bfloat16"), ""),
        W("conv_i8", "spm_conv2d", dict(H=37, W=32, F=4, dtype="int8"), ""),
        W("conv_i32_f40", "spm_conv2d", dict(H=40, W=37, F=40,
                                             dtype="int32", shift=4), ""),
        W("fft", "spm_fft", dict(B=5, n=256), ""),
        W("composite", "het_mimd", dict(H=32, W=32, F=3, nb=4, n=256, m=64,
                                        k=64, p=64), "")]
    inputs, launches, err, paths = smoke.run_compute_slice(
        "cpu", np.random.default_rng(0), tiny)
    assert set(inputs) == {w.name for w in tiny}
    assert launches == dict.fromkeys(micro.MODULES, 0)
    assert paths == {k: {"tensor_cores": 0, "cuda_cores": 0}
                     for k in smoke.TC_KERNELS}
    assert err == dict.fromkeys(micro.MODULES, 0.0)
    assert capsys.readouterr().out.count("[slice2]") == len(tiny)


def test_chip_smoke_conv_formula_samples_rows_of_large_work():
    """Past its multiply-add limit ``chip_smoke._formula_conv`` forms the
    first and last ``FORMULA_ROWS`` output rows only, and still catches a
    wrong value there (not in the rows between)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import checks
    from repro_torch.kernels import spm_conv2d as sc
    rng = np.random.default_rng(4)
    for dtype, shift in ((torch.int32, 4), (torch.int8, 0),
                         (torch.float32, 0)):
        img, filt = checks.conv_operands(rng, 40, 21, 5, dtype, "cpu")
        out = sc.spm_conv2d(img, filt, shift=shift)
        smoke._formula_conv("c", out, img, filt, shift, pad=True, limit=100)
        bad = out.clone()
        bad[20, 3] += 1                       # between the sampled rows
        smoke._formula_conv("c", bad, img, filt, shift, pad=True, limit=100)
        bad[39, 3] += 1
        with pytest.raises(AssertionError):
            smoke._formula_conv("c", bad, img, filt, shift, pad=True,
                                limit=100)


def test_chip_smoke_lm_phase_rehearsed_on_the_cpu(capsys):
    """The slice-3 run of ``chip_smoke.run_compute_slice`` at tiny
    shapes on the CPU: attention (a window, an offset, G = 5, bf16) and
    the SSD scan equal their plain versions and their float64 numpy
    formulas, and nothing counts as a launch."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    W = micro.Workload
    tiny = [
        W("attn", "flash_attention", dict(B=2, H=4, KV=2, Sq=70, Skv=70,
                                          hd=16, dtype="bfloat16"), ""),
        W("attn_swa", "flash_attention", dict(B=1, H=5, KV=1, Sq=40,
                                              Skv=100, hd=32, window=30,
                                              q_offset=60,
                                              dtype="float32"), ""),
        W("ssd", "ssd_scan", dict(Bz=2, S=96, H=4, P=8, N=6, G=2, chunk=32,
                                  dtype="float32"), "")]
    inputs, launches, err, paths = smoke.run_compute_slice(
        "cpu", np.random.default_rng(0), tiny, tag="slice3")
    assert set(inputs) == {w.name for w in tiny}
    assert launches == dict.fromkeys(micro.MODULES, 0)
    assert paths == {k: {"tensor_cores": 0, "cuda_cores": 0}
                     for k in smoke.TC_KERNELS}
    assert err == dict.fromkeys(micro.MODULES, 0.0)
    assert capsys.readouterr().out.count("[slice3]") == len(tiny)
    assert {k for k, _, _ in smoke.KERNELS} == set(micro.MODULES) | {
        "fused_vops", "kdotp"}
    assert len(smoke.KERNELS) == 8
    # the JSON lists the SSD scan as its three kernels, each with the
    # scan's source and TPU kernel
    from repro_torch.kernels import ssd_scan as ss
    rows = smoke.json_rows(ss.PARTS)
    assert [n for n, _, _ in rows] == [k for k, _, _ in smoke.KERNELS
                                       if k != "ssd_scan"] + list(ss.PARTS)
    assert {(src, rep) for n, src, rep in rows if n in ss.PARTS} == {
        ("src/repro_torch/csrc/ssd_scan.cu",
         "src/repro/kernels/ssd_scan.py:24")}
    assert set(smoke.SLICE2) | set(smoke.SLICE3) == set(micro.MODULES)
    assert {w.kernel for w in micro.CARD} == set(micro.MODULES)
