"""The port's measurement protocol and legacy authoring layer against the
reference's: ``core.workloads`` (homogeneous / composite cycles, the
energy model), ``core.baselines``, ``core.programs`` (``build_*``,
``*_result``, ``conv2d_oracle``, the deprecated ``ProgramBuilder``) and
the deprecated ``kernels.kvi_vops.run_vops`` — cycles, traces and values
equal, integers bit for bit."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.baselines as rbase
import repro.core.programs as rprog
import repro.core.workloads as rwork
from repro.configs.base import KlessydraConfig as RConfig
from repro.configs.base import klessydra_taxonomy as rtax
from repro.kernels import ref as rref
from repro.kernels.kvi_vops import run_vops as ref_run_vops
from repro_torch.configs.base import KlessydraConfig, klessydra_taxonomy
from repro_torch.core import baselines, programs, workloads
from repro_torch.kernels import fused_vops, ref
from repro_torch.kernels.kvi_vops import run_vops

SCHEMES = list(klessydra_taxonomy())
#: kernels each scheme's homogeneous protocol runs here (the rest of
#: KERNEL_BUILDERS run on a few schemes: fft256 and matmul64 take seconds)
SMALL = ("conv4", "conv8", "conv16", "conv32", "conv32_f5")


def _pair(name):
    return klessydra_taxonomy()[name], rtax()[name]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_homogeneous_cycles_equal_the_reference(scheme):
    cfg, rcfg = _pair(scheme)
    for kernel in SMALL:
        assert workloads.homogeneous_cycles(cfg, kernel) == \
            rwork.homogeneous_cycles(rcfg, kernel), kernel


@pytest.mark.parametrize("scheme", ["sisd", "het_mimd_d8", "sym_mimd_d4"])
@pytest.mark.parametrize("kernel", ["conv32_f7", "conv32_f11", "fft256",
                                    "matmul64"])
def test_homogeneous_cycles_of_the_large_kernels(scheme, kernel):
    cfg, rcfg = _pair(scheme)
    assert workloads.homogeneous_cycles(cfg, kernel) == \
        rwork.homogeneous_cycles(rcfg, kernel)


@pytest.mark.parametrize("scheme", ["sisd", "simd_d8", "sym_mimd_d8",
                                    "het_mimd_d8"])
def test_composite_cycles_equal_the_reference(scheme):
    cfg, rcfg = _pair(scheme)
    reps = {"conv32": 2, "fft256": 2, "matmul64": 1}
    assert workloads.composite_cycles(cfg, reps) == \
        rwork.composite_cycles(rcfg, reps)


def test_workload_objects_equal_the_reference():
    cfg, rcfg = _pair("het_mimd_d8")
    wl, rwl = (workloads.composite_workload(cfg, {"conv32": 2}),
               rwork.composite_workload(rcfg, {"conv32": 2}))
    assert str(wl) == str(rwl) and dict(wl.meta) == dict(rwl.meta)
    assert [e.hart for e in wl.entries] == [e.hart for e in rwl.entries]
    for e, r in zip(wl.entries, rwl.entries):
        assert e.program.name == r.program.name
        for k, v in r.program.mem_init.items():
            assert np.array_equal(e.program.mem_init[k], v)
    h = workloads.homogeneous_workload(cfg, "fft256", harts=2)
    assert h.name == "homogeneous_fft256" and len(h.entries) == 2
    assert set(workloads.KERNEL_BUILDERS) == set(rwork.KERNEL_BUILDERS)
    assert workloads.BASELINE_ARGS == rwork.BASELINE_ARGS
    assert workloads.COMPOSITE_KERNELS == rwork.COMPOSITE_KERNELS


@pytest.mark.parametrize("scheme,D", [("SISD", 1), ("SIMD", 4),
                                      ("SymMIMD+SIMD", 8), ("HetMIMD", 1),
                                      ("ri5cy", 0), ("zeroriscy", 0)])
def test_energy_model_equals_the_reference(scheme, D):
    for cycles, ops in ((1000.0, 10), (123456.5, 0)):
        assert workloads.exec_time_us(scheme, D, cycles) == \
            rwork.exec_time_us(scheme, D, cycles)
        assert workloads.energy_proxy(scheme, D, cycles) == \
            rwork.energy_proxy(scheme, D, cycles)
        assert workloads.energy_per_op(scheme, D, cycles, ops) == \
            rwork.energy_per_op(scheme, D, cycles, ops)


def test_baselines_equal_the_reference():
    for core in baselines.BASELINES:
        for kernel, kw in [("conv", dict(S=s, F=f)) for s in (4, 32)
                           for f in (3, 11)] + \
                [("matmul", dict(n=n)) for n in (8, 64)] + \
                [("fft", dict(n=n)) for n in (64, 256)]:
            assert baselines.baseline_cycles(core, kernel, **kw) == \
                rbase.baseline_cycles(core, kernel, **kw)
    with pytest.raises(ValueError):
        baselines.baseline_cycles("ri5cy", "sort", n=4)
    assert baselines.SYNTHESIS == rbase.SYNTHESIS
    for scheme, D in [("SISD", 1), ("SIMD", 2), ("SymMIMD", 1),
                      ("HetMIMD+SIMD", 8), ("klessydra-t03", 0)]:
        assert baselines.synthesis_for(scheme, D) == \
            rbase.synthesis_for(scheme, D)
    with pytest.raises(KeyError):
        baselines.synthesis_for("SIMD", 3)


# ---------------------------------------------------------------------------
# the deprecated authoring layer
# ---------------------------------------------------------------------------

def _items(prog):
    return [(type(i).__name__, tuple(sorted(vars(i).items())))
            for i in prog.items]


@pytest.fixture
def quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


@pytest.mark.parametrize("shift", [0, 3])
def test_build_conv2d_equals_the_reference(quiet, shift):
    rng = np.random.default_rng(shift)
    img = rng.integers(-100, 100, (8, 8)).astype(np.int32)
    filt = rng.integers(-5, 5, (3, 3)).astype(np.int32)
    cfg, rcfg = _pair("het_mimd_d4")
    p, r = programs.build_conv2d(cfg, img, filt, shift), \
        rprog.build_conv2d(rcfg, img, filt, shift)
    assert (p.name, p.alg_ops, p.n_instructions) == \
        (r.name, r.alg_ops, r.n_instructions)
    p.builder.run_functional()
    r.builder.run_functional()
    got = programs.conv2d_result(p, 8)
    assert np.array_equal(got, rprog.conv2d_result(r, 8))
    assert np.array_equal(got, programs.conv2d_oracle(img, filt, shift))
    assert np.array_equal(programs.conv2d_oracle(img, filt, shift),
                          rprog.conv2d_oracle(img, filt, shift))


@pytest.mark.parametrize("spm_kbytes", [4, 64])
def test_build_matmul_equals_the_reference(quiet, spm_kbytes):
    rng = np.random.default_rng(1)
    A = rng.integers(-60, 60, (8, 8)).astype(np.int32)
    B = rng.integers(-60, 60, (8, 8)).astype(np.int32)
    cfg = KlessydraConfig("x", M=3, F=1, D=4, spm_kbytes=spm_kbytes)
    rcfg = RConfig("x", M=3, F=1, D=4, spm_kbytes=spm_kbytes)
    p, r = programs.build_matmul(cfg, A, B, 2), \
        rprog.build_matmul(rcfg, A, B, 2)
    assert p.n_instructions == r.n_instructions
    p.builder.run_functional()
    r.builder.run_functional()
    got = programs.matmul_result(p, 8, 8)
    assert np.array_equal(got, rprog.matmul_result(r, 8, 8))
    assert np.array_equal(got, (A.astype(np.int64) @ B >> 2).astype(
        np.int32))


def test_build_fft_equals_the_reference(quiet):
    rng = np.random.default_rng(2)
    re = rng.integers(-2048, 2048, 64).astype(np.int32)
    im = rng.integers(-2048, 2048, 64).astype(np.int32)
    cfg, rcfg = _pair("simd_d8")
    p, r = programs.build_fft(cfg, re, im), rprog.build_fft(rcfg, re, im)
    assert p.out_handles == r.out_handles
    p.builder.run_functional()
    r.builder.run_functional()
    assert np.array_equal(programs.fft_result(p), rprog.fft_result(r))
    assert programs.Q == rprog.Q


def test_program_builder_warns_and_replays_like_the_reference():
    cfg, rcfg = _pair("sisd")
    x = np.arange(-8, 8, dtype=np.int32)
    mems = []
    for mod, c in ((programs, cfg), (rprog, rcfg)):
        with pytest.warns(DeprecationWarning, match="ProgramBuilder is "
                                                    "deprecated"):
            pb = mod.ProgramBuilder(c)
        h = pb.to_memory(x)
        out = pb.to_memory(np.zeros(16, np.int32))
        pb.kmemld(0, h, 16)
        pb.emit("ksvmulsc", dst=0, src1=0, scalar=3, length=16)
        pb.emit("krelu", dst=0, src1=0, length=16)
        pb.scalar(2)
        pb.kmemstr(out, 0, 16)
        prog = pb.finish("relu3x", alg_ops=32)
        assert prog.n_instructions == 6
        mems.append(pb.run_functional()[out])
    assert np.array_equal(mems[0], mems[1])
    assert np.array_equal(mems[0], np.maximum(3 * x, 0))


# ---------------------------------------------------------------------------
# run_vops
# ---------------------------------------------------------------------------

PROGRAMS = [
    [("kvmul", 2, 0, 1, 0), ("ksrav", 2, 2, None, 3),
     ("krelu", 2, 2, None, 0)],
    [("kaddv", 2, 0, 1, 0), ("ksvmulsc", 3, 2, None, -7),
     ("kvslt", 4, 3, 0, 0), ("ksubv", 5, 4, 1, 0)],
    [("ksvaddsc", 0, 0, None, 99), ("ksrlv", 1, 0, None, 2),
     ("ksvslt", 2, 1, None, 5), ("kvcp", 3, 2, None, 0)],
]


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32"])
@pytest.mark.parametrize("k", range(len(PROGRAMS)))
def test_run_vops_equals_the_references_vops_ref(dtype, k):
    rng = np.random.default_rng(k)
    info = np.iinfo(dtype)
    a, b = (rng.integers(info.min, info.max, 1000, endpoint=True).astype(
        dtype) for _ in range(2))
    prog = PROGRAMS[k]
    with pytest.warns(DeprecationWarning, match="run_vops is deprecated"):
        got = run_vops(prog, [torch.from_numpy(a), torch.from_numpy(b)])
    want = rref.vops_ref(prog, [jnp.asarray(a), jnp.asarray(b)])
    assert got.dtype == getattr(torch, dtype) and got.shape == (1000,)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, ref.vops_ref(prog, [torch.from_numpy(a),
                                                torch.from_numpy(b)]))


def test_run_vops_takes_the_references_defaults():
    """out_slot is the last op's dst, n_slots the larger of the inputs and
    the highest dst + 1; the result keeps the inputs' shape (a 2-D input
    as the reference's reshape does); an explicit out_slot is honoured."""
    rng = np.random.default_rng(9)
    a = rng.integers(-500, 500, (4, 64)).astype(np.int32)
    b = rng.integers(-500, 500, (4, 64)).astype(np.int32)
    prog = [("kaddv", 2, 0, 1, 0), ("krelu", 3, 2, None, 0)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = run_vops(prog, [torch.from_numpy(a), torch.from_numpy(b)])
        mid = run_vops(prog, [torch.from_numpy(a), torch.from_numpy(b)],
                       out_slot=2)
        want = ref_run_vops(prog, [jnp.asarray(a), jnp.asarray(b)])
        want_mid = ref_run_vops(prog, [jnp.asarray(a), jnp.asarray(b)],
                                out_slot=2)
    assert got.shape == (4, 64)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(mid.numpy(), np.asarray(want_mid))


def test_run_vops_refuses_non_elementwise_ops_before_running():
    before = fused_vops.launch_count
    x = torch.arange(8, dtype=torch.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for op in ("kdotp", "kvred", "kmemld"):
            with pytest.raises(ValueError, match="not an element-wise"):
                run_vops([(op, 2, 0, 1, 0)], [x, x])
            with pytest.raises(ValueError, match="not an element-wise"):
                ref_run_vops([(op, 2, 0, 1, 0)], [jnp.asarray(x.numpy())] * 2)
    assert fused_vops.launch_count == before


def test_core_package_exports_as_the_reference():
    import repro.core as rcore
    import repro_torch.core as tcore
    for name in ("baselines", "mfu", "programs", "simulator", "spm",
                 "workloads", "Instr", "Scalar", "OPDEFS", "Unit",
                 "SimResult", "simulate", "KlessydraConfig",
                 "klessydra_taxonomy"):
        assert hasattr(rcore, name) and hasattr(tcore, name), name
