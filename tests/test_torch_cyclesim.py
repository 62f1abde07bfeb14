"""The port's cycle-sim backend and the first two stages of its DSE
(``repro_torch.kvi.cyclesim``, ``repro_torch.kvi.dse.space`` and
``.cost``) against the reference's (``repro.kvi.cyclesim``,
``repro.kvi.dse``): the paper's programs, built by the reference from
numpy-seeded inputs and carried across with ``program_from_reference``,
time to the same cycles and per-hart ``HartStats`` under every scheme
and execute to the same outputs (the reference's and the port's oracle);
``run()``, ``replicate_harts=False``, schemes of unequal hart counts and
``functional=False`` behave as the reference's; the paper's ordering
sym <= het <= shared holds; and the scheme configs, the design space's
enumeration and errors, the constraints, the preflight and every cost
model function equal the reference's exactly."""
import dataclasses

import numpy as np
import pytest

import repro.kvi.programs as rprog
from benchmarks.paper_data import TABLE3_FILTERS as R_TABLE3
from repro.kvi import KviWorkload as RWorkload
from repro.kvi import get_backend as r_backend
from repro.kvi.cyclesim import TIMING_VERSION as R_TIMING_VERSION
from repro.kvi.cyclesim import CycleSimBackend as RCycleSim
from repro.kvi.cyclesim import default_schemes as r_default_schemes
from repro.kvi.dse import cost as rcost
from repro.kvi.dse import space as rspace

import repro_torch.kvi as tk
from repro_torch.kvi.cyclesim import (TIMING_VERSION, CycleSimBackend,
                                      default_schemes)
from repro_torch.kvi.dse import cost as tcost
from repro_torch.kvi.dse import space as tspace

KINDS = ("conv8_f3", "conv16_f5", "fft32", "matmul8", "matmul8_resident")


def _reference_program(kind, eb=4, seed=0):
    rng = np.random.default_rng((seed, KINDS.index(kind), eb))
    lim = {1: 8, 2: 64, 4: 128}[eb]
    if kind.startswith("conv"):
        S, F = (8, 3) if kind == "conv8_f3" else (16, 5)
        return rprog.conv2d_program(
            rng.integers(-lim, lim, (S, S)).astype(np.int32),
            rng.integers(-4, 4, (F, F)).astype(np.int32), shift=2,
            elem_bytes=eb)
    if kind == "fft32":
        return rprog.fft_program(
            rng.integers(-lim, lim, 32).astype(np.int32),
            rng.integers(-lim, lim, 32).astype(np.int32), elem_bytes=eb)
    a, b = (rng.integers(-lim // 2, lim // 2, (8, 8)).astype(np.int32)
            for _ in range(2))
    return rprog.matmul_program(a, b, shift=2, elem_bytes=eb,
                                resident=kind.endswith("resident"))


def _stats(timing):
    return {s: (r.cycles, r.mfu_busy_cycles, r.lsu_busy_cycles,
                [dataclasses.astuple(h) for h in r.per_hart])
            for s, r in timing.items()}


def _same_outputs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            assert g[k].dtype == v.dtype
            np.testing.assert_array_equal(g[k], v)


def _pair(by_hart):
    """The same composite workload in both packages."""
    return (RWorkload.composite(by_hart), tk.KviWorkload.composite(
        {h: [tk.program_from_reference(p) for p in ps]
         for h, ps in by_hart.items()}))


# ---------------------------------------------------------------------------
# CycleSimBackend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("passes", [None, ()], ids=["pipeline", "raw"])
@pytest.mark.parametrize("chaining", [False, True])
@pytest.mark.parametrize("eb", [1, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_replicated_timing_and_outputs_equal_the_reference(kind, eb,
                                                           chaining, passes):
    """The homogeneous protocol (3 harts): cycles, MFU / LSU busy cycles
    and every ``HartStats`` per scheme; outputs equal to the reference's
    and to the port's oracle."""
    ref = _reference_program(kind, eb)
    want = RCycleSim(chaining=chaining, passes=passes).run_workload(
        RWorkload.replicate(ref, 3))
    wl = tk.KviWorkload.replicate(tk.program_from_reference(ref), 3)
    got = CycleSimBackend(chaining=chaining, passes=passes).run_workload(wl)
    assert _stats(got.timing) == _stats(want.timing)
    assert got.cycles == want.cycles
    _same_outputs(got.outputs, want.outputs)
    _same_outputs(got.outputs, tk.get_backend(
        "oracle", passes=passes).run_workload(wl).outputs)


@pytest.mark.parametrize("chaining", [False, True])
def test_composite_timing_equals_the_reference(chaining):
    """The paper's composite protocol (conv, FFT and matmul pinned to
    harts 0, 1, 2; a second program queued on hart 0)."""
    rwl, twl = _pair({0: [_reference_program("conv8_f3"),
                          _reference_program("conv16_f5")],
                      1: [_reference_program("fft32")],
                      2: [_reference_program("matmul8")]})
    want = RCycleSim(chaining=chaining).run_workload(rwl)
    got = CycleSimBackend(chaining=chaining).run_workload(twl)
    assert _stats(got.timing) == _stats(want.timing)
    _same_outputs(got.outputs, want.outputs)
    assert got.hart_utilization == want.hart_utilization


@pytest.mark.parametrize("replicate", [True, False])
@pytest.mark.parametrize("kind", ["conv8_f3", "fft32"])
def test_run_equals_the_reference(kind, replicate):
    """``run()``: replicated on every hart by default, alone with
    ``replicate_harts=False``."""
    ref = _reference_program(kind)
    want = RCycleSim(replicate_harts=replicate).run(ref)
    got = CycleSimBackend(replicate_harts=replicate).run(
        tk.program_from_reference(ref))
    assert got.backend == "cyclesim"
    assert _stats(got.timing) == _stats(want.timing)
    _same_outputs([got.outputs], [want.outputs])


def test_unequal_hart_counts_replicate_the_smallest():
    """Schemes of 2 and 4 harts: ``run()`` replicates on 2, as the
    reference does."""
    from repro.configs.base import KlessydraConfig as RConfig

    from repro_torch.configs import KlessydraConfig
    ref = _reference_program("conv8_f3")
    kw = {"a": dict(M=1, F=1, D=4, harts=2),
          "b": dict(M=4, F=4, D=2, harts=4)}
    want = RCycleSim(schemes={k: RConfig(k, **v) for k, v in kw.items()}
                     ).run(ref)
    got = CycleSimBackend(schemes={k: KlessydraConfig(k, **v)
                                   for k, v in kw.items()}).run(
        tk.program_from_reference(ref))
    assert _stats(got.timing) == _stats(want.timing)
    assert [h.instructions > 0 for h in got.timing["b"].per_hart] == \
        [True, True, False, False]


def test_functional_false_times_without_outputs():
    ref = _reference_program("matmul8")
    want = RCycleSim().run_workload(RWorkload.replicate(ref, 3),
                                    functional=False)
    got = CycleSimBackend().run_workload(tk.KviWorkload.replicate(
        tk.program_from_reference(ref), 3), functional=False)
    assert _stats(got.timing) == _stats(want.timing)
    assert got.outputs == want.outputs == ({}, {}, {})


def test_paper_ordering_sym_le_het_le_shared():
    """The paper's invariant, homogeneous and composite."""
    rwl, twl = _pair({0: [_reference_program("conv16_f5")],
                      1: [_reference_program("fft32")],
                      2: [_reference_program("matmul8")]})
    for wl in (twl, tk.KviWorkload.replicate(tk.program_from_reference(
            _reference_program("conv16_f5")), 3)):
        c = CycleSimBackend().run_workload(wl).cycles
        assert c["sym_mimd"] <= c["het_mimd"] <= c["shared"], c


def test_defaults_and_registry_equal_the_reference():
    assert TIMING_VERSION == R_TIMING_VERSION
    for D in (1, 2, 4, 8):
        got, want = default_schemes(D=D), r_default_schemes(D=D)
        assert list(got) == list(want)
        assert [dataclasses.astuple(c) for c in got.values()] == \
            [dataclasses.astuple(c) for c in want.values()]
    be = tk.get_backend("cyclesim", chaining=True)
    assert isinstance(be, CycleSimBackend) and be.name == "cyclesim"
    assert list(be.schemes) == list(r_backend("cyclesim").schemes)


# ---------------------------------------------------------------------------
# dse.space
# ---------------------------------------------------------------------------


def _cfg(c):
    return dataclasses.astuple(c)


@pytest.mark.parametrize("scheme", tspace.SCHEMES)
def test_scheme_config_equals_the_reference(scheme):
    assert tspace.SCHEMES == rspace.SCHEMES
    for D in (1, 2, 4, 8):
        for kw in ({}, {"spm_kbytes": 16, "M": 4}, {"F": 2, "M": 4},
                   {"subword_bits": 32, "name": "x"},
                   {"fu_counts": (("adder", 2),)}):
            assert _cfg(tspace.scheme_config(scheme, D=D, **kw)) == \
                _cfg(rspace.scheme_config(scheme, D=D, **kw))
    with pytest.raises(ValueError) as got:
        tspace.scheme_config("vector")
    with pytest.raises(ValueError) as want:
        rspace.scheme_config("vector")
    assert str(got.value) == str(want.value)


SPACES = {
    "default": {},
    "wide": dict(lanes=(1, 2, 8), precisions=(8, 32), spm_kbytes=(16, 64),
                 chaining=(False, True), replication=(3, 4),
                 het_fus=(1, 2, 3), pipelines=(None, ()),
                 fu_counts=((), (("multiplier", 2),))),
    "het_only": dict(schemes=("het_mimd",), replication=(2,),
                     het_fus=(1, 2)),
}


@pytest.mark.parametrize("space", sorted(SPACES))
def test_design_space_enumeration_equals_the_reference(space):
    got = tspace.DesignSpace(**SPACES[space])
    want = rspace.DesignSpace(**SPACES[space])
    assert got.grid_size == want.grid_size
    pts, rpts = got.points(), want.points()
    assert [p.canonical_dict() for p in pts] == \
        [p.canonical_dict() for p in rpts]
    assert [p.name for p in pts] == [p.name for p in rpts]
    assert [_cfg(p.config()) for p in pts] == \
        [_cfg(p.config()) for p in rpts]
    for i in range(got.grid_size):
        assert got.point_at(i).canonical_dict() == \
            want.point_at(i).canonical_dict()
    assert got.size == len(pts)


def _error(fn):
    with pytest.raises((ValueError, IndexError)) as e:
        fn()
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("case", [
    ("space", dict(lanes=())), ("space", dict(schemes=("vector",))),
    ("space", dict(precisions=(4,))), ("space", dict(lanes=(3,))),
    ("space", dict(spm_kbytes=(0,))), ("space", dict(replication=(1,))),
    ("space", dict(het_fus=(0,))),
    ("point", ("shared", 3, 1, 4)), ("point", ("sym_mimd", 3, 2, 4)),
    ("point", ("het_mimd", 3, 3, 4)), ("point", ("vector", 1, 1, 4)),
    ("point", ("shared", 1, 1, 4, 12)), ("point", ("shared", 1, 1, 0)),
    ("point_at", -1), ("point_at", 10_000),
], ids=str)
def test_design_space_errors_equal_the_reference(case):
    what, arg = case
    if what == "space":
        assert _error(lambda: tspace.DesignSpace(**arg)) == \
            _error(lambda: rspace.DesignSpace(**arg))
    elif what == "point":
        assert _error(lambda: tspace.DesignPoint(*arg)) == \
            _error(lambda: rspace.DesignPoint(*arg))
    else:
        assert _error(lambda: tspace.DesignSpace().point_at(arg)) == \
            _error(lambda: rspace.DesignSpace().point_at(arg))


CONSTRAINTS = [dict(), dict(schemes=("shared",)), dict(max_lanes=4),
               dict(precisions=(16,)), dict(max_area_luteq=20000.0),
               dict(max_static_nj_per_cycle=1.2),
               dict(max_area_luteq=1e9, max_static_nj_per_cycle=1.0)]


@pytest.mark.parametrize("kw", CONSTRAINTS, ids=str)
def test_space_constraints_equal_the_reference(kw):
    got = tspace.SpaceConstraints(**kw)
    want = rspace.SpaceConstraints(**kw)
    for p, rp in zip(tspace.DesignSpace().points(),
                     rspace.DesignSpace().points()):
        assert got.reject_reason(p) == want.reject_reason(rp)
        assert got.feasible(p) == want.feasible(rp)
    assert got.as_dict() == want.as_dict()
    pred = tspace.SpaceConstraints(predicate=lambda p: p.D < 8)
    rpred = rspace.SpaceConstraints(predicate=lambda p: p.D < 8)
    assert [pred.reject_reason(p) for p in tspace.DesignSpace().points()] \
        == [rpred.reject_reason(p) for p in rspace.DesignSpace().points()]


@pytest.mark.parametrize("spm_kbytes", [1, 2, 64])
def test_preflight_equals_the_reference(spm_kbytes):
    """The paper's programs at 8 and 32 bits against SPMs from 1 KiB
    (conv16 and FFT-32 overflow) to 64 KiB: the same reason or None,
    with and without a trace cache."""
    from repro.kvi.lowering import TraceCache as RTraceCache

    from repro_torch.kvi.lowering import TraceCache
    for prec in (8, 32):
        refs = [_reference_program(k, prec // 8) for k in KINDS]
        progs = [tk.program_from_reference(p) for p in refs]
        for scheme, M, F in (("shared", 1, 1), ("het_mimd", 3, 1)):
            pt = tspace.DesignPoint(scheme, M, F, 4, prec, spm_kbytes)
            rpt = rspace.DesignPoint(scheme, M, F, 4, prec, spm_kbytes)
            want = rspace.preflight_point(rpt, refs)
            assert tspace.preflight_point(pt, progs) == want
            assert tspace.preflight_point(pt, progs, TraceCache()) == \
                rspace.preflight_point(rpt, refs, RTraceCache())
            if spm_kbytes == 64:
                assert want is None


# ---------------------------------------------------------------------------
# dse.cost
# ---------------------------------------------------------------------------


def _points():
    return zip(tspace.DesignSpace(**SPACES["wide"]).points(),
               rspace.DesignSpace(**SPACES["wide"]).points())


def test_hardware_cost_and_static_energy_equal_the_reference():
    assert tcost.CALIBRATION == rcost.CALIBRATION
    assert tcost.CALIBRATION_VERSION == rcost.CALIBRATION_VERSION
    assert tcost.CALIBRATION_FIT_MAX_REL_ERR == \
        rcost.CALIBRATION_FIT_MAX_REL_ERR
    for p, rp in _points():
        cfg, rcfg = p.config(), rp.config()
        got, want = tcost.hardware_cost(cfg), rcost.hardware_cost(rcfg)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.area_luteq == want.area_luteq
        assert got.as_dict() == want.as_dict()
        assert tcost.mfu_cost(cfg) == rcost.mfu_cost(rcfg)
        assert tcost.spm_cost(cfg) == rcost.spm_cost(rcfg)
        assert tcost.energy_per_cycle_static(cfg) == \
            rcost.energy_per_cycle_static(rcfg)


@pytest.mark.parametrize("scheme", tspace.SCHEMES)
def test_energy_model_equals_the_reference(scheme):
    """The energy of the port's simulated run, from the port's model,
    equals the reference's of its own run."""
    ref = _reference_program("conv16_f5")
    for D in (2, 8):
        cfg = tspace.scheme_config(scheme, D=D)
        rcfg = rspace.scheme_config(scheme, D=D)
        got = CycleSimBackend(schemes={scheme: cfg}).run(
            tk.program_from_reference(ref)).timing[scheme]
        want = RCycleSim(schemes={scheme: rcfg}).run(ref).timing[scheme]
        assert tcost.energy_model(cfg, got) == rcost.energy_model(rcfg,
                                                                  want)


@pytest.mark.parametrize("optimized", [False, True])
def test_kernel_profile_and_estimate_equal_the_reference(optimized):
    from repro.kvi.passes import default_pipeline as r_pipeline
    for kind in KINDS:
        for eb in (1, 2, 4):
            ref = _reference_program(kind, eb)
            port = tk.program_from_reference(ref)
            if optimized:
                ref, port = r_pipeline().run(ref), \
                    tk.default_pipeline().run(port)
            got, want = tcost.kernel_profile(port), rcost.kernel_profile(ref)
            for f in dataclasses.fields(want):
                g, w = getattr(got, f.name), getattr(want, f.name)
                if isinstance(w, np.ndarray):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)
                else:
                    assert g == w
            for p, rp in _points():
                for chaining in (False, True):
                    assert tcost.estimate_kernel(got, p.config(),
                                                 chaining) == \
                        rcost.estimate_kernel(want, rp.config(), chaining)
    profs = {"conv": tcost.kernel_profile(tk.program_from_reference(
        _reference_program("conv8_f3")))}
    rprofs = {"conv": rcost.kernel_profile(_reference_program("conv8_f3"))}
    pts = tspace.DesignSpace().points()
    assert tcost.batch_estimate(profs, pts) == rcost.batch_estimate(
        rprofs, rspace.DesignSpace().points())


def test_calibration_fit_and_table3_equal_the_reference():
    """The port's copy of Table 3 is the reference's, and the fit over
    it (and over an explicit table) is the reference's number for
    number."""
    assert tcost.TABLE3_FILTERS == R_TABLE3
    got = tcost.calibration_fit()
    assert got == rcost.calibration_fit()
    assert got["ok"] and len(got["rows"]) == 20
    cut = {k: v for k, v in R_TABLE3.items() if k[1] == 2}
    assert tcost.calibration_fit(cut) == rcost.calibration_fit(cut)
