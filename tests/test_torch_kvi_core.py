"""The port's copies of the KVI lowering, the cycle model, the scheduler's
estimator and the MFU oracle (``repro_torch.kvi.lowering``,
``repro_torch.core``, ``repro_torch.kvi.scheduler``,
``repro_torch.kvi.oracle``) against the reference's: the paper's conv2d,
FFT and matmul programs, built by both packages from the same numpy
inputs at 8, 16 and 32 bits, lower to the same trace item for item under
Table-2 configurations, simulate to the same cycles and per-hart
busy / stall / idle, and execute to the same outputs bit for bit."""
import dataclasses

import numpy as np
import pytest

import repro.kvi.programs as rprog
from repro.configs.base import KlessydraConfig as RConfig
from repro.configs.base import klessydra_taxonomy as r_taxonomy
from repro.core.isa import Instr as RInstr
from repro.core.simulator import Simulator as RSimulator
from repro.kvi import KviProgramBuilder as RBuilder
from repro.kvi import KviWorkload as RWorkload
from repro.kvi import get_backend as r_backend
from repro.kvi.lowering import SpmOverflowError as RSpmOverflowError
from repro.kvi.lowering import TraceCache as RTraceCache
from repro.kvi.lowering import lower as r_lower
from repro.kvi.passes import default_pipeline as r_pipeline
from repro.kvi.scheduler import HartScheduler as RScheduler
from repro.kvi.scheduler import simulated_profile as r_profile

import repro_torch.kvi as tk
import repro_torch.kvi.programs as tprog
from repro_torch.configs import KlessydraConfig, klessydra_taxonomy
from repro_torch.core import Instr
from repro_torch.core.simulator import Simulator
from repro_torch.kvi.lowering import TraceCache
from repro_torch.kvi.scheduler import HartScheduler, simulated_profile

NP_OF = {1: np.int8, 2: np.int16, 4: np.int32}
LIMIT = {1: 8, 2: 64, 4: 128}            # data ranges of the serving mix
KERNELS = ("conv16_f3", "fft64", "matmul16_streamed", "matmul16_resident")
#: Table-2 schemes: SISD, SIMD, symmetric and heterogeneous MIMD
CONFIGS = ("sisd", "simd_d4", "sym_mimd_d2", "het_mimd_d8")


def _inputs(kind, eb, seed=0):
    rng = np.random.default_rng((seed, KERNELS.index(kind), eb))
    lim = LIMIT[eb]
    if kind.startswith("conv"):
        return (rng.integers(-lim, lim, (16, 16)).astype(np.int32),
                rng.integers(-8, 8, (3, 3)).astype(np.int32))
    if kind == "fft64":
        return (rng.integers(-lim, lim, 64).astype(np.int32),
                rng.integers(-lim, lim, 64).astype(np.int32))
    return (rng.integers(-lim // 2, lim // 2, (16, 16)).astype(np.int32),
            rng.integers(-lim // 2, lim // 2, (16, 16)).astype(np.int32))


def _build(mod, kind, eb, seed=0):
    """The paper's program ``kind`` at ``eb`` bytes, from ``mod`` (the
    reference's or the port's ``kvi.programs``) on the same arrays."""
    a, b = _inputs(kind, eb, seed)
    if kind.startswith("conv"):
        return mod.conv2d_program(a, b, shift=4, elem_bytes=eb)
    if kind == "fft64":
        return mod.fft_program(a, b, elem_bytes=eb)
    return mod.matmul_program(a, b, shift=2, elem_bytes=eb,
                              resident=kind.endswith("resident"))


def _pair(kind, eb, optimized=False):
    ref, port = _build(rprog, kind, eb), _build(tprog, kind, eb)
    if optimized:
        ref = r_pipeline().run(ref)
        port = tk.default_pipeline().run(port)
    return ref, port


def _configs(name):
    return r_taxonomy()[name], klessydra_taxonomy()[name]


def _item(it):
    """Everything the cycle model and the MFU read off one trace item."""
    if type(it).__name__ == "Scalar":          # either package's class
        return ("scalar", it.count)
    return (it.op, it.dst, it.src1, it.src2, it.scalar, it.length,
            it.elem_bytes, getattr(it, "rf_store", None),
            getattr(it, "chain_discount", 0))


def _stats(sim):
    return (sim.cycles, sim.mfu_busy_cycles, sim.lsu_busy_cycles,
            [dataclasses.astuple(h) for h in sim.per_hart])


def test_table2_configs_equal_the_reference():
    ref, port = r_taxonomy(), klessydra_taxonomy()
    assert ref.keys() == port.keys()
    for k in ref:
        assert dataclasses.astuple(ref[k]) == dataclasses.astuple(port[k])
        assert ref[k].scheme == port[k].scheme
        assert ref[k].spm_capacity_bytes == port[k].spm_capacity_bytes
    with pytest.raises(ValueError, match="cannot exceed M"):
        KlessydraConfig("bad", M=1, F=2)


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("eb", [1, 2, 4])
@pytest.mark.parametrize("kind", KERNELS)
def test_lower_matches_the_reference(kind, eb, cfg):
    """Raw programs lower to the same trace, SPM allocation and output
    handles; optimized ones with ``chaining=True`` carry the same chain
    discounts."""
    rcfg, tcfg = _configs(cfg)
    for optimized in (False, True):
        ref, port = _pair(kind, eb, optimized)
        rt = r_lower(ref, rcfg, chaining=optimized)
        tt = tk.lower(port, tcfg, chaining=optimized)
        assert [_item(i) for i in tt.items] == [_item(i) for i in rt.items]
        assert tt.vreg_addr == rt.vreg_addr
        assert tt.out_handles == rt.out_handles
        assert tt.spm.total_bytes == rt.spm.total_bytes
        if optimized:
            assert any(getattr(i, "chain_discount", 0) for i in tt.items) \
                == any(getattr(i, "chain_discount", 0) for i in rt.items)


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("eb", [1, 2, 4])
@pytest.mark.parametrize("harts", [1, 3])
def test_simulate_matches_the_reference(harts, eb, cfg):
    """The port's simulator gives the reference's
    cycles and per-hart busy / stall / idle: each kernel alone on one
    hart, and conv2d / FFT / matmul on three."""
    rcfg, tcfg = _configs(cfg)
    rcfg, tcfg = rcfg.replace(harts=harts), tcfg.replace(harts=harts)
    groups = ([[k] for k in KERNELS] if harts == 1 else
              [["conv16_f3", "fft64", "matmul16_streamed"]])
    for group in groups:
        rtraces, ttraces = [], []
        for kind in group:
            ref, port = _pair(kind, eb, optimized=True)
            rtraces.append(r_lower(ref, rcfg, chaining=True,
                                   functional=False).items)
            ttraces.append(tk.lower(port, tcfg, chaining=True,
                                    functional=False).items)
        want = _stats(RSimulator(rcfg).run(rtraces))
        got = Simulator(tcfg).run(ttraces)
        assert _stats(got) == want
        for h in got.per_hart:
            assert h.total_cycles == want[0]


@pytest.mark.parametrize("eb", [1, 2, 4])
@pytest.mark.parametrize("kind", KERNELS)
def test_scheduler_profile_matches_the_reference(kind, eb):
    ref, port = _pair(kind, eb, optimized=True)
    rc, tc = RTraceCache(), TraceCache()
    assert simulated_profile(port, trace_cache=tc) == r_profile(
        ref, trace_cache=rc)
    assert simulated_profile(port, trace_cache=tc) == r_profile(
        ref, trace_cache=rc)
    assert tc.stats == rc.stats == {"hits": 1, "misses": 1}


def test_scheduler_packing_matches_the_reference():
    """Batch drain and continuous admission place the same programs on
    the same harts at the same estimated cycles."""
    rs, ts = RScheduler(n_harts=3), HartScheduler(n_harts=3)
    order = [k for _ in range(3) for k in KERNELS]
    for kind in order:
        ref, port = _pair(kind, 4)
        rs.submit(ref)
        ts.submit(port)
    rw, tw = rs.dispatch(), ts.dispatch()
    assert [e.assignment.hart for e in tw.entries] == \
        [e.assignment.hart for e in rw.entries]
    assert [(t.hart, t.start_est, t.est_cycles) for t in ts.dispatched] \
        == [(t.hart, t.start_est, t.est_cycles) for t in rs.dispatched]
    for now, kind in enumerate(order):
        ref, port = _pair(kind, 2)
        r, t = rs.admit(ref, now=50 * now), ts.admit(port, now=50 * now)
        assert (t.hart, t.start_est, t.finish_est) == \
            (r.hart, r.start_est, r.finish_est)
    assert ts.hart_free == rs.hart_free
    assert ts.hart_loads == rs.hart_loads


@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("eb", [1, 2, 4])
@pytest.mark.parametrize("kind", KERNELS)
def test_oracle_matches_the_reference(kind, eb, optimized):
    ref, port = _pair(kind, eb, optimized)
    want = r_backend("oracle", passes=()).run(ref).outputs
    got = tk.get_backend("oracle", passes=()).run(port).outputs
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _single_op(builder_cls, eb, emit, x, y):
    b = builder_cls("edge")
    hx = b.mem_in("x", x.astype(NP_OF[eb]), elem_bytes=eb)
    hy = b.mem_in("y", y.astype(NP_OF[eb]), elem_bytes=eb)
    rx, ry = b.vreg("x", len(x), eb), b.vreg("y", len(x), eb)
    out = b.vreg("out", len(x), eb)
    b.kmemld(rx, hx)
    b.kmemld(ry, hy)
    emit(b, out, rx, ry)
    b.kmemstr(b.mem_out("out", len(x), elem_bytes=eb), out)
    return b.build()


#: out-of-range immediates, shifts past the width and wrapping reductions
EDGE_CASES = {
    "ksvaddsc_300": lambda b, o, x, y: b.ksvaddsc(o, x, 300),
    "ksvslt_200": lambda b, o, x, y: b.ksvslt(o, x, 200),
    "ksvmulsc_big": lambda b, o, x, y: b.ksvmulsc(o, x, 3_000_000_019),
    "ksrav_40": lambda b, o, x, y: b.ksrav(o, x, 40),
    "ksrlv_40": lambda b, o, x, y: b.ksrlv(o, x, 40),
    "kdotpps_9": lambda b, o, x, y: b.kdotpps(o[3], x, y, 9),
    "ksvaddrf_big": lambda b, o, x, y: b.ksvaddrf(o[0], x, -(1 << 40)),
    "ksvmulrf_big": lambda b, o, x, y: b.ksvmulrf(o[15], x, 2_000_000_011),
    "kvred": lambda b, o, x, y: b.kvred(o[7], x),
}


@pytest.mark.parametrize("eb", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_oracle_edge_cases_match_the_reference(case, eb):
    info = np.iinfo(NP_OF[eb])
    rng = np.random.default_rng(eb)
    x = rng.integers(info.min, info.max + 1, 16)
    y = rng.integers(info.min, info.max + 1, 16)
    want = r_backend("oracle").run(
        _single_op(RBuilder, eb, EDGE_CASES[case], x, y)).outputs["out"]
    got = tk.get_backend("oracle").run(
        _single_op(tk.KviProgramBuilder, eb, EDGE_CASES[case], x, y)
    ).outputs["out"]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_ksvaddsc_300_wraps_to_44_at_int8():
    zeros = np.zeros(16, np.int64)
    for builder, backend in ((RBuilder, r_backend),
                             (tk.KviProgramBuilder, tk.get_backend)):
        p = _single_op(builder, 1, EDGE_CASES["ksvaddsc_300"], zeros, zeros)
        out = backend("oracle").run(p).outputs["out"]
        assert out.dtype == np.int8 and (out == 44).all()


def test_overflowing_kdotpps_gives_2_pow_28_as_the_reference_oracle():
    """64 elements, a = 2^20, b = 2^10, shift 8: the MFU shifts the exact
    int64 sum 2^36 (``core/mfu.py``), not a wrapped int32."""
    outs = []
    for builder, backend in ((RBuilder, r_backend),
                             (tk.KviProgramBuilder, tk.get_backend)):
        b = builder("ovf")
        ha = b.mem_in("a", np.full(64, 1 << 20, np.int32))
        hb = b.mem_in("b", np.full(64, 1 << 10, np.int32))
        ra, rb, acc = b.vreg("a", 64), b.vreg("b", 64), b.vreg("acc", 1)
        b.kmemld(ra, ha)
        b.kmemld(rb, hb)
        b.kdotpps(acc[0], ra, rb, 8)
        b.kmemstr(b.mem_out("out", 1), acc)
        outs.append(backend("oracle").run(b.build()).outputs["out"][0])
    assert outs == [1 << 28, 1 << 28]


def test_oracle_workload_executes_each_program_once_and_copies():
    """``dedup_entry_outputs``: entries sharing one program object get
    equal outputs in arrays of their own, as in the reference."""
    ref, port = _pair("conv16_f3", 4)
    want = r_backend("oracle").run_workload(RWorkload.homogeneous(
        [ref, ref])).entry_results
    got = tk.get_backend("oracle").run_workload(tk.KviWorkload.homogeneous(
        [port, port])).entry_results
    assert got[0].outputs.keys() == want[0].outputs.keys()
    for k in want[0].outputs:
        a, b = got[0].outputs[k], got[1].outputs[k]
        np.testing.assert_array_equal(a, want[0].outputs[k])
        np.testing.assert_array_equal(b, want[1].outputs[k])
        assert a is not b and not np.shares_memory(a, b)


@pytest.mark.parametrize("spm_kbytes,N", [(1, 1), (1, 2)])
def test_spm_overflow_error_matches_the_reference(spm_kbytes, N):
    """A 32x32 int32 conv2d (its padded image alone is 4.6 KiB) does not
    fit: both packages raise with the same message and footprint."""
    img = np.arange(32 * 32, dtype=np.int32).reshape(32, 32) % 97
    filt = np.ones((3, 3), np.int32)
    rcfg = RConfig("tiny", D=4, N=N, spm_kbytes=spm_kbytes)
    tcfg = KlessydraConfig("tiny", D=4, N=N, spm_kbytes=spm_kbytes)
    with pytest.raises(RSpmOverflowError) as rerr:
        r_lower(rprog.conv2d_program(img, filt), rcfg)
    with pytest.raises(tk.SpmOverflowError) as terr:
        tk.lower(tprog.conv2d_program(img, filt), tcfg)
    assert str(terr.value) == str(rerr.value)
    for attr in ("program_name", "peak_live_bytes", "capacity_bytes",
                 "fragmented"):
        assert getattr(terr.value, attr) == getattr(rerr.value, attr)
    with pytest.raises(tk.SpmOverflowError):
        tk.get_backend("oracle", config=tcfg).run(
            tprog.conv2d_program(img, filt))


def test_timing_only_trace_refuses_to_execute():
    _, port = _pair("fft64", 4)
    tr = tk.lower(port, klessydra_taxonomy()["sisd"], functional=False)
    assert tr.mem[0] is port.mem_init[0]
    with pytest.raises(RuntimeError, match="functional=False"):
        tr.execute()
    with pytest.raises(ValueError, match="unknown KVI op"):
        Instr("kfoo")
    with pytest.raises(ValueError, match="unknown KVI op"):
        RInstr("kfoo")
