"""The port's static analyzer (``repro_torch.kvi.analysis``) against the
reference's (``repro.kvi.analysis``): the cases of
``tests/kvi/test_analysis.py`` that do not reach the DSE, each built with
both packages' builders and checked in both, with the port's diagnostics
(code, severity, subject, message, item, op) equal to the reference's.
Also the pipeline's verify mode naming the same pass, the backends'
``verify=`` gate on the port's ``torch`` (``device="cpu"``) and ``oracle``
backends, and the two CLIs' output byte for byte.

Defects that construction-time validation rejects (OOB views, negative
offsets) are seeded post-hoc with ``dataclasses.replace`` on the frozen
IR, as the reference's tests seed them."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

import repro.configs.base as rcfg
import repro.kvi as rk
import repro.kvi.analysis as ra
import repro.kvi.analysis.registry as rreg
import repro.kvi.lowering as rlow
import repro.kvi.passes as rpass
import repro_torch.configs.base as tcfg
import repro_torch.kvi as tk
import repro_torch.kvi.analysis as ta
import repro_torch.kvi.analysis.registry as treg
import repro_torch.kvi.lowering as tlow
import repro_torch.kvi.passes as tpass

REF = types.SimpleNamespace(kvi=rk, an=ra, reg=rreg, cfg=rcfg.KlessydraConfig,
                            low=rlow, passes=rpass, name="ref")
PORT = types.SimpleNamespace(kvi=tk, an=ta, reg=treg,
                             cfg=tcfg.KlessydraConfig, low=tlow,
                             passes=tpass, name="port")
ROOT = pathlib.Path(__file__).resolve().parents[1]


def small_program(pkg, name="demo"):
    b = pkg.kvi.KviProgramBuilder(name)
    h = b.mem_in("x", np.arange(16, dtype=np.int32))
    v = b.vreg("v", 16)
    w = b.vreg("w", 16)
    b.kmemld(v, h)
    b.ksvmulsc(w, v, scalar=2)
    b.kaddv(w, w, v)
    out = b.mem_out("y", 16)
    b.kmemstr(out, w)
    return b.build()


def replace_instr(program, idx, **fields):
    items = list(program.items)
    items[idx] = dataclasses.replace(items[idx], **fields)
    return dataclasses.replace(program, items=tuple(items))


def instr_indices(pkg, program, op=None):
    return [i for i, it in enumerate(program.items)
            if isinstance(it, pkg.kvi.KviInstr)
            and (op is None or it.op is getattr(pkg.kvi.KviOp, op))]


def both(case):
    """Run ``case(pkg)`` -> report for the reference and the port; the
    port's diagnostics must equal the reference's. Returns the port's."""
    want = case(REF)
    got = case(PORT)
    assert [d.as_dict() for d in got] == [d.as_dict() for d in want]
    assert (got.ok, got.clean) == (want.ok, want.clean)
    return got


# ---------------------------------------------------------------------------
# seeded defects: one program per code class, checked in both packages
# ---------------------------------------------------------------------------


def _oob_window(pkg):
    p = small_program(pkg)
    idx = instr_indices(pkg, p, "KADDV")[0]
    it = p.items[idx]
    return pkg.an.verify_program(replace_instr(
        p, idx, src1=dataclasses.replace(it.src1, offset=9)))


def _elem_bytes(pkg):
    p = small_program(pkg)
    idx = instr_indices(pkg, p, "KADDV")[0]
    return pkg.an.verify_program(replace_instr(p, idx, elem_bytes=2))


def _mem_extent(pkg):
    p = small_program(pkg)
    idx = instr_indices(pkg, p, "KMEMLD")[0]
    return pkg.an.verify_program(replace_instr(p, idx, length=8))


def _use_before_def(pkg):
    b = pkg.kvi.KviProgramBuilder("cold")
    v = b.vreg("v", 8)
    w = b.vreg("w", 8)
    b.kaddv(w, v, v)                   # v never written: defined zeros
    out = b.mem_out("y", 8)
    b.kmemstr(out, w)
    return pkg.an.verify_program(b.build())


def _output_never_written(pkg):
    p = small_program(pkg)
    idx = instr_indices(pkg, p, "KMEMSTR")[0]
    items = tuple(it for i, it in enumerate(p.items) if i != idx)
    return pkg.an.verify_program(dataclasses.replace(p, items=items))


def _duplicate_vreg(pkg):
    p = small_program(pkg)
    vregs = list(p.vregs)
    clash = pkg.kvi.VReg(vregs[0].name, vregs[1].id, vregs[1].length,
                         vregs[1].elem_bytes)
    return pkg.an.verify_program(
        dataclasses.replace(p, vregs=(vregs[0], clash)))


def _dangling_ref(pkg):
    p = small_program(pkg)
    idx = instr_indices(pkg, p, "KADDV")[0]
    it = p.items[idx]
    return pkg.an.verify_program(replace_instr(
        p, idx, src2=dataclasses.replace(it.src2, id=77)))


def _wrong_space(pkg):
    p = small_program(pkg)
    idx = instr_indices(pkg, p, "KADDV")[0]
    return pkg.an.verify_program(replace_instr(
        p, idx, src2=pkg.kvi.Ref("mem", 0, 0)))


def _degenerate_length(pkg):
    p = small_program(pkg)
    return pkg.an.verify_program(dataclasses.replace(
        p, items=p.items + (pkg.kvi.ScalarBlock(0),)))


def _ignored_mem_offset(pkg):
    p = small_program(pkg)
    idx = instr_indices(pkg, p, "KMEMLD")[0]
    it = p.items[idx]
    return pkg.an.verify_program(replace_instr(
        p, idx, src1=dataclasses.replace(it.src1, offset=4)))


def _mem_init_mismatch(pkg):
    p = small_program(pkg)
    bad_init = dict(p.mem_init)
    bad_init[0] = np.arange(4, dtype=np.int32)    # declared 16
    return pkg.an.verify_program(dataclasses.replace(p, mem_init=bad_init))


def _optimized(pkg):
    p = pkg.passes.optimize_program(small_program(pkg))
    assert isinstance(p.meta.get(pkg.passes.META_KEY), pkg.passes.FusionPlan)
    return p


def _with_plan(pkg, p, plan):
    meta = dict(p.meta)
    meta[pkg.passes.META_KEY] = plan
    return dataclasses.replace(p, meta=meta)


def _planner_output(pkg):
    return pkg.an.analyze_program(_optimized(pkg))


def _weld_mem_op(pkg):
    p = _optimized(pkg)
    plan = p.meta[pkg.passes.META_KEY]
    mem_idx = instr_indices(pkg, p, "KMEMLD")[0]
    region = plan.regions[0]
    bad_region = dataclasses.replace(
        region, items=tuple(sorted(region.items + (mem_idx,))))
    return pkg.an.analyze_program(_with_plan(pkg, p, dataclasses.replace(
        plan, regions=(bad_region,) + plan.regions[1:])))


def _invalid_indices(pkg):
    p = _optimized(pkg)
    plan = p.meta[pkg.passes.META_KEY]
    bad_region = dataclasses.replace(plan.regions[0], items=(999,))
    return pkg.an.analyze_program(_with_plan(
        pkg, p, dataclasses.replace(plan, regions=(bad_region,))))


def _stale_read_weld(pkg):
    b = pkg.kvi.KviProgramBuilder("weld")
    h = b.mem_in("x", np.arange(16, dtype=np.int32))
    v = b.vreg("v", 16)
    w = b.vreg("w", 16)
    u = b.vreg("u", 16)
    b.kmemld(v, h)
    b.kaddv(w.view(0, 8), v.view(0, 8), v.view(0, 8))
    b.kaddv(u.view(0, 8), w.view(4, 8), v.view(4, 8))
    out = b.mem_out("y", 16)
    b.kmemstr(out, u)
    p = b.build()
    i1, i2 = instr_indices(pkg, p, "KADDV")
    region = pkg.passes.FusedRegion(items=(i1, i2), length=8, elem_bytes=4,
                                    ops=(), inputs=(), outputs=(),
                                    n_slots=0)
    return pkg.an.analyze_program(_with_plan(
        pkg, p, pkg.passes.FusionPlan(regions=(region,))))


def _over_pressure(pkg):
    tiny = pkg.cfg("t", M=1, F=1, D=4, spm_kbytes=1)
    return pkg.an.check_spm_pressure(pkg.reg.build_target("conv32"), tiny)


def _writer(pkg, name, value, out_name="y", n=8):
    b = pkg.kvi.KviProgramBuilder(name)
    h = b.mem_in("x_" + name, np.full(n, value, dtype=np.int32))
    v = b.vreg("v", n)
    b.kmemld(v, h)
    if name.endswith("_mul"):              # structurally distinct pair
        b.ksvmulsc(v, v, scalar=3)
    out = b.mem_out(out_name, n)
    b.kmemstr(out, v)
    return b.build()


def _race_pair(pkg):
    return pkg.kvi.KviWorkload.composite(
        {0: [_writer(pkg, "a", 1)], 1: [_writer(pkg, "b_mul", 2)]})


def _reader(pkg):
    b = pkg.kvi.KviProgramBuilder("reader")
    h = b.mem_in("shared_buf", np.zeros(8, dtype=np.int32))
    v = b.vreg("v", 8)
    b.kmemld(v, h)
    out = b.mem_out("z", 8)
    b.kmemstr(out, v)
    return b.build()


CASES = {
    # name: (case, codes the report must hold, report.ok)
    "oob_window_kvi105": (_oob_window, {"KVI105"}, False),
    "elem_bytes_mismatch_kvi106": (_elem_bytes, {"KVI106"}, False),
    "mem_transfer_extent_kvi107": (_mem_extent, {"KVI107"}, False),
    "use_before_def_kvi109_is_warning": (_use_before_def, {"KVI109"}, True),
    "output_never_written_kvi110": (_output_never_written, {"KVI110"},
                                    False),
    "duplicate_vreg_name_kvi111": (_duplicate_vreg, {"KVI111"}, False),
    "dangling_ref_kvi103": (_dangling_ref, {"KVI103"}, False),
    "wrong_space_kvi104": (_wrong_space, {"KVI104"}, False),
    "degenerate_length_kvi102": (_degenerate_length, {"KVI102"}, False),
    "ignored_mem_offset_kvi113": (_ignored_mem_offset, {"KVI113"}, True),
    "mem_init_mismatch_kvi108": (_mem_init_mismatch, {"KVI108"}, False),
    "planner_output_is_legal": (_planner_output, set(), True),
    "weld_of_mem_op_kvi201": (_weld_mem_op, {"KVI201"}, False),
    "invalid_indices_kvi204": (_invalid_indices, {"KVI204"}, False),
    "stale_read_weld_kvi203": (_stale_read_weld, {"KVI203"}, False),
    "over_pressure_kvi301": (_over_pressure, {"KVI301"}, False),
    "write_write_race_kvi210": (
        lambda pkg: pkg.an.check_workload(_race_pair(pkg)), {"KVI210"},
        False),
    "same_hart_is_sequential_not_a_race": (
        lambda pkg: pkg.an.check_workload(pkg.kvi.KviWorkload.composite(
            {0: [_writer(pkg, "a", 1), _writer(pkg, "b_mul", 2)]})),
        set(), True),
    "homogeneous_instances_exempt": (
        lambda pkg: pkg.an.check_workload(
            pkg.kvi.KviWorkload.replicate(_writer(pkg, "a", 1), 3)),
        set(), True),
    "non_shared_scheme_downgrades": (
        lambda pkg: pkg.an.check_workload(_race_pair(pkg),
                                          shared_scheme=False),
        set(), True),
    "read_write_sharing_kvi211": (
        lambda pkg: pkg.an.check_workload(pkg.kvi.KviWorkload.composite(
            {0: [_writer(pkg, "a", 1, out_name="shared_buf")],
             1: [_reader(pkg)]})), {"KVI211"}, True),
    "hart_pin_oob_kvi302": (
        lambda pkg: pkg.an.check_workload(
            pkg.kvi.KviWorkload.composite({5: [_writer(pkg, "a", 1)]}),
            config=pkg.cfg("t", M=1, F=1, D=4, spm_kbytes=32)),
        {"KVI302"}, False),
    "analyze_workload_aggregates": (
        lambda pkg: pkg.an.analyze_workload(_race_pair(pkg)), {"KVI210"},
        False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_seeded_defect_diagnosed_as_the_reference_does(name):
    case, codes, ok = CASES[name]
    rep = both(case)
    assert codes <= set(rep.codes)
    assert rep.ok is ok
    if not codes:
        assert rep.clean, rep.render_text()


# ---------------------------------------------------------------------------
# diagnostics plumbing
# ---------------------------------------------------------------------------


def test_code_table_equals_the_reference():
    assert {c: (int(s), m) for c, (s, m) in ta.CODES.items()} == \
        {c: (int(s), m) for c, (s, m) in ra.CODES.items()}
    assert ta.__all__ == ra.__all__
    readme = (ROOT / "README.md").read_text()
    for code, (sev, meaning) in ta.CODES.items():
        assert code.startswith("KVI") and len(code) == 6
        assert isinstance(sev, ta.Severity) and meaning
        assert code in readme


def test_report_plumbing():
    with pytest.raises(ValueError, match="unregistered"):
        ta.Diagnostic("KVI999", "nope", "p")
    assert ta.Diagnostic("KVI105", "msg", "p").severity is ta.Severity.ERROR
    assert ta.Diagnostic("KVI109", "msg", "p").severity \
        is ta.Severity.WARNING
    rep = ta.DiagnosticReport()
    rep.add("KVI105", "bad window", "p", subject="a")
    rep.add("KVI109", "cold read", "p", subject="b")
    assert len(rep.errors) == 1 and len(rep.warnings) == 1
    assert not rep.ok and not rep.clean
    assert rep.at_least(ta.Severity.WARNING) == list(rep)
    with pytest.raises(ta.KviVerificationError) as ei:
        rep.raise_if()
    assert "KVI105" in str(ei.value)
    d = ta.Diagnostic("KVI105", "msg", "prog", item=3, op="kaddv",
                      subject="item3:dst")
    r = ra.Diagnostic("KVI105", "msg", "prog", item=3, op="kaddv",
                      subject="item3:dst")
    assert d.render() == r.render() and d.as_dict() == r.as_dict()
    assert d.as_dict()["severity"] == "error"


# ---------------------------------------------------------------------------
# dependence graph and SPM pressure
# ---------------------------------------------------------------------------


def _graph(g):
    return sorted((e.src, e.dst, e.kind, e.src_window, e.dst_window)
                  for e in g.edges)


def test_window_overlap():
    for a, b in (((0, 0, 8), (0, 4, 8)), ((0, 0, 4), (0, 4, 4)),
                 ((0, 0, 8), (1, 0, 8))):
        assert ta.windows_overlap(a, b) == ra.windows_overlap(a, b)
    assert ta.windows_overlap((0, 0, 8), (0, 4, 8))
    assert not ta.windows_overlap((0, 0, 4), (0, 4, 4))
    assert not ta.windows_overlap((0, 0, 8), (1, 0, 8))


def test_dependence_graphs_equal_the_reference():
    def dep(pkg):
        b = pkg.kvi.KviProgramBuilder("dep")
        h = b.mem_in("x", np.arange(8, dtype=np.int32))
        v = b.vreg("v", 8)
        w = b.vreg("w", 8)
        b.kmemld(v, h)
        b.kaddv(w, v, v)
        b.ksvmulsc(v, w, scalar=3)
        out = b.mem_out("y", 8)
        b.kmemstr(out, v)
        return b.build()

    def disjoint(pkg):
        b = pkg.kvi.KviProgramBuilder("disjoint")
        h = b.mem_in("x", np.arange(16, dtype=np.int32))
        v = b.vreg("v", 16)
        w = b.vreg("w", 16)
        b.kmemld(v, h)
        b.kaddv(w.view(0, 8), v.view(0, 8), v.view(0, 8))
        b.kaddv(w.view(8, 8), v.view(8, 8), v.view(8, 8))
        out = b.mem_out("y", 16)
        b.kmemstr(out, w)
        return b.build()

    g = ta.dependence_graph(dep(PORT))
    assert _graph(g) == _graph(ra.dependence_graph(dep(REF)))
    assert g.counts == ra.dependence_graph(dep(REF)).counts
    assert g.counts["RAW"] >= 3 and g.counts["WAR"] >= 1 \
        and g.counts["WAW"] >= 1
    g = ta.dependence_graph(disjoint(PORT))
    assert _graph(g) == _graph(ra.dependence_graph(disjoint(REF)))
    assert [e for e in g.edges
            if e.src_window[1] != e.dst_window[1]
            and e.src_window[0] == e.dst_window[0] and e.kind != "RAW"] == []
    g = ta.dependence_graph(treg.build_target("conv32"))
    assert len(g.edges) > 0
    assert _graph(g) == _graph(ra.dependence_graph(
        rreg.build_target("conv32")))


@pytest.mark.parametrize("kb", (1, 2, 4, 8, 64))
def test_spm_estimate_matches_allocator_decision(kb):
    for pkg_name in ("demo", "conv32", "fft256"):
        ests = []
        for pkg in (REF, PORT):
            p = (small_program(pkg) if pkg_name == "demo"
                 else pkg.reg.build_target(pkg_name))
            cfg = pkg.cfg("t", M=1, F=1, D=4, spm_kbytes=kb)
            est = pkg.an.spm_pressure(p, cfg)
            try:
                pkg.low.allocate_vregs(p, cfg)
                fits = True
            except pkg.low.SpmOverflowError:
                fits = False
            assert est.fits == fits, (pkg.name, pkg_name, kb)
            ests.append(dataclasses.asdict(est))
        assert ests[0] == ests[1], (pkg_name, kb)


# ---------------------------------------------------------------------------
# the registry: every target clean, and equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(rreg.REGISTERED_TARGETS))
def test_registered_target_is_clean(name):
    def lint(pkg):
        target = pkg.reg.build_target(name)
        cfg = pkg.cfg("lint", M=1, F=1, D=4, spm_kbytes=64)
        if isinstance(target, pkg.kvi.KviProgram):
            return pkg.an.analyze_program(target, config=cfg)
        return pkg.an.analyze_workload(target, config=cfg)

    rep = both(lint)
    assert rep.clean, rep.render_text()


def test_optimized_programs_stay_clean():
    for name in ("conv32", "fft256", "matmul64"):
        rep = both(lambda pkg: pkg.an.analyze_program(
            pkg.passes.optimize_program(pkg.reg.build_target(name))))
        assert rep.clean, rep.render_text()


def test_registry_listing():
    names = treg.registered_targets()
    assert list(names) == list(rreg.registered_targets())
    assert "conv32" in names and "composite_paper" in names
    with pytest.raises(KeyError, match="unknown lint target"):
        treg.build_target("nope")


# ---------------------------------------------------------------------------
# pipeline verify mode: the same pass named
# ---------------------------------------------------------------------------


def _clobber_window(program):
    """A 'pass' that miscompiles: shifts the first kaddv's dst off the
    end of its vreg (in either package: matched by the op's value)."""
    items = list(program.items)
    for k, it in enumerate(items):
        if getattr(getattr(it, "op", None), "value", None) == "kaddv":
            items[k] = dataclasses.replace(
                it, dst=dataclasses.replace(it.dst, offset=10 ** 6))
            break
    return dataclasses.replace(program, items=tuple(items))


def _broken(pkg):
    p = small_program(pkg)
    idx = instr_indices(pkg, p, "KADDV")[0]
    return replace_instr(
        p, idx, src1=dataclasses.replace(p.items[idx].src1, offset=10 ** 6))


@pytest.mark.parametrize("spec,program,pass_name", [
    (("copy_prop", _clobber_window, "dce"), small_program, "_clobber_window"),
    (None, _broken, "<input>"),
])
def test_pipeline_names_the_pass_the_reference_names(spec, program,
                                                     pass_name):
    errs = []
    for pkg in (REF, PORT):
        pipe = pkg.passes.PassPipeline.from_spec(spec, verify=True)
        with pytest.raises(pkg.passes.PassVerificationError) as ei:
            pipe.run(program(pkg))
        errs.append(ei.value)
    want, got = errs
    assert got.pass_name == want.pass_name == pass_name
    assert [d.as_dict() for d in got.report] == \
        [d.as_dict() for d in want.report]
    assert str(got) == str(want)
    assert "KVI105" in got.report.codes


def test_clean_program_passes_verified_pipeline():
    out = tpass.PassPipeline.from_spec(None, verify=True).run(
        small_program(PORT))
    assert ta.analyze_program(out).clean
    base = tpass.PassPipeline.from_spec(None)
    assert not base.verify
    up = tpass.PassPipeline.from_spec(base, verify=True)
    assert up.verify and up.passes == base.passes


# ---------------------------------------------------------------------------
# backend gate: the port's backends reject what the reference's reject
# ---------------------------------------------------------------------------


PORT_BACKENDS = {"oracle": {}, "torch": {"device": "cpu"}}


@pytest.mark.parametrize("backend", sorted(PORT_BACKENDS))
def test_backend_gate_rejects_as_the_reference(backend):
    kw = PORT_BACKENDS[backend]
    with pytest.raises(ra.KviVerificationError) as want:
        rk.get_backend("oracle", verify=True).run(_broken(REF))
    with pytest.raises(ta.KviVerificationError) as got:
        tk.get_backend(backend, verify=True, **kw).run(_broken(PORT))
    assert "KVI105" in str(got.value)
    assert str(got.value).replace(f"backend {backend!r}", "") == \
        str(want.value).replace("backend 'oracle'", "")
    be = tk.get_backend(backend, **kw)
    with pytest.raises(ta.KviVerificationError):
        be.run_workload(tk.KviWorkload.single(_broken(PORT)), verify=True)
    with pytest.raises(ta.KviVerificationError, match="KVI210"):
        tk.get_backend(backend, verify=True, **kw).run_workload(
            _race_pair(PORT))
    res = tk.get_backend(backend, verify=True, **kw).run(small_program(PORT))
    x = np.arange(16, dtype=np.int32)
    np.testing.assert_array_equal(res.outputs["y"], x * 2 + x)


# ---------------------------------------------------------------------------
# CLI: the same output, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--all", "--format", "json"],
    ["--all"],
    ["--list"],
    ["--all", "--optimize", "--format", "json"],
    ["conv32", "--spm-kbytes", "1"],
    ["conv32", "--spm-kbytes", "1", "--fail-on", "never"],
    ["conv32", "fft256", "--fail-on", "warning", "--D", "8"],
])
def test_cli_equals_the_reference(argv, capsys):
    from repro.kvi.analysis.__main__ import main as ref_main
    from repro_torch.kvi.analysis.__main__ import main as port_main
    want_code = ref_main(argv)
    want = capsys.readouterr().out
    got_code = port_main(argv)
    got = capsys.readouterr().out
    assert (got_code, got) == (want_code, want)
    if argv[:3] == ["--all", "--format", "json"]:
        assert json.loads(got)["n_errors"] == 0


def test_cli_usage_error():
    from repro_torch.kvi.analysis.__main__ import main
    with pytest.raises(SystemExit) as ei:
        main(["definitely_not_registered"])
    assert ei.value.code == 2


def test_cli_runs_as_a_module_without_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    code = ("import runpy, sys; sys.argv = ['x', '--all', '--format', "
            "'json']\n"
            "try:\n    runpy.run_module('repro_torch.kvi.analysis', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, env=env)
    assert out.returncode == 0, out.stderr
    want = subprocess.run(
        [sys.executable, "-m", "repro.kvi.analysis", "--all", "--format",
         "json"], cwd=ROOT, capture_output=True, text=True, env=env)
    assert want.returncode == 0
    assert out.stdout == want.stdout


def test_chip_smoke_verify_phase_rehearsed_on_the_cpu(capsys):
    """``chip_smoke.run_verify`` (phase 3 under verify=True) on the CPU at
    a 64th of the card's batches: every main-path workload gives phase
    3's outputs with verify on, the verified pipeline keeps each
    prototype's plan, and the mutant workload is refused."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(0)
    be_off, records, _ = smoke.run_slice("cpu", rng, scale=64)
    verified = smoke.run_verify("cpu", rng, be_off, {
        r["phase"]: r["warm_wall_s"] for r in records}, scale=64)
    assert [r["phase"] for r in verified] == [r["phase"] for r in records]
    assert all(r["walk_launches"] == 0 and r["analyzer_host_s"] > 0
               for r in verified)
    out = capsys.readouterr().out
    assert out.count("[verify]") == len(verified) + 1
    assert "refused before any kvi_walk launch" in out
