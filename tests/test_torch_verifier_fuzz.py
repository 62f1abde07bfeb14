"""The port's static verifier (``repro_torch.kvi.analysis``) against the
reference's on the mutant catalog of ``tests/kvi/test_verifier_fuzz.py``.

The same base programs are built with each package's own builder, and
the same corruptions are seeded into each through ``dataclasses.replace``
(construction-time validation blocks building them directly). Every
mutant must get the reference's diagnostics (code, severity, subject,
message, item, op) from the port. The reference's property holds on the
port's own backends too: a mutant that makes the ``oracle`` or the
``torch`` backend (``device="cpu"``) raise, or the two disagree, is
flagged. A hypothesis variant samples the same catalog when hypothesis
is installed and skips otherwise, as the reference's does."""
import dataclasses
import types

import numpy as np
import pytest
from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st

import repro.kvi as rk
import repro.kvi.analysis as ra
import repro.kvi.programs as rprog
import repro_torch.kvi as tk
import repro_torch.kvi.analysis as ta
import repro_torch.kvi.programs as tprog

REF = types.SimpleNamespace(kvi=rk, analysis=ra, programs=rprog)
PORT = types.SimpleNamespace(kvi=tk, analysis=ta, programs=tprog)


def base_programs(pkg):
    progs = []

    b = pkg.kvi.KviProgramBuilder("mix")
    h = b.mem_in("x", np.arange(16, dtype=np.int32))
    v = b.vreg("v", 16)
    w = b.vreg("w", 16)
    acc = b.vreg("acc", 4)
    b.kmemld(v, h)
    b.ksvmulsc(w, v, scalar=3)
    b.kaddv(w, w, v)
    b.kdotp(acc[0], w, v)
    out = b.mem_out("y", 16)
    b.kmemstr(out, w)
    progs.append(b.build())

    rng = np.random.default_rng(7)
    progs.append(pkg.programs.conv2d_program(
        rng.integers(-64, 64, (6, 6)).astype(np.int32),
        rng.integers(-8, 8, (3, 3)).astype(np.int32), shift=3))
    progs.append(pkg.programs.fft_program(
        rng.integers(-64, 64, 16).astype(np.int32),
        rng.integers(-64, 64, 16).astype(np.int32)))
    return progs


def mutants(pkg, program):
    """(label, mutant) catalog of the reference's fuzz test, seeded with
    ``pkg``'s IR classes."""
    out = []
    instr_at = [(i, it) for i, it in enumerate(program.items)
                if isinstance(it, pkg.kvi.KviInstr)]

    def with_item(idx, instr):
        items = list(program.items)
        items[idx] = instr
        return dataclasses.replace(program, items=tuple(items))

    for idx, it in instr_at[:6]:        # bound the catalog per program
        for role in ("dst", "src1", "src2"):
            ref = getattr(it, role)
            if ref is None or ref.space != "vreg":
                continue
            reg = program.vregs[ref.id]
            out.append((
                f"oob:{idx}:{role}",
                with_item(idx, dataclasses.replace(
                    it, **{role: dataclasses.replace(
                        ref, offset=ref.offset + reg.length)}))))
            out.append((
                f"dangle:{idx}:{role}",
                with_item(idx, dataclasses.replace(
                    it, **{role: dataclasses.replace(ref, id=57)}))))
        if it.elem_bytes == 4:
            out.append((f"elem:{idx}",
                        with_item(idx, dataclasses.replace(
                            it, elem_bytes=2))))

    for vi, reg in enumerate(program.vregs):
        if reg.length < 2:
            continue
        shrunk = pkg.kvi.VReg(reg.name, reg.id, reg.length // 2,
                              reg.elem_bytes)
        vregs = tuple(shrunk if i == vi else r
                      for i, r in enumerate(program.vregs))
        out.append((f"shrink:{reg.name}",
                    dataclasses.replace(program, vregs=vregs)))
    return out


def catalog(pi):
    """[(label, reference mutant, port mutant)] of base program ``pi``."""
    ref = mutants(REF, base_programs(REF)[pi])
    port = mutants(PORT, base_programs(PORT)[pi])
    assert [lbl for lbl, _ in ref] == [lbl for lbl, _ in port]
    return [(lbl, r, p) for (lbl, r), (_, p) in zip(ref, port)]


def diagnostics(analysis, program):
    return [d.as_dict() for d in analysis.verify_program(program)]


def execute(backend, program):
    """("ok", outputs) or ("raise", None)."""
    try:
        res = backend.run_workload(
            tk.KviWorkload.single(program)).entry_result(0)
        return "ok", {k: np.asarray(v) for k, v in res.outputs.items()}
    except Exception:
        return "raise", None


def misbehaves(program):
    """True when a port backend raises or the two disagree."""
    s1, o1 = execute(tk.get_backend("oracle", passes=()), program)
    s2, o2 = execute(tk.get_backend("torch", device="cpu", passes=()),
                     program)
    if s1 == "raise" or s2 == "raise":
        return True
    if sorted(o1) != sorted(o2):
        return True
    return any(not np.array_equal(o1[k], o2[k]) for k in o1)


class TestFuzzOracle:
    @pytest.mark.parametrize("pi", range(3))
    def test_stock_programs_clean_and_agree(self, pi):
        r, p = base_programs(REF)[pi], base_programs(PORT)[pi]
        assert diagnostics(ta, p) == diagnostics(ra, r) == []
        assert not misbehaves(p)

    @pytest.mark.parametrize("pi", range(3))
    def test_every_mutant_flagged_as_the_reference_flags_it(self, pi):
        cases = catalog(pi)
        for label, r, p in cases:
            assert diagnostics(ta, p) == diagnostics(ra, r), label
        assert sum(bool(diagnostics(ta, p)) for _, _, p in cases) >= 3

    @pytest.mark.parametrize("pi", range(3))
    def test_every_misbehaving_mutant_is_flagged(self, pi):
        caught = 0
        for label, _, m in catalog(pi):
            rep = ta.verify_program(m)
            if misbehaves(m):
                assert not rep.clean, (
                    f"mutant {label} of {m.name!r} breaks a port backend "
                    f"but the verifier is silent")
                caught += 1
        # the catalog must actually exercise the property
        assert caught >= 3, caught


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
class TestFuzzOracleHypothesis:
    @settings(max_examples=25, deadline=None)
    @given(st.integers(min_value=0, max_value=2), st.data())
    def test_sampled_mutants_hold_the_property(self, pi, data):
        cases = catalog(pi)
        label, r, m = cases[data.draw(
            st.integers(min_value=0, max_value=len(cases) - 1))]
        assert diagnostics(ta, m) == diagnostics(ra, r), label
        if misbehaves(m):
            assert not ta.verify_program(m).clean, f"mutant {label} unflagged"
