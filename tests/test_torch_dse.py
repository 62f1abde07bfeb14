"""The port's design-space exploration (``repro_torch.kvi.dse``): every
test of the reference's ``tests/kvi/test_dse.py`` against the port —
config validation, space enumeration, cost model ordering, Pareto
extraction (hypothesis properties + hand fixture), sweep driver
(executors, trace cache, the device walltime axis on the CPU),
calibration fit and the report checks — then the port held against the
reference (``repro.kvi.dse``, its Pallas stage in interpret mode): the
smoke DSE's canonical JSON, markdown report and SVG plots byte for byte,
``point_key`` / ``program_fingerprint`` of every smoke point, and a
walltime-stage sweep whose ``kernel_launches`` are the reference's
``pallas_calls``."""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro_torch.configs.base import KlessydraConfig, klessydra_taxonomy
from repro_torch.kvi.dse import (DesignPoint, DesignSpace, ProcessExecutor,
                                 SerialExecutor, ThreadExecutor, build_report,
                                 calibration_fit, dominates, front_metrics,
                                 hardware_cost, make_executor, pareto_front,
                                 preflight_point, run_point, scheme_config,
                                 sweep)
from repro_torch.kvi.programs import (conv2d_program, fft_program,
                                      matmul_program)

# ---------------------------------------------------------------------------
# KlessydraConfig validation (satellite: degenerate combos rejected)
# ---------------------------------------------------------------------------


class TestConfigValidation:
    @pytest.mark.parametrize("kw,fieldname", [
        (dict(M=0), "M"),
        (dict(M=-2), "M"),
        (dict(F=0), "F"),
        (dict(M=3, F=4), "F"),            # F > M: MFUs without SPMIs
        (dict(M=1, F=2), "F"),
        (dict(D=3), "D"),                 # not a power of two
        (dict(D=0), "D"),
        (dict(D=-4), "D"),
        (dict(N=0), "N"),
        (dict(harts=0), "harts"),
        (dict(spm_kbytes=0), "spm_kbytes"),
        (dict(spm_kbytes=-1), "spm_kbytes"),
        (dict(elem_bytes=3), "elem_bytes"),
        (dict(mem_port_bytes=0), "mem_port_bytes"),
        (dict(subword_bits=12), "subword_bits"),
        (dict(fu_counts=(("turbo", 2),)), "fu_counts"),
        (dict(fu_counts=(("adder", 0),)), "fu_counts"),
        (dict(fu_counts=(("adder", 1), ("adder", 2))), "fu_counts"),
    ])
    def test_degenerate_combo_rejected_naming_field(self, kw, fieldname):
        with pytest.raises(ValueError, match=fieldname):
            KlessydraConfig("bad", **kw)

    def test_paper_taxonomy_still_valid(self):
        # every Table-2 configuration constructs unchanged
        assert len(klessydra_taxonomy()) == 12

    def test_fu_count_lookup(self):
        cfg = KlessydraConfig("t", M=3, F=1, D=4,
                              fu_counts=(("multiplier", 2),))
        assert cfg.fu_count("multiplier") == 2
        assert cfg.fu_count("adder") == 1

    def test_capacity_property(self):
        cfg = KlessydraConfig("t", N=4, spm_kbytes=64)
        assert cfg.spm_capacity_bytes == 4 * 64 * 1024

    def test_mfu_units_match_isa_enum(self):
        # configs keep unit names as literals (import-light); they must
        # track the ISA's Unit enum or cost/fu_counts silently drift
        from repro_torch.configs.base import MFU_UNITS
        from repro_torch.core.isa import Unit
        assert set(MFU_UNITS) == {u.value for u in Unit} - {"lsu"}


# ---------------------------------------------------------------------------
# DesignSpace / DesignPoint
# ---------------------------------------------------------------------------


class TestDesignSpace:
    def test_default_space_size_and_coverage(self):
        pts = DesignSpace().points()
        assert len(pts) == 3 * 4 * 3          # schemes x D x precision
        assert {p.scheme for p in pts} == \
            {"shared", "sym_mimd", "het_mimd"}
        names = [p.name for p in pts]
        assert len(set(names)) == len(names)  # unique

    def test_enumeration_deterministic(self):
        a = DesignSpace().points()
        b = DesignSpace().points()
        assert [p.name for p in a] == [p.name for p in b]

    @pytest.mark.parametrize("kw", [
        dict(scheme="shared", M=3, F=3),      # shared must be M=F=1
        dict(scheme="sym_mimd", M=3, F=1),    # sym must have F=M
        dict(scheme="het_mimd", M=3, F=3),    # het must have F<M
        dict(scheme="het_mimd", M=1, F=1),
        dict(scheme="warp", M=1, F=1),
        dict(scheme="shared", M=1, F=1, precision_bits=12),
        dict(scheme="shared", M=1, F=1, D=3),  # config-level validation
    ])
    def test_invalid_point_rejected(self, kw):
        kw.setdefault("D", 4)
        with pytest.raises(ValueError):
            DesignPoint(**kw)

    @pytest.mark.parametrize("axis,kw", [
        ("schemes", dict(schemes=())),
        ("schemes", dict(schemes=("vliw",))),
        ("precisions", dict(precisions=(8, 12))),
        ("replication", dict(replication=(1,))),
        ("het_fus", dict(het_fus=(0,))),
        ("lanes", dict(lanes=(6,))),
        ("spm_kbytes", dict(spm_kbytes=(0,))),
    ])
    def test_invalid_axis_rejected_naming_axis(self, axis, kw):
        with pytest.raises(ValueError, match=axis):
            DesignSpace(**kw)

    def test_scheme_config_matches_legacy_defaults(self):
        from repro_torch.kvi.cyclesim import default_schemes
        legacy = default_schemes(D=8, spm_kbytes=32)
        for name, cfg in legacy.items():
            mine = scheme_config(name, D=8, spm_kbytes=32)
            assert (mine.M, mine.F, mine.D, mine.spm_kbytes) == \
                (cfg.M, cfg.F, cfg.D, cfg.spm_kbytes), name

    def test_point_config_couples_subword_to_precision(self):
        pt = DesignPoint("shared", 1, 1, 4, precision_bits=8)
        assert pt.config().subword_bits == 8
        pt32 = DesignPoint("shared", 1, 1, 4, precision_bits=32)
        assert pt32.config().subword_bits == 32

    def test_custom_pipeline_axis_points_survive_dedup(self):
        # regression: points differing only in a custom pass tuple must
        # enumerate distinctly (names encode the pipeline)
        space = DesignSpace(lanes=(4,), precisions=(32,),
                            pipelines=(None, ("dce",), ()))
        pts = space.points()
        assert len(pts) == 3 * 3
        names = {p.name for p in pts if p.scheme == "shared"}
        assert any(n.endswith("_pdce") for n in names)
        assert any(n.endswith("_raw") for n in names)

    def test_preflight_rejects_oversized_workload(self):
        img = np.arange(1024, dtype=np.int32).reshape(32, 32)
        filt = np.ones((3, 3), np.int32)
        prog = conv2d_program(img, filt)
        tiny = DesignPoint("shared", 1, 1, 4, spm_kbytes=1)
        # 1 KiB x N=4 cannot hold the 34x34 padded image vreg (4.6 KiB)
        reason = preflight_point(tiny, [prog])
        assert reason is not None and "SPM overflow" in reason
        big = DesignPoint("shared", 1, 1, 4, spm_kbytes=64)
        assert preflight_point(big, [prog]) is None


# ---------------------------------------------------------------------------
# Cost model: relative orderings the paper's synthesis tables establish
# ---------------------------------------------------------------------------


class TestCostModel:
    def area(self, scheme, D=4, prec=32):
        return hardware_cost(
            DesignPoint(scheme, 1 if scheme == "shared" else 3,
                        {"shared": 1, "sym_mimd": 3, "het_mimd": 1}[scheme],
                        D, precision_bits=prec).config()).area_luteq

    def test_scheme_area_ordering(self):
        for d in (2, 4, 8, 16):
            shared = self.area("shared", d)
            het = self.area("het_mimd", d)
            sym = self.area("sym_mimd", d)
            assert shared < het < sym, f"D={d}"

    def test_area_grows_with_lanes(self):
        for scheme in ("shared", "sym_mimd", "het_mimd"):
            areas = [self.area(scheme, d) for d in (2, 4, 8, 16)]
            assert areas == sorted(areas) and len(set(areas)) == 4

    def test_subword_support_costs_area(self):
        assert self.area("shared", 4, prec=8) > \
            self.area("shared", 4, prec=32)

    def test_fu_replication_costs_area(self):
        base = DesignPoint("het_mimd", 3, 1, 4).config()
        more = DesignPoint("het_mimd", 3, 1, 4,
                           fu_counts=(("multiplier", 2),)).config()
        assert hardware_cost(more).area_luteq > \
            hardware_cost(base).area_luteq

    def test_breakdown_covers_total(self):
        cost = hardware_cost(DesignPoint("sym_mimd", 3, 3, 8).config())
        assert cost.breakdown.keys() == {"core", "mfu", "spm"}
        assert sum(cost.breakdown.values()) == \
            pytest.approx(cost.area_luteq)

    def test_calibration_energy_scale_matches_paper(self):
        # paper Table 3: T13 Sym MIMD D=8 runs at a few nJ/cycle
        from repro_torch.kvi.dse.cost import energy_per_cycle_static
        e = energy_per_cycle_static(
            DesignPoint("sym_mimd", 3, 3, 8).config())
        assert 0.5 < e < 10.0


# ---------------------------------------------------------------------------
# Pareto extraction: hand fixture + hypothesis properties
# ---------------------------------------------------------------------------

# hand-built 5-point fixture over (cycles, area, energy)
FIXTURE = [
    (100, 10, 50),    # A: on front (cheapest)
    (50, 20, 40),     # B: on front
    (50, 20, 45),     # C: dominated by B (ties cycles/area, worse energy)
    (20, 40, 60),     # D: on front (fastest)
    (120, 15, 55),    # E: dominated by A
]
FIXTURE_FRONT = {(100, 10, 50), (50, 20, 40), (20, 40, 60)}


class TestPareto:
    def test_dominates_basics(self):
        assert dominates((1, 1), (2, 2))
        assert dominates((1, 2), (1, 3))
        assert not dominates((1, 1), (1, 1))   # ties never dominate
        assert not dominates((1, 3), (2, 1))
        with pytest.raises(ValueError):
            dominates((1,), (1, 2))

    def test_hand_fixture(self):
        front = pareto_front(FIXTURE)
        assert set(front) == FIXTURE_FRONT
        assert front_metrics(FIXTURE) == sorted(FIXTURE_FRONT)

    def test_front_preserves_input_order(self):
        front = pareto_front(FIXTURE)
        assert front == [p for p in FIXTURE if p in FIXTURE_FRONT]

    @settings(max_examples=60, deadline=None)
    @given(st.lists(st.tuples(st.integers(0, 30), st.integers(0, 30),
                              st.integers(0, 30)),
                    min_size=1, max_size=24),
           st.randoms(use_true_random=False))
    def test_no_front_point_dominated_and_invariance(self, pts, rnd):
        front = front_metrics(pts)
        # no swept point dominates any front point
        for f in front:
            assert not any(dominates(p, f) for p in pts)
        # every non-front point is dominated by someone
        for p in set(map(tuple, pts)) - set(front):
            assert any(dominates(q, p) for q in pts)
        # invariance under duplication + permutation
        doubled = list(pts) + list(pts)
        rnd.shuffle(doubled)
        assert front_metrics(doubled) == front


# ---------------------------------------------------------------------------
# Sweep driver + report (tiny kernels so the whole class runs in seconds)
# ---------------------------------------------------------------------------


def tiny_kernels(precision_bits: int):
    eb = precision_bits // 8
    rng = np.random.default_rng(7)
    img = rng.integers(-8, 8, (8, 8)).astype(np.int32)
    filt = rng.integers(-4, 4, (3, 3)).astype(np.int32)
    A = rng.integers(-4, 4, (8, 8)).astype(np.int32)
    B = rng.integers(-4, 4, (8, 8)).astype(np.int32)
    return {
        "conv": conv2d_program(img, filt, shift=2, elem_bytes=eb),
        "fft": fft_program(rng.integers(-64, 64, 32).astype(np.int32),
                           rng.integers(-64, 64, 32).astype(np.int32),
                           elem_bytes=eb),
        "matmul": matmul_program(A, B, shift=2, resident=True,
                                 elem_bytes=eb),
    }


TINY_SPACE = DesignSpace(lanes=(2, 8), precisions=(8, 32))


@pytest.fixture(scope="module")
def tiny_sweep():
    return sweep(TINY_SPACE, tiny_kernels, max_workers=1)


class TestSweep:
    def test_records_in_enumeration_order(self, tiny_sweep):
        assert [r.point.name for r in tiny_sweep.records] == \
            [p.name for p in TINY_SPACE.points()]
        assert tiny_sweep.meta["n_points"] == 12
        assert all(r.ok for r in tiny_sweep.records)

    def test_parallel_sweep_is_deterministic(self, tiny_sweep):
        par = sweep(TINY_SPACE, tiny_kernels, max_workers=4)
        for a, b in zip(tiny_sweep.records, par.records):
            assert a.point.name == b.point.name
            for k in a.kernels:
                assert a.kernels[k]["cycles"] == b.kernels[k]["cycles"]

    def test_paper_scheme_cycle_ordering(self, tiny_sweep):
        by_name = {r.point.name: r for r in tiny_sweep.records}
        for d in (2, 8):
            for prec in (8, 32):
                def cyc(scheme, mf, d=d, prec=prec):
                    return by_name[
                        f"{scheme}_M{mf[0]}F{mf[1]}_D{d}_b{prec}"
                        f"_spm64"].kernels["conv"]["cycles"]
                sym = cyc("sym_mimd", (3, 3))
                het = cyc("het_mimd", (3, 1))
                shared = cyc("shared", (1, 1))
                assert sym <= het <= shared

    def test_subword_cuts_cycles(self, tiny_sweep):
        by_name = {r.point.name: r for r in tiny_sweep.records}
        for kern in ("conv", "matmul"):
            c32 = by_name["shared_M1F1_D2_b32_spm64"].kernels[
                kern]["cycles"]
            c8 = by_name["shared_M1F1_D2_b8_spm64"].kernels[
                kern]["cycles"]
            assert c8 < c32

    def test_utilization_breakdown_sums_to_total(self, tiny_sweep):
        # per-hart busy + stall + idle == workload cycles, every point
        for r in tiny_sweep.records:
            for kern, k in r.kernels.items():
                for h in k["hart_utilization"]:
                    assert (h["busy"] + h["stall"] + h["idle"]
                            == k["cycles"]), (r.point.name, kern)
                    assert h["busy"] >= 0 and h["stall"] >= 0 \
                        and h["idle"] >= 0

    def test_incompatible_point_recorded_not_raised(self):
        def big_kernels(precision_bits):
            img = np.arange(1024, dtype=np.int32).reshape(32, 32)
            return {"conv": conv2d_program(img, np.ones((3, 3), np.int32),
                                           elem_bytes=4)}
        pts = [DesignPoint("shared", 1, 1, 4, spm_kbytes=1,
                           precision_bits=32)]
        res = sweep(pts, big_kernels, max_workers=1)
        assert res.records[0].status == "incompatible"
        assert "SPM overflow" in res.records[0].reason

    def test_chaining_point_not_slower(self):
        base = DesignPoint("shared", 1, 1, 4)
        chained = DesignPoint("shared", 1, 1, 4, chaining=True)
        res = sweep([base, chained], tiny_kernels, max_workers=1)
        a, b = res.records
        assert b.kernels["conv"]["cycles"] <= \
            a.kernels["conv"]["cycles"]

    def test_raw_passes_point_differs(self):
        opt = DesignPoint("shared", 1, 1, 4)
        raw = DesignPoint("shared", 1, 1, 4, passes=())
        res = sweep([opt, raw], tiny_kernels, max_workers=1)
        assert res.records[1].point.name.endswith("_raw")
        # fft carries kvcp bit-reversal the pipeline optimizes away
        assert res.records[0].kernels["fft"]["cycles"] <= \
            res.records[1].kernels["fft"]["cycles"]

    def test_json_csv_roundtrip(self, tiny_sweep, tmp_path):
        jpath = tmp_path / "sweep.json"
        cpath = tmp_path / "sweep.csv"
        tiny_sweep.save_json(str(jpath))
        tiny_sweep.save_csv(str(cpath))
        data = json.loads(jpath.read_text())
        assert len(data["points"]) == len(tiny_sweep.records)
        assert data["kernels"] == ["conv", "fft", "matmul"]
        header = cpath.read_text().splitlines()[0]
        assert "cycles" in header and "area_luteq" in header
        # one csv row per ok point x (kernels + composite)
        assert len(cpath.read_text().splitlines()) == 1 + 12 * 4

    def test_matched_group_checks_are_not_vacuous(self, tiny_sweep):
        # regression: shared (M=1) must land in the same matched group
        # as the MIMD schemes or the ordering checks never execute
        from repro_torch.kvi.dse.report import scheme_ordering_checks
        checks = scheme_ordering_checks(tiny_sweep.ok_records, "conv")
        assert checks["n_matched_groups"] == 4     # 2 lanes x 2 precs

    def test_matched_group_check_catches_violations(self):
        # fabricate records where shared is fastest: the matched-group
        # check must fail, not pass vacuously
        from repro_torch.kvi.dse.report import scheme_ordering_checks
        from repro_torch.kvi.dse.sweep import PointRecord
        from repro_torch.kvi.dse.cost import hardware_cost

        def fake(scheme, m, f, cycles):
            pt = DesignPoint(scheme, m, f, 4, precision_bits=32)
            rec = PointRecord(pt, "ok",
                              area=hardware_cost(pt.config()))
            rec.kernels["conv"] = {"cycles": cycles,
                                   "energy_nj": float(cycles)}
            return rec
        recs = [fake("shared", 1, 1, 100), fake("sym_mimd", 3, 3, 200),
                fake("het_mimd", 3, 1, 150)]
        checks = scheme_ordering_checks(recs, "conv")
        assert checks["n_matched_groups"] == 1
        assert not checks["sym_fastest_matched_groups"]

    def test_preflight_runs_on_optimized_programs(self):
        # a program that only fits the SPM after dce (huge dead vreg)
        # must be a VALID point under the default pipeline and an
        # incompatible one with passes=()
        from repro_torch.kvi.ir import KviProgramBuilder

        def dead_heavy(precision_bits):
            b = KviProgramBuilder("dead_heavy")
            x = np.arange(64, dtype=np.int32)
            v = b.vreg("v", 64)
            dead = b.vreg("dead", 2048)       # 8 KiB, never observed
            b.kmemld(v, b.mem_in("x", x))
            b.ksvaddsc(dead, dead, scalar=1)
            b.krelu(v, v)
            b.kmemstr(b.mem_out("y", 64), v)
            return {"k": b.build()}

        opt = DesignPoint("shared", 1, 1, 4, spm_kbytes=1)
        raw = DesignPoint("shared", 1, 1, 4, spm_kbytes=1, passes=())
        res = sweep([opt, raw], dead_heavy, max_workers=1,
                    composite=False)
        assert res.records[0].status == "ok"
        assert res.records[1].status == "incompatible"

    def test_report_checks_pass_on_tiny_space(self, tiny_sweep):
        report = build_report(tiny_sweep, subword_min_speedup=1.2)
        checks = report["checks"]
        assert checks["all_schemes_covered"]
        assert checks["pareto_ordering_ok"]
        assert checks["subword_2x_on_mfu_bound"]
        for kern in ("conv", "fft", "matmul", "composite"):
            assert kern in report["kernels"]
            front = report["kernels"][kern]["front"]
            assert front, kern
            schemes_on_front = {row["scheme"] for row in front}
            assert "het_mimd" in schemes_on_front or \
                len(schemes_on_front) >= 2

    def test_run_point_composite_pins_kernels_to_harts(self):
        rec = run_point(DesignPoint("sym_mimd", 3, 3, 4),
                        tiny_kernels(32))
        assert rec.composite is not None
        assert rec.composite["cycles"] > 0
        # composite runs all three kernels concurrently: faster than
        # the sum of the homogeneous runs on the same machine
        assert rec.composite["cycles"] < sum(
            k["cycles"] for k in rec.kernels.values())



# ---------------------------------------------------------------------------
# Multi-instance FU contention (fu_counts through the simulator)
# ---------------------------------------------------------------------------


class TestFuCounts:
    def test_replicated_multiplier_helps_het_mimd(self):
        # het-MIMD shares one MFU: three harts fighting for the single
        # multiplier serialize; a second instance relieves exactly that
        base = DesignPoint("het_mimd", 3, 1, 4)
        dual = DesignPoint("het_mimd", 3, 1, 4,
                           fu_counts=(("multiplier", 3),))
        res = sweep([base, dual], tiny_kernels, max_workers=1)
        a, b = res.records
        assert b.kernels["matmul"]["cycles"] <= \
            a.kernels["matmul"]["cycles"]

    def test_het_second_mfu_is_modeled_not_just_billed(self):
        # regression: het F=2 must contribute real unit instances in the
        # simulator (not only F x area in the cost model)
        f1 = DesignPoint("het_mimd", 3, 1, 4)
        f2 = DesignPoint("het_mimd", 3, 2, 4)
        res = sweep([f1, f2], tiny_kernels, max_workers=1)
        a, b = res.records
        assert b.area.area_luteq > a.area.area_luteq
        assert b.kernels["matmul"]["cycles"] < \
            a.kernels["matmul"]["cycles"]

    def test_empty_sweep_rejected(self):
        with pytest.raises(ValueError, match="at least one"):
            sweep([], tiny_kernels, max_workers=1)


# ---------------------------------------------------------------------------
# LoweredTrace cache (tentpole: one allocator run per kernel per point)
# ---------------------------------------------------------------------------


class TestTraceCache:
    def test_counters_and_shared_allocation(self):
        from repro_torch.kvi.lowering import TraceCache, lower
        cache = TraceCache()
        prog = tiny_kernels(32)["conv"]
        cfg = DesignPoint("shared", 1, 1, 4).config()
        t1 = cache.lower(prog, cfg, functional=False)
        assert cache.stats == {"hits": 0, "misses": 1}
        t2 = cache.lower(prog, cfg, functional=False)
        assert t2 is t1                    # timing traces shared outright
        assert cache.stats == {"hits": 1, "misses": 1}
        # functional lowers hit the cached allocation but return fresh
        # executable traces (memory gets mutated by execution)
        t3 = cache.lower(prog, cfg, functional=True)
        assert t3 is not t1 and t3.functional
        assert t3.vreg_addr == t1.vreg_addr
        assert cache.stats == {"hits": 2, "misses": 1}
        # a different config is a different trace
        cfg8 = DesignPoint("shared", 1, 1, 8).config()
        cache.lower(prog, cfg8, functional=False)
        assert cache.stats == {"hits": 2, "misses": 2}
        # uncached lower is unchanged semantics
        assert lower(prog, cfg).vreg_addr == t1.vreg_addr

    def test_timing_trace_aliases_mem_and_refuses_execute(self):
        from repro_torch.kvi.lowering import lower
        prog = tiny_kernels(32)["conv"]
        cfg = DesignPoint("shared", 1, 1, 4).config()
        timing = lower(prog, cfg, functional=False)
        for m in prog.mems:
            assert timing.mem[m.id] is prog.mem_init[m.id]  # no copy
        with pytest.raises(RuntimeError, match="functional=False"):
            timing.execute()
        functional = lower(prog, cfg, functional=True)
        for m in prog.mems:
            assert functional.mem[m.id] is not prog.mem_init[m.id]

    def test_backend_results_bit_identical_cache_on_vs_off(self):
        from repro_torch.kvi.cyclesim import CycleSimBackend
        from repro_torch.kvi.lowering import TraceCache
        from repro_torch.kvi.workload import KviWorkload
        prog = tiny_kernels(32)["conv"]
        wl = KviWorkload.replicate(prog, 3)
        plain = CycleSimBackend()
        cached = CycleSimBackend(trace_cache=TraceCache())
        a = plain.run_workload(wl)
        b = cached.run_workload(wl)
        assert a.cycles == b.cycles
        for ra, rb in zip(a.entry_results, b.entry_results):
            for name in ra.outputs:
                np.testing.assert_array_equal(ra.outputs[name],
                                              rb.outputs[name])
        # timing-only runs hit the same numbers too
        at = plain.run_workload(wl, functional=False)
        bt = cached.run_workload(wl, functional=False)
        assert at.cycles == bt.cycles
        # and the program's buffers were never corrupted by any of it
        fresh = tiny_kernels(32)["conv"]
        for m in prog.mems:
            np.testing.assert_array_equal(prog.mem_init[m.id],
                                          fresh.mem_init[m.id])

    def test_run_point_allocates_once_per_kernel(self):
        # preflight + homogeneous + composite used to run the SPM
        # allocator up to 3x per kernel; through the cache it runs once
        rec = run_point(DesignPoint("sym_mimd", 3, 3, 4),
                        tiny_kernels(32))
        assert rec.composite is not None   # composite protocol ran
        assert rec.lowering == {"misses": 3, "hits": 6}  # 3 kernels
        rec_nc = run_point(DesignPoint("sym_mimd", 3, 3, 4),
                           tiny_kernels(32), composite=False)
        assert rec_nc.lowering == {"misses": 3, "hits": 3}

    def test_sweep_meta_aggregates_cache_counters(self, tiny_sweep):
        lw = tiny_sweep.meta["lowering"]
        n_ok = tiny_sweep.meta["n_ok"]
        assert lw["misses"] == 3 * n_ok    # one per kernel per point
        assert lw["hits"] == 6 * n_ok


# ---------------------------------------------------------------------------
# Executors (tentpole: serial / thread / process, deterministic merge)
# ---------------------------------------------------------------------------

#: the 5-point executor-determinism fixture: every scheme, two lane
#: widths, both precisions, one incompatible point (SPM too small for
#: the fixture's 32x32 conv at 32-bit: 4624 B peak-live vs 4 KiB)
FIVE_POINTS = (
    DesignPoint("shared", 1, 1, 2, precision_bits=32),
    DesignPoint("shared", 1, 1, 8, precision_bits=8),
    DesignPoint("sym_mimd", 3, 3, 4, precision_bits=32),
    DesignPoint("het_mimd", 3, 1, 4, precision_bits=8),
    DesignPoint("shared", 1, 1, 4, spm_kbytes=1),   # overflows
)


def fixture_kernels(precision_bits):
    """tiny_kernels plus a 32x32 conv big enough that the fixture's
    1-KiB point genuinely overflows at 32-bit (34x34 padded image =
    4624 B peak-live vs the 4-KiB capacity floor)."""
    ks = tiny_kernels(precision_bits)
    eb = precision_bits // 8
    rng = np.random.default_rng(3)
    img = rng.integers(-8, 8, (32, 32)).astype(np.int32)
    filt = rng.integers(-4, 4, (3, 3)).astype(np.int32)
    ks["bigconv"] = conv2d_program(img, filt, shift=2, elem_bytes=eb)
    return ks


class TestExecutors:
    def test_make_executor_resolution(self):
        assert isinstance(make_executor(None, max_workers=1),
                          SerialExecutor)
        assert isinstance(make_executor(None, max_workers=4),
                          ThreadExecutor)
        assert isinstance(make_executor("process", max_workers=2),
                          ProcessExecutor)
        ex = SerialExecutor()
        assert make_executor(ex) is ex
        with pytest.raises(ValueError, match="unknown sweep executor"):
            make_executor("gpu")

    def test_sweep_records_executor_in_meta(self, tiny_sweep):
        assert tiny_sweep.meta["executor"] == "serial"
        res = sweep(FIVE_POINTS[:1], tiny_kernels, max_workers=4)
        assert res.meta["executor"] == "thread"

    def test_thread_executor_matches_serial(self):
        serial = sweep(FIVE_POINTS, fixture_kernels, executor="serial")
        threaded = sweep(FIVE_POINTS, fixture_kernels,
                         executor="thread", max_workers=4)
        assert serial.canonical_json() == threaded.canonical_json()

    def test_process_executor_matches_serial(self):
        # the acceptance gate: ProcessExecutor pickles jobs to spawn
        # workers and merges records deterministically — canonical
        # JSON (wall-clock fields stripped) must be byte-identical,
        # trace-cache counters and the incompatible record included
        serial = sweep(FIVE_POINTS, fixture_kernels, executor="serial")
        procs = sweep(FIVE_POINTS, fixture_kernels, executor="process",
                      max_workers=2)
        assert serial.canonical_json() == procs.canonical_json()
        assert procs.meta["executor"] == "process"
        assert procs.records[4].status == "incompatible"
        assert procs.records[0].lowering == \
            serial.records[0].lowering

    def test_canonical_json_strips_volatile_fields(self, tiny_sweep):
        from repro_torch.kvi.dse.sweep import scrub_volatile
        js = tiny_sweep.canonical_json()
        assert "wall_s" not in js and '"executor"' not in js
        assert "cycles" in js              # measurements survive
        assert scrub_volatile({"wall_s": 1, "x": [{"walltime_s": 2}],
                               "cycles": 3}) == {"x": [{}], "cycles": 3}


# ---------------------------------------------------------------------------
# Device walltime axis (measure, don't model) — on the CPU here: the
# walk's plain version through TorchBackend(device="cpu")
# ---------------------------------------------------------------------------


def saxpy_kernels(precision_bits):
    """One small element-wise kernel so the device stage stays
    sub-second in the default suite."""
    from repro_torch.kvi.ir import KviProgramBuilder
    eb = precision_bits // 8
    x = np.arange(-32, 32, dtype=np.int32)
    b = KviProgramBuilder("saxpy")
    v = b.vreg("v", 64, elem_bytes=eb)
    b.kmemld(v, b.mem_in("x", x.astype(np.int32)))
    b.ksvmulsc(v, v, scalar=3)
    b.krelu(v, v)
    b.kmemstr(b.mem_out("y", 64), v)
    return {"saxpy": b.build()}


class TestDeviceWalltime:
    def test_measure_device_attaches_walltime_columns(self):
        pts = [DesignPoint("shared", 1, 1, 4, measure_device=True),
               DesignPoint("sym_mimd", 3, 3, 4, measure_device=True),
               DesignPoint("shared", 1, 1, 8)]     # not measured
        res = sweep(pts, saxpy_kernels, max_workers=1, composite=False,
                    device="cpu")
        for rec in res.records[:2]:
            k = rec.kernels["saxpy"]
            assert k["kernel_launches"] > 0
            assert k["device_walltime_s"] >= 0
            # the warm-up split: compile is one-time, steady is the
            # warm per-batch cost a serving loop pays
            assert k["device_compile_s"] >= 0
            assert k["device_steady_s"] >= 0
        assert "kernel_launches" not in res.records[2].kernels["saxpy"]
        # scheme/D don't change device execution: both measured points
        # are one measurement class sharing one set of numbers
        assert res.meta["device"]["n_measured_points"] == 2
        assert res.meta["device"]["n_measurement_classes"] == 1
        assert res.meta["device"]["device_name"] == "cpu"
        cc = res.meta["device"]["compile_cache"]
        # the warm iteration replays the cold iteration's launch
        # records: every cache entry built once, hit at least once
        assert cc["misses"] > 0 and cc["hits"] >= cc["misses"]
        a, b = (r.kernels["saxpy"] for r in res.records[:2])
        assert a["kernel_launches"] == b["kernel_launches"]
        assert a["device_walltime_s"] == b["device_walltime_s"]
        assert a["device_steady_s"] == b["device_steady_s"]
        # CSV grows the walltime columns, blank for unmeasured points
        rows = res.csv_rows()
        assert rows[0]["kernel_launches"] > 0
        assert rows[2]["kernel_launches"] == ""

    def test_sweep_level_override_and_report(self):
        res = sweep([DesignPoint("shared", 1, 1, 4)], saxpy_kernels,
                    max_workers=1, composite=False, measure_device=True,
                    device="cpu")
        assert res.measured_device
        report = build_report(res)
        dev = report["kernels"]["saxpy"]["device"]
        assert len(dev) == 1
        assert dev[0]["precision_bits"] == 32
        assert dev[0]["kernel_launches"] > 0
        assert dev[0]["device_compile_s"] >= 0
        assert dev[0]["device_steady_s"] >= 0
        from repro_torch.kvi.dse import render_markdown
        md = render_markdown(report)
        assert "Device walltime" in md and "kernel_launches" in md
        assert "compile (s)" in md and "steady (s)" in md

    def test_unmeasured_sweep_has_no_device_columns(self, tiny_sweep):
        assert not tiny_sweep.measured_device
        assert "device" not in tiny_sweep.meta
        assert "kernel_launches" not in tiny_sweep.csv_rows()[0]


# ---------------------------------------------------------------------------
# Calibration fit (satellite: CALIBRATION vs paper Table 3 energies)
# ---------------------------------------------------------------------------


class TestCalibrationFit:
    def test_current_constants_fit_table3(self):
        fit = calibration_fit()
        assert fit["ok"], fit
        assert fit["max_rel_err"] <= fit["threshold"]
        # every T13 (scheme, D) x filter-order row participates
        assert len(fit["rows"]) == 5 * 4
        assert {r["scheme"] for r in fit["rows"]} == \
            {"T13 SIMD", "T13 Sym MIMD", "T13 Het MIMD"}
        json.dumps(fit)                    # BENCH-serializable

    def test_drifted_constants_fail_the_gate(self):
        # 5x the static-power constant pushes every predicted nJ/cycle
        # out of the paper's regime — the gate must catch it
        from repro_torch.kvi.dse.cost import CALIBRATION
        key = "static_nj_per_cycle_per_kluteq"
        orig = CALIBRATION[key]
        try:
            CALIBRATION[key] = orig * 5
            assert not calibration_fit()["ok"]
        finally:
            CALIBRATION[key] = orig

    def test_report_renders_utilization_bars(self, tiny_sweep):
        from repro_torch.kvi.dse import render_markdown
        report = build_report(tiny_sweep)
        util = report["kernels"]["conv"]["hart_utilization"]
        assert set(util) == {"shared", "sym_mimd", "het_mimd"}
        for u in util.values():
            assert len(u["harts"]) == 3
            for h in u["harts"]:
                assert h["busy"] + h["stall"] + h["idle"] == h["total"]
        md = render_markdown(report)
        assert "Hart utilization" in md
        assert "█" in md and "▒" in md

    def test_speedup_curves_keep_spm_series_apart(self):
        from repro_torch.kvi.dse.report import speedup_vs_lanes
        pts = [DesignPoint("shared", 1, 1, d, precision_bits=32,
                           spm_kbytes=s)
               for s in (32, 64) for d in (2, 8)]
        res = sweep(pts, tiny_kernels, max_workers=1)
        curves = speedup_vs_lanes(res.ok_records, "conv")
        assert len(curves) == 2           # one series per spm size
        assert all(set(c) == {"D2", "D8"} for c in curves.values())

    def test_second_mac_lands_on_matmul_front(self):
        # ROADMAP item: het-MIMD's three harts serialize on the shared
        # multiplier during matmul — a second MAC instance buys cycles
        # for area nobody else offers at that price, so the dual-MAC
        # point must be non-dominated (on the Pareto front)
        dual = DesignPoint("het_mimd", 3, 1, 4,
                           fu_counts=(("multiplier", 2),))
        pts = [DesignPoint("shared", 1, 1, 4),
               DesignPoint("sym_mimd", 3, 3, 4),
               DesignPoint("het_mimd", 3, 1, 4), dual]
        res = sweep(pts, tiny_kernels, max_workers=1, composite=False)
        front = pareto_front(res.ok_records,
                             key=lambda r: r.metrics("matmul"))
        assert dual.name in {r.point.name for r in front}
        by_name = {r.point.name: r for r in res.records}
        base = by_name[pts[2].name]
        assert by_name[dual.name].kernels["matmul"]["cycles"] < \
            base.kernels["matmul"]["cycles"]
        assert by_name[dual.name].area.area_luteq > base.area.area_luteq

    def test_full_space_carries_fu_axis_smoke_does_not(self):
        from repro_torch.kvi.dse import full_space, smoke_space
        assert smoke_space().size == 36            # CI budget unchanged
        assert all(pt.fu_counts == () for pt in smoke_space().points())
        full = full_space().points()
        assert any(pt.fu_counts == (("multiplier", 2),) for pt in full)
        # the axis is het-only: the simulator contends internal FU
        # instances solely in the heterogeneous scheme, so shared/sym
        # replicated-unit points would be inert (identical cycles,
        # strictly more area — always dominated)
        assert all(pt.scheme == "het_mimd" for pt in full
                   if pt.fu_counts)
        assert len(full) == 36 * 2 + 12 * 2        # base x chain + het fu


# ---------------------------------------------------------------------------
# The port held against the reference (repro.kvi.dse; its Pallas stage in
# interpret mode, as the reference's own tests run it on the CPU)
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]
#: the 16 files of the reference's DSE, each with its counterpart
DSE_FILES = ("__init__.py", "__main__.py", "cost.py", "executors.py",
             "pareto.py", "plots.py", "pointcache.py", "report.py",
             "space.py", "sweep.py", "search/__init__.py",
             "search/driver.py", "search/evaluator.py", "search/result.py",
             "search/sampler.py", "search/strategies.py")
#: the smoke report's figures: speedup and Pareto per kernel
SMOKE_PLOTS = tuple(f"dse_{kind}_{kern}.svg" for kern in
                    ("conv", "fft", "matmul", "composite")
                    for kind in ("speedup", "pareto"))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("fname", DSE_FILES)
def test_every_reference_file_has_a_counterpart_importing_no_jax(fname):
    assert (ROOT / "src" / "repro" / "kvi" / "dse" / fname).is_file()
    port = ROOT / "src" / "repro_torch" / "kvi" / "dse" / fname
    for mod in _imports(port):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro",
                                         "benchmarks"), (fname, mod)


def test_no_dse_name_of_the_port_speaks_of_pallas():
    for f in (ROOT / "src" / "repro_torch" / "kvi" / "dse").rglob("*.py"):
        assert "pallas" not in f.read_text().lower(), f


@pytest.fixture(scope="module")
def smoke_pair(tmp_path_factory):
    """``run_dse(smoke=True)`` of the reference and of the port, each
    writing its artifacts, serially (the executors agree byte for
    byte)."""
    from repro.kvi.dse import run_dse as r_run_dse

    from repro_torch.kvi.dse import run_dse as t_run_dse
    out = {}
    for side, fn in (("ref", r_run_dse), ("port", t_run_dse)):
        d = tmp_path_factory.mktemp(f"smoke-{side}")
        result, report = fn(smoke=True, out_dir=str(d), executor="serial")
        out[side] = (result, report, d)
    return out


def test_smoke_canonical_json_equals_the_reference(smoke_pair):
    ref, port = smoke_pair["ref"][0], smoke_pair["port"][0]
    assert len(port.records) == 36
    assert port.canonical_json() == ref.canonical_json()


def test_smoke_report_equals_the_reference(smoke_pair):
    from repro.kvi.obs.scrub import DSE_VOLATILE as R_VOLATILE

    from repro_torch.kvi.dse.sweep import scrub_volatile
    ref, port = smoke_pair["ref"][1], smoke_pair["port"][1]
    assert json.dumps(scrub_volatile(port), sort_keys=True) == \
        json.dumps(scrub_volatile(ref, R_VOLATILE), sort_keys=True)
    assert all(v for v in port["checks"].values() if isinstance(v, bool))


def test_smoke_markdown_equals_the_reference(smoke_pair):
    """Byte for byte, but for the one wall-clock number the report
    prints (the sweep's ``wall_s`` in its header line)."""
    import copy

    from repro.kvi.dse.report import render_markdown as r_render

    from repro_torch.kvi.dse import render_markdown
    ref, port = smoke_pair["ref"], smoke_pair["port"]

    def unclocked(text):
        return re.sub(r"wall [0-9.]+s", "wall <s>s", text)
    assert unclocked((port[2] / "dse_report.md").read_text()) == \
        unclocked((ref[2] / "dse_report.md").read_text())
    report = copy.deepcopy(port[1])
    report["meta"]["wall_s"] = ref[1]["meta"]["wall_s"]
    assert render_markdown(report) == r_render(ref[1])


@pytest.mark.parametrize("fname", SMOKE_PLOTS)
def test_smoke_plot_equals_the_reference(smoke_pair, fname):
    ref, port = smoke_pair["ref"][2], smoke_pair["port"][2]
    assert (port / fname).read_bytes() == (ref / fname).read_bytes()


def test_port_writes_its_own_bench_file(smoke_pair):
    """``run_dse`` writes ``BENCH_torch_kvi_dse.json``, never the
    reference's ``BENCH_kvi_dse.json``; its scrubbed content is the
    reference's report."""
    ref, port = smoke_pair["ref"][2], smoke_pair["port"][2]
    assert not (port / "BENCH_kvi_dse.json").exists()
    from repro_torch.kvi.dse.sweep import scrub_volatile
    got = json.loads((port / "BENCH_torch_kvi_dse.json").read_text())
    want = json.loads((ref / "BENCH_kvi_dse.json").read_text())
    assert scrub_volatile(got) == scrub_volatile(want)


@pytest.mark.parametrize("bits", (8, 16, 32))
def test_point_keys_equal_the_reference(bits):
    """``program_fingerprint`` of every optimized smoke program and
    ``point_key`` of every smoke point at ``bits`` equal the
    reference's: the programs' reprs (fusion plans included) and the
    version tokens are the reference's, so a record's address is too."""
    from repro.kvi.dse import paper_kernel_factory as r_factory
    from repro.kvi.dse import point_key as r_point_key
    from repro.kvi.dse import program_fingerprint as r_fingerprint
    from repro.kvi.dse import smoke_space as r_smoke
    from repro.kvi.dse.sweep import optimize_kernels as r_optimize

    from repro_torch.kvi.dse import (paper_kernel_factory, point_key,
                                     program_fingerprint, smoke_space)
    from repro_torch.kvi.dse.sweep import optimize_kernels
    r_fps = {n: r_fingerprint(p) for n, p in r_optimize(
        r_factory(smoke=True)(bits), None).items()}
    t_fps = {n: program_fingerprint(p) for n, p in optimize_kernels(
        paper_kernel_factory(smoke=True)(bits), None).items()}
    assert t_fps == r_fps
    r_pts = [p for p in r_smoke().points() if p.precision_bits == bits]
    t_pts = [p for p in smoke_space().points() if p.precision_bits == bits]
    assert [p.name for p in t_pts] == [p.name for p in r_pts]
    for rp, tp in zip(r_pts, t_pts):
        assert point_key(tp, t_fps, True) == r_point_key(rp, r_fps, True)


def _tiny_factory(programs):
    def factory(precision_bits):
        eb = precision_bits // 8
        rng = np.random.default_rng(7)
        img = rng.integers(-8, 8, (8, 8)).astype(np.int32)
        filt = rng.integers(-4, 4, (3, 3)).astype(np.int32)
        A = rng.integers(-4, 4, (8, 8)).astype(np.int32)
        B = rng.integers(-4, 4, (8, 8)).astype(np.int32)
        return {
            "conv": programs.conv2d_program(img, filt, shift=2,
                                            elem_bytes=eb),
            "fft": programs.fft_program(
                rng.integers(-64, 64, 32).astype(np.int32),
                rng.integers(-64, 64, 32).astype(np.int32), elem_bytes=eb),
            "matmul": programs.matmul_program(A, B, shift=2, resident=True,
                                              elem_bytes=eb),
        }
    return factory


#: the port's walltime-stage names -> the reference's
TO_REFERENCE = {"kernel_launches": "pallas_calls",
                "measure_device": "measure_pallas", "device": "pallas"}


def _to_reference(obj):
    if isinstance(obj, dict):
        return {TO_REFERENCE.get(k, k): _to_reference(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_reference(v) for v in obj]
    return obj


@pytest.fixture(scope="module")
def walltime_pair():
    """One 8-bit measurement class (two points: shared and sym-MIMD) of
    the tiny conv / FFT-32 / resident matmul 8 and their composite,
    through the reference's Pallas stage and the port's device stage on
    the CPU."""
    import repro.kvi.programs as r_programs
    from repro.kvi.dse import DesignPoint as RPoint
    from repro.kvi.dse import sweep as r_sweep

    import repro_torch.kvi.programs as t_programs
    pts = (("shared", 1, 1), ("sym_mimd", 3, 3))
    ref = r_sweep([RPoint(s, m, f, 4, precision_bits=8) for s, m, f in pts],
                  _tiny_factory(r_programs), max_workers=1,
                  measure_pallas=True)
    port = sweep([DesignPoint(s, m, f, 4, precision_bits=8)
                  for s, m, f in pts], _tiny_factory(t_programs),
                 max_workers=1, measure_device=True, device="cpu")
    return ref, port


def test_walltime_launches_equal_the_reference_pallas_calls(walltime_pair):
    ref, port = walltime_pair
    for r, t in zip(ref.records, port.records):
        for name, k in r.kernels.items():
            assert t.kernels[name]["kernel_launches"] == \
                k["pallas_calls"] > 0, name
        assert t.composite["kernel_launches"] == \
            r.composite["pallas_calls"] > 0
    assert port.meta["device"]["compile_cache"] == \
        ref.meta["pallas"]["compile_cache"]


def test_walltime_canonical_json_equals_the_reference_renamed(
        walltime_pair):
    """Every canonical field equal after the renaming (``pallas_calls``
    -> ``kernel_launches``, ``meta["pallas"]`` -> ``meta["device"]``).
    ``meta["device"]["classes"]`` has no reference counterpart: it lists
    each class's launches beside its unrounded (volatile) seconds."""
    ref, port = walltime_pair
    got = _to_reference(json.loads(port.canonical_json()))
    classes = got["meta"]["pallas"].pop("classes")
    assert [c["kernels"]["composite"]["pallas_calls"] for c in classes] \
        == [ref.records[0].composite["pallas_calls"]]
    assert json.dumps(got, indent=2, sort_keys=True) == \
        ref.canonical_json()


def test_cli_smoke_exits_zero_on_the_cpu(tmp_path):
    """``python -m repro_torch.kvi.dse --smoke --measure-device --device
    cpu``: 36 points, every check True, exit 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.kvi.dse", "--smoke", "--quiet",
         "--measure-device", "--device", "cpu", "--jobs", "2",
         "--out-dir", str(tmp_path), "--cache-dir", str(tmp_path / "c")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "# swept 36 points (36 ok)" in proc.stdout
    assert "# device walltime: 36 points in 3 measurement classes on cpu" \
        in proc.stdout
    assert (tmp_path / "BENCH_torch_kvi_dse.json").is_file()


def test_chip_smoke_dse_phase_rehearsed_on_the_cpu(capsys):
    """``chip_smoke.run_dse_phase`` (phase 3d) with the CPU as the
    device: every check of the phase holds (both sweeps, the oracle at
    full width, the CLI cold then warm from the store) and it prints
    one ``[dse]`` line per class and kernel, then its summary."""
    import importlib.util

    import torch
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.run_dse_phase(torch.device("cpu"), 0)
    assert out["walk_launches"] == 0
    assert out["oracle_checked_entries"] == 3 * (3 * 3 + 3)
    assert [r["kernel_launches"] for r in out["classes"]
            if r["bits"] == 8] == [32, 61, 192, 285]
    cold, warm = out["cli"]
    assert (cold["misses"], cold["device_misses"]) == (36, 3)
    assert (warm["hits"], warm["device_hits"], warm["misses"]) == (36, 3, 0)
    assert capsys.readouterr().out.count("[dse]") == 3 * 4 + 1
