"""The port's budget-constrained auto-tuner (``repro_torch.kvi.dse.search``):
every test of the reference's ``tests/kvi/test_search.py`` against the
port — front-recovery metric,
ε-relaxed layer peeling, the feasible-candidate sampler, the three
strategies' acceptance gates on the smoke space (full exhaustive-front
recovery under half the grid's sims), warm-cache zero-simulation
re-search, seeded byte-determinism, and the >=5000-point synthetic
space returning a budget-feasible best with per-rung accounting — then
``run_search`` of each strategy held against the reference's, byte for
byte, on the smoke space."""
import json
import random

import numpy as np
import pytest

from repro_torch.kvi.dse import (DesignPoint, DesignSpace, PointCache,
                                 SpaceConstraints, hardware_cost, pareto_front)
from repro_torch.kvi.dse.search import (STRATEGIES, CandidateSampler,
                                        front_recovery, run_search)
from repro_torch.kvi.dse.search.evaluator import LowFidScore
from repro_torch.kvi.dse.search.strategies import eps_peel
from repro_torch.kvi.programs import conv2d_program, matmul_program

# ---------------------------------------------------------------------------
# front_recovery: the acceptance metric
# ---------------------------------------------------------------------------


class TestFrontRecovery:
    REF = [(100.0, 50.0, 10.0), (120.0, 40.0, 12.0)]

    def test_exact_match_is_full_recovery(self):
        assert front_recovery(list(self.REF), self.REF) == 1.0

    def test_empty_reference_is_vacuously_recovered(self):
        assert front_recovery([(1.0, 2.0, 3.0)], []) == 1.0

    def test_missing_member_is_fractional(self):
        assert front_recovery([self.REF[0]], self.REF) == 0.5
        assert front_recovery([], self.REF) == 0.0

    def test_relative_tolerance_absorbs_float_noise(self):
        wiggled = [(c * (1 + 1e-9), a, e) for c, a, e in self.REF]
        assert front_recovery(wiggled, self.REF) == 1.0
        off = [(c * 1.01, a, e) for c, a, e in self.REF]
        assert front_recovery(off, self.REF) == 0.0

    def test_duplicate_reference_metrics_count_once(self):
        # two distinct configs landing on identical metrics are ONE
        # front member for recovery purposes (tie tolerance)
        ref = [self.REF[0], self.REF[0], self.REF[1]]
        assert front_recovery([self.REF[0]], ref) == 0.5

    def test_extra_found_points_never_hurt(self):
        found = list(self.REF) + [(999.0, 999.0, 999.0)]
        assert front_recovery(found, self.REF) == 1.0


# ---------------------------------------------------------------------------
# ε-relaxed layer peeling
# ---------------------------------------------------------------------------


def _scores(objs, feasible=None):
    """LowFidScore fixtures over distinct real points (names matter
    only for deterministic sort order)."""
    pts = DesignSpace().points()
    assert len(objs) <= len(pts)
    out = []
    for i, obj in enumerate(objs):
        ok = feasible[i] if feasible is not None else True
        out.append(LowFidScore(pts[i], ok,
                               objectives=tuple(obj) if ok else None,
                               reason=None if ok else "infeasible"))
    return out


class TestEpsPeel:
    def test_layers_partition_feasible_and_drop_infeasible(self):
        scores = _scores([(10, 5, 1), (11, 5, 1), (20, 4, 2),
                          (30, 6, 3), (9, 9, 9)],
                         feasible=[True, True, True, True, False])
        layers = eps_peel(scores, eps=0.05)
        names = [s.point.name for layer in layers for s in layer]
        feas = [s.point.name for s in scores if s.feasible]
        assert sorted(names) == sorted(feas)      # partition: no loss,
        assert len(names) == len(set(names))      # no duplication

    def test_layer0_contains_exact_front(self):
        # ε-relaxation only ever ADDS near-ties to the first layer
        rng = random.Random(3)
        objs = [(rng.uniform(10, 100), rng.uniform(10, 100),
                 rng.uniform(10, 100)) for _ in range(24)]
        scores = _scores(objs)
        exact = {s.point.name
                 for s in eps_peel(scores, eps=0.0)[0]}
        relaxed = {s.point.name
                   for s in eps_peel(scores, eps=0.05)[0]}
        assert exact <= relaxed

    def test_near_tie_within_eps_survives_layer0(self):
        # b is 1% worse on both estimated axes with equal exact area:
        # inside the 2% error band, so it must not be culled analytically
        scores = _scores([(100.0, 50.0, 10.0), (101.0, 50.0, 10.1),
                          (200.0, 50.0, 20.0)])
        layer0 = {s.point.name for s in eps_peel(scores, eps=0.02)[0]}
        assert {scores[0].point.name, scores[1].point.name} <= layer0
        assert scores[2].point.name not in layer0

    def test_exact_area_gates_domination(self):
        # area is exact at low fidelity: beating a candidate by the
        # error margin on both estimated axes culls it only when the
        # dominator's area is no worse...
        culled = _scores([(100.0, 50.0, 10.0), (200.0, 50.0, 20.0)])
        layer0 = eps_peel(culled, eps=0.02)[0]
        assert [s.point.name for s in layer0] == [culled[0].point.name]
        # ...a larger-area dominator keeps the candidate alive, however
        # lopsided the estimates (it's a genuine area/speed trade-off)
        kept = _scores([(100.0, 51.0, 10.0), (200.0, 50.0, 20.0)])
        layer0 = eps_peel(kept, eps=0.02)[0]
        assert len(layer0) == 2

    def test_layers_sorted_deterministically(self):
        scores = _scores([(20, 4, 2), (10, 5, 1), (10, 5, 1)])
        layers = eps_peel(scores, eps=0.0)
        for layer in layers:
            keys = [(s.objectives[0], s.objectives[1], s.point.name)
                    for s in layer]
            assert keys == sorted(keys)


# ---------------------------------------------------------------------------
# CandidateSampler
# ---------------------------------------------------------------------------


class TestCandidateSampler:
    SPACE = DesignSpace()                     # 36 points

    def test_draws_are_distinct_and_in_space(self):
        s = CandidateSampler(self.SPACE, rng=random.Random(0))
        pts = s.draw(20)
        names = [p.name for p in pts]
        assert len(names) == 20
        assert len(set(names)) == 20
        grid_names = {p.name for p in self.SPACE.points()}
        assert set(names) <= grid_names

    def test_overdraw_exhausts_the_feasible_grid_exactly_once(self):
        s = CandidateSampler(self.SPACE, rng=random.Random(1))
        pts = s.draw(500)
        assert len(pts) == self.SPACE.grid_size
        assert s.draw(10) == []               # nothing left
        assert s.stats["distinct_points"] == self.SPACE.grid_size

    def test_constraints_respected_and_counted(self):
        cons = SpaceConstraints(schemes=("het_mimd",), max_lanes=8)
        s = CandidateSampler(self.SPACE, constraints=cons,
                             rng=random.Random(2))
        pts = s.draw(100)
        assert pts and all(p.scheme == "het_mimd" and p.D <= 8
                           for p in pts)
        expect = [p for p in self.SPACE.points()
                  if cons.feasible(p)]
        assert len(pts) == len(expect)
        assert s.stats["rejections"] > 0

    def test_same_seed_same_sequence(self):
        a = CandidateSampler(self.SPACE, rng=random.Random(7)).draw(36)
        b = CandidateSampler(self.SPACE, rng=random.Random(7)).draw(36)
        assert [p.name for p in a] == [p.name for p in b]

    def test_mutate_moves_one_axis_and_stays_feasible(self):
        cons = SpaceConstraints(max_lanes=8)
        s = CandidateSampler(self.SPACE, constraints=cons,
                             rng=random.Random(5))
        parent = DesignPoint(scheme="sym_mimd", M=3, F=3, D=4,
                             precision_bits=16)
        for _ in range(30):
            child = s.mutate(parent)
            assert child is not None
            assert child.name != parent.name
            assert cons.feasible(child)
            # a scheme move re-draws the coupled (M, F) pair; any other
            # move changes exactly one independent axis
            diffs = sum((child.scheme != parent.scheme,
                         (child.M, child.F) != (parent.M, parent.F),
                         child.D != parent.D,
                         child.precision_bits != parent.precision_bits,
                         child.spm_kbytes != parent.spm_kbytes,
                         child.chaining != parent.chaining,
                         child.passes != parent.passes,
                         child.fu_counts != parent.fu_counts))
            if child.scheme != parent.scheme:
                assert diffs <= 3             # scheme + (M,F) + fu
            else:
                assert diffs == 1

    def test_crossover_yields_valid_feasible_child(self):
        s = CandidateSampler(self.SPACE, rng=random.Random(9))
        a = DesignPoint(scheme="het_mimd", M=3, F=1, D=2,
                        precision_bits=8)
        b = DesignPoint(scheme="shared", M=1, F=1, D=16,
                        precision_bits=32)
        got_child = False
        for _ in range(20):
            child = s.crossover(a, b)
            if child is None:
                continue
            got_child = True
            assert child.name not in (a.name, b.name)
            # scheme-coupled fields travel together (the child must be
            # a VALID DesignPoint, constructed without ValueError)
            assert child.scheme in ("het_mimd", "shared")
            assert child.D in (2, 16)
            assert child.precision_bits in (8, 32)
        assert got_child


# ---------------------------------------------------------------------------
# Strategy acceptance gates on the smoke space (serial, shared cache)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shared_cache_dir(tmp_path_factory):
    """One persistent point-cache dir for every search in this module:
    the first test pays the 36 cold smoke sims, everything after runs
    from the store — exactly the re-search economics being tested."""
    return str(tmp_path_factory.mktemp("search-point-cache"))


def smoke_search(strategy, seed, cache_dir, **kw):
    kw.setdefault("compare_exhaustive", True)
    return run_search(strategy=strategy, smoke=True, seed=seed,
                      executor="serial",
                      cache=PointCache(cache_dir=cache_dir),
                      emit=None, **kw)


class TestStrategiesOnSmokeSpace:
    @pytest.mark.parametrize("strategy", sorted(STRATEGIES))
    def test_recovers_exhaustive_front_within_half_budget(
            self, strategy, shared_cache_dir):
        res = smoke_search(strategy, seed=0, cache_dir=shared_cache_dir)
        rec = res.meta["recovery"]
        # full tie-tolerant Pareto-front recovery...
        assert rec["front_recovery"] == 1.0, rec
        # ...with at most half the exhaustive grid's cycle-accurate
        # evaluations (the persistent-cache-independent count)
        assert res.evaluations["high_evals"] \
            <= 0.5 * res.meta["grid_size"]
        assert res.exhaustive_fraction <= 0.5

    @pytest.mark.parametrize("strategy", sorted(STRATEGIES))
    def test_rungs_account_every_fidelity(self, strategy,
                                          shared_cache_dir):
        res = smoke_search(strategy, seed=0, cache_dir=shared_cache_dir)
        assert res.rungs
        for rung in res.rungs:
            assert {"rung", "requested",
                    "high_evals", "low_evals"} <= set(rung)
        # cumulative counters are monotone and end at the totals
        highs = [r["high_evals"] for r in res.rungs]
        assert highs == sorted(highs)
        assert highs[-1] == res.evaluations["high_evals"]

    @pytest.mark.parametrize("strategy", sorted(STRATEGIES))
    def test_trajectory_best_is_monotone_nonincreasing(
            self, strategy, shared_cache_dir):
        res = smoke_search(strategy, seed=0, cache_dir=shared_cache_dir)
        best = [t["best_mix_cycles"] for t in res.trajectory
                if t["best_mix_cycles"] is not None]
        assert best, res.trajectory
        assert all(b <= a for a, b in zip(best, best[1:]))
        assert res.best is not None and res.best.ok

    def test_search_front_is_confirmed_pareto_consistent(
            self, shared_cache_dir):
        res = smoke_search("successive_halving", seed=0,
                           cache_dir=shared_cache_dir)
        # the reported front must be non-dominated within itself under
        # the high-fidelity metrics recorded in the report
        metrics = [tuple(res.meta["front_metrics"][r.point.name])
                   for r in res.front]
        assert len(pareto_front(metrics)) == len(metrics)

    def test_warm_research_does_zero_cyclesim_work(
            self, shared_cache_dir):
        first = smoke_search("successive_halving", seed=0,
                             cache_dir=shared_cache_dir,
                             compare_exhaustive=False)
        again = smoke_search("successive_halving", seed=0,
                             cache_dir=shared_cache_dir,
                             compare_exhaustive=False)
        # identical (space, strategy, seed, budget) -> every confirmed
        # point served from the persistent store: no fresh simulations,
        # every per-rung cache round pure hits
        assert again.evaluations["fresh_evals"] == 0
        assert again.evaluations["high_evals"] \
            == first.evaluations["high_evals"] > 0
        rounds = again.meta["point_cache"]["rounds"]
        assert rounds and all(r["misses"] == 0 for r in rounds)
        assert sum(r["hits"] for r in rounds) \
            == again.evaluations["high_evals"]

    @pytest.mark.parametrize("seed", [0, 3])
    def test_same_seed_byte_identical_canonical_report(
            self, seed, shared_cache_dir):
        a = smoke_search("successive_halving", seed=seed,
                         cache_dir=shared_cache_dir)
        b = smoke_search("successive_halving", seed=seed,
                         cache_dir=shared_cache_dir)
        assert a.canonical_json() == b.canonical_json()
        # and the canonical form really is volatile-free
        assert "walltime_s" not in json.loads(a.canonical_json())["meta"]

    def test_canonical_bytes_independent_of_cache_temperature(
            self, shared_cache_dir, tmp_path):
        warm = smoke_search("random", seed=1,
                            cache_dir=shared_cache_dir,
                            compare_exhaustive=False)
        cold = smoke_search("random", seed=1,
                            cache_dir=str(tmp_path / "cold"),
                            compare_exhaustive=False)
        assert cold.evaluations["fresh_evals"] > 0
        assert warm.canonical_json() == cold.canonical_json()


# ---------------------------------------------------------------------------
# >=5000-point synthetic space: budget-feasible best in bounded time
# ---------------------------------------------------------------------------


def tiny_kernels(precision_bits, data_seed=7):
    """Two fast kernels (seconds for a handful of sims) so the big-space
    test exercises the search plumbing, not the simulator."""
    eb = precision_bits // 8
    rng = np.random.default_rng(data_seed)
    img = rng.integers(-8, 8, (8, 8)).astype(np.int32)
    filt = rng.integers(-4, 4, (3, 3)).astype(np.int32)
    A = rng.integers(-4, 4, (8, 8)).astype(np.int32)
    B = rng.integers(-4, 4, (8, 8)).astype(np.int32)
    return {
        "conv": conv2d_program(img, filt, shift=2, elem_bytes=eb),
        "matmul": matmul_program(A, B, shift=2, resident=True,
                                 elem_bytes=eb),
    }


def big_space():
    return DesignSpace(
        lanes=(2, 4, 8, 16),
        precisions=(8, 16, 32),
        spm_kbytes=(8, 16, 32, 48, 64, 128),
        chaining=(False, True),
        replication=(2, 3, 4, 5),
        het_fus=(1, 2, 3),
        pipelines=(None, ()),
        fu_counts=((), (("multiplier", 2),)))


class TestSyntheticBigSpace:
    def test_budget_feasible_best_under_constraints(self):
        space = big_space()
        assert space.grid_size >= 5000
        area_cap = hardware_cost(
            DesignPoint(scheme="het_mimd", M=3, F=1, D=8,
                        precision_bits=8).config()).area_luteq
        cons = SpaceConstraints(max_area_luteq=area_cap, max_lanes=8)
        res = run_search(strategy="successive_halving",
                         space=space, constraints=cons,
                         kernel_factory=tiny_kernels,
                         budget=4, pool=64, seed=0,
                         executor="serial", compare_exhaustive=False,
                         emit=None)
        # a budget-feasible best: confirmed cycle-accurate, inside the
        # constraint envelope, found with <=4 sims out of >=5000 cells
        assert res.best is not None and res.best.ok
        assert cons.feasible(res.best.point)
        assert res.evaluations["high_evals"] <= 4
        assert res.evaluations["low_evals"] <= 64
        assert res.exhaustive_fraction < 0.001
        # meta records per-rung evaluations at both fidelities
        assert res.rungs and all(
            {"high_evals", "low_evals"} <= set(r) for r in res.rungs)
        assert res.meta["grid_size"] == space.grid_size
        assert res.meta["constraints"]["max_area_luteq"] == area_cap
        # bounded wall time: the search never touched the other ~5000
        # cells (sampler saw at most the pool, not the grid)
        assert res.evaluations["sampler"]["distinct_points"] <= 64

    def test_big_space_search_is_seed_deterministic(self):
        space = big_space()
        runs = [run_search(strategy="evolutionary", space=space,
                           kernel_factory=tiny_kernels,
                           budget=4, pool=48, seed=11,
                           executor="serial",
                           compare_exhaustive=False, emit=None)
                for _ in range(2)]
        assert runs[0].canonical_json() == runs[1].canonical_json()


# ---------------------------------------------------------------------------
# Driver policy details
# ---------------------------------------------------------------------------


class TestDriverPolicy:
    def test_unknown_strategy_rejected_naming_choices(self):
        with pytest.raises(ValueError, match="evolutionary"):
            run_search(strategy="annealing", smoke=True)

    def test_default_budget_is_half_grid_floored_and_capped(self):
        from repro_torch.kvi.dse.search.driver import default_budget
        assert default_budget(36) == 18
        assert default_budget(96) == 48
        assert default_budget(10) == 8          # floor
        assert default_budget(6624) == 64       # cap

    def test_budget_is_a_hard_ceiling(self, shared_cache_dir):
        res = smoke_search("random", seed=0,
                           cache_dir=shared_cache_dir,
                           budget=5, compare_exhaustive=False)
        assert res.evaluations["high_evals"] == 5
        assert len(res.trajectory) >= 1

    def test_artifacts_written_and_canonical_matches(
            self, shared_cache_dir, tmp_path):
        out = tmp_path / "artifacts"
        res = smoke_search("successive_halving", seed=0,
                           cache_dir=shared_cache_dir,
                           out_dir=str(out))
        for fname in ("dse_search.json", "dse_search_canonical.json",
                      "dse_search.md", "dse_search_trajectory.svg",
                      "BENCH_torch_kvi_search.json"):
            assert (out / fname).exists(), fname
        on_disk = (out / "dse_search_canonical.json").read_text()
        assert on_disk == res.canonical_json() + "\n"
        assert not (out / "BENCH_kvi_search.json").exists()
        bench = json.loads((out / "BENCH_torch_kvi_search.json"
                            ).read_text())
        assert bench["front_recovery"] == 1.0
        md = (out / "dse_search.md").read_text()
        assert "dse_search_trajectory.svg" in md


# ---------------------------------------------------------------------------
# Held against the reference: run_search byte for byte per strategy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_cache_dir(tmp_path_factory):
    """The reference's own point-cache store for this module's
    reference searches (its records are the reference's classes)."""
    return str(tmp_path_factory.mktemp("reference-search-point-cache"))


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_search_equals_the_reference(strategy, shared_cache_dir,
                                     reference_cache_dir):
    """``run_search`` on the smoke space at seed 0 (the exhaustive
    yardstick on): the port's canonical report is the reference's, byte
    for byte."""
    from repro.kvi.dse.pointcache import PointCache as RPointCache
    from repro.kvi.dse.search import run_search as r_run_search
    ref = r_run_search(strategy=strategy, smoke=True, seed=0,
                       executor="serial", compare_exhaustive=True,
                       cache=RPointCache(cache_dir=reference_cache_dir),
                       emit=None)
    port = smoke_search(strategy, seed=0, cache_dir=shared_cache_dir)
    assert port.canonical_json() == ref.canonical_json()
    assert port.meta["recovery"]["front_recovery"] == 1.0


def test_search_cli_smoke_exits_zero(tmp_path):
    """``python -m repro_torch.kvi.dse search --smoke``: the full front
    recovered within half the grid's simulations, exit 0."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.kvi.dse", "search", "--smoke",
         "--quiet", "--executor", "serial", "--out-dir", str(tmp_path),
         "--cache-dir", str(tmp_path / "c")],
        env=dict(os.environ, PYTHONPATH=str(root / "src")), cwd=root,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "# front recovery: 100.0%" in proc.stdout
    assert (tmp_path / "BENCH_torch_kvi_search.json").is_file()
