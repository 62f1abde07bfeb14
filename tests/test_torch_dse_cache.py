"""The port's persistent point cache (``repro_torch.kvi.dse.pointcache``):
every test of the reference's ``tests/kvi/test_dse_cache.py`` against the
port — content-addressed keys (the invalidation matrix), the JSON-lines
store (integrity, last-write-wins, GC compaction), sweep integration
(cold/warm/mixed byte-identity across executors, counter pins, delta
re-sweeps), device measurement-class caching (on the CPU here) and the
auto executor — then the port's own: the device class key names the
backend and the device, and the default store is the port's own
directory."""
import json

import numpy as np
import pytest

from repro_torch.kvi.dse import (AUTO_SERIAL_MAX, DesignPoint, DesignSpace,
                                 PointCache, SerialExecutor, device_class_key,
                                 point_key, program_fingerprint, resolve_auto,
                                 sweep)
from repro_torch.kvi.dse.pointcache import (record_from_payload,
                                            record_to_payload, resolved_passes)
from repro_torch.kvi.programs import (conv2d_program, fft_program,
                                      matmul_program)

# ---------------------------------------------------------------------------
# Fixtures: a 6-point space over tiny kernels (seconds per sweep)
# ---------------------------------------------------------------------------

SMALL_SPACE = DesignSpace(lanes=(2,), precisions=(8, 32))   # 6 points


def small_kernels(precision_bits, data_seed=7):
    eb = precision_bits // 8
    rng = np.random.default_rng(data_seed)
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


def edited8_kernels(precision_bits):
    """small_kernels with *different input data* for the 8-bit programs
    only — the one-axis edit of the delta-re-sweep tests."""
    return small_kernels(precision_bits,
                         data_seed=11 if precision_bits == 8 else 7)


def saxpy_kernels(precision_bits):
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


def fps_for(point, kernels=small_kernels):
    return {name: program_fingerprint(p)
            for name, p in kernels(point.precision_bits).items()}


# ---------------------------------------------------------------------------
# Keys: the invalidation matrix
# ---------------------------------------------------------------------------


class TestKeys:
    def test_fingerprint_stable_across_rebuilds(self):
        a = small_kernels(32)["conv"]
        b = small_kernels(32)["conv"]
        assert a is not b
        assert program_fingerprint(a) == program_fingerprint(b)

    def test_fingerprint_changes_with_data_and_structure(self):
        base = program_fingerprint(small_kernels(32)["conv"])
        edited = program_fingerprint(small_kernels(32, data_seed=11)
                                     ["conv"])
        assert base != edited                      # mem_init bytes
        assert base != program_fingerprint(small_kernels(8)["conv"])

    def test_key_stable_for_identical_inputs(self):
        pt = DesignPoint("shared", 1, 1, 2, precision_bits=32)
        assert point_key(pt, fps_for(pt), True) == \
            point_key(pt, fps_for(pt), True)

    def test_point_dict_change_misses(self):
        a = DesignPoint("shared", 1, 1, 2, precision_bits=32)
        fps = fps_for(a)
        base = point_key(a, fps, True)
        for other in (
                DesignPoint("shared", 1, 1, 4, precision_bits=32),
                DesignPoint("shared", 1, 1, 2, precision_bits=32,
                            spm_kbytes=32),
                DesignPoint("shared", 1, 1, 2, precision_bits=32,
                            chaining=True),
                DesignPoint("sym_mimd", 3, 3, 2, precision_bits=32)):
            assert point_key(other, fps, True) != base, other.name

    def test_program_ir_change_misses(self):
        pt = DesignPoint("shared", 1, 1, 2, precision_bits=8)
        base = point_key(pt, fps_for(pt), True)
        edited = point_key(pt, fps_for(pt, edited8_kernels), True)
        assert base != edited

    def test_pass_spec_change_misses(self):
        pt = DesignPoint("shared", 1, 1, 2, precision_bits=32)
        fps = fps_for(pt)
        raw = DesignPoint("shared", 1, 1, 2, precision_bits=32,
                          passes=())
        dce = DesignPoint("shared", 1, 1, 2, precision_bits=32,
                          passes=("dce",))
        keys = {point_key(p, fps, True) for p in (pt, raw, dce)}
        assert len(keys) == 3

    def test_default_pipeline_resolves_to_names(self):
        from repro_torch.kvi.passes.pipeline import DEFAULT_PASSES
        assert resolved_passes(None) == list(DEFAULT_PASSES)
        assert resolved_passes(()) == []

    def test_calibration_version_bump_misses(self, monkeypatch):
        from repro_torch.kvi.dse import cost
        pt = DesignPoint("shared", 1, 1, 2, precision_bits=32)
        fps = fps_for(pt)
        base = point_key(pt, fps, True)
        monkeypatch.setattr(cost, "CALIBRATION_VERSION",
                            cost.CALIBRATION_VERSION + 1)
        assert point_key(pt, fps, True) != base

    def test_timing_version_bump_misses(self, monkeypatch):
        from repro_torch.kvi import cyclesim
        pt = DesignPoint("shared", 1, 1, 2, precision_bits=32)
        fps = fps_for(pt)
        base = point_key(pt, fps, True)
        monkeypatch.setattr(cyclesim, "TIMING_VERSION",
                            cyclesim.TIMING_VERSION + 1)
        assert point_key(pt, fps, True) != base

    def test_composite_flag_misses(self):
        pt = DesignPoint("shared", 1, 1, 2, precision_bits=32)
        fps = fps_for(pt)
        assert point_key(pt, fps, True) != point_key(pt, fps, False)

    def test_measure_device_mode_does_not_change_key(self):
        # a measurement MODE, not an input: flipping it must keep the
        # cyclesim record warm
        a = DesignPoint("shared", 1, 1, 2, precision_bits=32)
        b = DesignPoint("shared", 1, 1, 2, precision_bits=32,
                        measure_device=True)
        fps = fps_for(a)
        assert point_key(a, fps, True) == point_key(b, fps, True)

    def test_device_class_key_axes(self, monkeypatch):
        fps = {"saxpy": program_fingerprint(saxpy_kernels(32)["saxpy"])}

        def key(*args):
            return device_class_key(fps, *args, "torch", "cpu")
        base = key(32, None, 3, True)
        assert key(8, None, 3, True) != base
        assert key(32, (), 3, True) != base
        assert key(32, None, 4, True) != base
        from repro_torch.kvi import cyclesim
        monkeypatch.setattr(cyclesim, "TIMING_VERSION",
                            cyclesim.TIMING_VERSION + 1)
        assert key(32, None, 3, True) != base


# ---------------------------------------------------------------------------
# Record (de)serialization
# ---------------------------------------------------------------------------


class TestRecordRoundtrip:
    def test_ok_record_roundtrips(self):
        from repro_torch.kvi.dse.sweep import run_point
        pt = DesignPoint("shared", 1, 1, 2, precision_bits=32)
        rec = run_point(pt, small_kernels(32))
        back = record_from_payload(
            json.loads(json.dumps(record_to_payload(rec))), pt)
        assert back.cached and back.wall_s == 0.0
        a, b = rec.as_dict(), back.as_dict()
        a.pop("wall_s"), b.pop("wall_s"), b.pop("cached")
        assert a == b
        assert back.area.area_luteq == rec.area.area_luteq

    def test_incompatible_record_roundtrips(self):
        from repro_torch.kvi.dse.sweep import run_point
        pt = DesignPoint("shared", 1, 1, 4, spm_kbytes=1,
                         precision_bits=32)
        def big(precision_bits):
            img = np.arange(1024, dtype=np.int32).reshape(32, 32)
            return {"conv": conv2d_program(img, np.ones((3, 3), np.int32),
                                           elem_bytes=4)}
        rec = run_point(pt, big(32))
        assert rec.status == "incompatible"
        back = record_from_payload(
            json.loads(json.dumps(record_to_payload(rec))), pt)
        assert back.status == "incompatible"
        assert back.reason == rec.reason and back.area is None


# ---------------------------------------------------------------------------
# The on-disk store
# ---------------------------------------------------------------------------


class TestStore:
    def test_last_write_wins_within_and_across_instances(self, tmp_path):
        c = PointCache(cache_dir=str(tmp_path))
        c._store("point", "k1", "p1", {"n": 1})
        c._store("point", "k1", "p1", {"n": 2})
        assert c._lookup("point", "k1", "p1") == {"n": 2}
        again = PointCache(cache_dir=str(tmp_path))
        assert again._lookup("point", "k1", "p1") == {"n": 2}
        assert again.n_entries == 1

    def test_lookup_returns_isolated_copies(self, tmp_path):
        c = PointCache(cache_dir=str(tmp_path))
        c._store("point", "k1", "p1", {"n": 1, "d": {"x": 1}})
        got = c._lookup("point", "k1", "p1")
        got["d"]["x"] = 999                 # caller mutates its copy
        assert c._lookup("point", "k1", "p1")["d"]["x"] == 1

    def test_invalidation_counted_on_label_key_mismatch(self, tmp_path):
        c = PointCache(cache_dir=str(tmp_path))
        c._store("point", "k_old", "p1", {"n": 1})
        assert c._lookup("point", "k_new", "p1") is None
        assert c.invalidations == 1
        # a genuinely new label is a plain miss, not an invalidation
        assert c._lookup("point", "k_other", "p_new") is None
        assert c.invalidations == 1
        # storing under the new key replaces the stale entry
        c._store("point", "k_new", "p1", {"n": 2})
        assert c.n_entries == 1
        assert c._lookup("point", "k_old", "p1") is None

    def test_corrupt_lines_discarded_not_fatal(self, tmp_path):
        c = PointCache(cache_dir=str(tmp_path))
        for i in range(3):
            c._store("point", f"k{i}", f"p{i}", {"n": i})
        lines = (tmp_path / "dse_point_cache.jsonl").read_text(
        ).splitlines()
        # tamper with one payload (checksum now wrong), add garbage and
        # a schema-stale line
        bad = json.loads(lines[1])
        bad["payload"]["n"] = 999
        stale = json.loads(lines[2])
        stale["v"] = 9999
        (tmp_path / "dse_point_cache.jsonl").write_text("\n".join(
            [lines[0], json.dumps(bad), "{{{not json",
             json.dumps(stale), ""]) + "\n")
        again = PointCache(cache_dir=str(tmp_path))
        assert again._lookup("point", "k0", "p0") == {"n": 0}
        assert again._lookup("point", "k1", "p1") is None
        assert again._lookup("point", "k2", "p2") is None
        assert again.corrupt_discarded == 3

    def test_gc_compaction_drops_oldest_first(self, tmp_path):
        c = PointCache(cache_dir=str(tmp_path), max_bytes=600)
        for i in range(12):
            c._store("point", f"k{i:02d}", f"p{i:02d}", {"n": i})
        assert c.store_bytes <= 600
        assert 0 < c.n_entries < 12
        # survivors are the newest entries
        survivors = {json.loads(line)["key"] for line in
                     (tmp_path / "dse_point_cache.jsonl").read_text(
                     ).splitlines()}
        assert survivors == {f"k{i:02d}"
                             for i in range(12 - len(survivors), 12)}

    def test_compaction_is_reloadable(self, tmp_path):
        c = PointCache(cache_dir=str(tmp_path))
        for i in range(4):
            c._store("point", f"k{i}", f"p{i}", {"n": i})
        c._store("point", "k0b", "p0", {"n": 99})   # replaces k0
        c.compact()
        again = PointCache(cache_dir=str(tmp_path))
        assert again.n_entries == 4
        assert again._lookup("point", "k0b", "p0") == {"n": 99}


# ---------------------------------------------------------------------------
# Sweep integration: cold / warm / mixed
# ---------------------------------------------------------------------------


N_SMALL = len(SMALL_SPACE.points())


class TestSweepIntegration:
    @pytest.fixture()
    def store_dir(self, tmp_path):
        return str(tmp_path / "cache")

    def cold(self, store_dir, **kw):
        cache = PointCache(cache_dir=store_dir)
        return sweep(SMALL_SPACE, small_kernels, max_workers=1,
                     cache=cache, **kw), cache

    def test_cold_then_warm_counters_and_bytes(self, store_dir):
        cold_res, cold_cache = self.cold(store_dir)
        assert cold_cache.hits == 0
        assert cold_cache.misses == N_SMALL
        assert cold_cache.stores == N_SMALL
        warm_cache = PointCache(cache_dir=store_dir)
        warm_res = sweep(SMALL_SPACE, small_kernels, max_workers=1,
                         cache=warm_cache)
        assert warm_cache.hits == N_SMALL
        assert warm_cache.misses == 0 and warm_cache.stores == 0
        assert all(r.cached for r in warm_res.records)
        assert not any(r.cached for r in cold_res.records)
        assert warm_res.canonical_json() == cold_res.canonical_json()
        # cache metadata is volatile-scrubbed but present in raw JSON
        assert warm_res.meta["point_cache"]["hits"] == N_SMALL
        assert warm_res.to_json()["points"][0]["cached"] is True

    def test_byte_identity_vs_uncached_and_across_executors(
            self, store_dir):
        plain = sweep(SMALL_SPACE, small_kernels, max_workers=1)
        cold_res, _ = self.cold(store_dir, executor="serial")
        assert cold_res.canonical_json() == plain.canonical_json()
        for executor in ("thread", "process"):
            res, cache = self.cold(str(store_dir) + "_" + executor,
                                   executor=executor)
            assert cache.misses == N_SMALL, executor
            assert res.canonical_json() == plain.canonical_json(), \
                executor
        # warm resolve against the serial-cold store, via every executor
        for executor in ("serial", "thread", "process"):
            cache = PointCache(cache_dir=store_dir)
            res = sweep(SMALL_SPACE, small_kernels, max_workers=1,
                        cache=cache, executor=executor)
            assert cache.hits == N_SMALL, executor
            assert res.canonical_json() == plain.canonical_json(), \
                executor

    def test_one_axis_edit_recomputes_only_the_delta(self, store_dir):
        self.cold(store_dir)
        cache = PointCache(cache_dir=store_dir)
        res = sweep(SMALL_SPACE, edited8_kernels, max_workers=1,
                    cache=cache)
        n8 = sum(p.precision_bits == 8 for p in SMALL_SPACE.points())
        assert cache.hits == N_SMALL - n8       # 32-bit points warm
        assert cache.misses == n8               # 8-bit points recompute
        assert cache.invalidations == n8        # same point, new inputs
        assert cache.stores == n8
        by_prec = {r.point.precision_bits: r.cached for r in res.records}
        assert by_prec[32] is True and by_prec[8] is False
        # the store replaced the stale 8-bit entries, no growth
        assert cache.n_entries == N_SMALL
        # byte-identity against an uncached sweep of the edited inputs
        plain = sweep(SMALL_SPACE, edited8_kernels, max_workers=1)
        assert res.canonical_json() == plain.canonical_json()

    def test_space_growth_is_a_mixed_sweep(self, store_dir):
        self.cold(store_dir)
        grown = DesignSpace(lanes=(2, 4), precisions=(8, 32))
        cache = PointCache(cache_dir=store_dir)
        res = sweep(grown, small_kernels, max_workers=1, cache=cache)
        n_grown = len(grown.points())
        assert cache.hits == N_SMALL
        assert cache.misses == n_grown - N_SMALL
        plain = sweep(grown, small_kernels, max_workers=1)
        assert res.canonical_json() == plain.canonical_json()

    def test_version_bump_invalidates_everything(self, store_dir,
                                                 monkeypatch):
        self.cold(store_dir)
        from repro_torch.kvi.dse import cost
        monkeypatch.setattr(cost, "CALIBRATION_VERSION",
                            cost.CALIBRATION_VERSION + 1)
        cache = PointCache(cache_dir=store_dir)
        sweep(SMALL_SPACE, small_kernels, max_workers=1, cache=cache)
        assert cache.hits == 0
        assert cache.misses == N_SMALL
        assert cache.invalidations == N_SMALL

    def test_corrupted_entry_recomputed_in_sweep(self, store_dir):
        _, cold_cache = self.cold(store_dir)
        path = cold_cache.path
        with open(path) as f:
            lines = f.read().splitlines()
        bad = json.loads(lines[0])
        bad["payload"]["status"] = "tampered"
        lines[0] = json.dumps(bad)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        cache = PointCache(cache_dir=store_dir)
        res = sweep(SMALL_SPACE, small_kernels, max_workers=1,
                    cache=cache)
        assert cache.corrupt_discarded == 1
        assert cache.hits == N_SMALL - 1 and cache.misses == 1
        assert all(r.ok for r in res.records)

    def test_incompatible_points_cache_too(self, tmp_path):
        def big(precision_bits):
            img = np.arange(1024, dtype=np.int32).reshape(32, 32)
            return {"conv": conv2d_program(img, np.ones((3, 3), np.int32),
                                           elem_bytes=4)}
        pts = [DesignPoint("shared", 1, 1, 4, spm_kbytes=1,
                           precision_bits=32)]
        c1 = PointCache(cache_dir=str(tmp_path))
        a = sweep(pts, big, max_workers=1, cache=c1)
        assert a.records[0].status == "incompatible"
        c2 = PointCache(cache_dir=str(tmp_path))
        b = sweep(pts, big, max_workers=1, cache=c2)
        assert c2.hits == 1
        assert b.records[0].status == "incompatible"
        assert b.records[0].reason == a.records[0].reason


# ---------------------------------------------------------------------------
# Device measurement-class caching (on the CPU)
# ---------------------------------------------------------------------------


class TestDeviceCaching:
    def test_warm_resweep_resolves_device_classes(self, tmp_path):
        pts = [DesignPoint("shared", 1, 1, 4, measure_device=True),
               DesignPoint("sym_mimd", 3, 3, 4, measure_device=True)]
        c1 = PointCache(cache_dir=str(tmp_path))
        cold = sweep(pts, saxpy_kernels, max_workers=1, composite=False,
                     cache=c1, device="cpu")
        assert c1.device_misses == 1 and c1.device_hits == 0
        c2 = PointCache(cache_dir=str(tmp_path))
        warm = sweep(pts, saxpy_kernels, max_workers=1, composite=False,
                     cache=c2, device="cpu")
        assert c2.device_hits == 1 and c2.device_misses == 0
        assert c2.hits == 2 and c2.misses == 0
        # the cached class payload reproduces the walltime columns, the
        # classes' seconds and the deterministic compile-cache meta
        # exactly; only the stage's own wall time is this run's
        def stage(meta):
            return {k: v for k, v in meta["device"].items() if k != "wall_s"}
        assert stage(warm.meta) == stage(cold.meta)
        assert warm.meta["device"]["wall_s"] >= 0
        for a, b in zip(cold.records, warm.records):
            assert a.kernels["saxpy"]["device_walltime_s"] == \
                b.kernels["saxpy"]["device_walltime_s"]
            assert a.kernels["saxpy"]["kernel_launches"] == \
                b.kernels["saxpy"]["kernel_launches"]
        assert warm.canonical_json() == cold.canonical_json()

    def test_point_records_persist_without_device_columns(self, tmp_path):
        # device columns attach in the parent AFTER the point record is
        # stored: a later unmeasured sweep must not inherit them
        pts = [DesignPoint("shared", 1, 1, 4, measure_device=True)]
        c1 = PointCache(cache_dir=str(tmp_path))
        sweep(pts, saxpy_kernels, max_workers=1, composite=False,
              cache=c1, device="cpu")
        c2 = PointCache(cache_dir=str(tmp_path))
        plain = sweep([DesignPoint("shared", 1, 1, 4)], saxpy_kernels,
                      max_workers=1, composite=False, cache=c2)
        assert c2.hits == 1
        assert "kernel_launches" not in plain.records[0].kernels["saxpy"]


# ---------------------------------------------------------------------------
# Auto executor selection
# ---------------------------------------------------------------------------


class TestAutoExecutor:
    def test_resolve_auto_mapping(self):
        assert resolve_auto("auto", 0) == "serial"
        assert resolve_auto("auto", AUTO_SERIAL_MAX - 1) == "serial"
        assert resolve_auto("auto", AUTO_SERIAL_MAX) == "process"
        # explicit specs are authoritative, None keeps legacy behavior
        assert resolve_auto("thread", 1000) == "thread"
        assert resolve_auto("serial", 1000) == "serial"
        assert resolve_auto(None, 1000) is None
        ex = SerialExecutor()
        assert resolve_auto(ex, 1000) is ex

    def test_warm_auto_sweep_runs_serially(self, tmp_path):
        cache = PointCache(cache_dir=str(tmp_path))
        sweep(SMALL_SPACE, small_kernels, max_workers=1, cache=cache)
        warm_cache = PointCache(cache_dir=str(tmp_path))
        res = sweep(SMALL_SPACE, small_kernels, max_workers=4,
                    cache=warm_cache, executor="auto")
        assert warm_cache.hits == N_SMALL
        assert res.meta["executor"] == "serial"

    def test_small_cold_auto_sweep_runs_serially(self):
        # 6 uncached points < AUTO_SERIAL_MAX: no spawn-pool startup
        res = sweep(SMALL_SPACE, small_kernels, max_workers=4,
                    executor="auto")
        assert res.meta["executor"] == "serial"

    def test_large_cold_auto_sweep_picks_process(self):
        pts = DesignSpace(lanes=(2, 4), precisions=(8, 16, 32)).points()
        assert len(pts) >= AUTO_SERIAL_MAX
        res = sweep(pts, small_kernels, max_workers=2,
                    executor="auto")
        assert res.meta["executor"] == "process"


# ---------------------------------------------------------------------------
# The port's own: device class keys and the store's directory
# ---------------------------------------------------------------------------


class TestDeviceClassKeys:
    def test_class_measured_on_one_device_never_resolves_on_another(
            self):
        fps = {"saxpy": program_fingerprint(saxpy_kernels(32)["saxpy"])}
        keys = {device_class_key(fps, 32, None, 3, True, backend, name)
                for backend, name in (("torch", "cpu"),
                                      ("torch", "NVIDIA H100 80GB HBM3"),
                                      ("torch", "NVIDIA A100-SXM4-80GB"),
                                      ("other", "cpu"))}
        assert len(keys) == 4

    def test_cpu_class_does_not_resolve_a_class_of_another_device(
            self, tmp_path, monkeypatch):
        """A store holding a class measured under another device name
        misses on the CPU, and the two classes then live side by side
        (the label names the device)."""
        import importlib
        # the module (the package's ``sweep`` is the function)
        sweep_mod = importlib.import_module("repro_torch.kvi.dse.sweep")
        pts = [DesignPoint("shared", 1, 1, 4, measure_device=True)]
        c1 = PointCache(cache_dir=str(tmp_path))
        real = sweep_mod.device_class_key
        monkeypatch.setattr(
            sweep_mod, "device_class_key",
            lambda *a: real(*a[:-1], "NVIDIA H100 80GB HBM3"))
        sweep(pts, saxpy_kernels, max_workers=1, composite=False,
              cache=c1, device="cpu")
        monkeypatch.setattr(sweep_mod, "device_class_key", real)
        c2 = PointCache(cache_dir=str(tmp_path))
        sweep(pts, saxpy_kernels, max_workers=1, composite=False,
              cache=c2, device="cpu")
        assert (c2.device_hits, c2.device_misses) == (0, 1)
        assert c2.hits == 1

    def test_default_store_is_the_ports_own(self, monkeypatch, tmp_path):
        from repro.kvi.dse.pointcache import \
            default_cache_dir as r_default_cache_dir

        from repro_torch.kvi.dse import default_cache_dir
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
        assert default_cache_dir() == str(tmp_path / "klessydra-dse-torch")
        assert default_cache_dir() != r_default_cache_dir()
        assert PointCache().cache_dir == default_cache_dir()

    def test_stats_name_device_counters(self, tmp_path):
        stats = PointCache(cache_dir=str(tmp_path)).stats
        assert {"device_hits", "device_misses"} <= set(stats)
        assert not any("pallas" in k for k in stats)
