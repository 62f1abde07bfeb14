"""The port's telemetry layer (``repro_torch.kvi.obs``): every test of the
reference's ``tests/kvi/test_obs.py`` run on the port (tracer and Chrome
export, metrics registry, trace schema, the shared scrubber, cycle-sim
trace integrity, determinism, the disabled path's 2 % bound, serving's
view-vs-report cross-checks, the SVG charts, the DSE sweep's telemetry
and plots); the scrubber's DSE set held to the reference's under the
walltime stage's renaming; then the port
against the reference (``repro.kvi.obs``) on the same numpy-seeded
inputs:

  * cycle-sim traces of conv 8x8 F 3, FFT-32 and matmul 8 (each on 3
    harts) and their composite, chaining off and on: canonical traces
    byte-equal, metrics snapshots equal;
  * the smoke serving stream through both CLIs with ``--trace-out`` /
    ``--metrics-out`` (the reference's Pallas backend in interpret mode,
    once, in a module fixture; the port's ``TorchBackend`` on the CPU):
    canonical traces byte-equal (the backend's own track named after
    its backend), ``serving.*`` / ``scheduler.*`` equal, the backend
    counters the reference's ``pallas.*``; ``view`` of the port's files
    the reference's of its files;
  * the disabled path of ``TorchBackend`` on the CPU within 2 %.
"""
import contextlib
import copy
import io
import json
import sys
import time

import numpy as np
import pytest

import repro.kvi.programs as rprog
from repro.kvi import KviWorkload as RWorkload
from repro.kvi.cyclesim import CycleSimBackend as RCycleSim
from repro.kvi.obs import Obs as RObs
from repro.kvi.obs import canonical_trace as r_canonical_trace
from repro.kvi.obs.__main__ import view as r_view
from repro.kvi.obs.svg import line_chart as r_line_chart
from repro.kvi.obs.svg import scatter_chart as r_scatter_chart
from repro.kvi.serving.__main__ import main as r_serve_main

import repro_torch.kvi as tk
from repro_torch.kvi.cyclesim import CycleSimBackend
from repro_torch.kvi.dse import (DesignSpace, build_report,
                                 render_markdown, sweep)
from repro_torch.kvi.obs import (DSE_VOLATILE, NULL_METRICS, NULL_OBS,
                                 NULL_TRACER, SERVE_VOLATILE,
                                 MetricsRegistry, Obs, Tracer,
                                 canonical_trace, scrub, validate_metrics,
                                 validate_trace)
from repro_torch.kvi.obs.__main__ import flow_summary, stall_attribution, view
from repro_torch.kvi.obs.svg import line_chart, scatter_chart
from repro_torch.kvi.programs import conv2d_program, fft_program
from repro_torch.kvi.serving import (SMOKE_MIX, ServeEngine,
                                     canonical_report, make_templates,
                                     poisson_arrivals)
from repro_torch.kvi.serving.__main__ import main as serve_main
from repro_torch.kvi.torch_backend import TorchBackend
from repro_torch.kvi.workload import KviWorkload

#: the smoke stream both CLIs serve with a backend and telemetry
SMOKE_ARGS = ["--smoke", "--requests", "16", "--canonical"]


def _track_names(trace):
    """(pid, tid) -> (process, lane) from the metadata events."""
    procs, lanes = {}, {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") != "M":
            continue
        if ev["name"] == "process_name":
            procs[ev["pid"]] = ev["args"]["name"]
        else:
            lanes[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    return {k: (procs[k[0]], v) for k, v in lanes.items()}


def _small_prog(seed=3):
    rng = np.random.default_rng(seed)
    img = rng.integers(-8, 8, (8, 8)).astype(np.int32)
    filt = rng.integers(-4, 4, (3, 3)).astype(np.int32)
    return conv2d_program(img, filt, shift=2)


def _canon(trace):
    return json.dumps(canonical_trace(trace), sort_keys=True)


# ---------------------------------------------------------------------------
# Tracer + Chrome export
# ---------------------------------------------------------------------------


class TestTracer:
    def test_export_shape_and_metadata(self):
        tr = Tracer()
        tr.span(("sim", "hart0"), "vadd", 0, 4, args={"engine": "mfu"})
        tr.instant(("sim", "hart0"), "mark", 2)
        tr.counter(("sim", "queue"), "depth", 1, {"n": 3})
        tr.flow_start(("serve", "arrivals"), "req0", 0, 7)
        tr.flow_end(("serve", "hart1"), "req0", 9, 7)
        trace = tr.to_chrome()
        assert trace["displayTimeUnit"] == "ms"
        assert validate_trace(trace) == []
        names = _track_names(trace)
        assert ("sim", "hart0") in names.values()
        assert ("serve", "arrivals") in names.values()
        # pids/tids are stable 1-based first-use ids
        assert sorted({ev["pid"] for ev in trace["traceEvents"]}) == [1, 2]

    def test_events_sorted_per_track(self):
        tr = Tracer()
        tr.span(("p", "l"), "b", 10, 1)
        tr.span(("p", "l"), "a", 0, 1)
        trace = tr.to_chrome()
        xs = [ev["ts"] for ev in trace["traceEvents"]
              if ev["ph"] == "X"]
        assert xs == sorted(xs)
        assert validate_trace(trace) == []

    def test_null_tracer_collects_nothing(self):
        assert NULL_TRACER.enabled is False
        NULL_TRACER.span(("p", "l"), "x", 0, 1)
        NULL_TRACER.flow_start(("p", "l"), "x", 0, 1)
        assert NULL_TRACER.events == []
        assert NULL_TRACER.wall_us() == 0.0

    def test_obs_bundle_enable_states(self):
        assert NULL_OBS.enabled is False
        assert Obs().enabled is False
        live = Obs.on()
        assert live.enabled is True
        assert live.tracer is not Obs.on().tracer

    def test_canonical_trace_drops_wall_and_scrubs(self):
        tr = Tracer()
        tr.span(("p", "l"), "cyc", 0, 4, args={"wall_s": 1.25, "n": 2})
        t0 = tr.wall_us()
        tr.wall_span(("p", "wall"), "compile", t0)
        trace = tr.to_chrome()
        assert any(ev.get("clock") == "wall"
                   for ev in trace["traceEvents"])
        canon = canonical_trace(trace)
        evs = [ev for ev in canon["traceEvents"] if ev["ph"] != "M"]
        assert all(ev["clock"] != "wall" for ev in evs)
        assert all("wall_s" not in ev.get("args", {}) for ev in evs)
        assert any(ev.get("args", {}).get("n") == 2 for ev in evs)


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------


class TestMetrics:
    def test_counter_gauge_roundtrip(self):
        m = MetricsRegistry()
        m.counter("a.b").inc()
        m.counter("a.b").inc(3)
        m.gauge("g").set(17)
        snap = m.snapshot()
        assert snap["schema"] == "kvi-metrics-v1"
        assert snap["counters"] == {"a.b": 4}
        assert snap["gauges"] == {"g": 17}
        assert validate_metrics(snap) == []

    def test_histogram_percentiles_match_raw_nearest_rank(self):
        rng = np.random.default_rng(5)
        xs = rng.integers(0, 500, 237).tolist()
        m = MetricsRegistry()
        h = m.histogram("lat")
        for x in xs:
            h.observe(x)
        arr = np.sort(np.asarray(xs))

        def rank(q):
            return int(arr[min(len(arr) - 1,
                               max(0, int(np.ceil(q * len(arr))) - 1))])

        s = h.summary()
        assert s["count"] == len(xs)
        assert s["sum"] == sum(xs)
        assert (s["p50"], s["p95"], s["p99"]) == \
            (rank(0.50), rank(0.95), rank(0.99))
        assert validate_metrics(m.snapshot()) == []

    def test_absorb_skips_non_ints_and_bools(self):
        m = MetricsRegistry()
        m.absorb("cache", {"hits": 5, "misses": 2, "rate": 0.7,
                           "warm": True, "label": "x"})
        snap = m.snapshot()
        assert snap["counters"] == {"cache.hits": 5, "cache.misses": 2}

    def test_null_metrics_allocates_nothing(self):
        assert NULL_METRICS.enabled is False
        c = NULL_METRICS.counter("x")
        c.inc(100)
        assert c is NULL_METRICS.histogram("y")
        assert NULL_METRICS.snapshot()["counters"] == {}

    def test_validate_metrics_negatives(self):
        assert validate_metrics([]) == ["snapshot is not a dict"]
        assert validate_metrics({"schema": "nope"})
        bad = {"schema": "kvi-metrics-v1", "counters": {"c": -1},
               "gauges": {}, "histograms": {}}
        assert any("non-negative" in e for e in validate_metrics(bad))
        bad = {"schema": "kvi-metrics-v1", "counters": {}, "gauges": {},
               "histograms": {"h": {"count": 3, "sum": 1, "min": 0,
                                    "max": 1, "p50": 0, "p95": 1,
                                    "p99": 1, "buckets": {"0": 1}}}}
        assert any("bucket total" in e for e in validate_metrics(bad))


# ---------------------------------------------------------------------------
# Trace schema validation (negatives)
# ---------------------------------------------------------------------------


def _valid_trace():
    tr = Tracer()
    tr.span(("p", "l"), "a", 0, 4)
    tr.counter(("p", "l"), "c", 2, {"v": 1})
    tr.flow_start(("p", "l"), "r", 1, 7)
    tr.flow_end(("p", "l2"), "r", 3, 7)
    return tr.to_chrome()


class TestSchemaNegatives:
    def test_base_is_valid(self):
        assert validate_trace(_valid_trace()) == []

    def _first(self, trace, ph):
        return next(ev for ev in trace["traceEvents"] if ev["ph"] == ph)

    def test_unknown_phase(self):
        t = copy.deepcopy(_valid_trace())
        self._first(t, "X")["ph"] = "Z"
        assert any("unknown phase" in e for e in validate_trace(t))

    def test_unknown_clock(self):
        t = copy.deepcopy(_valid_trace())
        self._first(t, "X")["clock"] = "lunar"
        assert any("unknown clock" in e for e in validate_trace(t))

    def test_non_integral_cycle_ts(self):
        t = copy.deepcopy(_valid_trace())
        self._first(t, "X")["ts"] = 0.5
        assert any("not integral" in e for e in validate_trace(t))

    def test_x_without_dur(self):
        t = copy.deepcopy(_valid_trace())
        del self._first(t, "X")["dur"]
        assert any("needs dur" in e for e in validate_trace(t))

    def test_decreasing_ts_on_track(self):
        t = copy.deepcopy(_valid_trace())
        self._first(t, "X")["ts"] = 99      # X sits first on its track
        assert any("decreases" in e for e in validate_trace(t))

    def test_flow_without_end(self):
        t = copy.deepcopy(_valid_trace())
        t["traceEvents"] = [ev for ev in t["traceEvents"]
                            if ev["ph"] != "f"]
        assert any("exactly one start" in e for e in validate_trace(t))

    def test_counter_without_numeric_args(self):
        t = copy.deepcopy(_valid_trace())
        self._first(t, "C")["args"] = {"v": "high"}
        assert any("counter args" in e for e in validate_trace(t))

    def test_unbalanced_be(self):
        t = copy.deepcopy(_valid_trace())
        t["traceEvents"].append({"ph": "B", "pid": 1, "tid": 1,
                                 "name": "open", "ts": 5,
                                 "clock": "cycles"})
        assert any("unclosed" in e for e in validate_trace(t))


# ---------------------------------------------------------------------------
# The shared scrubber
# ---------------------------------------------------------------------------


class TestScrub:
    def test_sweep_aliases_point_at_shared_sets(self):
        from repro_torch.kvi.dse.sweep import VOLATILE_KEYS, scrub_volatile
        assert VOLATILE_KEYS is DSE_VOLATILE
        obj = {"wall_s": 1.0, "cycles": 5,
               "meta": {"executor": "thread", "n": 2}}
        assert scrub_volatile(obj) == scrub(obj, DSE_VOLATILE) == \
            {"cycles": 5, "meta": {"n": 2}}

    def test_dse_sets_are_the_references_renamed(self):
        """The reference's DSE set with the walltime stage's
        ``pallas_*`` names as ``device_*`` and the device's name added;
        the serving and trace sets unchanged."""
        import repro.kvi.obs.scrub
        rscrub = sys.modules["repro.kvi.obs.scrub"]
        renamed = {k.replace("pallas_", "device_")
                   for k in rscrub.DSE_VOLATILE}
        assert DSE_VOLATILE == renamed | {"device_name"}
        assert SERVE_VOLATILE - DSE_VOLATILE == \
            rscrub.SERVE_VOLATILE - rscrub.DSE_VOLATILE
        assert not any("pallas" in k for k in DSE_VOLATILE)

    def test_serve_volatile_extends_dse(self):
        assert DSE_VOLATILE < SERVE_VOLATILE
        assert "req_per_s" in SERVE_VOLATILE

    def test_scrub_recurses_into_lists(self):
        obj = {"rows": [{"wall_s": 1, "d": 2}, {"cached": True, "d": 3}]}
        assert scrub(obj) == {"rows": [{"d": 2}, {"d": 3}]}


# ---------------------------------------------------------------------------
# Cyclesim trace integrity
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sim_traced():
    obs = Obs.on()
    wl = KviWorkload.replicate(_small_prog(), 3)
    res = CycleSimBackend(obs=obs).run_workload(wl, functional=False)
    return obs, res


class TestCycleSimTrace:
    def test_trace_validates(self, sim_traced):
        obs, _ = sim_traced
        assert validate_trace(obs.tracer.to_chrome()) == []
        assert validate_metrics(obs.metrics.snapshot()) == []

    def test_spans_reproduce_hartstats_breakdown(self, sim_traced):
        """Per scheme per hart: emitted stall spans sum to
        ``stall_cycles``, idle spans to ``idle_cycles`` — so busy
        follows from the busy+stall+idle == total invariant."""
        obs, res = sim_traced
        trace = obs.tracer.to_chrome()
        names = _track_names(trace)
        sums = {}                       # (scheme, hart) -> {cat: cycles}
        for ev in trace["traceEvents"]:
            if ev["ph"] != "X":
                continue
            proc, lane = names[(ev["pid"], ev["tid"])]
            if not proc.startswith("cyclesim:") or \
                    not lane.startswith("hart"):
                continue
            key = (proc[len("cyclesim:"):], int(lane[4:]))
            d = sums.setdefault(key, {})
            d[ev["cat"]] = d.get(ev["cat"], 0) + ev["dur"]
            assert 0 <= ev["ts"] <= ev["ts"] + ev["dur"] <= \
                res.timing[key[0]].cycles
        assert sums, "no cyclesim hart spans emitted"
        for scheme, sim in res.timing.items():
            for h, st in enumerate(sim.per_hart):
                d = sums.get((scheme, h), {})
                assert d.get("stall", 0) == st.stall_cycles, (scheme, h)
                assert d.get("idle", 0) == st.idle_cycles, (scheme, h)

    def test_fu_hold_lanes_present(self, sim_traced):
        obs, _ = sim_traced
        names = _track_names(obs.tracer.to_chrome())
        assert any(lane.startswith("fu:") for _, lane in names.values())

    def test_metrics_match_simresult(self, sim_traced):
        obs, res = sim_traced
        snap = obs.metrics.snapshot()
        for scheme, sim in res.timing.items():
            assert snap["counters"][f"cyclesim.{scheme}.instructions"] \
                == sum(h.instructions for h in sim.per_hart)
            assert snap["gauges"][f"cyclesim.{scheme}.cycles"] \
                == sim.cycles

    def test_canonical_trace_deterministic(self):
        def once():
            obs = Obs.on()
            wl = KviWorkload.replicate(_small_prog(), 3)
            CycleSimBackend(obs=obs).run_workload(wl, functional=False)
            return _canon(obs.tracer.to_chrome())
        assert once() == once()

    def test_disabled_path_allocates_nothing(self):
        wl = KviWorkload.replicate(_small_prog(), 3)
        CycleSimBackend(obs=NULL_OBS).run_workload(wl, functional=False)
        assert NULL_TRACER.events == []
        assert NULL_OBS.metrics.snapshot()["counters"] == {}

    def test_disabled_overhead_within_2pct(self):
        """obs=None (the uninstrumented path) vs obs=NULL_OBS (the
        disabled bundle): both skip the recorder entirely, so their
        runtimes must agree within the pinned 2% bound — the least of
        15 back-to-back paired ratios, each side batching several runs
        (the reference's measurement)."""
        wl = KviWorkload.replicate(_small_prog(), 3)
        assert min(_paired_ratios(CycleSimBackend(),
                                  CycleSimBackend(obs=NULL_OBS),
                                  lambda b: b.run_workload(
                                      wl, functional=False))) <= 1.02


def _paired_ratios(base, nul, run, pairs=15, batch=10):
    """``pairs`` ratios of ``batch`` runs of ``nul`` over ``batch`` runs
    of ``base``, back to back, after one warm run each."""
    for b in (base, nul):
        run(b)

    def sample(backend):
        t0 = time.perf_counter()
        for _ in range(batch):
            run(backend)
        return time.perf_counter() - t0

    return [sample(nul) / sample(base) for _ in range(pairs)]


# ---------------------------------------------------------------------------
# Serving telemetry: flows, view-vs-report, byte-identity
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def templates():
    return make_templates(SMOKE_MIX, smoke=True, seed=0)


@pytest.fixture(scope="module")
def specs(templates):
    return poisson_arrivals(templates, 24, 80.0, n_clients=40, seed=0)


@pytest.fixture(scope="module")
def served(templates, specs):
    obs = Obs.on()
    engine = ServeEngine(templates, n_harts=3, backend=None, seed=0,
                         obs=obs)
    report = engine.run(specs)
    return obs, report


class TestServingTelemetry:
    def test_trace_and_metrics_validate(self, served):
        obs, _ = served
        assert validate_trace(obs.tracer.to_chrome()) == []
        assert validate_metrics(obs.metrics.snapshot()) == []

    def test_view_reproduces_report(self, served, tmp_path):
        """``obs view`` recomputes makespan and latency percentiles from
        the flow events alone, matching the engine's report exactly."""
        obs, report = served
        path = tmp_path / "kvi_trace.json"
        obs.tracer.save(str(path))
        summary = view(str(path), out=lambda *_: None)
        assert summary["requests"] == \
            report["throughput"]["requests"]
        assert summary["makespan_cycles"] == \
            report["throughput"]["makespan_cycles"]
        for q in ("p50", "p95", "p99", "mean", "max"):
            assert summary["latency_cycles"][q] == \
                report["latency_cycles"][q], q

    def test_flow_summary_counts_every_request(self, served, specs):
        obs, _ = served
        flows = flow_summary(obs.tracer.to_chrome()["traceEvents"])
        assert flows["requests"] == len(specs)

    def test_scheduler_ticket_spans_present(self, served):
        obs, _ = served
        names = _track_names(obs.tracer.to_chrome())
        harts = {lane for proc, lane in names.values()
                 if proc == "scheduler"}
        assert {"hart0", "hart1", "hart2"} <= harts

    def test_latency_histogram_matches_report(self, served, specs):
        obs, report = served
        h = obs.metrics.snapshot()["histograms"]["serving.latency_cycles"]
        assert h["count"] == len(specs)
        assert h["p99"] == report["latency_cycles"]["p99"]

    def test_canonical_report_byte_identical_with_obs(self, templates,
                                                      specs, served):
        _, traced_report = served
        plain = ServeEngine(templates, n_harts=3, backend=None,
                            seed=0).run(specs)
        assert canonical_report(plain) == canonical_report(traced_report)

    def test_repeated_runs_keep_flow_ids_unique(self, templates, specs):
        obs = Obs.on()
        engine = ServeEngine(templates, n_harts=3, backend=None, seed=0,
                             obs=obs)
        engine.run(specs)
        engine.run(specs)
        assert validate_trace(obs.tracer.to_chrome()) == []
        flows = flow_summary(obs.tracer.to_chrome()["traceEvents"])
        assert flows["requests"] == 2 * len(specs)

    def test_stall_attribution_rows_sorted(self, sim_traced):
        obs, _ = sim_traced
        rows = stall_attribution(obs.tracer.to_chrome()["traceEvents"])
        durs = [d for _, d, _ in rows]
        assert durs == sorted(durs, reverse=True)


# ---------------------------------------------------------------------------
# SVG plots
# ---------------------------------------------------------------------------

SERIES = {"shared/8b": [(2, 1.0), (8, 3.1)],
          "sym_mimd/8b": [(2, 1.0), (8, 3.9)]}


def _tiny_kernels(precision_bits):
    eb = precision_bits // 8
    rng = np.random.default_rng(11)
    img = rng.integers(-8, 8, (8, 8)).astype(np.int32)
    filt = rng.integers(-4, 4, (3, 3)).astype(np.int32)
    return {
        "conv": conv2d_program(img, filt, shift=2, elem_bytes=eb),
        "fft": fft_program(rng.integers(-64, 64, 32).astype(np.int32),
                           rng.integers(-64, 64, 32).astype(np.int32),
                           elem_bytes=eb),
    }


TINY_SPACE = DesignSpace(lanes=(2, 8), precisions=(8,))


@pytest.fixture(scope="module")
def tiny_obs_sweep():
    obs = Obs.on()
    lines = []
    result = sweep(TINY_SPACE, _tiny_kernels, max_workers=1,
                   executor="serial", emit=lines.append, obs=obs,
                   progress_every=1)
    return obs, lines, result


class TestSweepTelemetry:
    def test_progress_lines_stream_per_point(self, tiny_obs_sweep):
        _, lines, result = tiny_obs_sweep
        prog = [ln for ln in lines if ln.startswith("progress ")]
        n = len(result.records)
        assert len(prog) == n
        assert f"{n}/{n} fresh points" in prog[-1]
        assert "pts/s" in prog[-1] and "eta" in prog[-1]

    def test_quiet_suppresses_progress(self):
        result = sweep(TINY_SPACE.points()[:1], _tiny_kernels,
                       max_workers=1, executor="serial", emit=None,
                       progress_every=1)
        assert result.records[0].ok

    def test_sweep_trace_and_metrics(self, tiny_obs_sweep):
        obs, _, result = tiny_obs_sweep
        trace = obs.tracer.to_chrome()
        assert validate_trace(trace) == []
        snap = obs.metrics.snapshot()
        assert validate_metrics(snap) == []
        assert snap["counters"]["dse.points"] == len(result.records)
        names = _track_names(trace)
        assert ("dse", "points") in names.values()

    def test_canonical_json_byte_identical_with_obs(self, tiny_obs_sweep):
        _, _, traced = tiny_obs_sweep
        plain = sweep(TINY_SPACE, _tiny_kernels, max_workers=1,
                      executor="serial")
        assert plain.canonical_json() == traced.canonical_json()


class TestSvgPlots:
    def test_write_plots_and_markdown_links(self, tiny_obs_sweep,
                                            tmp_path):
        from repro_torch.kvi.dse.plots import write_plots
        _, _, result = tiny_obs_sweep
        report = build_report(result)
        plots = write_plots(result, report, str(tmp_path))
        assert plots, "no figures written"
        for kern, files in plots.items():
            for fname in files:
                body = (tmp_path / fname).read_text()
                assert body.startswith("<svg"), fname
        md = render_markdown(report, plots=plots)
        fname = next(iter(plots.values()))[0]
        assert f"]({fname})" in md

    def test_line_chart_deterministic_svg(self):
        svg = line_chart("t", "D", "speedup", SERIES, log_x=True)
        assert svg.startswith("<svg")
        assert "shared/8b" in svg and "sym_mimd/8b" in svg
        assert svg == line_chart("t", "D", "speedup", SERIES, log_x=True)

    def test_scatter_chart_with_front(self):
        svg = scatter_chart("t", "area", "cycles",
                            {"shared": [(10, 100), (20, 60)]},
                            front=[(10, 100), (20, 60)])
        assert "pareto front" in svg

    @pytest.mark.parametrize("log_x", [False, True])
    def test_charts_equal_the_reference_byte_for_byte(self, log_x):
        assert line_chart("t", "D", "speedup", SERIES, log_x=log_x) == \
            r_line_chart("t", "D", "speedup", SERIES, log_x=log_x)
        pts = {"shared": [(10, 100), (20, 60)], "het": [(15, 70)]}
        front = [(10, 100), (15, 70)]
        assert scatter_chart("t", "area", "cycles", pts, front=front) == \
            r_scatter_chart("t", "area", "cycles", pts, front=front)


# ---------------------------------------------------------------------------
# The port against the reference: cycle-sim traces
# ---------------------------------------------------------------------------


def _paper_programs(mod):
    """conv 8x8 F 3, FFT-32 and matmul 8 from ``mod`` (the reference's
    or the port's ``kvi.programs``) on the same numpy inputs."""
    rng = np.random.default_rng(21)
    img = rng.integers(-8, 8, (8, 8)).astype(np.int32)
    filt = rng.integers(-4, 4, (3, 3)).astype(np.int32)
    re, im = (rng.integers(-64, 64, 32).astype(np.int32) for _ in range(2))
    a, b = (rng.integers(-16, 16, (8, 8)).astype(np.int32)
            for _ in range(2))
    return {"conv": mod.conv2d_program(img, filt, shift=2),
            "fft": mod.fft_program(re, im),
            "matmul": mod.matmul_program(a, b, shift=2)}


def _workload(W, progs, kind):
    if kind == "composite":
        return W.composite({h: [progs[k]] for h, k in
                            enumerate(("conv", "fft", "matmul"))})
    return W.replicate(progs[kind], 3)


@pytest.mark.parametrize("chaining", [False, True])
@pytest.mark.parametrize("kind", ["conv", "fft", "matmul", "composite"])
def test_cyclesim_trace_equals_the_reference(kind, chaining):
    """The same workload through both cycle-sim backends with a live
    bundle (the default pass pipeline, chaining off or on): canonical
    traces byte for byte, metrics snapshots and cycles equal."""
    rprogs = _paper_programs(rprog)
    tprogs = {k: tk.program_from_reference(p) for k, p in rprogs.items()}
    robs, tobs = RObs.on(), Obs.on()
    want = RCycleSim(obs=robs, chaining=chaining).run_workload(
        _workload(RWorkload, rprogs, kind))
    got = CycleSimBackend(obs=tobs, chaining=chaining).run_workload(
        _workload(KviWorkload, tprogs, kind))
    assert got.cycles == want.cycles
    trace = tobs.tracer.to_chrome()
    assert validate_trace(trace) == []
    assert _canon(trace) == json.dumps(
        r_canonical_trace(robs.tracer.to_chrome()), sort_keys=True)
    assert tobs.metrics.snapshot() == robs.metrics.snapshot()


# ---------------------------------------------------------------------------
# The port against the reference: serving through both CLIs
# ---------------------------------------------------------------------------


def _serve_cli(fn, out_dir, extra=()):
    """Run one serving CLI on the smoke stream with both telemetry flags;
    returns (report text, trace, metrics snapshot, their paths)."""
    paths = {k: str(out_dir / f"kvi_{k}.json") for k in ("trace",
                                                         "metrics")}
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = fn(SMOKE_ARGS + list(extra) + ["--trace-out", paths["trace"],
                                            "--metrics-out",
                                            paths["metrics"]])
    assert rc == 0
    with open(paths["trace"]) as f:
        trace = json.load(f)
    with open(paths["metrics"]) as f:
        snap = json.load(f)
    return out.getvalue(), trace, snap, paths


@pytest.fixture(scope="module")
def reference_served(tmp_path_factory):
    """The reference CLI on the smoke stream with its Pallas backend
    (interpret mode) and both telemetry flags, once a module."""
    return _serve_cli(r_serve_main, tmp_path_factory.mktemp("ref"))


@pytest.fixture(scope="module")
def port_served(tmp_path_factory):
    return _serve_cli(serve_main, tmp_path_factory.mktemp("port"),
                      extra=("--device", "cpu"))


def _backend_as_torch(trace):
    """The reference trace with its backend's track named as the port's
    (``pallas`` -> ``torch``): the one name that tells the two apart."""
    trace = copy.deepcopy(trace)
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "M" and ev["name"] == "process_name" and \
                ev["args"]["name"] == "pallas":
            ev["args"]["name"] = "torch"
    return trace


def test_served_trace_equals_the_reference(reference_served, port_served):
    report, trace, snap, _ = port_served
    want_report, want_trace, want_snap, _ = reference_served
    assert validate_trace(trace) == [] and validate_metrics(snap) == []
    assert json.loads(report)["engine"].pop("backend") == "torch"
    assert _canon(trace) == json.dumps(
        r_canonical_trace(_backend_as_torch(want_trace)), sort_keys=True)
    assert flow_summary(trace["traceEvents"])["requests"] == 16
    # one wall span a backend run, as the reference's
    spans = [ev for ev in trace["traceEvents"]
             if ev.get("name") == "run_workload"]
    assert len(spans) == snap["counters"]["torch.runs"] == \
        want_snap["counters"]["pallas.runs"]
    assert [ev["args"]["kernel_launches"] for ev in spans] == [
        ev["args"]["pallas_calls"] for ev in want_trace["traceEvents"]
        if ev.get("name") == "run_workload"]
    assert all(ev["args"]["walk_launches"] == 0 for ev in spans)


def test_served_metrics_equal_the_reference(reference_served, port_served):
    """``serving.*`` and ``scheduler.*`` equal; the backend's counters
    the reference's under the port's names (``pallas.calls`` is
    ``torch.kernel_launches``); no walk launch on the CPU."""
    snap, want = port_served[2], reference_served[2]
    for section in ("counters", "gauges", "histograms"):
        mine = {k: v for k, v in snap[section].items()
                if k.split(".")[0] in ("serving", "scheduler")}
        theirs = {k: v for k, v in want[section].items()
                  if k.split(".")[0] in ("serving", "scheduler")}
        assert mine == theirs, section
    c, rc = snap["counters"], want["counters"]
    assert c["serving.requests"] == c["scheduler.admitted"] == 16
    assert (c["torch.runs"], c["torch.kernel_launches"],
            c["torch.compile_cache.hits"], c["torch.compile_cache.misses"]
            ) == (rc["pallas.runs"], rc["pallas.calls"],
                  rc["pallas.compile_cache.hits"],
                  rc["pallas.compile_cache.misses"])
    assert c["torch.walk_launches"] == 0
    assert snap["histograms"]["torch.run_wall_s"]["count"] == \
        c["torch.runs"]


def test_view_of_the_port_equals_the_reference(reference_served,
                                               port_served):
    """``view`` of the port's trace prints what the reference's prints of
    its own (the file's path aside), and the same summary."""
    printed = {}
    for tag, fn, served_ in (("port", view, port_served),
                             ("ref", r_view, reference_served)):
        lines = []
        path = served_[3]["trace"]
        summary = fn(path, out=lines.append)
        printed[tag] = ([ln.replace(path, "TRACE") for ln in lines],
                        summary)
    assert printed["port"] == printed["ref"]
    assert printed["port"][1]["requests"] == 16


def test_obs_cli_validates_and_views_the_served_files(port_served,
                                                      capsys):
    from repro_torch.kvi.obs.__main__ import main as obs_main
    _, trace, _, paths = port_served
    assert obs_main(["validate", paths["trace"], "--metrics",
                     paths["metrics"]]) == 0
    assert capsys.readouterr().out.rstrip().endswith("OK")
    assert obs_main(["view", paths["trace"], "--metrics",
                     paths["metrics"]]) == 0
    out = capsys.readouterr().out
    flows = flow_summary(trace["traceEvents"])
    assert f"makespan={flows['makespan_cycles']} cycles" in out
    assert "counter torch.walk_launches = 0" in out


# ---------------------------------------------------------------------------
# The disabled path of the torch backend
# ---------------------------------------------------------------------------


def test_torch_backend_disabled_overhead_within_2pct():
    """``TorchBackend(obs=NULL_OBS)`` against ``obs=None`` on the CPU
    (the walk's plain version): the least of 15 paired ratios within the
    2 % bound, and nothing recorded."""
    wl = KviWorkload.replicate(_small_prog(), 3)
    ratios = _paired_ratios(TorchBackend(device="cpu", passes=()),
                            TorchBackend(device="cpu", passes=(),
                                         obs=NULL_OBS),
                            lambda b: b.run_workload(wl))
    assert min(ratios) <= 1.02, ratios
    assert NULL_TRACER.events == []


def test_torch_backend_span_args_equal_meta():
    """One live bundle over repeated runs: one wall span a run on the
    ``("torch", "run_workload")`` track, never stepping back in time,
    its args the run's ``meta``; the counters sum over the runs."""
    obs = Obs.on()
    be = TorchBackend(device="cpu", passes=(), obs=obs)
    wls = [KviWorkload.replicate(_small_prog(s), 3) for s in (1, 2)]
    metas = [be.run_workload(wls[i % 2]).meta for i in range(4)]
    trace = obs.tracer.to_chrome()
    assert validate_trace(trace) == []
    spans = [ev for ev in trace["traceEvents"] if ev["ph"] == "X"]
    assert {_track_names(trace)[(ev["pid"], ev["tid"])]
            for ev in spans} == {("torch", "run_workload")}
    assert [ev["args"] for ev in spans] == [
        {"entries": 3, "groups": 1, "kernel_launches": m["kernel_launches"],
         "walk_launches": 0} for m in metas]
    assert all(ev["clock"] == "wall" and ev["cat"] == "wall"
               for ev in spans)
    c = obs.metrics.snapshot()["counters"]
    assert c["torch.runs"] == 4
    assert c["torch.kernel_launches"] == sum(m["kernel_launches"]
                                             for m in metas)
    assert (c["torch.compile_cache.hits"], c["torch.compile_cache.misses"]
            ) == tuple(sum(m["compile_cache"][k] for m in metas)
                       for k in ("hits", "misses"))


def test_chip_smoke_telemetry_phase_rehearsed_on_the_cpu(capsys):
    """``chip_smoke.run_telemetry`` (phase 3t) on the CPU: a 64th of the
    main-path batches and 32 requests of the default stream, one round;
    every check of the phase holds and its ``[telemetry]`` line is
    printed."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(0)
    workloads = [(name, wl) for name, wl, _ in
                 smoke.main_path_workloads(rng, scale=64)]
    be = TorchBackend(device="cpu", passes=())
    rec = smoke.run_telemetry("cpu", 0, workloads, be, requests=32,
                              rounds=1, gate_rounds=4)
    assert (rec["flows"], rec["walk_launches"]) == (32, 0)
    assert rec["backend_runs"] == len(workloads) == 7
    assert rec["events"] > 0 and rec["trace_bytes"] > 0
    assert rec["disabled_ratio"] <= smoke.TELEMETRY_GATE["bound"]
    assert rec["disabled_interleaved_median"] > 0
    assert rec["control_interleaved_median"] > 0
    assert "disabled_gate" not in rec
    assert be.obs is None
    assert capsys.readouterr().out.count("[telemetry]") == 1
