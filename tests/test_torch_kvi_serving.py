"""The port's request-driven KVI server (``repro_torch.kvi.serving``)
against the reference's (``repro.kvi.serving``): the same templates,
request instances, arrivals and buckets under the same seeds; schedule-
only reports byte for byte; with ``TorchBackend(device="cpu")`` the
reference Pallas run's canonical report, launch-record cache counts
included; outputs equal to the MFU oracle; and the CLI, its telemetry
files included.

The reference's Pallas run (interpret mode on the CPU, about 16 s) is
made once, through its CLI, by a module-scoped fixture."""
import contextlib
import dataclasses
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kvi import get_backend as r_backend
from repro.kvi.obs import canonical_trace as r_canonical_trace
from repro.kvi.serving import DEFAULT_MIX as R_DEFAULT_MIX
from repro.kvi.serving import SMOKE_MIX as R_SMOKE_MIX
from repro.kvi.serving import ServeEngine as RServeEngine
from repro.kvi.serving import bucket_sizes as r_bucket_sizes
from repro.kvi.serving import canonical_report as r_canonical
from repro.kvi.serving import make_templates as r_make_templates
from repro.kvi.serving import poisson_arrivals as r_arrivals
from repro.kvi.serving import save_trace as r_save_trace
from repro.kvi.serving.__main__ import main as r_main

import repro_torch.kvi as tk
from repro_torch.kvi.obs import (Obs, canonical_trace, validate_metrics,
                                 validate_trace)
from repro_torch.kvi.obs.__main__ import main as obs_main
from repro_torch.kvi.scheduler import HartScheduler
from repro_torch.kvi.serving import (DEFAULT_MIX, SMOKE_MIX, ServeEngine,
                                     bucket_sizes, canonical_report,
                                     load_trace, make_templates,
                                     poisson_arrivals, save_trace)
from repro_torch.kvi.serving.__main__ import main
from repro_torch.kvi.serving.checks import check_against_oracle
from repro_torch.kvi.torch_backend import TorchBackend

ROOT = Path(__file__).resolve().parents[1]
#: the smoke stream both packages serve with a backend: 16 requests of
#: SMOKE_MIX, seed 0, mean gap 40 cycles, 3 harts, max_batch 8
SMOKE_ARGS = ["--smoke", "--requests", "16", "--canonical"]
MIXES = {"default": (R_DEFAULT_MIX, DEFAULT_MIX, False),
         "smoke": (R_SMOKE_MIX, SMOKE_MIX, True)}


def _run_cli(fn, argv):
    """(exit code, stdout) of one CLI ``main``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def reference_smoke(tmp_path_factory):
    """The reference CLI on the smoke stream with its Pallas backend:
    (canonical report text, summary line)."""
    path = tmp_path_factory.mktemp("ref") / "serve.json"
    rc, line = _run_cli(r_main, SMOKE_ARGS + ["--out", str(path)])
    assert rc == 0
    return path.read_text(), line


def _without_backend_name(text):
    report = json.loads(text)
    assert report["engine"].pop("backend") in ("pallas", "torch")
    return report


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_templates_equal_the_reference(mix):
    rmix, tmix, smoke = MIXES[mix]
    assert tmix == rmix
    ref = r_make_templates(rmix, smoke=smoke, seed=0)
    port = make_templates(tmix, smoke=smoke, seed=0)
    assert port.keys() == ref.keys()
    for name in ref:
        r, t = ref[name], port[name]
        assert t.as_dict() == r.as_dict()
        assert t.profile == r.profile
        assert (t.data_mems, t.data_limit) == (r.data_mems, r.data_limit)
        assert t.signature == tk.structural_signature(
            tk.program_from_reference(r.program))
        for rid in (0, 7, 10_000, 2 ** 48 + 3):
            ri, ti = r.instantiate(0, rid), t.instantiate(0, rid)
            assert ti.name == ri.name
            assert ti.mem_init.keys() == ri.mem_init.keys()
            for k, v in ri.mem_init.items():
                assert ti.mem_init[k].dtype == v.dtype
                assert ti.mem_init[k].tobytes() == v.tobytes()
            # instances share the prototype's structure tuples
            assert (ti.items, ti.vregs, ti.mems) == (
                t.program.items, t.program.vregs, t.program.mems)
            assert ti.items is t.program.items


@pytest.mark.parametrize("gap", [5.0, 40.0, 300.0])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_poisson_arrivals_equal_the_reference(mix, gap):
    rmix, tmix, smoke = MIXES[mix]
    ref = r_make_templates(rmix, smoke=smoke, seed=0)
    port = make_templates(tmix, smoke=smoke, seed=0)
    for seed in (0, 3):
        want = r_arrivals(ref, 200, gap, n_clients=1000, seed=seed)
        got = poisson_arrivals(port, 200, gap, n_clients=1000, seed=seed)
        assert [dataclasses.astuple(s) for s in got] == \
            [dataclasses.astuple(s) for s in want]
    weights = {sorted(port)[0]: 3.0, sorted(port)[-1]: 1.0}
    assert [dataclasses.astuple(s) for s in poisson_arrivals(
        port, 50, gap, seed=1, weights=weights)] == \
        [dataclasses.astuple(s) for s in r_arrivals(
            ref, 50, gap, seed=1, weights=weights)]


def test_bucket_sizes_equal_the_reference():
    for max_batch in (1, 2, 4, 8, 16):
        for n in range(0, 70):
            assert bucket_sizes(n, max_batch) == r_bucket_sizes(n, max_batch)
    assert bucket_sizes(13, 8) == [8, 4, 1]


def test_trace_files_round_trip_as_the_reference(tmp_path):
    port = make_templates(SMOKE_MIX, smoke=True, seed=0)
    specs = poisson_arrivals(port, 24, 40.0, seed=2)
    save_trace(specs, tmp_path / "port.json")
    r_save_trace(r_arrivals(r_make_templates(R_SMOKE_MIX, smoke=True,
                                             seed=0), 24, 40.0, seed=2),
                 tmp_path / "ref.json")
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    assert load_trace(tmp_path / "port.json") == specs


@pytest.mark.parametrize("batching", [True, False])
@pytest.mark.parametrize("mix,n", [("default", 256), ("smoke", 64)])
def test_schedule_only_report_is_the_reference_byte_for_byte(mix, n,
                                                             batching):
    rmix, tmix, smoke = MIXES[mix]
    ref = r_make_templates(rmix, smoke=smoke, seed=0)
    port = make_templates(tmix, smoke=smoke, seed=0)
    want = r_canonical(RServeEngine(ref, backend=None, batching=batching)
                       .run(r_arrivals(ref, n, 40.0, seed=0)))
    got = canonical_report(ServeEngine(port, backend=None,
                                       batching=batching)
                           .run(poisson_arrivals(port, n, 40.0, seed=0)))
    assert got == want
    if mix == "default":
        # the full configuration: 5 steps, 43 buckets
        report = json.loads(got)
        assert report["n_steps"] == 5
        if batching:
            assert report["batch_sizes"] == {"8": 28, "4": 4, "2": 5,
                                             "1": 6}
        assert (report["latency_cycles"]["p50"],
                report["latency_cycles"]["p99"]) == (245787, 498670)


def test_cpu_backend_report_equals_the_reference_pallas_run(
        reference_smoke):
    """Everything but ``engine.backend``, the launch-record cache counts
    (68 hits, 36 misses) included."""
    templates = make_templates(SMOKE_MIX, smoke=True, seed=0)
    specs = poisson_arrivals(templates, 16, 40.0, seed=0)
    be = TorchBackend(device="cpu", passes=())
    report = ServeEngine(templates, n_harts=3, backend=be, max_batch=8,
                         seed=0).run(specs)
    got = _without_backend_name(canonical_report(report))
    want = _without_backend_name(reference_smoke[0])
    assert got == want
    assert want["compile_cache"]["hits"] == 68
    assert want["compile_cache"]["misses"] == 36
    assert got["compile_cache"]["steady_hit_rate"] == 1.0
    # two fresh batched runs give byte-identical canonical reports
    again = ServeEngine(templates, backend=TorchBackend(
        device="cpu", passes=())).run(specs)
    assert canonical_report(again) == canonical_report(report)
    assert be.walk_calls == 0                   # no launch on the CPU


def test_cli_on_the_cpu_matches_the_reference_cli(reference_smoke,
                                                  tmp_path):
    path = tmp_path / "serve.json"
    rc, line = _run_cli(main, SMOKE_ARGS + ["--device", "cpu", "--out",
                                            str(path)])
    assert rc == 0
    assert line.rsplit(" -> ", 1)[0] == \
        reference_smoke[1].rsplit(" -> ", 1)[0]
    assert _without_backend_name(path.read_text()) == \
        _without_backend_name(reference_smoke[0])
    assert json.loads(path.read_text())["engine"]["backend"] == "torch"


def test_schedule_only_cli_matches_the_reference_cli():
    argv = ["--no-backend", "--canonical", "--requests", "40", "--seed", "2"]
    want, got = _run_cli(r_main, argv), _run_cli(main, argv)
    assert got == want


@pytest.mark.parametrize("flag", ["--trace-out", "--metrics-out"])
def test_telemetry_flags_write_the_reference_files(flag, tmp_path):
    """Each flag alone writes a file that ``python -m repro_torch.kvi.obs
    validate`` accepts and that equals the reference CLI's canonically
    (the trace through ``canonical_trace``, byte for byte; the metrics
    snapshot whole: a schedule-only run holds no wall field)."""
    argv = ["--smoke", "--no-backend", "--requests", "24", "--canonical"]
    texts = {}
    for tag, fn in (("ref", r_main), ("port", main)):
        path = tmp_path / f"{tag}.json"
        rc, report = _run_cli(fn, argv + [flag, str(path)])
        assert rc == 0
        texts[tag] = (report, json.loads(path.read_text()))
    assert texts["port"][0] == texts["ref"][0]
    got, want = texts["port"][1], texts["ref"][1]
    if flag == "--trace-out":
        assert validate_trace(got) == []
        assert json.dumps(canonical_trace(got), sort_keys=True) == \
            json.dumps(r_canonical_trace(want), sort_keys=True)
        kind = "trace"
    else:
        assert validate_metrics(got) == []
        assert got == want and got["counters"]["serving.requests"] == 24
        kind = "metrics"
    argv = ["validate", str(tmp_path / "port.json")]
    if kind == "metrics":
        # a metrics snapshot is validated beside a trace
        trace = tmp_path / "t.json"
        assert main(["--smoke", "--no-backend", "--requests", "24",
                     "--trace-out", str(trace)]) == 0
        argv = ["validate", str(trace), "--metrics", str(tmp_path /
                                                         "port.json")]
    rc, line = _run_cli(obs_main, argv)
    assert rc == 0 and line.rstrip().endswith("OK")


def test_cli_without_device_needs_the_card():
    """No ``--device``: the card, and an error without one (there is no
    CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the CPU-only behaviour is moot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke", "--requests", "4"])


CONSTRUCTORS = {
    "TorchBackend": lambda obs: TorchBackend(device="cpu", obs=obs),
    "get_backend_torch": lambda obs: tk.get_backend(
        "torch", passes=(), device="cpu", obs=obs),
    "get_backend_cyclesim": lambda obs: tk.get_backend("cyclesim",
                                                       obs=obs),
    "ServeEngine": lambda obs: ServeEngine({}, obs=obs),
    "HartScheduler": lambda obs: HartScheduler(obs=obs),
}


@pytest.mark.parametrize("make", sorted(CONSTRUCTORS))
def test_every_constructor_takes_none_and_a_live_obs(make):
    """``obs=None`` (the default) and a live bundle are both taken and
    kept as given: no layer refuses telemetry or drops it to a disabled
    bundle."""
    assert CONSTRUCTORS[make](None).obs is None
    live = Obs.on()
    assert CONSTRUCTORS[make](live).obs is live


def test_port_templates_on_the_cpu_equal_the_oracle_at_every_bucket():
    templates = make_templates(DEFAULT_MIX, smoke=False, seed=0)
    n = check_against_oracle(templates, 0,
                             TorchBackend(device="cpu", passes=()))
    assert n == len(templates) * (1 + 2 + 4 + 8)


def test_oracle_gate_refuses_a_result_with_an_entry_missing():
    """A backend that returns one result fewer than its batch's instances
    fails the gate; it is not compared on the results it did return."""
    templates = make_templates(SMOKE_MIX, smoke=True, seed=0)
    be = TorchBackend(device="cpu", passes=())
    run = be.run_workload

    def short(wl, verify=None):
        res = run(wl, verify)
        return dataclasses.replace(res,
                                   entry_results=res.entry_results[:-1])
    be.run_workload = short
    name = sorted(templates)[0]
    with pytest.raises(AssertionError, match="1 results for 2 instances"):
        check_against_oracle({name: templates[name]}, 0, be, sizes=(2,))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_serve_checks_rehearsed_on_the_cpu():
    """The serve phase's watch on the smoke stream with the CPU backend:
    the batched and the unbatched run serve every request once, in the
    same order, with the same outputs, which are the oracle's; the watch
    sums the backend's host split over the loop's calls only; a result
    that differs in one element is told apart."""
    smoke = _chip_smoke()
    templates = make_templates(SMOKE_MIX, smoke=True, seed=0)
    specs = poisson_arrivals(templates, 16, 40.0, seed=0)
    served = []
    for batching in (True, False):
        be = TorchBackend(device="cpu", passes=())
        watch = smoke._watch(be)
        with smoke.gc_clock() as gcr:
            rep = ServeEngine(templates, backend=be, batching=batching,
                              max_batch=8, seed=0).run(specs)
        assert gcr["gc_s"] >= 0.0 and len(gcr["collections"]) == 3
        assert sum(watch["sizes"]) == 16 + len(templates) * (
            15 if batching else 1)
        assert sorted(len(wl.entries) for wl, _ in watch["served"]) == \
            sorted(int(b) for b, n in rep["batch_sizes"].items()
                   for _ in range(n))
        assert set(watch["host_s"]) == {"stack_s", "walk_s", "unpack_s"}
        assert 0.0 < sum(watch["host_s"].values()) <= watch["backend_s"]
        served.append(smoke.served_outputs(watch))
    (batched, unbatched), oracle = served, tk.get_backend("oracle")
    assert len(batched) == len(unbatched) == 16
    for (pb, ob), (pu, ou) in zip(batched, unbatched):
        assert pb.name == pu.name
        assert smoke.same_outputs(ob, ou)
        assert smoke.same_outputs(ob, oracle.run(pb).outputs)
    _, outs = batched[0]
    k = sorted(outs)[0]
    bent = dict(outs, **{k: outs[k].copy()})
    bent[k].flat[0] += 1
    assert not smoke.same_outputs(bent, outs)
    assert not smoke.same_outputs({**outs, "extra": outs[k]}, outs)


def test_reference_instances_through_the_port_equal_the_reference_oracle():
    """The reference's own template instances, carried across, batched
    through the port's CPU backend."""
    ref = r_make_templates(R_DEFAULT_MIX, smoke=False, seed=0)
    oracle = r_backend("oracle")
    be = TorchBackend(device="cpu", passes=())
    for name in sorted(ref):
        progs = [ref[name].instantiate(0, 10_000 + i) for i in range(3)]
        got = be.run_workload(tk.KviWorkload.homogeneous(
            [tk.program_from_reference(p) for p in progs]))
        assert got.meta["groups"] == 1
        for p, res in zip(progs, got.entry_results):
            want = oracle.run(p).outputs
            assert res.outputs.keys() == want.keys()
            for k, v in want.items():
                assert res.outputs[k].dtype == v.dtype
                np.testing.assert_array_equal(res.outputs[k], v)


def test_serving_modules_load_neither_jax_nor_repro():
    code = ("import sys, io, contextlib\n"
            "import repro_torch.configs, repro_torch.core\n"
            "import repro_torch.kvi.oracle, repro_torch.kvi.lowering\n"
            "import repro_torch.kvi.scheduler, repro_torch.kvi.obs\n"
            "import repro_torch.kvi.serving.checks\n"
            "import repro_torch.kvi.cyclesim, repro_torch.kvi.dse\n"
            "import repro_torch.kvi.obs.__main__\n"
            "assert repro_torch.kvi.dse.calibration_fit()['ok']\n"
            "from repro_torch.kvi.serving.__main__ import main\n"
            "with contextlib.redirect_stdout(io.StringIO()), \\\n"
            "        contextlib.redirect_stderr(io.StringIO()):\n"
            "    assert main(['--no-backend', '--smoke', '--trace-out', "
            "'/dev/null']) == 0\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src"),
                        "PATH": "/usr/bin:/bin"}, cwd=ROOT, timeout=120)
