"""Spans inside the port's train step (``repro_torch.kvi.obs.spans``):
off, the step records nothing and its autograd graph is the one without
markers; on, its outputs are bit-equal to the step's off; the span tree
a step (``train_step`` over ``forward``, ``backward``, ``optimizer``;
``block``, the scan's and ``attention`` spans by phase); the host stamps
on the profiler's clock; the exported trace against the kvi-trace-v1 schema; and
``python -m repro_torch.launch.train``'s ``--trace-out`` /
``--metrics-out``. Reduced mamba2-1.3b (the SSD scan, span ``ssd``) and
hymba-1.5b (the selective scan, ``selective_scan``, beside attention)
on the CPU, remat "none" and "block"; the test marked ``cuda`` runs on
the card."""
import contextlib
import io
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_spec, reduced_model
from repro_torch.kvi.obs import (Obs, canonical_trace, spans,
                                 validate_metrics, validate_trace)
from repro_torch.kvi.obs.trace import Tracer
from repro_torch.launch import train as launch_train
from repro_torch.models import model_zoo as zoo
from repro_torch.models import params as params_lib
from repro_torch.models import steps
from repro_torch.models.sharding import make_rules
from repro_torch.optim.optimizer import OptimizerConfig, adamw_init

ARCHS = ["mamba2-1.3b", "hymba-1.5b"]
#: each arch's scan span
SCAN = {"mamba2-1.3b": "ssd", "hymba-1.5b": "selective_scan"}
REMATS = ["none", "block"]
MARKERS = {"_OpensInBackwardBackward", "_ClosesInBackwardBackward"}


@pytest.fixture(autouse=True)
def fresh_collector():
    spans.reset()
    yield
    spans.reset()


def build(arch, remat, device="cpu"):
    spec = get_spec(arch)
    cfg = reduced_model(spec.model)
    par = spec.parallelism.replace(remat=remat, fsdp=False,
                                   sequence_parallel=False)
    rules = make_rules(None, cfg, par)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = params_lib.initialize(zoo.param_template(cfg), 0,
                                   device=device)
    return cfg, par, rules, opt, params


def make_batch(seed=0, batch=2, seq=32, device="cpu"):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, 100, (batch, seq))
                                .astype(np.int32)).to(device)
            for k in ("tokens", "labels")}


def traced_step(arch, remat):
    """One train step with an activated bundle: (bundle, outputs)."""
    cfg, par, rules, opt, params = build(arch, remat)
    step = steps.make_train_step(cfg, rules, par, opt)
    obs = Obs.on()
    with spans.activate(obs):
        out = step(params, adamw_init(params, opt), make_batch())
    return cfg, obs, out


def span_events(obs, track=spans.HOST):
    trace = obs.tracer.to_chrome()
    tid = {ev["args"]["name"]: (ev["pid"], ev["tid"])
           for ev in trace["traceEvents"] if ev["name"] == "thread_name"}
    want = tid[track[1]]
    return [ev for ev in trace["traceEvents"]
            if ev["ph"] == "X" and (ev["pid"], ev["tid"]) == want]


def graph(loss):
    """The class names of every node of ``loss``'s autograd graph."""
    seen, todo, names = set(), [loss.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def loss_of(cfg, par, rules, params, batch):
    leaves = params_lib.tree_map(
        lambda x: x.detach().requires_grad_(x.is_floating_point()), params)
    loss, _ = steps.make_loss_fn(cfg, rules, par)(leaves, batch)
    return loss


# ---------------------------------------------------------------------------
# off: nothing recorded, the graph without markers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_off_records_nothing_and_adds_no_node(arch, remat, monkeypatch):
    cfg, par, rules, opt, params = build(arch, remat)
    batch = make_batch()
    step = steps.make_train_step(cfg, rules, par, opt)
    step(params, adamw_init(params, opt), batch)
    assert spans.COLLECTOR.bundle() is None
    assert spans.collected() is None
    off = graph(loss_of(cfg, par, rules, params, batch))
    assert not MARKERS & set(off)
    # the graph as the zoo made it before the spans: the scan called
    # directly
    with monkeypatch.context() as m:
        m.setattr(spans, "bracketed",
                  lambda name, fn, *a, span_args=None, **kw: fn(*a, **kw))
        plain = graph(loss_of(cfg, par, rules, params, batch))
    assert sorted(off) == sorted(plain)
    # on: two marker nodes a scan and an attention, nothing else added
    with spans.activate(Obs.on()), spans.step(batch):
        on = graph(loss_of(cfg, par, rules, params, batch))
    assert sorted(n for n in on if n not in MARKERS) == sorted(plain)
    bracketed = 2 if cfg.family == "hybrid" else 1
    assert sum(n in MARKERS for n in on) == 2 * bracketed * cfg.num_layers


# ---------------------------------------------------------------------------
# on: bit-equal outputs
# ---------------------------------------------------------------------------

def _leaves(tree):
    return dict(params_lib.tree_leaves(tree))


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_on_is_bit_equal_to_off(arch, remat):
    cfg, par, rules, opt, params = build(arch, remat)
    batch = make_batch()
    state = adamw_init(params, opt)
    step = steps.make_train_step(cfg, rules, par, opt)
    loss_fn = steps.make_loss_fn(cfg, rules, par)
    off = step(params, state, batch)
    (l_off, m_off), g_off = steps.value_and_grad(loss_fn, params, batch)
    with spans.activate(Obs.on()):
        on = step(params, state, batch)
        with spans.step(batch):
            (l_on, m_on), g_on = steps.value_and_grad(loss_fn, params,
                                                      batch)
    assert torch.equal(l_on, l_off)
    for k in m_off:
        assert torch.equal(m_on[k], m_off[k]), k
    for k, g in _leaves(g_off).items():
        assert torch.equal(_leaves(g_on)[k], g), k
    for i in (0, 1):        # the new params and the optimizer state
        got = _leaves(on[i])
        for k, v in _leaves(off[i]).items():
            assert torch.equal(got[k], v), (i, k)
    for k, v in off[2].items():
        assert torch.equal(on[2][k], v), k


# ---------------------------------------------------------------------------
# the span tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_span_tree(arch, remat):
    cfg, obs, _ = traced_step(arch, remat)
    L = cfg.num_layers
    evs = span_events(obs)
    by_id = {ev["args"]["span"]: ev for ev in evs}
    assert len(by_id) == len(evs)
    assert {ev["args"]["step"] for ev in evs} == {1}

    def named(name, phase=None):
        return [ev for ev in evs if ev["name"] == name and
                (phase is None or ev["args"].get("phase") == phase)]

    (root,) = named("train_step")
    assert root["args"]["parent"] is None
    top = {}
    for name in ("forward", "backward", "optimizer"):
        (top[name],) = named(name)
        assert top[name]["args"]["parent"] == root["args"]["span"]

    def under(ev, name):
        """Whether ``ev``'s ancestors hold the span ``top[name]``."""
        p = ev["args"]["parent"]
        while p is not None:
            if p == top[name]["args"]["span"]:
                return True
            p = by_id[p]["args"]["parent"]
        return False

    scan = SCAN[arch]
    recomputed = L if remat == "block" else 0
    want = {("block", "forward"): L, (scan, "forward"): L,
            (scan, "backward"): L,
            ("block", "recompute"): recomputed,
            (scan, "recompute"): recomputed}
    if cfg.family == "hybrid":      # attention, bracketed beside the scan
        want.update({("attention", "forward"): L,
                     ("attention", "backward"): L,
                     ("attention", "recompute"): recomputed})
    for (name, phase), n in want.items():
        got = named(name, phase)
        assert len(got) == n, (name, phase)
        parent = "forward" if phase == "forward" else "backward"
        assert all(under(ev, parent) for ev in got), (name, phase)
    assert sorted(ev["args"]["layer"] for ev in named("block", "forward")) \
        == list(range(L))
    # the scan and attention inside their block; the recomputed blocks
    # and their backward (the autograd engine's) under the step's backward
    for name in (scan, "attention"):
        for ev in named(name, "forward") + named(name, "recompute"):
            assert by_id[ev["args"]["parent"]]["name"] == "block"
        for ev in named(name, "backward"):
            assert ev["args"]["parent"] == top["backward"]["args"]["span"]
    for ev in named("block", "recompute"):
        assert ev["args"]["parent"] == top["backward"]["args"]["span"]
    # on CPU tensors every phase of the scan is the plain layer
    assert {ev["args"]["path"] for ev in named(scan)} == {"plain"}
    n_attn = L if cfg.family == "hybrid" else 0
    assert len(named("attention")) == n_attn * (3 if remat == "block"
                                                else 2)
    if n_attn:      # hymba: global and windowed, own and shared K/V
        kinds = {(ev["args"]["window"], ev["args"]["kv"])
                 for ev in named("attention", "forward")}
        assert kinds == {("global", "own"), ("sliding", "own"),
                         ("sliding", "shared")}
    # every span inside its parent, on the host lane
    for ev in evs:
        p = ev["args"]["parent"]
        if p is not None:
            assert by_id[p]["ts"] <= ev["ts"]
            assert ev["ts"] + ev["dur"] <= by_id[p]["ts"] + by_id[p]["dur"]
    # the totals the benchmark's readers take
    got = spans.collected(obs)
    assert got["steps"] == 1
    assert got["spans"][scan]["count"] == (3 if remat == "block" else 2) * L
    if remat == "block":
        assert got["spans"]["block/recompute"]["count"] == L
    else:
        assert "block/recompute" not in got["spans"]
    for key, rec in got["spans"].items():
        assert rec["device_ms"] == pytest.approx(rec["host_ms"]), key


def test_grad_accum_has_a_forward_and_backward_a_micro_batch():
    cfg, par, rules, opt, params = build("mamba2-1.3b", "none")
    par = par.replace(grad_accum=2)
    step = steps.make_train_step(cfg, rules, par, opt)
    obs = Obs.on()
    with spans.activate(obs):
        for seed in (0, 1):
            step(params, adamw_init(params, opt), make_batch(seed, batch=4))
    got = spans.collected(obs)
    assert got["steps"] == 2
    assert got["spans"]["forward"]["count"] == 4
    assert got["spans"]["backward"]["count"] == 4
    assert got["spans"]["optimizer"]["count"] == 2
    assert {ev["args"]["step"] for ev in span_events(obs)} == {1, 2}


# ---------------------------------------------------------------------------
# the profiler's clock
# ---------------------------------------------------------------------------

def test_on_under_a_profiler_and_on_its_clock():
    """A profiler session turns the spans on; the forward span's host
    stamps, converted to the epoch clock, bracket an ``aten::`` op of
    the forward in the profiler's own trace."""
    cfg, par, rules, opt, params = build("mamba2-1.3b", "block")
    step = steps.make_train_step(cfg, rules, par, opt)
    state = adamw_init(params, opt)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, state, make_batch())
    got = spans.collected()
    assert got["steps"] == 1 and got["spans"]["forward"]["count"] == 1
    obs = spans.COLLECTOR.bundle()
    (fwd,) = [ev for ev in span_events(obs) if ev["name"] == "forward"]
    base = obs.tracer.to_chrome()["otherData"]["wall_epoch_ns"]
    t0 = base + fwd["ts"] * 1e3
    t1 = base + (fwd["ts"] + fwd["dur"]) * 1e3
    events = prof.profiler.kineto_results.events()
    cumsum = min((e for e in events if e.name() == "aten::cumsum"),
                 key=lambda e: e.start_ns())
    assert t0 <= cumsum.start_ns()
    assert cumsum.start_ns() + cumsum.duration_ns() <= t1
    # the span is on the profiler's host lane too, as a user annotation
    (rf,) = [e for e in events if e.name() == "forward"]
    assert rf.is_user_annotation()
    # after the session the next step is off again
    step(params, state, make_batch())
    assert spans.collected()["steps"] == 1


# ---------------------------------------------------------------------------
# the exported trace
# ---------------------------------------------------------------------------

def test_export_validates_and_the_canonical_form_is_unchanged():
    _, obs, _ = traced_step("hymba-1.5b", "block")
    trace = obs.tracer.to_chrome()
    assert validate_trace(trace) == []
    assert validate_metrics(obs.metrics.snapshot()) == []
    assert isinstance(trace["otherData"]["wall_epoch_ns"], int)
    assert len(span_events(obs, spans.DEVICE)) == len(span_events(obs))
    # wall events and their epoch base are what the canonical form drops
    canon = canonical_trace(trace)
    assert "otherData" not in canon
    assert all(ev.get("clock") != "wall" for ev in canon["traceEvents"])
    tr = Tracer()
    tr.span(("sim", "hart0"), "vadd", 0, 4)
    tr.wall_span(("torch", "run"), "run", tr.wall_us())
    assert canonical_trace(tr.to_chrome()) == {
        "displayTimeUnit": "ms",
        "traceEvents": [ev for ev in tr.to_chrome()["traceEvents"]
                        if ev.get("clock") != "wall"]}


def test_launch_train_trace_and_metrics_out(tmp_path):
    paths = [str(tmp_path / "trace.json"), str(tmp_path / "metrics.json")]
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = launch_train.main(
            ["--arch", "mamba2-1.3b", "--reduced", "--steps", "2",
             "--batch", "2", "--seq", "32", "--device", "cpu",
             "--trace-out", paths[0], "--metrics-out", paths[1]])
    assert rc == 0
    trace, snap = (json.load(open(p)) for p in paths)
    assert validate_trace(trace) == [] and validate_metrics(snap) == []
    assert snap["histograms"]["train.train_step.device_ms"]["count"] == 2
    names = {ev["name"] for ev in trace["traceEvents"] if ev["ph"] == "X"}
    assert {"train_step", "forward", "backward", "optimizer", "block",
            "ssd"} <= names
    assert "wall_epoch_ns" in trace["otherData"]
    # the run leaves the collector as it found it
    assert spans.COLLECTOR.obs is None and spans.collected() is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _device_ops(events) -> list:
    """(start, end) ns of the device's operations in a profiler trace:
    kernels, copies and sets, not the annotations mirrored on its lane."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in events
                  if str(e.device_type()).rsplit(".", 1)[-1] == "CUDA"
                  and e.duration_ns() > 0 and not e.is_user_annotation())


def _covered_ns(ops, spans_ns) -> int:
    """Nanoseconds of the union of ``ops`` inside the union of
    ``spans_ns``."""
    def union(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out
    return sum(max(0, min(b, d) - max(a, c))
               for a, b in union(ops) for c, d in union(spans_ns))


@pytest.mark.cuda
def test_spans_on_the_card():
    """Every span has its device time; the device work of a step lies in
    its forward, backward and optimizer spans (within 2 % of the step's
    device-busy time, from a profiler trace of the same steps) and their
    device times add up to no more than the step timed on the host with a
    synchronise at each end: what the host timing holds past the spans is
    the device idle between them, waiting on the host; the recomputed
    blocks and the scan's backward, opened on autograd's device thread,
    nest under the step's backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cfg, par, rules, opt, params = build("mamba2-1.3b", "block", dev)
    step = steps.make_train_step(cfg, rules, par, opt)
    state = adamw_init(params, opt)
    batch = make_batch(batch=8, seq=512, device=dev)
    for _ in range(3):
        step(params, state, batch)
    obs = Obs.on()
    host_ms = []
    with spans.activate(obs), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            step(params, state, batch)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - h0) * 1e3)
    got = spans.collected(obs)
    assert got["steps"] == 5
    dev_evs = span_events(obs, spans.DEVICE)
    assert all(ev["args"]["step"] in range(1, 6) for ev in dev_evs)
    assert all("dur" in ev and ev["dur"] >= 0 for ev in dev_evs)
    parts = sum(got["spans"][k]["device_ms"]
                for k in ("forward", "backward", "optimizer"))
    assert parts <= sum(host_ms)
    base = obs.tracer.to_chrome()["otherData"]["wall_epoch_ns"]
    phases = [(base + ev["ts"] * 1e3, base + (ev["ts"] + ev["dur"]) * 1e3)
              for ev in dev_evs
              if ev["name"] in ("forward", "backward", "optimizer")]
    assert len(phases) == 3 * 5
    ops = _device_ops(prof.profiler.kineto_results.events())
    busy = _covered_ns(ops, [(ops[0][0], max(b for _, b in ops))])
    inside = _covered_ns(ops, phases)
    print(f"[spans] 5 steps of {cfg.num_layers} layers at 8 x 512: host "
          f"{sum(host_ms):.3f} ms, forward + backward + optimizer "
          f"{parts:.3f} ms, device busy {busy / 1e6:.3f} ms, of it in "
          f"the spans {inside / 1e6:.3f} ms")
    assert inside >= 0.98 * busy
    evs = span_events(obs)
    back = {ev["args"]["span"] for ev in evs if ev["name"] == "backward"}
    nested = [ev for ev in evs if (ev["name"], ev["args"].get("phase")) in
              (("block", "recompute"), ("ssd", "backward"))]
    assert len(nested) == 5 * 2 * cfg.num_layers
    assert all(ev["args"]["parent"] in back for ev in nested)
    # every phase of every block's scan on the card's kernels
    ssd = [ev for ev in evs if ev["name"] == "ssd"]
    assert len(ssd) == 5 * 3 * cfg.num_layers
    assert {ev["args"]["path"] for ev in ssd} == {"kernel"}
