"""The readers of the program's spans (``metrics/*.py`` with source
``program_span``): nothing to read without a collector, a step or a
span of their name, or in a program without spans; from a collector
filled by CPU train steps under a profiler session, as the traced run
fills it, each span's total over the steps divided by their number."""
import json
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import ROOT

from cardbench.harness import manifest

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = {"forward_ms.train": "forward", "backward_ms.train": "backward",
           "recompute_ms.train": "block/recompute",
           "optimizer_ms.train": "optimizer", "ssd_ms.train": "ssd"}
CTX = {"kind": "train"}


@pytest.fixture(autouse=True)
def fresh_collector():
    from repro_torch.kvi.obs import spans
    spans.reset()
    yield spans
    spans.reset()


def _steps(remat: str, n: int):
    """``n`` train steps of reduced mamba2-1.3b on the CPU under a
    profiler session recording the CPU alone."""
    from repro_torch.configs import get_spec, reduced_model
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import params as params_lib
    from repro_torch.models import steps
    from repro_torch.models.sharding import make_rules
    from repro_torch.optim.optimizer import OptimizerConfig, adamw_init
    spec = get_spec("mamba2-1.3b")
    cfg = reduced_model(spec.model)
    par = spec.parallelism.replace(remat=remat)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = steps.make_train_step(cfg, make_rules(None, cfg, par), par, opt)
    params = params_lib.initialize(zoo.param_template(cfg), 0, device="cpu")
    state = adamw_init(params, opt)
    rng = np.random.default_rng(0)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(n):
            batch = {k: torch.from_numpy(rng.integers(0, 100, (2, 32))
                                         .astype(np.int32))
                     for k in ("tokens", "labels")}
            params, state, _ = step(params, state, batch)
    return cfg


def test_the_entries():
    got = {m["name"]: m for m in MAN["per_layer"]
           if m["source"] == "program_span"}
    assert set(got) == set(READERS)
    for name, m in got.items():
        assert (m["unit"], m["better"], m["moves"], m["workloads"]) == (
            "ms", "lower", "train_tokens_per_s", ["train.mamba2-1.3b.s4k"])
        assert m["layer"] == ("ssm mixer" if name == "ssd_ms.train"
                              else "train step")


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_to_read(name, monkeypatch):
    reader = manifest.load_metric(name)
    assert reader.read({}) is None
    assert reader.read(CTX) is None            # no collector, no step
    _steps("none", 1)
    assert reader.read({"kind": "serve"}) is None
    if READERS[name] == "block/recompute":     # no span of its name
        assert reader.read(CTX) is None
    else:
        assert reader.read(CTX) is not None
    # a program without spans (the parent of the change that adds them)
    import repro_torch.kvi.obs as obs_pkg
    monkeypatch.delattr(obs_pkg, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.kvi.obs.spans", None)
    assert reader.read(CTX) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_total_over_the_steps(name, fresh_collector):
    cfg = _steps("block", 2)
    got = fresh_collector.collected()
    assert got["steps"] == 2
    rec = got["spans"][READERS[name]]
    want = rec["device_ms"] / 2
    assert manifest.load_metric(name).read(CTX) == pytest.approx(want)
    assert want > 0
    L = cfg.num_layers
    assert rec["count"] == {"forward": 2, "backward": 2, "optimizer": 2,
                            "block/recompute": 2 * L,
                            "ssd": 2 * 3 * L}[READERS[name]]
