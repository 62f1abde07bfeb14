"""LM serving on the port (repro_torch.serving, python -m
repro_torch.launch.serve) against the reference's (repro.serving,
repro.launch.serve): with the reference's float32 weights carried
across, the port's engine serves the reference's tokens request by
request (continuous batching over more requests than slots, so slots
are reset and reused; ring caches and SSM states included); then the
reference's own engine checks on the port, the CLI's summary line, and
the entry point's imports (no jax, no repro)."""
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as rcfg
from repro.models import model_zoo as rzoo
from repro.models import params as rparams
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine
import repro_torch.configs as tcfg
from repro_torch.configs.base import Parallelism, ShapeConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import params as tparams
from repro_torch.models import steps as tsteps
from repro_torch.models.sharding import make_rules
from repro_torch.serving import Request, ServingEngine
from test_torch_lm_params import port_spec

ROOT = Path(__file__).resolve().parents[1]


def prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 90, int(rng.integers(3, 12))).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b",
                                  "mamba2-1.3b", "hymba-1.5b"])
def test_engine_serves_the_references_tokens(arch):
    rm = rcfg.reduced_model(rcfg.get_spec(arch).model).replace(
        dtype="float32")
    tm = tcfg.reduced_model(port_spec(arch).model).replace(
        dtype="float32")
    rp = rparams.initialize(rzoo.param_template(rm), jax.random.PRNGKey(0))
    ps = prompts(6)
    reng = RServingEngine(rm, rp, slots=3, max_seq=48)
    teng = ServingEngine(tm, tparams.from_reference(rp, device="cpu"),
                         slots=3, max_seq=48, device="cpu")
    for eng, req in ((reng, RRequest), (teng, Request)):
        for i, p in enumerate(ps):
            eng.submit(req(rid=i, prompt=p.copy(), max_new_tokens=5 + i % 3))
    want = {r.rid: r.out_tokens for r in reng.run_until_drained(500)}
    got = {r.rid: r.out_tokens for r in teng.run_until_drained(500)}
    assert len(got) == 6 and got == want


# ---------------------------------------------------------------------------
# the reference's engine checks (tests/test_serving.py) on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_engine_parts():
    cfg = tcfg.reduced_model(tcfg.get_spec("llama3.2-1b").model)
    params = tparams.initialize(tzoo.param_template(cfg), 0, device="cpu")
    return cfg, params


def test_drains_more_requests_than_slots(small_engine_parts, rng):
    cfg, params = small_engine_parts
    eng = ServingEngine(cfg, params, slots=2, max_seq=64, device="cpu")
    for i in range(5):
        eng.submit(Request(rid=i,
                           prompt=rng.integers(1, 90, 4 + i).astype(np.int32),
                           max_new_tokens=4))
    done = eng.run_until_drained(max_steps=500)
    assert len(done) == 5
    assert all(len(r.out_tokens) == 4 for r in done)
    assert all(r.first_token_at is not None and r.done_at is not None
               for r in done)


def test_slot_reuse_is_deterministic(small_engine_parts, rng):
    cfg, params = small_engine_parts
    prompt = rng.integers(1, 90, 6).astype(np.int32)
    eng = ServingEngine(cfg, params, slots=2, max_seq=64, device="cpu")
    for i in range(4):
        eng.submit(Request(rid=i, prompt=prompt.copy(), max_new_tokens=5))
    done = eng.run_until_drained(max_steps=500)
    outs = {tuple(r.out_tokens) for r in done}
    assert len(outs) == 1, outs


def test_greedy_matches_decode_loop(small_engine_parts, rng):
    """Engine output == manual teacher-forced decode + argmax for a
    single request, through the same decode step."""
    cfg, params = small_engine_parts
    par = Parallelism(remat="none")
    rules = make_rules(None, cfg, par)
    prompt = rng.integers(1, 90, 7).astype(np.int32)

    eng = ServingEngine(cfg, params, slots=1, max_seq=64, device="cpu")
    eng.submit(Request(rid=0, prompt=prompt.copy(), max_new_tokens=4))
    got = eng.run_until_drained(max_steps=200)[0].out_tokens

    decode = tsteps.make_decode_step(cfg, rules, par,
                                     ShapeConfig("d", "decode", 64, 1))
    cache = ServingEngine(cfg, params, slots=1, max_seq=64,
                          device="cpu").cache
    for t in prompt:
        logits, cache = decode(params, cache,
                               {"tokens": torch.tensor([[t]], dtype=torch.int32)})
    out = []
    for _ in range(4):
        nxt = int(logits[:, -1].argmax(dim=-1)[0])
        out.append(nxt)
        logits, cache = decode(params, cache,
                               {"tokens": torch.tensor([[nxt]],
                                                       dtype=torch.int32)})
    assert got == out


def test_argmax_takes_the_first_maximum():
    """Greedy sampling breaks ties as ``jnp.argmax`` does."""
    logits = torch.tensor([[[0.0, 3.0, 1.0, 3.0]]], dtype=torch.bfloat16)
    assert int(logits[:, -1].argmax(dim=-1)[0]) == 1


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

LINE = re.compile(r"^served (\d+) requests, (\d+) tokens in \d+\.\d\ds "
                  r"\(\d+\.\d tok/s\), TTFT p50=\d+\.\d\ds p99=\d+\.\d\ds$")


def test_serve_main_prints_the_references_line(capsys):
    report = {}
    assert tserve.main(["--device", "cpu", "--reduced", "--requests", "5",
                        "--slots", "2", "--max-seq", "32", "--max-new", "3"],
                       report=report) == 0
    line = capsys.readouterr().out.strip()
    m = LINE.match(line)
    assert m and m.groups() == ("5", "15"), line
    assert report["line"] == line and report["tokens"] == 15
    assert sorted(r.rid for r in report["done"]) == list(range(5))
    assert report["engine"].device.type == "cpu"


def test_serve_takes_every_flag_of_the_reference():
    import repro.launch.serve as rserve
    src = Path(rserve.__file__).read_text()
    want = set(re.findall(r'add_argument\("(--[a-z-]+)"', src))
    got = set(re.findall(r'add_argument\("(--[a-z-]+)"',
                         Path(tserve.__file__).read_text()))
    assert got == want | {"--device"}


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal shows only without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--reduced", "--requests", "1"])


def test_serve_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "from repro_torch.launch import serve\n"
            "from repro_torch.configs import get_spec, reduced_model\n"
            "from repro_torch.models import model_zoo, params\n"
            "cfg = reduced_model(get_spec('hymba-1.5b').model)\n"
            "p = params.initialize(model_zoo.param_template(cfg), 0, "
            "device='cpu')\n"
            "serve.ServingEngine(cfg, p, slots=2, max_seq=32, device='cpu')"
            ".step()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
