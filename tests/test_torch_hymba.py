"""Hymba-1.5B's published block on the port (repro_torch's ``hymba-1.5b``)
at reduced size on the CPU: against the benchmark's plain reference
(``cardbench/reference/hymba.py``, loaded by its path: torch alone) on
seeded random weights, the logits, the loss, every leaf's gradient and
one AdamW step, in float32 and bfloat16; the window's mask with the meta
keys against a dense masked softmax; the K/V sharing map; the chunked
selective scan against the recurrence, forward and gradients; prefill
and decode against the full forward, and the serving engine's tokens;
the parameter count at full width; the span counter of shared K/V.

Tolerances (``TOL``), and why:
- float32 logits 2e-5 and loss 1e-5 (relative and absolute): the two
  programs order their float32 sums apart (the scan chunked against one
  position at a time, attention in one block against a dense softmax);
  the readings are under 2e-6. A bfloat16 product anywhere in the port
  moves them by 1e-3 and more, which ``test_the_float32_limits_fail_
  bfloat16`` holds;
- float32 gradients 2e-4 of the leaf's norm, or of the median leaf's
  where that is larger (the benchmark's own measure, ``grad_gap``): the
  same sums, through the backward; readings under 3e-6;
- one AdamW step: the loss within 1e-5 and the gradient norm within
  1e-4 (relative), and each leaf's change within 1e-3 of the reference's
  (relative) or 1e-6 an element (absolute): Adam's first update is
  g / (|g| + eps), about lr for every element whatever g's rounding, but
  an element whose gradient rounds across zero moves by 2 lr;
- bfloat16 logits 0.05 and loss 2e-3 relative, gradients 0.1 by the
  same measure: bfloat16 keeps 8 bits and every product rounds its
  inputs; on seeds 7-9 the readings are 0.022, 1.2e-4 and 0.058 (the
  small leaves of the scan's dt path move most)."""
import dataclasses
import importlib.util
import json
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_spec, reduced_model
from repro_torch.kvi.obs import Obs, spans
from repro_torch.launch import train as launch
from repro_torch.models import layers, ssm
from repro_torch.models import model_zoo as zoo
from repro_torch.models import params as params_lib
from repro_torch.models import steps
from repro_torch.models.sharding import make_rules
from repro_torch.optim.optimizer import adamw_init
from repro_torch.serving import Request, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": {"logits": 2e-5, "loss": 1e-5, "grad": 2e-4},
       "bfloat16": {"logits": 5e-2, "loss": 2e-3, "grad": 1e-1}}
STEP_ATOL = 1e-6
B, S = 2, 24            # S + 4 meta tokens > the window of 16


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("cardbench/reference/hymba.py", "cardbench_reference_hymba")
WEIGHTS = _load("cardbench/harness/weights.py", "cardbench_harness_weights")


def reduced_cfg(dtype="float32"):
    return reduced_model(get_spec("hymba-1.5b").model).replace(dtype=dtype)


def bench_config(cfg) -> dict:
    """The benchmark's configuration file with the reduced model."""
    c = json.loads((ROOT / "cardbench/configs/hymba-1.5b.json").read_text())
    c["model"] = {k: getattr(cfg, k) for k in c["model"]}
    c["padded_vocab"] = zoo.padded_vocab(cfg.vocab_size)
    return c


def weights(cfg, seed=7):
    return WEIGHTS.make(REF.param_specs(bench_config(cfg)), seed, "cpu")


def batch(cfg, seed=0, rows=B, seq=S):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, cfg.vocab_size, (rows, seq + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(r[:, :-1].copy()),
            "labels": torch.from_numpy(r[:, 1:].copy())}


def port_parts(cfg, remat="none"):
    par = get_spec("hymba-1.5b").parallelism.replace(remat=remat)
    return par, make_rules(None, cfg, par)


def port_logits_loss_grads(cfg, w, b):
    par, rules = port_parts(cfg)
    params = WEIGHTS.nest({k: v.clone() for k, v in w.items()})
    (loss, met), g = steps.value_and_grad(steps.make_loss_fn(cfg, rules, par),
                                          params, b)
    with torch.no_grad():
        logits = steps.forward_train(params, cfg, rules, par, b)[0]
    return logits.float(), float(loss), dict(params_lib.tree_leaves(g))


def ref_logits_loss_grads(cfg, w, b):
    c = bench_config(cfg)
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    n = b["labels"].numel()
    _, total = REF.loss_fn(c, leaves, b["tokens"], b["labels"], n)
    g = torch.autograd.grad(total, list(leaves.values()))
    with torch.no_grad():
        logits = REF.logits_fn(c, w, b["tokens"])
    return logits, float(total.detach()), dict(zip(leaves, g))


@pytest.fixture(scope="module")
def reference():
    cfg = reduced_cfg()
    w, b = weights(cfg), batch(cfg)
    with REF.lm.exact_float32():
        return w, b, ref_logits_loss_grads(cfg, w, b)


def _grad_gaps(got: dict, want: dict) -> dict:
    """Each leaf's gradient gap over its norm or the median leaf's,
    whichever is larger."""
    med = statistics.median(float(v.norm()) for v in want.values())
    return {k: float((got[k].float() - want[k]).norm()) /
            max(float(want[k].norm()), med) for k in want}


def _close(got, want, tol):
    V = REF.lm.NEG
    keep = want > V / 2                       # the padded columns aside
    return torch.allclose(got[keep], want[keep], rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["logits", "loss", "grads"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_equals_the_reference(reference, dtype, what):
    w, b, (rl, rloss, rg) = reference
    cfg = reduced_cfg(dtype)
    pl, ploss, pg = port_logits_loss_grads(cfg, w, b)
    tol = TOL[dtype]
    if what == "logits":
        assert _close(pl, rl, tol["logits"])
    elif what == "loss":
        assert ploss == pytest.approx(rloss, rel=tol["loss"])
    else:
        assert set(pg) == set(rg)
        for k, gap in _grad_gaps(pg, rg).items():
            assert gap <= tol["grad"], (k, gap)


def test_the_float32_limits_fail_bfloat16(reference):
    """The float32 tolerances see a bfloat16 product: the bfloat16 port
    fails every one of them."""
    w, b, (rl, rloss, rg) = reference
    pl, ploss, pg = port_logits_loss_grads(reduced_cfg("bfloat16"), w, b)
    tol = TOL["float32"]
    assert not _close(pl, rl, tol["logits"])
    assert ploss != pytest.approx(rloss, rel=tol["loss"])
    assert max(_grad_gaps(pg, rg).values()) > tol["grad"]


def test_one_adamw_step_equals_the_reference():
    cfg = reduced_cfg()
    c = bench_config(cfg)
    w, b = weights(cfg), batch(cfg)
    ref = REF.train(c, w, [(b["tokens"], b["labels"])])
    _, par, shape, rules, step, data, opt = launch.build_trainer(
        "hymba-1.5b", reduced=True, seq=S, batch=B,
        steps=c["optimizer"]["total_steps"], lr=c["optimizer"]["lr"],
        overrides=dict(c["parallelism"], **c["model"]))
    data.close()
    params = WEIGHTS.nest({k: v.clone() for k, v in w.items()})
    new, _, met = step(params, adamw_init(params, opt), b)
    assert float(met["loss"]) == pytest.approx(ref["loss"][0], rel=1e-5)
    assert float(met["grad_norm"]) == pytest.approx(ref["grad_norm"],
                                                    rel=1e-4)
    got = dict(params_lib.tree_leaves(new))
    for k, w0 in w.items():
        change = float((got[k] - w0).norm())
        assert change == pytest.approx(ref["change"][k], rel=1e-3,
                                       abs=STEP_ATOL * w0.numel() ** 0.5), k


def test_param_specs_are_the_template_at_full_width():
    """The reference's tree is the program's, path for path; the widths
    give the published count (the embedding unpadded)."""
    c = json.loads((ROOT / "cardbench/configs/hymba-1.5b.json").read_text())
    cfg = get_spec("hymba-1.5b").model
    assert dataclasses.replace(cfg, **c["model"]) == cfg
    ours = {p: tuple(s) for p, s, _, _ in REF.param_specs(c)}
    theirs = {p: tuple(s.shape) for p, s in
              WEIGHTS.flatten(zoo.param_template(cfg)).items()}
    assert ours == theirs
    n = zoo.param_count(cfg)
    assert n == c["derived"]["params"] == 1_523_205_824
    assert n - (c["padded_vocab"] - cfg.vocab_size) * cfg.d_model == \
        1_522_797_824


# ---------------------------------------------------------------------------
# the parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,meta,qb", [(16, 4, 12), (16, 0, 12),
                                            (0, 4, 9), (5, 3, 36)])
def test_window_mask_with_meta_keys_is_a_dense_softmax(window, meta, qb):
    g = torch.Generator().manual_seed(window + meta)
    Sx, H, KV, hd, vd = 36, 4, 2, 8, 12
    q = torch.randn(2, Sx, H, hd, generator=g)
    k = torch.randn(2, Sx, KV, hd, generator=g)
    v = torch.randn(2, Sx, KV, vd, generator=g)
    got = layers.flash_attention_xla(q, k, v, causal=True, window=window,
                                     q_block=qb, kv_block=qb, meta=meta)
    qp, kp = torch.arange(Sx)[:, None], torch.arange(Sx)[None, :]
    ok = (kp <= qp) & (((qp - kp < window) | (kp < meta)) if window
                       else True)
    kk, vv = k.repeat_interleave(H // KV, 2), v.repeat_interleave(H // KV, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / hd ** 0.5
    p = torch.softmax(s.masked_fill(~ok, -1e30), -1)
    want = torch.einsum("bhqk,bkhv->bqhv", p, vv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(layers.attention_ref(q, k, v, window=window,
                                                    meta=meta), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("full", [True, False])
def test_the_sharing_map(full):
    cfg = get_spec("hymba-1.5b").model
    cfg = cfg if full else reduced_model(cfg)
    if full:
        assert cfg.kv_producers == (0, 1, 3, 5, 7, 9, 11, 13, 15, 16, 19,
                                    21, 23, 25, 27, 29, 31)
        assert [cfg.kv_source(l) for l in (2, 14, 17, 18, 30)] == \
            [1, 13, 16, 16, 29]
        assert [cfg.layer_window(l) for l in (0, 1, 15, 31)] == \
            [0, 1024, 0, 0]
    else:
        assert cfg.kv_producers == (0, 1, 3) and cfg.kv_source(2) == 1
        assert [cfg.layer_window(l) for l in range(4)] == [0, 16, 16, 0]
    t = zoo.param_template(cfg)
    assert t["kv"]["wk"].shape[0] == len(cfg.kv_producers)
    assert "wk" not in t["blocks"]["attn"] and "wo" not in t["blocks"]["attn"]


@pytest.mark.parametrize("S_,chunk,init", [(13, 4, True), (16, 8, False),
                                           (7, 16, True), (20, 3, False)])
def test_selective_scan_is_the_recurrence(S_, chunk, init):
    g = torch.Generator().manual_seed(S_)
    Bz, d, N = 2, 5, 3
    f64 = dict(dtype=torch.float64)
    ins = [torch.randn(Bz, S_, d, generator=g, **f64),
           torch.rand(Bz, S_, d, generator=g, **f64) * 2,
           -torch.rand(d, N, generator=g, **f64) * 10 - 0.5,
           torch.randn(Bz, S_, N, generator=g, **f64),
           torch.randn(Bz, S_, N, generator=g, **f64)]
    s0 = torch.randn(Bz, d, N, generator=g, **f64) if init else None
    ins = [x.requires_grad_() for x in ins]
    y, last = ssm.selective_scan(*ins, chunk=chunk, initial_state=s0)
    yr, lr = ssm.selective_scan_ref(*ins, initial_state=s0)
    torch.testing.assert_close(y, yr, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(last, lr, rtol=1e-12, atol=1e-12)
    gy, gl = torch.randn_like(y), torch.randn_like(last)
    got = torch.autograd.grad((y * gy).sum() + (last * gl).sum(), ins)
    want = torch.autograd.grad((yr * gy).sum() + (lr * gl).sum(), ins)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-11, atol=1e-11)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [8, 32])
def test_prefill_then_decode_is_the_full_forward(seq):
    cfg = reduced_cfg()
    par, rules = port_parts(cfg)
    params = WEIGHTS.nest(weights(cfg))
    b = batch(cfg, 1, rows=2, seq=seq)
    logits, cache = steps.make_prefill_step(
        cfg, rules, par, steps.ShapeConfig("p", "prefill", seq, 2))(
        params, {"tokens": b["tokens"]})
    assert int(cache["pos"][0]) == seq + cfg.meta_tokens
    toks = b["tokens"]
    decode = steps.make_decode_step(cfg, rules, par,
                                    steps.ShapeConfig("d", "decode", seq, 2))
    for i in range(3):
        nxt = (toks[:, -1:] * 7 + i) % cfg.vocab_size
        logits, cache = decode(params, cache, {"tokens": nxt})
        toks = torch.cat([toks, nxt], 1)
        with torch.inference_mode():
            want = steps.forward_train(params, cfg, rules, par,
                                       {"tokens": toks, "labels": toks})[0]
        torch.testing.assert_close(logits[:, -1], want[:, -1], rtol=1e-4,
                                   atol=1e-4)
    # a ring after the meta slots; the layer that reuses K/V keeps none
    layers_ = cache["layers"]
    assert layers_["k"].shape[:3] == (1, 2, cfg.meta_tokens +
                                      cfg.sliding_window)
    assert layers_["k_global"].shape[0] == 2
    assert layers_["state"].shape == (4, 2, cfg.d_inner, cfg.ssm_state)


def test_the_engine_serves_the_full_forwards_tokens():
    cfg = reduced_cfg()
    par, rules = port_parts(cfg)
    params = WEIGHTS.nest(weights(cfg))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 90, n).astype(np.int32) for n in (21, 5, 13)]
    eng = ServingEngine(cfg, params, slots=2, max_seq=48, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=4))
    got = {r.rid: r.out_tokens for r in eng.run_until_drained(300)}
    for i, p in enumerate(prompts):
        toks = torch.from_numpy(p)[None]
        want = []
        for _ in range(4):
            with torch.inference_mode():
                lg = steps.forward_train(params, cfg, rules, par,
                                         {"tokens": toks, "labels": toks})[0]
            want.append(int(lg[0, -1].argmax()))
            toks = torch.cat([toks, torch.tensor([[want[-1]]])], 1)
        assert got[i] == want, i


# ---------------------------------------------------------------------------
# train steps with shared K/V, spans on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["none", "block"])
def test_shared_kv_is_counted_once_a_layer_a_forward(remat):
    cfg = reduced_cfg()
    par, rules = port_parts(cfg, remat)
    params = WEIGHTS.nest(weights(cfg))
    opt = launch.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = steps.make_train_step(cfg, rules, par, opt)
    obs = Obs.on()
    with spans.activate(obs):
        for seed in (0, 1):
            step(params, adamw_init(params, opt), batch(cfg, seed))
    assert sum(len(g) - 1 for g in cfg.kv_groups) == 1
    # the attention span's forward phase once a layer a step, the
    # recompute of remat apart
    got = spans.collected(obs)
    assert got["steps"] == 2
    assert got["spans"]["attention/forward"]["count"] == 2 * cfg.num_layers
    full = get_spec("hymba-1.5b").model
    assert sum(len(g) - 1 for g in full.kv_groups) == 15
    spans.reset()
