"""The port's train step (repro_torch.models.steps.make_train_step: the
loss, its gradients through autograd, AdamW) against the reference's,
one arch of each family at reduced size, and the reference's training
checks (tests/test_models_smoke.py, tests/test_system.py) on the port.

Weights are the reference's ``params_lib.initialize(..., PRNGKey(0))``,
carried across with ``params.from_reference``; batches come from numpy
with a seed. float32: loss, metrics and every gradient within 1e-4
(rtol and atol); every parameter after 1 and 3 steps within 1e-4 but
for at most 0.1 % of them, and those within the largest move the steps
can make (Adam's g / (sqrt(v) + eps) normalises each element, so the
float32 rounding of a gradient near zero can move its update by up to
lr: those are counted, the gradients themselves are held to 1e-4).
``mixed_precision``
(bfloat16 compute): metrics within 5e-2 relative and each gradient
within 5e-2 of the reference's in norm (the two packages round bfloat16
apart, see tests/test_torch_lm_params.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tcfg
from repro.models import steps as rsteps
from repro.optim import optimizer as ropt
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import params as tparams
from repro_torch.models import steps as tsteps
from repro_torch.models.sharding import make_rules as tmake_rules
from repro_torch.optim import optimizer as topt
from test_torch_lm_params import (_jax_batch, _torch_batch, configs,
                                  make_inputs, port_batch, to_np, torch_np)

from repro.models import model_zoo as rzoo
from repro.models import params as rparams

TOL = 1e-4
BF16_TOL = 5e-2
#: the share of parameters allowed past TOL (Adam-amplified rounding)
ILL_SHARE = 1e-3
#: the most one Adam step moves a parameter, in units of lr (an update
#: m^ / (sqrt(v^) + eps) stays within a few units early on; decay adds
#: wd * |p|)
STEP_BOUND = 4.0
#: one arch of each family
FAMILY_ARCHS = ["llama3.2-1b", "mixtral-8x7b", "mamba2-1.3b", "hymba-1.5b",
                "seamless-m4t-medium", "pixtral-12b"]
#: an lr that moves the weights well past the tolerance in one step
OPT_KW = dict(lr=1e-3, warmup_steps=1, total_steps=100)
STEPS = 3


def assert_close(got, want, tol=TOL, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            assert_close(got[k], want[k], tol, f"{path}/{k}")
        return
    assert got.shape == want.shape, path
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=path)


def batches(cfg, n=STEPS):
    return [make_inputs(cfg, seed)["train"] for seed in range(n)]


def run_both(arch, dtype="float32", par_kw=None, n_steps=STEPS):
    """The reference's and the port's train steps from one set of weights
    on the same batches: per step (metrics, params) as numpy, and the
    first batch's grads, each package's."""
    (rc, rpar, rr), (tc, tpar, tr) = configs(arch, dtype)
    if par_kw:
        rpar, tpar = rpar.replace(**par_kw), tpar.replace(**par_kw)
    ref_params = rparams.initialize(rzoo.param_template(rc),
                                    jax.random.PRNGKey(0))
    data = batches(rc, n_steps)
    dt = jnp.dtype(dtype)
    # reference
    rstep = jax.jit(rsteps.make_train_step(rc, rr, rpar,
                                           ropt.OptimizerConfig(**OPT_KW)))
    rgrad = jax.jit(jax.value_and_grad(rsteps.make_loss_fn(rc, rr, rpar),
                                       has_aux=True))
    (_, _), ref_grads = rgrad(ref_params, _jax_batch(data[0], dt))
    p, o = ref_params, ropt.adamw_init(ref_params,
                                       ropt.OptimizerConfig(**OPT_KW))
    want = []
    for b in data:
        p, o, m = rstep(p, o, _jax_batch(b, dt))
        want.append((to_np(m), to_np(p)))
    # port
    params = tparams.from_reference(ref_params, device="cpu")
    tstep = tsteps.make_train_step(tc, tr, tpar,
                                   topt.OptimizerConfig(**OPT_KW))
    tdt = getattr(torch, dtype)
    _, port_grads = tsteps.value_and_grad(
        tsteps.make_loss_fn(tc, tr, tpar), params, _torch_batch(data[0], tdt))
    p, o = params, topt.adamw_init(params, topt.OptimizerConfig(**OPT_KW))
    got = []
    for b in data:
        p, o, m = tstep(p, o, _torch_batch(b, tdt))
        got.append((torch_np(m), torch_np(p)))
    return {"want": want, "got": got, "want_grads": to_np(ref_grads),
            "got_grads": torch_np(port_grads), "params": params}


def assert_params_close(got, want, steps, lr=OPT_KW["lr"], path=""):
    """Params within TOL but for at most ILL_SHARE of them, and those
    within the move ``steps`` Adam steps can make."""
    past, total = 0, 0
    got = dict(tparams.tree_leaves(got))
    for name, w in tparams.tree_leaves(want):
        g = got[name]
        assert g.shape == w.shape, name
        diff = np.abs(g - w)
        assert (diff <= STEP_BOUND * lr * steps * (1 + np.abs(w))).all(), \
            (f"{path}/{name}", float(diff.max()))
        past += int((diff > TOL * (1 + np.abs(w))).sum())
        total += w.size
    assert past <= ILL_SHARE * total, (path, past, total)


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def family(request):
    return request.param, run_both(request.param)


def test_metrics_equal_the_reference(family):
    _, r = family
    for i, ((gm, _), (wm, _)) in enumerate(zip(r["got"], r["want"])):
        assert set(gm) == set(wm) == {"loss", "z_loss", "aux_loss",
                                      "total_loss", "grad_norm", "lr"}
        assert_close(gm, wm, path=f"step {i}")


def test_grads_equal_the_reference(family):
    _, r = family
    assert_close(r["got_grads"], r["want_grads"], path="grads")


@pytest.mark.parametrize("step", [1, STEPS])
def test_params_after_steps_equal_the_reference(family, step):
    _, r = family
    got, want = r["got"][step - 1][1], r["want"][step - 1][1]
    assert_params_close(got, want, step, path=f"params after {step}")
    # and they moved: the comparison is not of the initial weights
    moved = max(float(np.abs(x - y).max()) for (_, x), (_, y) in zip(
        tparams.tree_leaves(got), tparams.tree_leaves(torch_np(r["params"]))))
    assert moved > 10 * TOL


def test_train_step_leaves_its_arguments_as_they_are():
    cfg, par, rules, params = _port("llama3.2-1b")
    opt_cfg = topt.OptimizerConfig(**OPT_KW)
    opt = topt.adamw_init(params, opt_cfg)
    before = {n: x.clone() for n, x in tparams.tree_leaves(params)}
    batch = port_batch(cfg, "train", 32, 2, np.random.default_rng(0))
    new, new_opt, m = tsteps.make_train_step(cfg, rules, par, opt_cfg)(
        params, opt, batch)
    for n, x in tparams.tree_leaves(params):
        assert torch.equal(x, before[n]), n
        assert not x.requires_grad and x.grad is None
    assert int(opt["count"]) == 0 and int(new_opt["count"]) == 1
    assert all(not x.requires_grad and x.grad_fn is None
               for _, x in tparams.tree_leaves(new))
    assert all(v.grad_fn is None for v in m.values())


# ---------------------------------------------------------------------------
# remat, grad accumulation, mixed precision
# ---------------------------------------------------------------------------

def _port(arch, dtype=None, **par_kw):
    spec = tcfg.get_spec(arch)
    cfg = tcfg.reduced_model(spec.model)
    if dtype:
        cfg = cfg.replace(dtype=dtype)
    par = spec.parallelism.replace(remat="none", fsdp=False,
                                   sequence_parallel=False).replace(**par_kw)
    params = tparams.initialize(tzoo.param_template(cfg), 0, device="cpu")
    return cfg, par, tmake_rules(None, cfg, par), params


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_gives_the_same_grads(arch):
    """remat "block" and "full" recompute each block in the backward: the
    loss and every gradient equal those of remat "none" bit for bit."""
    cfg, _, _, params = _port(arch, "float32")
    batch = port_batch(cfg, "train", 64, 2, np.random.default_rng(1))
    outs = {}
    for remat in ("none", "block", "full"):
        _, par, rules, _ = _port(arch, "float32", remat=remat)
        (loss, _), grads = tsteps.value_and_grad(
            tsteps.make_loss_fn(cfg, rules, par), params, batch)
        outs[remat] = (loss, dict(tparams.tree_leaves(grads)))
    for remat in ("block", "full"):
        assert torch.equal(outs[remat][0], outs["none"][0]), remat
        for n, g in outs["none"][1].items():
            assert torch.equal(outs[remat][1][n], g), (remat, n)


def test_remat_recomputes_in_the_backward(monkeypatch):
    """With remat "block" each block body runs twice a step (forward and
    recompute), once without; serving steps never recompute."""
    calls = []
    orig = tzoo._decoder_block

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tzoo, "_decoder_block", counting)
    for remat, want in (("none", 2), ("block", 4)):
        cfg, par, rules, params = _port("llama3.2-1b", "float32",
                                        remat=remat)
        calls.clear()
        batch = port_batch(cfg, "train", 32, 2, np.random.default_rng(0))
        tsteps.value_and_grad(tsteps.make_loss_fn(cfg, rules, par), params,
                              batch)
        assert len(calls) == want, remat
        calls.clear()
        prefill = tsteps.make_prefill_step(
            cfg, rules, par, tcfg.ShapeConfig("p", "prefill", 32, 2))
        prefill(params, {"tokens": batch["tokens"]})
        assert len(calls) == cfg.num_layers, remat


@pytest.mark.parametrize("remat", ["block", "full"])
def test_remat_train_step_equals_the_reference(remat):
    r = run_both("hymba-1.5b", par_kw=dict(remat=remat), n_steps=1)
    assert_close(r["got_grads"], r["want_grads"], path="grads")
    assert_params_close(r["got"][0][1], r["want"][0][1], 1, path="params")


def test_grad_accumulation_matches_large_batch():
    """grad_accum=2 over a split batch == one step on the whole batch
    (the reference's check, tests/test_system.py), and equal to the
    reference's grad_accum=2 step."""
    cfg, base, rules, params = _port("llama3.2-1b", "float32")
    opt_cfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=100,
                                   clip_norm=0.0)
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 100, (4, 65)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(seq[:, :-1].copy()),
             "labels": torch.from_numpy(seq[:, 1:].copy())}
    outs = []
    for accum in (1, 2):
        par = base.replace(grad_accum=accum)
        step = tsteps.make_train_step(cfg, rules, par, opt_cfg)
        p2, _, m = step(params, topt.adamw_init(params, opt_cfg), batch)
        outs.append((torch_np(p2), torch_np(m)))
    assert_close(outs[1][0], outs[0][0], path="accum 2 vs 1")
    # against the reference's accumulating step on the same weights
    (rc, rpar, rr), _ = configs("llama3.2-1b", "float32")
    ref_params = rparams.initialize(rzoo.param_template(rc),
                                    jax.random.PRNGKey(0))
    rcfg_opt = ropt.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                    total_steps=100, clip_norm=0.0)
    rstep = jax.jit(rsteps.make_train_step(rc, rr, rpar.replace(grad_accum=2),
                                           rcfg_opt))
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want_p, _, want_m = rstep(ref_params,
                              ropt.adamw_init(ref_params, rcfg_opt), jb)
    tp = tparams.from_reference(ref_params, device="cpu")
    step = tsteps.make_train_step(cfg, rules, base.replace(grad_accum=2),
                                  opt_cfg)
    got_p, _, got_m = step(tp, topt.adamw_init(tp, opt_cfg), batch)
    assert_params_close(torch_np(got_p), to_np(want_p), 1,
                        path="accum 2 params")
    assert_close(torch_np(got_m), to_np(want_m), path="accum 2 metrics")


def test_mixed_precision_equals_the_reference():
    """bf16 compute params over float32 masters: metrics and gradients
    against the reference's mixed-precision step; the params stay
    float32."""
    (rc, rpar, rr), (tc, tpar, tr) = configs("llama3.2-1b", "bfloat16")
    rpar, tpar = rpar.replace(mixed_precision=True), \
        tpar.replace(mixed_precision=True)
    ref_params = rparams.initialize(rzoo.param_template(rc),
                                    jax.random.PRNGKey(0))
    b = batches(rc, 1)[0]
    rcfg_opt = ropt.OptimizerConfig(**OPT_KW)
    rp, _, rm = jax.jit(rsteps.make_train_step(rc, rr, rpar, rcfg_opt))(
        ref_params, ropt.adamw_init(ref_params, rcfg_opt),
        _jax_batch(b, jnp.bfloat16))
    tp = tparams.from_reference(ref_params, device="cpu")
    tcfg_opt = topt.OptimizerConfig(**OPT_KW)
    gp, _, gm = tsteps.make_train_step(tc, tr, tpar, tcfg_opt)(
        tp, topt.adamw_init(tp, tcfg_opt), _torch_batch(b, torch.bfloat16))
    for k, w in to_np(rm).items():
        assert float(gm[k]) == pytest.approx(float(w), rel=BF16_TOL), k
    assert all(x.dtype == torch.float32 for _, x in tparams.tree_leaves(gp))
    # the gradients, through the reference's own mixed-precision wrap
    base = rsteps.make_loss_fn(rc, rr, rpar)

    def rloss(params, batch):
        return base(jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16), params), batch)

    _, rg = jax.jit(jax.value_and_grad(rloss, has_aux=True))(
        ref_params, _jax_batch(b, jnp.bfloat16))
    tloss = tsteps.make_loss_fn(tc, tr, tpar)
    _, tg = tsteps.value_and_grad(
        lambda p, x: tloss(tsteps._cast_floating(p, torch.bfloat16), x), tp,
        _torch_batch(b, torch.bfloat16))
    want_g = dict(tparams.tree_leaves(to_np(rg)))
    for n, g in tparams.tree_leaves(torch_np(tg)):
        w = want_g[n]
        assert g.dtype == np.float32, n
        assert np.linalg.norm(g - w) <= BF16_TOL * np.linalg.norm(w) + 1e-6, n


# ---------------------------------------------------------------------------
# the reference's training checks on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", tcfg.list_archs() + ["llama100m"])
def test_train_step_shapes_and_finite(arch):
    """tests/test_models_smoke.py's train-step check on every arch: loss
    and grad norm finite, the params moved, every gradient finite."""
    cfg, par, rules, params = _port(arch)
    batch = port_batch(cfg, "train", 64, 2, np.random.default_rng(0))
    opt_cfg = topt.OptimizerConfig()
    new_params, _, metrics = tsteps.make_train_step(cfg, rules, par,
                                                    opt_cfg)(
        params, topt.adamw_init(params, opt_cfg), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    moved = max(float((a.float() - b.float()).abs().max())
                for (_, a), (_, b) in zip(tparams.tree_leaves(params),
                                          tparams.tree_leaves(new_params)))
    assert moved > 0
    _, grads = tsteps.value_and_grad(tsteps.make_loss_fn(cfg, rules, par),
                                     params, batch)
    for name, g in tparams.tree_leaves(grads):
        assert torch.isfinite(g.float()).all(), name


def test_training_overfits_fixed_batch():
    """tests/test_system.py: the optimizer + model together learn (loss
    drops 40%+ on one batch in 120 steps)."""
    cfg, par, rules, params = _port("llama3.2-1b")
    opt_cfg = topt.OptimizerConfig(lr=2e-3, warmup_steps=10,
                                   total_steps=10_000, weight_decay=0.0)
    step_fn = tsteps.make_train_step(cfg, rules, par, opt_cfg)
    opt = topt.adamw_init(params, opt_cfg)
    seq = np.random.default_rng(0).integers(0, 100, (4, 65)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(seq[:, :-1].copy()),
             "labels": torch.from_numpy(seq[:, 1:].copy())}
    first = None
    for _ in range(120):
        params, opt, m = step_fn(params, opt, batch)
        if first is None:
            first = float(m["loss"])
    last = float(m["loss"])
    assert last < first * 0.6, (first, last)


def test_train_then_serve_roundtrip(tmp_path):
    """tests/test_system.py: train a few steps, checkpoint, restore, serve
    greedily — the served model is the restored one."""
    from repro_torch.checkpoint.manager import restore, save
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.serving.engine import Request, ServingEngine

    cfg, par, rules, params = _port("llama3.2-1b")
    opt_cfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    step_fn = tsteps.make_train_step(cfg, rules, par, opt_cfg)
    data = DataPipeline(cfg, tcfg.ShapeConfig("t", "train", 64, 2),
                        DataConfig())
    opt = topt.adamw_init(params, opt_cfg)
    for s in range(3):
        b = {k: torch.from_numpy(v) for k, v in data.batch_at(s).items()}
        params, opt, _ = step_fn(params, opt, b)
    save(tmp_path, 3, {"params": params})
    restored, _ = restore(tmp_path, {"params": params}, device="cpu")

    prompt = np.array([5, 17, 9, 31], np.int32)
    outs = []
    for p in (params, restored["params"]):
        eng = ServingEngine(cfg, p, slots=1, max_seq=32, device="cpu")
        eng.submit(Request(rid=0, prompt=prompt.copy(), max_new_tokens=4))
        outs.append(eng.run_until_drained(max_steps=100)[0].out_tokens)
    assert outs[0] == outs[1] and len(outs[0]) == 4


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hymba-1.5b"])
def test_remat_does_not_change_serving(arch):
    """The serving engine runs the zoo under ``inference_mode``: remat
    "block" serves the tokens of remat "none" (the engine's own
    Parallelism keeps "none")."""
    from repro_torch.serving.engine import Request, ServingEngine
    cfg, _, _, params = _port(arch)
    prompt = np.array([3, 14, 15, 9, 2], np.int32)
    assert ServingEngine(cfg, params, slots=1, max_seq=8,
                         device="cpu").par.remat == "none"
    served = []
    for remat in ("none", "block"):
        eng = ServingEngine(cfg, params, slots=2, max_seq=32, device="cpu",
                            par=tcfg.Parallelism(remat=remat))
        eng.submit(Request(rid=0, prompt=prompt.copy(), max_new_tokens=5))
        served.append(eng.run_until_drained(max_steps=100)[0].out_tokens)
    assert served[0] == served[1] and len(served[0]) == 5


def test_make_step_builds_a_train_step_for_train_shapes():
    cfg = tcfg.reduced_model(tcfg.get_spec("llama3.2-1b").model)
    par = tcfg.Parallelism(remat="none", moment_dtype="int8")
    rules = tmake_rules(None, cfg, par)
    step = tsteps.make_step(cfg, rules, par, tcfg.SHAPES["train_4k"])
    assert step.__name__ == "train_step"
    params = tparams.initialize(tzoo.param_template(cfg), 0, device="cpu")
    opt = topt.adamw_init(params, topt.OptimizerConfig(moment_dtype="int8"))
    batch = port_batch(cfg, "train", 16, 2, np.random.default_rng(0))
    _, new_opt, _ = step(params, opt, batch)
    assert new_opt["m"]["embed"]["q"].dtype == torch.int8


def test_stacked_layers_unbind_once_for_the_backward():
    """The zoo takes each layer of the stacked ``[L, ...]`` params with one
    ``unbind`` a leaf: the same values as indexing each layer, and a
    backward that stacks the L gradients once (indexing would add L
    whole-leaf gradients)."""
    cfg, _, _, params = _port("llama3.2-1b", "float32")
    blocks = tparams.tree_map(lambda x: x.detach().requires_grad_(True),
                              params["blocks"],
                              is_leaf=lambda x: not isinstance(x, dict))
    per_layer = tzoo._layers(blocks, cfg.num_layers)
    assert len(per_layer) == cfg.num_layers
    for l, lp in enumerate(per_layer):
        want = tzoo._layer(blocks, l)
        for (name, x), (_, y) in zip(tparams.tree_leaves(lp),
                                     tparams.tree_leaves(want)):
            assert torch.equal(x, y), name
            assert type(x.grad_fn).__name__ == "UnbindBackward0", name
    w = blocks["attn"]["wq"]
    total = sum((lp["attn"]["wq"] * (l + 1)).sum()
                for l, lp in enumerate(per_layer))
    g, = torch.autograd.grad(total, [w])
    assert torch.equal(g, torch.arange(1, cfg.num_layers + 1,
                                       dtype=torch.float32).view(
        -1, 1, 1, 1).expand_as(w))
