"""The port's LM parameter machinery (repro_torch.models.params, .sharding
and the templates of .steps) against the reference's, and the helpers
that the zoo, MoE and serving tests share: one arch at reduced size
through both packages, with the reference's weights carried across.

Weights are the reference's ``params_lib.initialize(..., PRNGKey(0))``,
made in the test process and carried with ``from_reference``; inputs
come from numpy with a seed. float32 results agree to 1e-4 (rtol and
atol), integers exactly. In the config's own bfloat16 the reference's
5e-2 (``tests/test_models_smoke.py``) holds for at least 99 % of the
elements of each output and twice it for every element: the two
packages round bfloat16 apart (see ``assert_tree_close``).
"""
import dataclasses
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.models.moe as rmoe
from repro.models import model_zoo as rzoo
from repro.models import params as rparams
from repro.models import steps as rsteps
from repro.models.sharding import make_rules as rmake_rules
import repro_torch.configs as tcfg
import repro_torch.models.moe as tmoe
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import params as tparams
from repro_torch.models import steps as tsteps
from repro_torch.models.sharding import make_rules as tmake_rules

ROOT = Path(__file__).resolve().parents[1]
ALL_ARCHS = rcfg.list_archs() + ["llama100m"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
#: the reference smoke tests' knobs for one device
PAR_KW = dict(remat="none", fsdp=False, sequence_parallel=False)
S, B, DECODE_STEPS = 64, 2, 2
#: a router probability gap below which bfloat16 rounding may reorder
#: two experts (the reference's and the port's bf16 ops round apart)
NEAR_TIE = 2e-2
#: the share of bfloat16 elements allowed past 5e-2 (but within 1e-1)
BF16_OUTLIERS = 1e-2


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def port_spec(arch: str, reduced: bool = False):
    """The port's ArchSpec of ``arch`` built from the reference's, field
    for field (reduced first when ``reduced``): what every test that
    pairs the two packages runs on the port's side. The port's fields
    the reference lacks keep their defaults, so its hymba-1.5b is the
    reference's stand-in block, not the published one the port's own
    config describes."""
    spec = rcfg.get_spec(arch)
    model = rcfg.reduced_model(spec.model) if reduced else spec.model
    return tcfg.ArchSpec(
        tcfg.ModelConfig(**dataclasses.asdict(model)),
        tcfg.Parallelism(**dataclasses.asdict(spec.parallelism)),
        source=spec.source)


def configs(arch: str, dtype: str):
    """(reference cfg, par, rules), (port cfg, par, rules) at reduced
    size in ``dtype``; the port's built from the reference's
    (:func:`port_spec`)."""
    out = []
    for lib, make in ((rcfg, rmake_rules), (tcfg, tmake_rules)):
        spec = (lib.get_spec(arch) if lib is rcfg else
                port_spec(arch))
        cfg = lib.reduced_model(spec.model).replace(dtype=dtype)
        par = spec.parallelism.replace(**PAR_KW)
        out.append((cfg, par, make(None, cfg, par)))
    return out


def to_np(tree):
    """A reference tree as numpy (bfloat16 as float32)."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32))
        if x.dtype == jnp.bfloat16 else np.asarray(x), tree)


def torch_np(tree):
    return tparams.tree_map(
        lambda x: x.float().numpy() if x.dtype == torch.bfloat16
        else x.numpy(), tree, is_leaf=lambda x: not isinstance(x, dict))


def make_inputs(cfg, seed: int = 0) -> dict:
    """numpy inputs of one arch: a train batch and a prefill batch of
    S tokens (the reference smoke tests' draw), ``DECODE_STEPS`` next
    tokens."""
    rng = np.random.default_rng(seed)

    def batch(kind):
        out = {}
        shape = rcfg.ShapeConfig(kind, kind, S, B)
        for k, p in rsteps.batch_template(cfg, shape).items():
            if p.dtype == "int32":
                out[k] = rng.integers(0, min(cfg.vocab_size, 100),
                                      p.shape).astype(np.int32)
            else:
                out[k] = rng.normal(size=p.shape).astype(np.float32)
        return out

    return {"train": batch("train"), "prefill": batch("prefill"),
            "next": [rng.integers(1, 90, (B, 1)).astype(np.int32)
                     for _ in range(DECODE_STEPS)]}


def _jax_batch(batch, dtype):
    return {k: jnp.asarray(v, dtype if v.dtype == np.float32 else jnp.int32)
            for k, v in batch.items()}


def _torch_batch(batch, dtype):
    return {k: torch.from_numpy(v).to(dtype if v.dtype == np.float32
                                      else torch.int32)
            for k, v in batch.items()}


@contextmanager
def recording_reference_routes(log: list):
    """Route decisions of the reference's MoE layers, in call order (an
    ordered host callback inside the jitted steps)."""
    orig = rmoe.route

    def route(x, w, num_experts, top_k):
        weights, idx, aux = orig(x, w, num_experts, top_k)
        jax.debug.callback(lambda i: log.append(np.asarray(i)), idx,
                           ordered=True)
        return weights, idx, aux

    rmoe.route = route
    try:
        yield
    finally:
        rmoe.route = orig


def run_reference(arch: str, dtype: str, inputs: dict):
    """The reference's forward, prefill and decode steps at reduced size
    on ``inputs``: (params, outputs as numpy, MoE routes by phase)."""
    (cfg, par, rules), _ = configs(arch, dtype)
    params = rparams.initialize(rzoo.param_template(cfg),
                                jax.random.PRNGKey(0))
    dt = jnp.dtype(dtype)
    routes = {}
    out = {}
    with recording_reference_routes(log := []):
        fwd = jax.jit(lambda p, b: rsteps.forward_train(p, cfg, rules, par,
                                                        b)[0])
        out["forward"] = to_np(fwd(params, _jax_batch(inputs["train"], dt)))
        jax.effects_barrier()
        routes["forward"], log[:] = list(log), []
        prefill = jax.jit(rsteps.make_prefill_step(
            cfg, rules, par, rcfg.ShapeConfig("p", "prefill", S, B)))
        logits, cache = prefill(params, _jax_batch(inputs["prefill"], dt))
        out["prefill"], out["prefill_cache"] = to_np((logits, cache))
        jax.effects_barrier()
        routes["prefill"], log[:] = list(log), []
        decode = jax.jit(rsteps.make_decode_step(
            cfg, rules, par, rcfg.ShapeConfig("d", "decode", S, B)))
        for i, tok in enumerate(inputs["next"]):
            logits, cache = decode(params, cache,
                                   {"tokens": jnp.asarray(tok)})
            out[f"decode{i}"] = to_np(logits)
            jax.effects_barrier()
            routes[f"decode{i}"], log[:] = list(log), []
        out["decode_cache"] = to_np(cache)
    return params, out, routes


@contextmanager
def port_routes(want: list, log: list):
    """The port's MoE layers routed as the reference's ``want`` (in call
    order), each call's own decision and probabilities logged: under
    bfloat16 the two packages round apart, and a token whose top-k
    experts are near-tied may pick another; the tests check that every
    such difference is a near-tie, then compare the rest of the model
    on the same routes."""
    orig = tmoe.route

    def route(x, w, num_experts, top_k):
        weights, idx, aux = orig(x, w, num_experts, top_k)
        probs = torch.softmax(torch.einsum("bsd,de->bse", x.float(),
                                           w.float()), dim=-1)
        ref_idx = torch.from_numpy(np.array(want.pop(0))).long()
        log.append((idx.numpy(), ref_idx.numpy(), probs.numpy()))
        forced = torch.gather(probs, -1, ref_idx)
        forced = forced / torch.clamp(forced.sum(-1, keepdim=True), min=1e-9)
        return forced, ref_idx, aux

    tmoe.route = route
    try:
        yield
    finally:
        tmoe.route = orig


def run_port(arch: str, dtype: str, ref_params, inputs: dict,
             ref_routes: dict):
    """The port's steps on the same weights and inputs: (outputs as
    numpy, MoE route logs by phase)."""
    _, (cfg, par, rules) = configs(arch, dtype)
    params = tparams.from_reference(ref_params, device="cpu")
    dt = getattr(torch, dtype)
    out, logs = {}, {}
    phases = ["forward", "prefill"] + [f"decode{i}" for i in
                                       range(len(inputs["next"]))]
    want = {ph: list(ref_routes[ph]) for ph in phases}
    with port_routes(want["forward"], logs.setdefault("forward", [])), \
            torch.inference_mode():
        out["forward"] = torch_np(tsteps.forward_train(
            params, cfg, rules, par, _torch_batch(inputs["train"], dt))[0])
    with port_routes(want["prefill"], logs.setdefault("prefill", [])):
        logits, cache = tsteps.make_prefill_step(
            cfg, rules, par, tcfg.ShapeConfig("p", "prefill", S, B))(
            params, _torch_batch(inputs["prefill"], dt))
    out["prefill"], out["prefill_cache"] = torch_np(logits), torch_np(cache)
    decode = tsteps.make_decode_step(cfg, rules, par,
                                     tcfg.ShapeConfig("d", "decode", S, B))
    for i, tok in enumerate(inputs["next"]):
        with port_routes(want[f"decode{i}"], logs.setdefault(f"decode{i}",
                                                             [])):
            logits, cache = decode(params, cache,
                                   {"tokens": torch.from_numpy(tok)})
        out[f"decode{i}"] = torch_np(logits)
    out["decode_cache"] = torch_np(cache)
    assert all(not w for w in want.values()), "route calls differ"
    return out, logs


def assert_tree_close(got, want, tol: float, path: str = ""):
    """Float leaves within ``tol`` (rtol and atol), integer leaves
    equal; the same keys and shapes."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            assert_tree_close(got[k], want[k], tol, f"{path}/{k}")
        return
    assert got.shape == want.shape, (path, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif tol == TOL["float32"]:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=path)
    else:
        # two bfloat16 implementations round apart (XLA on the CPU rounds
        # every step of silu and takes Python scalars as bfloat16;
        # PyTorch rounds silu once and keeps scalars in float32): a few
        # logits in ten thousand land past 5e-2, none past twice it
        err = np.abs(got - want) / (tol * (1 + np.abs(want)))
        assert err.max() <= 2 and np.mean(err > 1) <= BF16_OUTLIERS, \
            (path, float(err.max()), float(np.mean(err > 1)))


def check_routes(logs: dict, dtype: str):
    """float32: the port routes every token as the reference does.
    bfloat16: where it does not, the experts it swapped are near-tied
    in its own probabilities."""
    for phase, calls in logs.items():
        for own, ref, probs in calls:
            diff = np.sort(own, -1) != np.sort(ref, -1)
            if dtype == "float32":
                assert not diff.any(), phase
                continue
            for b, s in zip(*np.nonzero(diff.any(-1))):
                p = probs[b, s]
                kth = np.sort(p[own[b, s]]).min()
                gap = np.abs(p[np.setdiff1d(ref[b, s], own[b, s])] - kth)
                assert (gap < NEAR_TIE).all(), (phase, b, s, gap)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init", ["zeros", "neg1", "ones", "ssm_a",
                                  "ssm_dt"])
def test_deterministic_inits_equal_the_reference(init):
    p = tparams.P((3, 7), (None, None), init)
    want = rparams._init_leaf(rparams.P((3, 7), (None, None), init),
                              jax.random.PRNGKey(0))
    got = tparams._init_leaf(p, None, "cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("init,fan_in,std", [("embed", None, 0.02),
                                             ("normal", None, 0.02),
                                             ("fanin", None, 1 / 16),
                                             ("fanin", 64, 1 / 8)])
def test_random_inits_draw_the_reference_law(init, fan_in, std):
    p = tparams.P((8, 256, 128), (None, None, None), init, fan_in=fan_in)
    x = tparams.initialize({"w": p}, 3, device="cpu")["w"]
    assert x.dtype == torch.float32 and x.shape == (8, 256, 128)
    assert abs(float(x.mean())) < 0.01 * std
    assert abs(float(x.std()) / std - 1) < 0.01


def test_initialize_seeds_each_leaf_from_its_path():
    t = tzoo.param_template(tcfg.reduced_model(
        tcfg.get_spec("hymba-1.5b").model))
    a = tparams.initialize(t, 5, device="cpu")
    b = tparams.initialize(t, 5, device="cpu")
    c = tparams.initialize(t, 6, device="cpu")
    for (name, x), (_, y), (_, z) in zip(tparams.tree_leaves(a),
                                         tparams.tree_leaves(b),
                                         tparams.tree_leaves(c)):
        assert torch.equal(x, y), name
        p = dict(tparams.tree_leaves(t))[name]
        assert torch.equal(x, z) == (p.init not in ("embed", "normal",
                                                    "fanin")), name
    # a leaf's values depend on its path only, not on the other leaves
    alone = tparams.initialize({"blocks": {"attn": t["blocks"]["attn"]}}, 5,
                               device="cpu")
    assert torch.equal(alone["blocks"]["attn"]["wq"],
                       a["blocks"]["attn"]["wq"])
    g = torch.Generator().manual_seed(11)
    h = torch.Generator().manual_seed(11)
    assert torch.equal(tparams.initialize(t, g, device="cpu")["embed"],
                       tparams.initialize(t, h, device="cpu")["embed"])


def test_initialize_gives_the_same_weights_in_two_processes():
    """The reference's ``hash(name)`` keys differ per process; the port's
    path seeds do not."""
    code = ("import hashlib, torch\n"
            "from repro_torch.configs import get_spec, reduced_model\n"
            "from repro_torch.models import model_zoo, params\n"
            "cfg = reduced_model(get_spec('mixtral-8x7b').model)\n"
            "p = params.initialize(model_zoo.param_template(cfg), 0, "
            "device='cpu')\n"
            "h = hashlib.sha256()\n"
            "for _, x in params.tree_leaves(p):\n"
            "    h.update(x.numpy().tobytes())\n"
            "print(h.hexdigest())\n")
    digests = {subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, check=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PYTHONHASHSEED": seed,
             "PATH": "/usr/bin:/bin"}).stdout.strip()
        for seed in ("1", "2")}
    assert len(digests) == 1 and len(next(iter(digests))) == 64


def test_abstract_allocates_nothing():
    t = tzoo.param_template(tcfg.get_spec("grok-1-314b").model)
    tree = tparams.abstract(t)
    leaves = list(tparams.tree_leaves(tree))
    assert all(x.device.type == "meta" for _, x in leaves)
    assert sum(x.numel() for _, x in leaves) == tzoo.param_count(
        tcfg.get_spec("grok-1-314b").model)
    assert tparams.bytes_params(t) == rparams.bytes_params(
        rzoo.param_template(rcfg.get_spec("grok-1-314b").model))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int32])
def test_from_reference_keeps_paths_and_values(dtype):
    tree = {"a": {"b": jnp.arange(6, dtype=dtype).reshape(2, 3) - 2},
            "c": np.ones((4,), np.float32)}
    got = tparams.from_reference(tree, device="cpu")
    assert str(got["a"]["b"].dtype) == f"torch.{jnp.dtype(dtype).name}"
    np.testing.assert_array_equal(
        got["a"]["b"].float().numpy(),
        np.asarray(tree["a"]["b"].astype(jnp.float32)))
    cast = tparams.from_reference(tree, device="cpu", dtype=torch.float64)
    assert cast["c"].dtype == torch.float64
    assert cast["a"]["b"].dtype == (torch.int32 if dtype == jnp.int32
                                    else torch.float64)


def test_initialize_and_from_reference_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal shows only without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparams.initialize({"w": tparams.P((2,), (None,))}, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparams.from_reference({"w": np.zeros(2)})


# ---------------------------------------------------------------------------
# sharding rules and step templates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("pure_dp", [False, True])
def test_rules_spec_every_leaf_as_the_reference(arch, pure_dp):
    rspec, tspec = rcfg.get_spec(arch), port_spec(arch)
    rr = rmake_rules(None, rspec.model,
                     rspec.parallelism.replace(pure_dp=pure_dp))
    tr = tmake_rules(None, tspec.model,
                     tspec.parallelism.replace(pure_dp=pure_dp))
    assert tr.mapping == rr.mapping
    rt = rzoo.param_template(rspec.model)
    assert _port_leaves(tzoo.param_template(tspec.model)) == \
        sorted(_ref_leaves(rt))
    for name, p in tparams.tree_leaves(tzoo.param_template(tspec.model)):
        assert tr.spec(p.axes, p.shape) == tuple(rr.spec(p.axes, p.shape))
        assert tr.sharding(p.axes, p.shape) is None
    x = torch.zeros(2, 3)
    assert tr.constrain(x, "batch", None) is x
    assert tr.downgrades == rr.downgrades == []


def test_a_mesh_is_refused():
    """Only a mesh is taken as one: a DeviceMesh or an AbstractMesh (the
    mesh paths are held in tests/test_torch_sharding_rules.py and
    tests/test_torch_mesh_train.py)."""
    cfg = tcfg.get_spec("llama3.2-1b")
    with pytest.raises(TypeError, match="a mesh is a DeviceMesh"):
        tmake_rules(object(), cfg.model, cfg.parallelism)


def _leaf_fields(p):
    return (tuple(p.shape), tuple(p.axes), p.init, p.dtype, p.fan_in)


def _ref_leaves(tree):
    return [("/".join(str(k.key) for k in path), _leaf_fields(p))
            for path, p in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, rparams.P))[0]]


def _port_leaves(tree):
    return sorted((name, _leaf_fields(p))
                  for name, p in tparams.tree_leaves(tree))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_and_batch_templates_equal_the_reference(arch):
    rm, tm = rcfg.get_spec(arch).model, port_spec(arch).model
    rm, tm = rcfg.reduced_model(rm), tcfg.reduced_model(tm)
    for kind, seq in (("train", 1100), ("prefill", 1100), ("decode", 40)):
        rs = rcfg.ShapeConfig(kind, kind, seq, 3)
        ts = tcfg.ShapeConfig(kind, kind, seq, 3)
        for extra in (0, rsteps.DECODE_HEADROOM):
            assert tsteps.cache_slots(tm, ts, extra) == \
                rsteps.cache_slots(rm, rs, extra)
            assert _port_leaves(tsteps.cache_template(tm, ts, extra)) == \
                sorted(_ref_leaves(rsteps.cache_template(rm, rs, extra)))
        assert _port_leaves(tsteps.batch_template(tm, ts)) == \
            sorted(_ref_leaves(rsteps.batch_template(rm, rs)))


def test_softmax_xent_equals_the_reference():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (2, 9, 40)).astype(np.float32)
    labels = rng.integers(-3, 45, (2, 9)).astype(np.int32)
    labels[0, :3] = tsteps.LABEL_IGNORE
    want = rsteps.softmax_xent(jnp.asarray(logits), jnp.asarray(labels), 37)
    got = tsteps.softmax_xent(torch.from_numpy(logits),
                              torch.from_numpy(labels), 37)
    assert tsteps.LABEL_IGNORE == rsteps.LABEL_IGNORE
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def test_make_step_refuses_training_and_builds_the_rest():
    """make_step builds all three steps: train, prefill and decode."""
    cfg = tcfg.reduced_model(tcfg.get_spec("llama3.2-1b").model)
    par = tcfg.Parallelism(remat="none")
    rules = tmake_rules(None, cfg, par)
    assert tsteps.make_step(cfg, rules, par, tcfg.SHAPES["train_4k"]
                            ).__name__ == "train_step"
    assert tsteps.make_step(cfg, rules, par, tcfg.SHAPES["prefill_32k"]
                            ).__name__ == "prefill_step"
    assert tsteps.make_step(cfg, rules, par, tcfg.SHAPES["decode_32k"]
                            ).__name__ == "decode_step"


# ---------------------------------------------------------------------------
# the zoo tests' shared body (tests/test_torch_model_zoo_*.py)
# ---------------------------------------------------------------------------

#: what a zoo test compares: the train forward's logits, prefill's
#: logits and cache, each decode step's logits, the cache after them
OUTPUTS = ["forward", "prefill", "prefill_cache"] + \
    [f"decode{i}" for i in range(DECODE_STEPS)] + ["decode_cache"]


def zoo_cases(archs):
    return [(a, d) for a in archs for d in TOL]


def zoo_pair(request):
    """One (arch, dtype) through both packages on the reference's
    weights: (dtype, port outputs, reference outputs, MoE route logs)."""
    arch, dtype = request.param
    (cfg, _, _), _ = configs(arch, dtype)
    inputs = make_inputs(cfg)
    params, want, routes = run_reference(arch, dtype, inputs)
    got, logs = run_port(arch, dtype, params, inputs, routes)
    return dtype, got, want, logs


def check_output(pair, what):
    dtype, got, want, logs = pair
    check_routes(logs, dtype)
    assert_tree_close(got[what], want[what], TOL[dtype], what)


def port_build(arch):
    """The reference smoke tests' ``build`` on the port: the reduced
    config in its own dtype, the port's weights from seed 0."""
    spec = tcfg.get_spec(arch)
    cfg = tcfg.reduced_model(spec.model)
    par = spec.parallelism.replace(**PAR_KW)
    params = tparams.initialize(tzoo.param_template(cfg), 0, device="cpu")
    return cfg, par, tmake_rules(None, cfg, par), params


def port_batch(cfg, kind, seq, batch, rng):
    out = {}
    for k, p in tsteps.batch_template(
            cfg, tcfg.ShapeConfig(kind, kind, seq, batch)).items():
        if p.dtype == "int32":
            out[k] = torch.from_numpy(rng.integers(
                0, min(cfg.vocab_size, 100), p.shape).astype(np.int32))
        else:
            out[k] = torch.from_numpy(rng.normal(size=p.shape)).to(
                tparams.torch_dtype(p.dtype))
    return out


def check_decode_after_prefill(arch, seq=32, batch=2, next_tok=None):
    """The reference's consistency checks on the port
    (``test_prefill_decode_matches_forward``,
    ``test_swa_ring_cache_consistency``): logits of a decode step after a
    prefill of ``seq`` tokens equal the forward's last logits over the
    extended stream (audio: shaped and finite), in the config's dtype at
    the reference's 5e-2. Returns the prefill cache."""
    rng = np.random.default_rng(0)
    cfg, par, rules, params = port_build(arch)
    b = port_batch(cfg, "prefill", seq, batch, rng)
    _, cache = tsteps.make_prefill_step(
        cfg, rules, par, tcfg.ShapeConfig("p", "prefill", seq, batch))(
        params, b)
    if next_tok is None:
        next_tok = rng.integers(1, 90, (batch, 1)).astype(np.int32)
    nxt = torch.from_numpy(next_tok)
    dlogits, _ = tsteps.make_decode_step(
        cfg, rules, par, tcfg.ShapeConfig("d", "decode", seq, batch))(
        params, cache, {"tokens": nxt})
    assert dlogits.shape == (batch, 1, tzoo.padded_vocab(cfg.vocab_size))
    if cfg.family == "audio":
        assert torch.isfinite(dlogits.float()).all()
        return cache
    ext = {"tokens": torch.cat([b["tokens"], nxt], dim=1)}
    if cfg.family == "vlm":
        ext["patch_embeds"] = b["patch_embeds"]
    with torch.inference_mode():
        x, pos = tsteps._embed_inputs(params, cfg, rules, ext, "prefill")
        hid, _, _ = tzoo.decoder_forward(params, cfg, rules, par, x, pos)
        want = tzoo.logits_fn(params, cfg, hid[:, -1:])
    np.testing.assert_allclose(dlogits.float().numpy(),
                               want.float().numpy(), rtol=5e-2, atol=5e-2)
    return cache
