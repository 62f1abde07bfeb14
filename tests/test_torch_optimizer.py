"""The port's optimizer (repro_torch.optim) against the reference's
(repro.optim): the reference's own checks (tests/test_optimizer.py)
re-run on the port, then AdamW over 5 steps through both packages on the
same numpy trees, for float32, bfloat16 and int8 moments, and the int8
gradient codec.

Tolerances: float32 params, moments and metrics within 1e-6 relative
(1e-7 absolute for values near 0); bfloat16 moments equal, or one
bfloat16 step apart where the two float32 values round to either side;
int8 codes equal, or +-1 where the two float32 quotients round to either
side of a tie (counted, and at most 1 % of codes);
scales within 1e-5 (XLA on the CPU contracts a multiply and an add into
one rounding where PyTorch rounds twice, and each step's re-quantization
carries the float32 ulp into the next step's scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import grad_compress as rgc
from repro.optim import optimizer as ropt
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim import optimizer as topt

RTOL, ATOL = 1e-6, 1e-7
SCALE_RTOL = 1e-5
#: shapes with every rank the update treats apart (decay only at ndim >= 2)
SHAPES = {"w": (6, 40), "stack": (2, 5, 24), "b": (24,), "s": ()}


def tree_np(rng, scale=1.0):
    return {"blocks": {k: (rng.normal(size=s) * scale).astype(np.float32)
                       for k, s in SHAPES.items() if k != "w"},
            "w": (rng.normal(size=SHAPES["w"]) * scale).astype(np.float32)}


def jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def th(tree):
    if isinstance(tree, dict):
        return {k: th(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def as_np(tree):
    if isinstance(tree, dict):
        return {k: as_np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy() if tree.dtype == torch.bfloat16 \
            else tree.numpy()
    return np.asarray(tree.astype(jnp.float32)) \
        if tree.dtype == jnp.bfloat16 else np.asarray(tree)


def leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# the reference's checks on the port
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    cfg = topt.OptimizerConfig(lr=0.1, warmup_steps=1, total_steps=10_000,
                               weight_decay=0.0, clip_norm=0.0)
    target = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 8)).astype(np.float32))
    params = {"w": torch.zeros((4, 8))}
    opt = topt.adamw_init(params, cfg)
    for _ in range(300):
        grads = {"w": params["w"] - target}
        params, opt, _ = topt.adamw_update(grads, opt, params, cfg)
    assert float((params["w"] - target).abs().max()) < 1e-2


def test_int8_moments_converge_too():
    cfg = topt.OptimizerConfig(lr=0.1, warmup_steps=1, total_steps=10_000,
                               weight_decay=0.0, clip_norm=0.0,
                               moment_dtype="int8")
    target = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 8)).astype(np.float32))
    params = {"w": torch.zeros((4, 8))}
    opt = topt.adamw_init(params, cfg)
    for _ in range(300):
        grads = {"w": params["w"] - target}
        params, opt, _ = topt.adamw_update(grads, opt, params, cfg)
    assert float((params["w"] - target).abs().max()) < 5e-2
    assert opt["m"]["w"]["q"].dtype == torch.int8


def test_grad_clip_bounds_update():
    cfg = topt.OptimizerConfig(lr=1.0, warmup_steps=1, total_steps=100,
                               clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros((4,))}
    opt = topt.adamw_init(params, cfg)
    huge = {"w": torch.full((4,), 1e9)}
    p2, opt, m = topt.adamw_update(huge, opt, params, cfg)
    assert float(m["grad_norm"]) > 1e8
    assert torch.isfinite(p2["w"]).all()
    assert float(p2["w"].abs().max()) < 10.0


def test_lr_schedule_shape():
    cfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(topt.lr_schedule(cfg, torch.tensor(s))) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9       # warmup rises
    assert lrs[-1] < lrs[20]                    # cosine decays
    assert min(lrs) >= 1e-3 * 0.09              # floor at ~10%


@pytest.mark.parametrize("seed", range(8))
def test_quantize_roundtrip_error_bound(seed):
    """The reference's property (hypothesis draws 4 floats in +-100,
    tiled to (2, 64)) on seeded draws."""
    vals = np.random.default_rng(seed).uniform(-100, 100, 4)
    x = torch.from_numpy(np.resize(vals.astype(np.float32), (2, 64)))
    q, s = tgc.quantize_block(x)
    err = float((tgc.dequantize_block(q, s) - x).abs().max())
    assert err <= float(x.abs().max()) / 127.0 + 1e-6


def test_error_feedback_recovers_mean():
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))
    err = torch.zeros_like(g_true)
    acc = torch.zeros_like(g_true)
    n = 200
    for _ in range(n):
        q, s, err = tgc.compress_residual(g_true, err)
        acc = acc + tgc.dequantize_block(q, s)
    np.testing.assert_allclose((acc / n).numpy(), g_true.numpy(), atol=2e-2)


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(topt.global_norm(t)) - 5.0) < 1e-6


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(), dict(warmup_steps=10, total_steps=40),
    dict(warmup_steps=0, total_steps=1), dict(lr=1e-2, warmup_steps=3,
                                              total_steps=7)])
def test_lr_schedule_equals_the_reference(cfg):
    for step in list(range(45)) + [99, 100, 5000, 9999, 20000]:
        want = float(ropt.lr_schedule(ropt.OptimizerConfig(**cfg),
                                      jnp.asarray(step, jnp.int32)))
        got = float(topt.lr_schedule(topt.OptimizerConfig(**cfg),
                                     torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=RTOL, abs=1e-12), step
        assert float(topt.lr_schedule(topt.OptimizerConfig(**cfg), step)) \
            == got


def _check_moment(got, want, dtype, path, ties):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=path)
    elif dtype == "bfloat16":
        apart = got != want
        # one bfloat16 step, where the float32 values straddle a rounding
        step = np.abs(want) * 2.0 ** -7
        assert (np.abs(got - want)[apart] <= step[apart] * 1.01).all(), path
        ties.append(int(apart.sum()))
    else:
        gq, wq = got["q"].astype(np.int32), want["q"].astype(np.int32)
        np.testing.assert_allclose(got["s"], want["s"], rtol=SCALE_RTOL,
                                   atol=0, err_msg=path)
        assert (np.abs(gq - wq) <= 1).all(), path
        ties.append(int((gq != wq).sum()))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("clip_norm", [1.0, 0.0])
def test_adamw_update_five_steps_equals_the_reference(moment_dtype,
                                                      clip_norm):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, clip_norm=clip_norm,
              moment_dtype=moment_dtype)
    rcfg, tcfg = ropt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    rng = np.random.default_rng(7)
    p0 = tree_np(rng)
    rp, tp = jx(p0), th(p0)
    rs, ts = ropt.adamw_init(rp, rcfg), topt.adamw_init(tp, tcfg)
    ties, n_codes = [], 0
    for step in range(5):
        g = tree_np(rng, scale=3.0 if step % 2 else 0.2)
        rp, rs, rm = ropt.adamw_update(jx(g), rs, rp, rcfg)
        tp, ts, tm = topt.adamw_update(th(g), ts, tp, tcfg)
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(rm[k]), rel=RTOL)
        assert ts["count"].dtype == torch.int32
        assert int(ts["count"]) == int(rs["count"]) == step + 1
        want_p, got_p = dict(leaves(as_np(rp))), dict(leaves(as_np(tp)))
        for path, w in want_p.items():
            np.testing.assert_allclose(got_p[path], w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {step} {path}")
        for which in ("m", "v"):
            want = as_np(rs[which])
            got = as_np(ts[which])
            for path, w in _moment_leaves(want):
                if moment_dtype == "int8":
                    n_codes += w["q"].size
                _check_moment(_get(got, path), w, moment_dtype,
                              f"step {step} {which}{path}", ties)
    if moment_dtype == "int8":
        assert sum(ties) <= 0.01 * n_codes, (sum(ties), n_codes)


def _moment_leaves(tree, path=""):
    if isinstance(tree, dict) and set(tree) != {"q", "s"}:
        for k in sorted(tree):
            yield from _moment_leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _get(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_init_matches_the_reference(moment_dtype):
    p = tree_np(np.random.default_rng(0))
    rcfg = ropt.OptimizerConfig(moment_dtype=moment_dtype)
    want = ropt.adamw_init(jx(p), rcfg)
    got = topt.adamw_init(th(p), topt.OptimizerConfig(
        moment_dtype=moment_dtype))
    for which in ("m", "v"):
        for path, w in _moment_leaves(as_np(want[which])):
            g = _get(as_np(got[which]), path)
            if moment_dtype == "int8":
                assert got[which]["w"]["q"].dtype == torch.int8
                for part in ("q", "s"):
                    assert g[part].shape == w[part].shape, path
                    np.testing.assert_array_equal(g[part], w[part])
            else:
                assert g.shape == w.shape and not g.any(), path
    if moment_dtype == "bfloat16":
        assert got["m"]["w"].dtype == torch.bfloat16
    assert got["count"].dtype == torch.int32 and int(got["count"]) == 0


@pytest.mark.parametrize("shape", [(7, 33), (3, 4, 9), (16,), ()])
def test_quantize_i8_equals_the_reference(shape):
    x = np.asarray(np.random.default_rng(5).normal(size=shape) * 3,
                   np.float32)
    want = ropt.quantize_i8(jnp.asarray(x))
    got = topt.quantize_i8(torch.from_numpy(x))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(got["s"].numpy(), np.asarray(want["s"]),
                               rtol=RTOL)
    np.testing.assert_allclose(topt.dequantize_i8(got).numpy(),
                               np.asarray(ropt.dequantize_i8(want)),
                               rtol=RTOL, atol=ATOL)


def test_quantize_rounds_half_to_even_and_clamps():
    """Codes on exact ties round to even, as jnp.round does; the row's
    absmax maps to 127."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5]], np.float32)
    got = topt.quantize_i8(torch.from_numpy(x))["q"].numpy()
    want = np.asarray(ropt.quantize_i8(jnp.asarray(x))["q"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[127, 0, 2, 2, 0, -2, -126]])


def test_compress_residual_equals_the_reference():
    rng = np.random.default_rng(2)
    g = rng.normal(size=(5, 48)).astype(np.float32)
    e = (rng.normal(size=(5, 48)) * 1e-2).astype(np.float32)
    want = rgc.compress_residual(jnp.asarray(g), jnp.asarray(e))
    got = tgc.compress_residual(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def test_cross_pod_mean_on_one_device_is_the_wire_value(tmp_path):
    """One pod: the mean is the gradient as the int8 wire carries it (the
    reference's q_sum * s_max / n with n = 1), the error the rest."""
    rng = np.random.default_rng(4)
    g = {"a": torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32)),
         "b": {"c": torch.from_numpy(rng.normal(size=(8,)).astype(
             np.float32))}}
    e = {"a": torch.zeros(3, 16), "b": {"c": torch.zeros(8)}}
    mean, err = tgc.cross_pod_mean(g, e)
    for got, x, new_e in ((mean["a"], g["a"], err["a"]),
                          (mean["b"]["c"], g["b"]["c"], err["b"]["c"])):
        q, s = tgc.quantize_block(x)
        assert torch.equal(got, tgc.dequantize_block(q, s))
        assert torch.equal(new_e, x - got)
    # on a one-pod mesh (a one-rank gloo group) the same, bit for bit
    # (more pods: tests/test_torch_mesh_train.py)
    import torch.distributed as dist
    from repro_torch.compat import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1, 1),
                                mesh_dim_names=("pod", "data", "model"))
        m_mean, m_err = tgc.cross_pod_mean(g, e, mesh=mesh)
    finally:
        dist.destroy_process_group()
    for a, b in ((m_mean["a"], mean["a"]), (m_err["b"]["c"], err["b"]["c"])):
        assert torch.equal(a, b)
