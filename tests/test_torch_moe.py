"""The port's MoE layer (repro_torch.models.moe) against the reference's
(repro.models.moe): ``capacity``, ``route``, the scatter-max
``dispatch_indices`` and ``moe_ffn`` — tokens dropped at a small
capacity factor, and one routing group for a decode batch
(``whole_batch_group``). Inputs from numpy with a seed; float32 at 1e-4
(weights and aux loss too), bfloat16 at the reference's 5e-2, integer
outputs exactly. Then the reference's own MoE checks on the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as rmoe
from repro_torch.kvi import array_from_reference
from repro_torch.models import moe as tmoe


def make_params(rng, D=32, F=64, E=4):
    return {
        "router": rng.normal(0, 0.5, (D, E)).astype(np.float32),
        "w_gate": rng.normal(0, 0.1, (E, D, F)).astype(np.float32),
        "w_up": rng.normal(0, 0.1, (E, D, F)).astype(np.float32),
        "w_down": rng.normal(0, 0.1, (E, F, D)).astype(np.float32),
    }


def both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in params.items()})


@pytest.mark.parametrize("args", [(4096, 8, 2, 1.25), (1, 8, 2, 1.25),
                                  (16, 4, 2, 1.0), (48, 4, 2, 0.5),
                                  (513, 8, 2, 4.0), (7, 3, 1, 0.3)])
def test_capacity_equals_the_reference(args):
    assert tmoe.capacity(*args) == rmoe.capacity(*args)


@pytest.mark.parametrize("E,k", [(4, 2), (8, 2), (5, 1)])
def test_route_equals_the_reference(E, k):
    rng = np.random.default_rng(E + k)
    x = rng.normal(0, 1, (2, 16, 32)).astype(np.float32)
    w = rng.normal(0, 0.5, (32, E)).astype(np.float32)
    rw, ri, raux = rmoe.route(jnp.asarray(x), jnp.asarray(w), E, k)
    tw, ti, taux = tmoe.route(torch.from_numpy(x), torch.from_numpy(w), E, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_allclose(tw.numpy(), np.asarray(rw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-5)


@pytest.mark.parametrize("S,E,k,factor", [(16, 4, 2, 4.0), (16, 4, 2, 1.0),
                                          (64, 4, 2, 0.25), (33, 8, 2, 0.5),
                                          (40, 3, 1, 0.2)])
def test_dispatch_indices_equal_the_reference(S, E, k, factor):
    rng = np.random.default_rng(S + E)
    # skewed choices, so that some experts overflow a small capacity
    idx = np.minimum(rng.geometric(0.5, (2, S, k)) - 1, E - 1).astype(
        np.int32)
    cap = rmoe.capacity(S, E, k, factor)
    want = rmoe.dispatch_indices(jnp.asarray(idx), E, cap)
    got = tmoe.dispatch_indices(torch.from_numpy(idx), E, cap)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if factor < 1:
        assert (got[2] >= cap).any()                  # tokens dropped


@pytest.mark.parametrize("factor", [4.0, 1.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_equals_the_reference(factor, dtype):
    rng = np.random.default_rng(7)
    rp, tp = both(make_params(rng))
    x = rng.normal(0, 1, (2, 24, 32)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    ty, taux = tmoe.moe_ffn(array_from_reference(jx), tp, num_experts=4,
                            top_k=2, cap_factor=factor)
    ry, raux = rmoe.moe_ffn(jx, rp, num_experts=4, top_k=2,
                            cap_factor=factor)
    assert str(ty.dtype) == f"torch.{dtype}"
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(ry.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-5)


@pytest.mark.parametrize("B", [1, 4])
def test_whole_batch_group_equals_the_reference(B):
    """Decode (S = 1): one routing group for the whole batch, the same
    function as per-sequence groups when nothing drops."""
    rng = np.random.default_rng(B)
    rp, tp = both(make_params(rng))
    x = rng.normal(0, 1, (B, 1, 32)).astype(np.float32)
    kw = dict(num_experts=4, top_k=2, cap_factor=1.25)
    ry, _ = rmoe.moe_ffn(jnp.asarray(x), rp, whole_batch_group=True, **kw)
    ty, _ = tmoe.moe_ffn(torch.from_numpy(x), tp, whole_batch_group=True,
                         **kw)
    tsplit, _ = tmoe.moe_ffn(torch.from_numpy(x), tp, **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ty.numpy(), tsplit.numpy(), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the reference's checks (tests/test_moe.py) on the port
# ---------------------------------------------------------------------------

def dense_moe_ref(x, params, num_experts, top_k):
    """Oracle: every expert on every token, combined with the router
    weights (no capacity drops)."""
    w, idx, _ = tmoe.route(x, params["router"], num_experts, top_k)
    outs = []
    for e in range(num_experts):
        g = x @ params["w_gate"][e]
        u = x @ params["w_up"][e]
        outs.append((torch.nn.functional.silu(g) * u) @ params["w_down"][e])
    stack = torch.stack(outs, dim=2)                 # [B,S,E,D]
    sel = torch.gather(stack, 2, idx[..., None].expand(
        *idx.shape, stack.shape[-1]))
    return torch.einsum("bskd,bsk->bsd", sel.float(), w)


def test_moe_matches_dense_reference_with_ample_capacity():
    rng = np.random.default_rng(0)
    _, params = both(make_params(rng))
    x = torch.from_numpy(rng.normal(0, 1, (2, 16, 32)).astype(np.float32))
    y, aux = tmoe.moe_ffn(x, params, num_experts=4, top_k=2, cap_factor=4.0)
    np.testing.assert_allclose(y.numpy(), dense_moe_ref(x, params, 4,
                                                        2).numpy(),
                               rtol=2e-2, atol=2e-2)
    assert float(aux) > 0


@pytest.mark.parametrize("seed", range(15))
def test_dispatch_invariants(seed):
    rng = np.random.default_rng(seed)
    B, S, E, k = 2, 16, 4, 2
    idx = rng.integers(0, E, (B, S, k)).astype(np.int32)
    cap = tmoe.capacity(S, E, k, 1.0)
    slot_token, slot_valid, token_slot = (
        t.numpy() for t in tmoe.dispatch_indices(torch.from_numpy(idx), E,
                                                 cap))
    # every valid slot holds a token actually routed to that expert
    for b in range(B):
        for e in range(E):
            for c in range(cap):
                if slot_valid[b, e, c]:
                    t = slot_token[b, e, c]
                    assert idx[b, t // k, t % k] == e
    # no slot is used twice
    for b in range(B):
        for e in range(E):
            used = slot_token[b, e][slot_valid[b, e]]
            assert len(set(used.tolist())) == len(used)
    assert (token_slot[token_slot < cap] >= 0).all()


def test_capacity_formula():
    assert tmoe.capacity(4096, 8, 2, 1.25) >= 4096 * 2 * 1.25 / 8
    assert tmoe.capacity(4096, 8, 2, 1.25) % 8 == 0
