"""The port's model zoo against the reference's, MoE family
(mixtral-8x7b with its sliding window, grok-1-314b) at reduced size, as
``test_torch_model_zoo_dense.py`` holds the dense family. The routes
too: in float32 the port routes every token as the reference does; in
bfloat16 a token whose experts are near-tied may route apart (the two
packages round apart), so the port takes the reference's routes and
every difference must be a near-tie. Then the reference's own
consistency checks on the port, the SWA ring cache included."""
import numpy as np
import pytest

from test_torch_lm_params import (OUTPUTS, check_decode_after_prefill,
                                  check_output, check_routes, zoo_cases,
                                  zoo_pair)

ARCHS = ["mixtral-8x7b", "grok-1-314b"]

pair = pytest.fixture(scope="module", params=zoo_cases(ARCHS),
                      ids="-".join)(zoo_pair)


@pytest.mark.parametrize("what", OUTPUTS)
def test_port_equals_reference(pair, what):
    check_output(pair, what)


def test_routes_are_the_references(pair):
    dtype, _, _, logs = pair
    # every MoE layer of every step, in the reference's call order
    assert [len(calls) for calls in logs.values()] == [2] * len(logs)
    check_routes(logs, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    check_decode_after_prefill(arch)


def test_swa_ring_cache_consistency():
    """mixtral's window (32 at reduced size) under a prompt of 48: the
    ring holds 32 slots, position p at slot p % 32."""
    cache = check_decode_after_prefill("mixtral-8x7b", seq=48, batch=1,
                                       next_tok=np.array([[7]], np.int32))
    assert cache["layers"]["k"].shape[2] == 32
    np.testing.assert_array_equal(cache["layers"]["cpos"][0, 0].numpy(),
                                  np.roll(np.arange(16, 48), 16))


def test_swa_prompt_shorter_than_the_window_as_the_reference():
    """A sliding-window cache holds min(prompt, window) slots and no
    decode headroom (``cache_slots``), so after a prompt shorter than
    the window the first decode step overwrites the prompt's last token
    (its slot, clamped). The port keeps the reference's behaviour:
    logits and cache equal in float32."""
    import jax
    import jax.numpy as jnp
    import torch

    import repro.configs as rcfg
    from repro.models import model_zoo as rzoo
    from repro.models import params as rparams
    from repro.models import steps as rsteps
    import repro_torch.configs as tcfg
    from repro_torch.models import params as tparams
    from repro_torch.models import steps as tsteps
    from test_torch_lm_params import assert_tree_close, configs, to_np, \
        torch_np

    (rc, rpar, rrules), (tc, tpar, trules) = configs("mixtral-8x7b",
                                                     "float32")
    S = 16                                      # window 32
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 100, (1, S)).astype(np.int32)
    nxt = np.array([[7]], np.int32)
    p = rparams.initialize(rzoo.param_template(rc), jax.random.PRNGKey(0))
    _, rcache = jax.jit(rsteps.make_prefill_step(
        rc, rrules, rpar, rcfg.ShapeConfig("p", "prefill", S, 1)))(
        p, {"tokens": jnp.asarray(toks)})
    rlogits, rcache = rsteps.make_decode_step(
        rc, rrules, rpar, rcfg.ShapeConfig("d", "decode", S, 1))(
        p, rcache, {"tokens": jnp.asarray(nxt)})
    tp = tparams.from_reference(p, device="cpu")
    _, tcache = tsteps.make_prefill_step(
        tc, trules, tpar, tcfg.ShapeConfig("p", "prefill", S, 1))(
        tp, {"tokens": torch.from_numpy(toks)})
    tlogits, tcache = tsteps.make_decode_step(
        tc, trules, tpar, tcfg.ShapeConfig("d", "decode", S, 1))(
        tp, tcache, {"tokens": torch.from_numpy(nxt)})
    assert tcache["layers"]["k"].shape[2] == S
    # position S landed in slot S - 1, where the prompt's last token was
    np.testing.assert_array_equal(tcache["layers"]["cpos"][0, 0].numpy(),
                                  np.r_[np.arange(S - 1), S])
    assert_tree_close(torch_np(tcache), to_np(rcache), 1e-4)
    assert_tree_close(torch_np(tlogits), to_np(rlogits), 1e-4)
