"""The port's LM configs (repro_torch.configs) against the reference's
(repro.configs): every arch's ModelConfig, Parallelism and source field
by field, the registry (list_archs, get_spec and its KeyError, the
cells), the reduced configs and shapes, SHAPES; every full config's
param_template leaf by leaf and its parameter counts as integers, with
no allocation; then the reference's own nameplate-count checks on the
port."""
import dataclasses

import jax
import pytest

import repro.configs as rcfg
from repro.models import model_zoo as rzoo
from repro.models import params as rparams
import repro_torch.configs as tcfg
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import params as tparams
from test_torch_lm_params import port_spec

ALL_ARCHS = rcfg.list_archs() + ["llama100m"]


def fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def assert_only_hymba_departs(arch: str):
    """The port's own config of ``arch`` differs from the reference's
    only where it describes hymba-1.5b's published block; every other
    arch's fields that the reference lacks are at their defaults."""
    t, r = tcfg.get_spec(arch), rcfg.get_spec(arch)
    extra = {f.name: f.default for f in dataclasses.fields(t.model)
             if f.name not in fields(r.model)}
    own = fields(t.model)
    shared = {k: v for k, v in own.items() if k not in extra}
    if arch == "hymba-1.5b":
        changed = {k for k in shared if shared[k] != getattr(r.model, k)}
        assert changed == {"sliding_window", "ssm_chunk", "norm_eps",
                           "tie_embeddings"}, changed
        assert {k for k in extra if own[k] != extra[k]} == set(extra)
    else:
        assert shared == fields(r.model)
        assert {k: own[k] for k in extra} == extra


def leaves(template, is_ref):
    if is_ref:
        pairs = [("/".join(str(k.key) for k in path), p)
                 for path, p in jax.tree_util.tree_flatten_with_path(
                     template, is_leaf=lambda x: isinstance(x, rparams.P))[0]]
    else:
        pairs = list(tparams.tree_leaves(template))
    return sorted((name, (p.shape, p.axes, p.init, p.dtype, p.fan_in))
                  for name, p in pairs)


def test_registry_equals_the_reference():
    assert tcfg.list_archs() == rcfg.list_archs()
    assert len(tcfg.list_archs()) == 10
    assert tcfg.all_cells() == rcfg.all_cells()
    for arch in ALL_ARCHS:
        assert tcfg.arch_cells(arch) == rcfg.arch_cells(arch)
    with pytest.raises(KeyError) as got:
        tcfg.get_spec("gpt-5")
    with pytest.raises(KeyError) as want:
        rcfg.get_spec("gpt-5")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_spec_equals_the_reference_field_by_field(arch):
    assert_only_hymba_departs(arch)
    t, r = port_spec(arch), rcfg.get_spec(arch)
    assert type(tcfg.get_spec(arch)).__module__ == "repro_torch.configs.base"
    assert fields(tcfg.get_spec(arch).parallelism) == fields(r.parallelism)
    assert {k: v for k, v in fields(t.model).items()
            if k in fields(r.model)} == fields(r.model)
    assert fields(t.parallelism) == fields(r.parallelism)
    assert t.source == r.source
    for prop in ("attention_free", "is_encdec", "d_inner", "ssm_heads"):
        assert getattr(t.model, prop) == getattr(r.model, prop)
    assert fields(tcfg.reduced_model(t.model)) == \
        fields(tcfg.ModelConfig(**fields(rcfg.reduced_model(r.model))))


def test_shapes_equal_the_reference():
    assert {k: fields(v) for k, v in tcfg.SHAPES.items()} == \
        {k: fields(v) for k, v in rcfg.SHAPES.items()}
    for name in tcfg.SHAPES:
        assert fields(tcfg.get_shape(name)) == fields(rcfg.get_shape(name))
        for kw in ({}, {"seq_len": 48, "batch": 3}):
            assert fields(tcfg.reduced_shape(tcfg.SHAPES[name], **kw)) == \
                fields(rcfg.reduced_shape(rcfg.SHAPES[name], **kw))


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_param_template_equals_the_reference(arch, reduced):
    t, r = port_spec(arch).model, rcfg.get_spec(arch).model
    if reduced:
        t, r = tcfg.reduced_model(t), rcfg.reduced_model(r)
    assert leaves(tzoo.param_template(t), False) == \
        leaves(rzoo.param_template(r), True)
    t, r = (c.replace(param_dtype="bfloat16") for c in (t, r))
    assert leaves(tzoo.param_template(t), False) == \
        leaves(rzoo.param_template(r), True)
    assert tzoo.padded_vocab(t.vocab_size) == rzoo.padded_vocab(r.vocab_size)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_counts_equal_the_reference(arch):
    t, r = port_spec(arch).model, rcfg.get_spec(arch).model
    n = tzoo.param_count(t)
    assert isinstance(n, int) and n == rzoo.param_count(r)
    a = tzoo.active_param_count(t)
    assert isinstance(a, int) and a == rzoo.active_param_count(r)


def test_param_counts_match_public_sizes():
    """The reference's nameplate check on the port's configs."""
    expect = {
        "mixtral-8x7b": (45e9, 48e9),
        "grok-1-314b": (300e9, 330e9),
        "llama3.2-1b": (1.0e9, 1.6e9),
        "deepseek-7b": (6.5e9, 7.5e9),
        "stablelm-12b": (11e9, 13.5e9),
        "phi3-mini-3.8b": (3.5e9, 4.1e9),
        "mamba2-1.3b": (1.1e9, 1.5e9),
        "hymba-1.5b": (1.2e9, 1.9e9),
        "pixtral-12b": (11e9, 13.5e9),
        "seamless-m4t-medium": (0.8e9, 1.6e9),
    }
    for arch, (lo, hi) in expect.items():
        n = tzoo.param_count(tcfg.get_spec(arch).model)
        assert lo <= n <= hi, f"{arch}: {n:,} not in [{lo:,.0f}, {hi:,.0f}]"


def test_moe_active_params():
    cfg = tcfg.get_spec("mixtral-8x7b").model
    total, active = tzoo.param_count(cfg), tzoo.active_param_count(cfg)
    assert active < total
    assert 11e9 < active < 15e9


def test_klessydra_configs_unchanged():
    assert {k: fields(v) for k, v in tcfg.klessydra_taxonomy().items()} == \
        {k: fields(v) for k, v in rcfg.klessydra_taxonomy().items()}
