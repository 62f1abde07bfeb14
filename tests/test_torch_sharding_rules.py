"""The port's logical-axis rules (repro_torch.models.sharding) against the
reference's ``make_rules``, and the reference's rule checks
(tests/test_sharding_rules.py, tests/test_perf_knobs.py::test_pure_dp_rules)
on the port.

Both production meshes are abstract: jax's ``AbstractMesh((16, 16),
("data", "model"))`` (the call form jax 0.9.0 takes) and the port's
``AbstractMesh`` of the same names and sizes. For all 11 archs, with the
arch's own Parallelism and with each of ``pure_dp``, ``fsdp``,
``sequence_parallel``, ``expert_parallel`` and ``moe_capacity_sharding``
flipped, the mapping, every leaf's spec (param, batch and cache
templates of each of the arch's shapes) and the downgrades it records
are the reference's.
"""
import pytest
from jax.sharding import AbstractMesh as JaxAbstractMesh

import repro.configs as rcfg
from repro.models import model_zoo as rzoo
from repro.models import params as rparams
from repro.models import steps as rsteps
from repro.models.sharding import make_rules as rmake_rules
from repro_torch.compat import Replicate, Shard
from repro_torch.configs import get_spec
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.model_zoo import padded_vocab
from repro_torch.models.sharding import make_rules
from test_torch_lm_params import port_spec

ALL_ARCHS = rcfg.list_archs() + ["llama100m"]
MESHES = {
    "pod": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
}
FLAGS = [None, "pure_dp", "fsdp", "sequence_parallel", "expert_parallel",
         "moe_capacity_sharding"]

MESH = AbstractMesh(*MESHES["pod"])
MESH_POD = AbstractMesh(*MESHES["multipod"])


def _pair(arch, mesh_name, flag):
    shape, axes = MESHES[mesh_name]
    rspec, tspec = rcfg.get_spec(arch), port_spec(arch)
    rpar, tpar = rspec.parallelism, tspec.parallelism
    if flag is not None:
        rpar = rpar.replace(**{flag: not getattr(rpar, flag)})
        tpar = tpar.replace(**{flag: not getattr(tpar, flag)})
    ref = rmake_rules(JaxAbstractMesh(shape, axes), rspec.model, rpar)
    port = make_rules(AbstractMesh(shape, axes), tspec.model, tpar)
    return ref, port, rspec


def _leaves(template):
    return [p for p in __import__("jax").tree_util.tree_leaves(
        template, is_leaf=lambda x: isinstance(x, rparams.P))]


@pytest.mark.parametrize("flag", FLAGS, ids=lambda f: f or "own")
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_rules_equal_the_reference(arch, mesh_name, flag):
    ref, port, rspec = _pair(arch, mesh_name, flag)
    assert port.mapping == ref.mapping
    cfg = rspec.model
    templates = [rzoo.param_template(cfg)]
    for s in rspec.parallelism.shapes:
        shape = rcfg.get_shape(s)
        templates.append(rsteps.batch_template(cfg, shape))
        if shape.kind == "decode":
            templates.append(rsteps.cache_template(cfg, shape))
    for t in templates:
        for p in _leaves(t):
            want = ref.spec(p.axes, p.shape)
            got = port.spec(p.axes, p.shape)
            assert got == tuple(want), (p, got, want)
    assert [tuple(d) for d in port.downgrades] == \
        [tuple(d) for d in ref.downgrades]


# ---------------------------------------------------------------------------
# the reference's rule checks, on the port
# ---------------------------------------------------------------------------

def rules_for(arch, mesh=MESH):
    spec = get_spec(arch)
    return make_rules(mesh, spec.model, spec.parallelism)


def test_batch_maps_to_tlp_axes():
    r = rules_for("llama3.2-1b", MESH)
    assert r.spec(("batch", "seq"), (256, 4096)) == ("data", None)
    rp = rules_for("llama3.2-1b", MESH_POD)
    assert rp.spec(("batch", "seq"), (256, 4096)) == (("pod", "data"), None)


def test_divisibility_guard_downgrades():
    r = rules_for("hymba-1.5b")
    # 25 heads don't divide the 16-way model axis -> replicate + record
    spec = r.spec(("layers", "embed", "heads", "head_dim"),
                  (32, 1600, 25, 64))
    assert spec[2] is None
    assert any(d[0] == "heads" for d in r.downgrades)
    # ffn still tensor-parallel
    assert r.spec(("layers", "embed", "mlp"), (32, 1600, 5504))[2] == "model"


def test_batch_of_one_replicates():
    r = rules_for("mamba2-1.3b")
    assert r.spec(("batch",), (1,))[0] is None


def test_kv_vs_cache_seq_flip():
    # deepseek kv=32 divides 16 -> heads sharded, cache_seq replicated
    rd = rules_for("deepseek-7b")
    assert rd.mapping["kv_heads"] == "model"
    assert rd.mapping["cache_seq"] is None
    # stablelm kv=8 doesn't -> flash-decode style seq sharding
    rs = rules_for("stablelm-12b")
    assert rs.mapping["kv_heads"] is None
    assert rs.mapping["cache_seq"] == "model"


def test_fsdp_and_sp_flags():
    rg = rules_for("grok-1-314b")
    assert rg.mapping["embed"] == "data"          # FSDP on
    assert rg.mapping["seq_sp"] == "model"        # SP on
    rl = rules_for("llama3.2-1b")
    assert rl.mapping["embed"] is None            # small model: no FSDP


def test_vocab_padding_divides_model_axis():
    for arch in ("mamba2-1.3b", "seamless-m4t-medium", "hymba-1.5b"):
        v = get_spec(arch).model.vocab_size
        assert padded_vocab(v) % 16 == 0
        assert padded_vocab(v) >= v


def test_no_mesh_is_noop():
    spec = get_spec("llama3.2-1b")
    r = make_rules(None, spec.model, spec.parallelism)
    assert r.sharding(("batch",), (8,)) is None
    x = __import__("torch").zeros((4, 4))
    assert r.constrain(x, "batch", None) is x


def test_pure_dp_rules():
    spec = get_spec("llama3.2-1b")
    r = make_rules(MESH, spec.model, spec.parallelism.replace(pure_dp=True))
    assert r.spec(("batch", "seq"), (256, 4096)) == (("data", "model"), None)
    assert r.mapping["heads"] is None and r.mapping["mlp"] is None
    assert r.mapping["embed"] == ("data", "model")   # ZeRO param sharding


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_placements_follow_the_spec(mesh_name):
    """``sharding``: one placement per mesh dim; a tuple of mesh axes
    splits one tensor dim over each of them."""
    mesh = AbstractMesh(*MESHES[mesh_name])
    r = rules_for("grok-1-314b", mesh)
    got = r.sharding(("batch", "seq_sp", None), (256, 4096, 6144))
    if mesh_name == "pod":
        assert got == (Shard(0), Shard(1))
    else:
        assert got == (Shard(0), Shard(0), Shard(1))
    # one mesh axis cannot split two dims (jax's NamedSharding refuses it)
    with pytest.raises(ValueError):
        r.sharding(("batch", "embed"), (256, 6144))
    # embed (FSDP, on data) and mlp (on model) of a weight
    got = r.sharding(("layers", "embed", "mlp"), (64, 6144, 32768))
    assert got[-2:] == (Shard(1), Shard(2))
    if mesh_name == "multipod":
        assert got[0] == Replicate()
    # a downgraded dim is replicated on every mesh dim
    h = rules_for("hymba-1.5b", mesh)
    assert h.sharding(("heads",), (25,)) == \
        tuple(Replicate() for _ in MESHES[mesh_name][0])
