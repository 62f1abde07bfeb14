"""The port's checkpoint manager (repro_torch.checkpoint.manager): the
reference's checks (tests/test_checkpoint.py) re-run on the port, and
checkpoints carried across in both directions: a directory written by
the reference restores in the port and one written by the port restores
in the reference, each to an equal tree (values bit for bit); the npy
members and manifests of one tree written by both are byte-equal,
bfloat16 leaves included (which the reference writes but cannot
restore, see ``test_bfloat16_leaves_as_the_reference_writes_them``).
"""
import json
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as rman
from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            restore, save)
from repro_torch.configs import get_spec, reduced_model
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.models import model_zoo as zoo
from repro_torch.models import params as params_lib
from repro_torch.models import steps as steps_lib
from repro_torch.models.sharding import make_rules
from repro_torch.optim.optimizer import OptimizerConfig, adamw_init


def tree_of(rng):
    return {"params": {"w": torch.from_numpy(rng.normal(size=(8, 16)).astype(
                           np.float32)),
                       "b": torch.from_numpy(rng.normal(size=(16,)).astype(
                           np.float32))},
            "opt": {"count": torch.tensor(3, dtype=torch.int32),
                    "m": [torch.ones((4,)), torch.zeros((2, 2))]}}


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def bits(x) -> np.ndarray:
    """A leaf's raw bytes with its dtype name (bfloat16 as its words)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().tobytes()
        return str(x.numpy().dtype), x.numpy().tobytes()
    a = np.asarray(x)
    return str(a.dtype), a.tobytes()


def assert_same_tree(got, want):
    g, w = flat(got), flat(want)
    assert set(g) == set(w)
    for k in w:
        assert tuple(g[k].shape) == tuple(np.shape(w[k])), k
        assert bits(g[k]) == bits(w[k]), k


# ---------------------------------------------------------------------------
# the reference's checks on the port
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path, rng):
    t = tree_of(rng)
    save(tmp_path, 7, t)
    assert latest_step(tmp_path) == 7
    got, step = restore(tmp_path, t, device="cpu")
    assert step == 7
    assert_same_tree(got, t)
    assert isinstance(got["opt"]["m"], list)


def test_async_save_and_gc(tmp_path, rng):
    t = tree_of(rng)
    mgr = CheckpointManager(tmp_path, interval=1, keep=2)
    for step in range(1, 6):
        assert mgr.maybe_save(step, t)
    mgr.wait()
    dirs = sorted(p.name for p in Path(tmp_path).glob("step_*"))
    assert len(dirs) == 2 and dirs[-1].endswith("5")
    assert latest_step(tmp_path) == 5


def test_gc_keeps_three_by_default(tmp_path, rng):
    t = tree_of(rng)
    for step in range(1, 6):
        save(tmp_path, step, t)
    assert sorted(p.name for p in Path(tmp_path).glob("step_*")) == \
        [f"step_{s:09d}" for s in (3, 4, 5)]


def test_async_save_snapshots_on_the_callers_thread(tmp_path, rng):
    """The device -> host copy happens before save returns: a tree
    changed in place afterwards does not reach the file."""
    t = tree_of(rng)
    want = t["params"]["w"].clone()
    th = save(tmp_path, 1, t, blocking=False)
    t["params"]["w"].add_(1.0)
    th.join()
    got, _ = restore(tmp_path, t, device="cpu")
    assert torch.equal(got["params"]["w"], want)


def test_crash_safety_tmp_never_visible(tmp_path, rng):
    """A leftover .tmp dir must not be treated as a checkpoint."""
    t = tree_of(rng)
    save(tmp_path, 1, t)
    fake = Path(tmp_path) / "step_000000002.tmp"
    fake.mkdir()
    (fake / "garbage").write_text("x")
    got, step = restore(tmp_path, t, device="cpu")
    assert step == 1


def test_integrity_check(tmp_path, rng):
    t = tree_of(rng)
    save(tmp_path, 1, t)
    man = Path(tmp_path) / "step_000000001" / "manifest.json"
    m = json.loads(man.read_text())
    next(iter(m["arrays"].values()))["crc32"] ^= 0xDEADBEEF
    man.write_text(json.dumps(m))
    with pytest.raises(IOError):
        restore(tmp_path, t, device="cpu")


def test_interval_gating(tmp_path, rng):
    t = tree_of(rng)
    mgr = CheckpointManager(tmp_path, interval=10)
    assert not mgr.maybe_save(3, t)
    assert mgr.maybe_save(10, t)
    assert mgr.maybe_save(4, t, force=True)   # preemption path
    mgr.wait()


def test_restore_refuses_shardings_and_defaults_to_the_card(tmp_path, rng):
    t = tree_of(rng)
    save(tmp_path, 1, t)
    # shardings= places leaves on a mesh: none given, and no DTensor in
    # the template to take one from (tests/test_torch_mesh_train.py
    # restores onto a mesh)
    with pytest.raises(ValueError, match="needs a mesh"):
        restore(tmp_path, t, shardings={"params": None}, device="cpu")
    with pytest.raises(FileNotFoundError):
        restore(Path(tmp_path) / "empty", t, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            restore(tmp_path, t)


def _trainer(opt_cfg=OptimizerConfig()):
    spec = get_spec("llama3.2-1b")
    cfg = reduced_model(spec.model)
    par = spec.parallelism.replace(remat="none", fsdp=False,
                                   sequence_parallel=False)
    rules = make_rules(None, cfg, par)
    step_fn = steps_lib.make_train_step(cfg, rules, par, opt_cfg)
    data = DataPipeline(cfg, ShapeConfig("t", "train", 64, 2), DataConfig())
    params = params_lib.initialize(zoo.param_template(cfg), 0, device="cpu")
    return step_fn, data, params


def _batch(data, s):
    return {k: torch.from_numpy(v) for k, v in data.batch_at(s).items()}


def test_resume_equivalence(tmp_path):
    """train k steps; checkpoint; train k more == restore + train k more
    (bit for bit on one device)."""
    step_fn, data, params = _trainer()
    opt = adamw_init(params, OptimizerConfig())
    for s in range(3):
        params, opt, _ = step_fn(params, opt, _batch(data, s))
    save(tmp_path, 3, {"p": params, "o": opt})
    p1, o1 = params, opt
    for s in range(3, 6):
        p1, o1, _ = step_fn(p1, o1, _batch(data, s))
    tree, start = restore(tmp_path, {"p": params, "o": opt}, device="cpu")
    p2, o2 = tree["p"], tree["o"]
    for s in range(start, start + 3):
        p2, o2, _ = step_fn(p2, o2, _batch(data, s))
    assert_same_tree({"p": p2, "o": o2}, {"p": p1, "o": o1})


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

def mixed_tree(rng):
    """numpy leaves of every kind a training state holds: float32 params,
    an int32 count, int8 moments with float32 scales, nested lists."""
    return {"params": {"embed": rng.normal(size=(12, 8)).astype(np.float32),
                       "blocks": {"w": rng.normal(size=(2, 8, 4)).astype(
                           np.float32)}},
            "opt": {"count": np.asarray(5, np.int32),
                    "m": {"embed": {"q": rng.integers(-127, 128, (12, 8)
                                                      ).astype(np.int8),
                                    "s": rng.random((12, 1)).astype(
                                        np.float32)}},
                    "list": [np.arange(3, dtype=np.int32),
                             np.ones((2, 2), np.float32)]}}


def as_torch(tree):
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True))


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_a_reference_checkpoint_restores_in_the_port(tmp_path, rng):
    t = mixed_tree(rng)
    rman.save(tmp_path, 4, as_jax(t))
    got, step = restore(tmp_path, as_torch(t), device="cpu")
    assert step == 4
    assert_same_tree(got, as_torch(t))
    assert got["opt"]["m"]["embed"]["q"].dtype == torch.int8


def test_a_port_checkpoint_restores_in_the_reference(tmp_path, rng):
    t = mixed_tree(rng)
    save(tmp_path, 9, as_torch(t))
    got, step = rman.restore(tmp_path, as_jax(t))
    assert step == 9 and rman.latest_step(tmp_path) == 9
    assert_same_tree(jax.tree_util.tree_map(np.asarray, got), t)


def test_both_packages_write_the_same_bytes(tmp_path, rng):
    """One tree saved by each: equal manifests and npy members (the zip
    containers differ only in their timestamps)."""
    t = mixed_tree(rng)
    t["opt"]["v"] = {"embed": rng.normal(size=(12, 8)).astype(np.float32)}
    rman.save(tmp_path / "ref", 1, as_jax(t))
    save(tmp_path / "port", 1, as_torch(t))
    for kind in ("ref", "port"):
        assert (tmp_path / kind / "LATEST").read_text() == "1"
    d = [tmp_path / kind / "step_000000001" for kind in ("ref", "port")]
    assert (d[0] / "manifest.json").read_text() == \
        (d[1] / "manifest.json").read_text()
    za, zb = (zipfile.ZipFile(x / "arrays.npz") for x in d)
    assert za.namelist() == zb.namelist()
    for n in za.namelist():
        assert za.read(n) == zb.read(n), n


def test_bfloat16_leaves_as_the_reference_writes_them(tmp_path, rng):
    """bfloat16 moments (``moment_dtype="bfloat16"``): the reference
    writes each as its 2-byte words (npy descr ``<V2``, manifest dtype
    ``bfloat16``) and its own restore refuses them. The port writes the
    same bytes without ``ml_dtypes`` and restores either file to bfloat16
    tensors bit for bit."""
    x = rng.normal(size=(6, 10)).astype(np.float32)
    ref_tree = {"m": jnp.asarray(x, jnp.bfloat16),
                "count": jnp.asarray(2, jnp.int32)}
    port_tree = {"m": torch.from_numpy(x).to(torch.bfloat16),
                 "count": torch.tensor(2, dtype=torch.int32)}
    rman.save(tmp_path / "ref", 2, ref_tree)
    save(tmp_path / "port", 2, port_tree)
    d = [tmp_path / kind / "step_000000002" for kind in ("ref", "port")]
    man = [json.loads((x / "manifest.json").read_text()) for x in d]
    assert man[0] == man[1] and man[1]["arrays"]["m"]["dtype"] == "bfloat16"
    za, zb = (zipfile.ZipFile(x / "arrays.npz") for x in d)
    assert za.read("m.npy") == zb.read("m.npy")
    assert b"'descr': '<V2'" in zb.read("m.npy")[:128]
    for kind in ("ref", "port"):
        got, _ = restore(tmp_path / kind, port_tree, device="cpu")
        assert got["m"].dtype == torch.bfloat16
        assert torch.equal(got["m"].view(torch.int16),
                           port_tree["m"].view(torch.int16))
        assert torch.equal(got["count"], port_tree["count"])
    with pytest.raises(TypeError):
        rman.restore(tmp_path / "port", ref_tree)


def test_a_train_state_crosses_both_ways(tmp_path):
    """A reduced arch's params and int8-moment optimizer state after one
    port step: port -> reference -> port, equal trees throughout."""
    opt_cfg = OptimizerConfig(moment_dtype="int8")
    step_fn, data, params = _trainer(opt_cfg)
    opt = adamw_init(params, opt_cfg)
    params, opt, _ = step_fn(params, opt, _batch(data, 0))
    tree = {"params": params, "opt": opt}
    save(tmp_path / "a", 1, tree)
    # the reference restores into a flat template of the same paths
    ref_tree, _ = rman.restore(tmp_path / "a", flat(tree))
    assert "opt/m/embed/q" in ref_tree
    rman.save(tmp_path / "b", 1, ref_tree)
    got, _ = restore(tmp_path / "b", tree, device="cpu")
    assert_same_tree(got, tree)
