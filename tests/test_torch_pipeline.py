"""GPipe pipeline parallelism on the port (repro_torch.models.pipeline):
``pipeline_apply`` on 8 gloo ranks of the CPU against the sequential
reference, the reference's own case (tests/test_pipeline.py): mesh
(4, 2) ("pod", "model"), S 4 stages, B 16, D 32, M 4 and 8, max error
under 1e-5. Held against the port's ``unpipelined_reference`` and the
reference's, run with jax on the CPU over the same numpy params.

The ranks are spawned once for the module (``spawn_ranks`` of
tests/test_torch_mesh_train.py), each with a ``file://`` rendezvous in its
own temporary directory, so parallel workers never share a port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.pipeline import unpipelined_reference as r_unpipelined
from repro_torch.models.pipeline import (pipeline_apply,
                                         unpipelined_reference)
from test_torch_mesh_train import spawn_ranks

S, B, D = 4, 16, 32
MICROBATCHES = (4, 8)
TOL = 1e-5


def stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _pipeline_rank(rank, world, params, x, out_dir):
    from repro_torch.compat import init_device_mesh
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("pod", "model"))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    outs = {f"M{M}": pipeline_apply(stage_fn, tp, torch.from_numpy(x),
                                    mesh=mesh, axis="pod",
                                    num_microbatches=M).numpy()
            for M in MICROBATCHES}
    np.savez(f"{out_dir}/rank{rank}.npz", **outs)


def make_case():
    rng = np.random.default_rng(0)
    params = {
        "w": rng.normal(0, 0.3, (S, D, D)).astype(np.float32),
        "b": rng.normal(0, 0.1, (S, D)).astype(np.float32),
    }
    x = rng.normal(0, 1, (B, D)).astype(np.float32)
    return params, x


@pytest.fixture(scope="module")
def pipelined(tmp_path_factory):
    """Every rank's output at each M (one spawn of 8 ranks)."""
    tmp = tmp_path_factory.mktemp("pipeline")
    params, x = make_case()
    spawn_ranks(_pipeline_rank, 8, tmp, params, x, str(tmp))
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(8)]


def _port_ref():
    params, x = make_case()
    return unpipelined_reference(
        stage_fn, {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x)).numpy()


def _jax_ref():
    params, x = make_case()
    return np.asarray(r_unpipelined(
        lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))


@pytest.mark.parametrize("M", MICROBATCHES)
@pytest.mark.parametrize("ref", ["port", "reference"])
def test_gpipe_matches_sequential(pipelined, M, ref):
    want = _port_ref() if ref == "port" else _jax_ref()
    for r, outs in enumerate(pipelined):
        err = float(np.abs(outs[f"M{M}"] - want).max())
        assert err < TOL, (r, M, err)


def test_unpipelined_references_agree():
    assert float(np.abs(_port_ref() - _jax_ref()).max()) < TOL


def test_one_stage_is_the_stage(tmp_path):
    """S = 1 (one rank on the pipeline axis): no rotation, the stage
    applied to each microbatch."""
    spawn_ranks(_one_stage_rank, 1, tmp_path, str(tmp_path))
    params, x = make_case()
    p0 = {k: torch.from_numpy(v[:1]) for k, v in params.items()}
    want = stage_fn({k: v[0] for k, v in p0.items()}, torch.from_numpy(x))
    got = np.load(tmp_path / "one.npy")
    assert float(np.abs(got - want.numpy()).max()) < TOL


def _one_stage_rank(rank, world, out_dir):
    from repro_torch.compat import init_device_mesh
    params, x = make_case()
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
    p0 = {k: torch.from_numpy(v[:1]) for k, v in params.items()}
    np.save(f"{out_dir}/one.npy",
            pipeline_apply(stage_fn, p0, torch.from_numpy(x), mesh=mesh,
                           num_microbatches=4).numpy())
