"""The port's mesh paths on 8 gloo ranks of the CPU, each against its
one-device result: ``build_trainer(mesh=)`` (DTensor params, moments and
batches placed by the rules; the arch's own Parallelism: FSDP, sequence
parallelism, remat), ``cross_pod_mean(mesh=)`` against the reference's,
and checkpoints saved from the mesh and restored with ``shardings=``.

One spawn of 8 ranks (``file://`` rendezvous in a temporary directory)
runs every case, against one-device runs made once in the test
process; ranks 0 and 7 write what they measured and the tests read it:

* llama3.2-1b reduced on a (2, 4) data x model mesh with ``fsdp`` and
  ``sequence_parallel`` on, mixtral-8x7b reduced (its own FSDP + SP) and
  mamba2-1.3b reduced (SP), float32, 2 steps: losses and the first
  step's gradients within 1e-4 of ``mesh=None``;
* expert parallelism on a (2, 2, 2) pod x data x model mesh: mixtral's
  MoE layer with ``expert_parallel=True`` rules (experts on "pod"),
  output and gradients within 1e-4 of one device. (The whole mixtral
  step on this 3-D mesh runs, but DTensor's sharding propagation over
  three mesh dims takes minutes of host time a rank, past what a test
  can take; the dry run runs the 2 x 16 x 16 cells.)
* ``cross_pod_mean`` on (2, 2, 2), each pod with its own gradients,
  against the reference's on 8 XLA host devices (a subprocess): means
  and errors within 1e-6, and the int8 codes of every pod equal;
* a checkpoint of the mesh's state after the llama steps, restored with
  ``shardings=`` bit for bit, equal to a ``mesh=None`` restore of the
  same directory and to a one-device save of the same state.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 1e-4
CROSS_TOL = 1e-6
F32 = {"dtype": "float32"}
#: arch -> overrides on the (2, 4) mesh: llama with FSDP and SP turned
#: on, the others with their own Parallelism
TRAIN_CASES = {
    "llama3.2-1b": dict(F32, fsdp=True, sequence_parallel=True),
    "mixtral-8x7b": dict(F32),
    "mamba2-1.3b": dict(F32),
}
#: the cross-pod case: a tree of per-pod gradients and errors
CROSS_SHAPES = {"w": (8, 16), "b": {"c": (4, 2, 16)}}


def spawn_ranks(fn, world: int, tmp_path, *args):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes, each
    in a gloo group over a ``file://`` rendezvous in ``tmp_path``; raises
    if any rank raises. One torch thread a rank. (This module imports no
    jax at its top, so a spawned rank does not pay for it.)"""
    init = f"file://{tmp_path}/rendezvous"
    mp.start_processes(_run_rank, args=(fn, world, init) + args,
                       nprocs=world, join=True, start_method="spawn")


def _run_rank(rank, fn, world, init, *args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _full(x):
    from repro_torch.compat import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _rel_err(got, want):
    got, want = _full(got).detach().float(), want.detach().float()
    return float((got - want).abs().max() / (want.abs().max() + TOL))


def train_run(arch, overrides, mesh):
    """Losses of 2 steps from the seeded weights and the first step's
    gradients, on ``mesh`` (``None``: one device), and the final state."""
    from repro_torch.compat import implicit_replication
    from repro_torch.launch import train as T
    from repro_torch.models import steps as S
    cfg, par, shape, rules, step, data, opt_cfg = T.build_trainer(
        arch, reduced=True, seq=64, batch=4, steps=2, mesh=mesh,
        overrides=overrides)
    params, opt = T.init_state(cfg, rules, opt_cfg, 0, "cpu")
    b0 = T.place_batch(data.batch_at(0), cfg, shape, rules, "cpu")
    with implicit_replication():
        (_, _), grads = S.value_and_grad(S.make_loss_fn(cfg, rules, par),
                                         params, b0)
    losses = []
    for i in range(2):
        b = T.place_batch(data.batch_at(i), cfg, shape, rules, "cpu")
        params, opt, met = step(params, opt, b)
        losses.append(float(_full(met["loss"])))
    return losses, _flat(grads), {"params": params, "opt": opt}


def _train_case(arch, overrides, mesh, one):
    """The mesh's run against ``one``, the one-device run's losses and
    gradients (computed once, in the test process)."""
    losses, grads, state = train_run(arch, overrides, mesh)
    grad_err = max(_rel_err(grads[k], torch.from_numpy(w))
                   for k, w in one[1].items())
    return {"losses_one": one[0], "losses_mesh": losses,
            "grad_err": grad_err}, state


def _ep_moe_case(mesh3):
    """Mixtral's MoE layer with expert parallelism on a 3-D mesh against
    one device: output and gradients."""
    from repro_torch.compat import implicit_replication
    from repro_torch.configs import get_spec, reduced_model
    from repro_torch.models import moe
    from repro_torch.models import model_zoo as Z
    from repro_torch.models import params as P
    from repro_torch.models.sharding import make_rules
    spec = get_spec("mixtral-8x7b")
    cfg = reduced_model(spec.model)
    par = spec.parallelism.replace(expert_parallel=True)
    rules = make_rules(mesh3, cfg, par)
    assert rules.mapping["experts"] == "pod"
    tmpl = {k: P.P(v.shape[1:], v.axes[1:], v.init, v.dtype, v.fan_in)
            for k, v in Z._moe_template(cfg, 1).items()}
    w = P.initialize(tmpl, 0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (4, 64, cfg.d_model)).astype(np.float32))
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
              cap_factor=cfg.capacity_factor)

    def run(w, x, rules):
        w = {k: v.detach().requires_grad_(True) for k, v in w.items()}
        y, aux = moe.moe_ffn(x, w, rules=rules, **kw)
        g = torch.autograd.grad(y.square().sum() + aux, list(w.values()))
        return y, dict(zip(w, g))

    y1, g1 = run(w, x, None)
    wm = P.place(w, P.shardings(tmpl, rules), mesh3)
    xm = P.place(x, rules.sharding(("batch", "seq", None), x.shape), mesh3)
    with implicit_replication():
        ym, gm = run(wm, xm, rules)
    return {"ep_out_err": _rel_err(ym, y1),
            "ep_grad_err": max(_rel_err(gm[k], g1[k]) for k in g1),
            "ep_expert_placements": str(wm["w_gate"].placements)}


def _cross_case(mesh3, pods):
    from repro_torch.optim.grad_compress import cross_pod_mean
    pod = mesh3.get_local_rank("pod")

    def tree(kind):
        return {"w": torch.from_numpy(pods[f"{kind}{pod}/w"]),
                "b": {"c": torch.from_numpy(pods[f"{kind}{pod}/b/c"])}}

    mean, err = cross_pod_mean(tree("g"), tree("e"), mesh=mesh3,
                               axis_name="pod")
    return {f"{kind}/{k}": v.numpy().tolist() for kind, t in
            (("mean", mean), ("err", err)) for k, v in _flat(t).items()}


def _ckpt_case(state, ckpt_dir, rank):
    import torch.distributed as dist
    from repro_torch.checkpoint import manager as M
    from repro_torch.models.params import placements_of
    M.save(f"{ckpt_dir}/mesh", 2, state)
    dist.barrier()
    restored, step = M.restore(f"{ckpt_dir}/mesh", state,
                               shardings=placements_of(state), device="cpu")
    plain, _ = M.restore(f"{ckpt_dir}/mesh", state, device="cpu")
    full = {k: _full(v) for k, v in _flat(state).items()}
    rs, pl = _flat(restored), _flat(plain)
    out = {"step": step,
           "placements_kept": all(
               str(getattr(rs[k], "placements", None)) ==
               str(getattr(v, "placements", None))
               for k, v in _flat(state).items()),
           "bitwise_sharded": all(torch.equal(_full(rs[k]), full[k])
                                  for k in full),
           "bitwise_plain": all(torch.equal(pl[k], full[k]) for k in full)}
    if rank == 0:
        one = {k: v.clone() for k, v in full.items()}
        M.save(f"{ckpt_dir}/one", 2, one)
        a = json.loads(Path(f"{ckpt_dir}/mesh/step_000000002/manifest.json")
                       .read_text())["arrays"]
        b = json.loads(Path(f"{ckpt_dir}/one/step_000000002/manifest.json")
                       .read_text())["arrays"]
        out["manifest_equal_one_device"] = a == b
    return out


def _mesh_rank(rank, world, pods, ones, out_dir):
    from repro_torch.compat import init_device_mesh
    mesh2 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    mesh3 = init_device_mesh("cpu", (2, 2, 2),
                             mesh_dim_names=("pod", "data", "model"))
    res, state = {}, None
    for arch, ov in TRAIN_CASES.items():
        res[arch], st = _train_case(arch, ov, mesh2, ones[arch])
        if arch == "llama3.2-1b":
            state = st
    res["ep"] = _ep_moe_case(mesh3)
    res["cross"] = _cross_case(mesh3, pods)
    res["ckpt"] = _ckpt_case(state, out_dir, rank)
    if rank in (0, world - 1):      # one rank of each pod
        Path(f"{out_dir}/rank{rank}.json").write_text(json.dumps(res))


def make_pods():
    rng = np.random.default_rng(0)
    out = {}
    for p in range(2):
        for kind, scale in (("g", 1.0), ("e", 1e-3)):
            for k, shp in _flat(CROSS_SHAPES).items():
                out[f"{kind}{p}/{k}"] = rng.normal(
                    0, scale, shp).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    ones = {}
    for arch, ov in TRAIN_CASES.items():
        losses, grads, _ = train_run(arch, ov, None)
        ones[arch] = (losses, {k: g.numpy() for k, g in grads.items()})
    spawn_ranks(_mesh_rank, 8, tmp, make_pods(), ones, str(tmp))
    return {r: json.loads((tmp / f"rank{r}.json").read_text())
            for r in (0, 7)}


@pytest.mark.parametrize("arch", sorted(TRAIN_CASES))
def test_mesh_training_equals_one_device(mesh_run, arch):
    r = mesh_run[0][arch]
    np.testing.assert_allclose(r["losses_mesh"], r["losses_one"],
                               rtol=TOL, atol=TOL)
    assert r["grad_err"] < TOL, r["grad_err"]


def test_expert_parallel_moe_equals_one_device(mesh_run):
    r = mesh_run[0]["ep"]
    assert "Shard(dim=0)" in r["ep_expert_placements"].split(",")[0]
    assert r["ep_out_err"] < TOL and r["ep_grad_err"] < TOL, r


# ---------------------------------------------------------------------------
# cross_pod_mean against the reference's on 8 XLA host devices
# ---------------------------------------------------------------------------

REF_CROSS = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    import numpy as np
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as PS
    from repro.optim.grad_compress import cross_pod_mean

    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    pods = dict(np.load(sys.argv[1]))
    keys = sorted({k.split("/", 1)[1] for k in pods})

    def per_pod(kind, key):
        # a "replicated" array whose devices hold their pod's values
        shards = [jax.device_put(pods[f"{kind}{idx[0]}/{key}"], dev)
                  for idx, dev in np.ndenumerate(mesh.devices)]
        shape = pods[f"{kind}0/{key}"].shape
        return jax.make_array_from_single_device_arrays(
            shape, NamedSharding(mesh, PS()), shards)

    out = {}
    for key in keys:
        # the reference's cross_pod_mean takes one array (its out_specs
        # are a pair of the grads' spec): leaf by leaf
        mean, err = cross_pod_mean(per_pod("g", key), per_pod("e", key),
                                   mesh)
        for name, leaf in (("mean", mean), ("err", err)):
            for shard in leaf.addressable_shards:
                idx = np.argwhere(mesh.devices == shard.device)[0]
                out[f"{name}/{key}/pod{idx[0]}"] = np.asarray(shard.data)
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def reference_cross(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cross")
    np.savez(tmp / "pods.npz", **make_pods())
    env = dict(os.environ, PYTHONPATH=SRC)
    p = subprocess.run([sys.executable, "-c", REF_CROSS, str(tmp / "pods.npz"),
                        str(tmp / "out.npz")], capture_output=True, text=True,
                       timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("pod", [0, 1])
def test_cross_pod_mean_equals_the_reference(mesh_run, reference_cross, pod):
    got = mesh_run[0 if pod == 0 else 7]["cross"]
    for key in _flat(CROSS_SHAPES):
        for kind in ("mean", "err"):
            np.testing.assert_allclose(
                np.asarray(got[f"{kind}/{key}"], np.float32),
                reference_cross[f"{kind}/{key}/pod{pod}"],
                rtol=CROSS_TOL, atol=CROSS_TOL)


@pytest.mark.parametrize("pod", [0, 1])
def test_cross_pod_codes_equal_the_reference(pod):
    """Each pod's int8 codes and scales (the wire payload) are the
    reference's, exactly."""
    import jax.numpy as jnp
    from repro.optim.grad_compress import compress_residual as r_compress
    from repro_torch.optim.grad_compress import compress_residual
    pods = make_pods()
    for key in _flat(CROSS_SHAPES):
        g, e = pods[f"g{pod}/{key}"], pods[f"e{pod}/{key}"]
        q, s, _ = compress_residual(torch.from_numpy(g), torch.from_numpy(e))
        rq, rs, _ = r_compress(jnp.asarray(g), jnp.asarray(e))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


def test_mesh_checkpoint_restores_bit_for_bit(mesh_run):
    for r in (0, 7):
        c = mesh_run[r]["ckpt"]
        assert c["step"] == 2
        assert c["placements_kept"] and c["bitwise_sharded"] and \
            c["bitwise_plain"], c
    assert mesh_run[0]["ckpt"]["manifest_equal_one_device"]
