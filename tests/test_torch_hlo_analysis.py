"""The port's step accountant (repro_torch.launch.hlo_analysis) against
the reference's trip-count-aware HLO accounting, on the contracts of
tests/test_hlo_analysis.py: one product exact, a 10-step loop and a
3 x 4 nested loop counted per iteration (the reference multiplies by
trip counts; eager execution runs each iteration), HBM bytes of
``x @ x + 1`` in range, no collectives on one device. The same programs
go through jax (compiled, ``analyze_hlo``) and the port (one eager run
under ``analyze_step``).

On a mesh (a fake process group in a subprocess, so no group leaks into
the test process): one all-reduce of a known tensor counted with its
bytes under ``all-reduce``, and a tensor-parallel product counted at
one device's share of its FLOPs (the hand count over 2 ranks).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.launch.hlo_analysis import (COLLECTIVES, analyze_step,
                                             xla_cost_analysis)

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _ref_flops(fn, *args):
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())[
        "dot_flops"]


def test_single_matmul_flops_exact():
    a, b = torch.zeros(128, 256), torch.zeros(256, 64)
    acct = analyze_step(lambda x, y: x @ y, a, b)
    want = 2 * 128 * 256 * 64
    assert acct["dot_flops"] == want
    assert acct["dot_flops"] == _ref_flops(
        lambda x, y: x @ y, jnp.zeros((128, 256)), jnp.zeros((256, 64)))
    # agrees with the library's own count (FlopCounterMode)
    assert xla_cost_analysis(lambda x, y: x @ y, a, b)["flops"] == want


def test_loop_counts_every_iteration():
    a = torch.zeros(64, 64)

    def f(x):
        for _ in range(10):
            x = x @ a
        return x

    def g(x):
        def body(c, _):
            return c @ jnp.zeros((64, 64)), None
        return jax.lax.scan(body, x, None, length=10)[0]

    want = 10 * 2 * 64 ** 3
    got = analyze_step(f, torch.zeros(64, 64))["dot_flops"]
    assert got == want
    assert got == _ref_flops(g, jnp.zeros((64, 64)))


def test_nested_loops():
    a = torch.zeros(32, 32)

    def f(x):
        for _ in range(3):
            for _ in range(4):
                x = x @ a
        return x

    def g(x):
        def outer(c, _):
            def inner(ci, _):
                return ci @ jnp.zeros((32, 32)), None
            return jax.lax.scan(inner, c, None, length=4)[0], None
        return jax.lax.scan(outer, x, None, length=3)[0]

    want = 12 * 2 * 32 ** 3
    got = analyze_step(f, torch.zeros(32, 32))["dot_flops"]
    assert got == want
    assert got == _ref_flops(g, jnp.zeros((32, 32)))


def test_hbm_bytes_reasonable():
    acct = analyze_step(lambda x: x @ x + 1.0, torch.zeros(1024, 1024))
    four_mb = 4 * 1024 * 1024
    # at least: read a (as two operands) + write result + elementwise pass
    assert acct["hbm_bytes"] >= 3 * four_mb
    assert acct["hbm_bytes"] <= 20 * four_mb


def test_views_move_nothing():
    x = torch.zeros(256, 256)
    acct = analyze_step(lambda x: x.view(-1).reshape(256, 256).t().detach(),
                        x)
    assert acct["hbm_bytes"] == 0 and acct["dot_flops"] == 0


def test_no_collectives_on_single_device():
    acct = analyze_step(lambda x: x * 2, torch.zeros(64))
    assert acct["collective_bytes"]["total"] == 0
    assert set(acct["collective_bytes"]) == set(COLLECTIVES) | {"total"}


MESH_SCRIPT = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    from repro_torch.compat import (Replicate, Shard, fake_store,
                                    init_device_mesh)
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.models.params import meta_dtensor

    dist.init_process_group("fake", store=fake_store(), rank=0,
                            world_size=2)
    try:
        t = torch.zeros(1000, dtype=torch.float32)
        ar = analyze_step(lambda: dist.all_reduce(t), top_collectives=2)
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
        x = meta_dtensor((64, 256), torch.float32, mesh, (Replicate(),))
        w1 = meta_dtensor((256, 512), torch.float32, mesh, (Shard(1),))
        w2 = meta_dtensor((512, 256), torch.float32, mesh, (Shard(0),))
        # column- then row-parallel: one all-reduce of the [64, 256]
        # partial sums, 1/2 of each product's FLOPs a device
        tp = analyze_step(
            lambda: (x @ w1 @ w2).redistribute(mesh, (Replicate(),)))
        print("RESULT:" + json.dumps({
            "ar": ar["collective_bytes"], "ar_top": ar["top_collectives"],
            "tp_flops": tp["dot_flops"], "tp_global": tp["global_dot_flops"],
            "tp_coll": tp["collective_bytes"]}))
    finally:
        dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def mesh_result():
    env = dict(os.environ, PYTHONPATH=SRC)
    p = subprocess.run([sys.executable, "-c", MESH_SCRIPT],
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [l for l in p.stdout.splitlines() if l.startswith("RESULT:")][0]
    return json.loads(line[len("RESULT:"):])


def test_all_reduce_counted_with_its_bytes(mesh_result):
    ar = mesh_result["ar"]
    assert ar["all-reduce"] == 4000.0 and ar["total"] == 4000.0
    assert mesh_result["ar_top"][0]["kind"] == "all-reduce"


def test_tensor_parallel_product_counts_one_device(mesh_result):
    hand = 2 * (2 * 64 * 256 * 512)          # the two products, global
    assert mesh_result["tp_global"] == hand
    assert mesh_result["tp_flops"] == hand / 2
    coll = mesh_result["tp_coll"]
    assert coll["all-reduce"] == 64 * 256 * 4 and coll["total"] == \
        coll["all-reduce"]
