"""Fault-tolerance walkthrough on the port: train, checkpoint, "lose" a
host, plan a remesh, resume from the same checkpoint — loss continues
from where it left off.

The walkthrough runs on one device: the remesh is a plan that is
printed, and the restore and the resumed steps run on the same device.
(On a mesh, ``CheckpointManager.restore_latest(template, shardings=)``
places each leaf of the checkpoint as a DTensor on the new mesh.) The
card is the default; ``--device cpu`` runs on the CPU.

Run:  PYTHONPATH=src python examples/torch_elastic_restart.py
"""
import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_spec, reduced_model
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.kernels.common import resolve_device
from repro_torch.models import model_zoo as zoo
from repro_torch.models import params as params_lib
from repro_torch.models import steps as steps_lib
from repro_torch.models.sharding import make_rules
from repro_torch.optim.optimizer import OptimizerConfig, adamw_init
from repro_torch.runtime.fault_tolerance import Heartbeats, plan_remesh

CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_elastic_demo")


def main(device=None):
    device = resolve_device(device)
    shutil.rmtree(CKPT, ignore_errors=True)
    spec = get_spec("llama3.2-1b")
    cfg = reduced_model(spec.model)
    par = spec.parallelism.replace(remat="none", fsdp=False,
                                   sequence_parallel=False)
    shape = ShapeConfig("t", "train", 128, 8)
    rules = make_rules(None, cfg, par)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=1000)
    step_fn = steps_lib.make_train_step(cfg, rules, par, opt_cfg)
    data = DataPipeline(cfg, shape, DataConfig(seed=0))

    def batch_at(step):
        return {k: torch.from_numpy(v).to(device)
                for k, v in data.batch_at(step).items()}

    params = params_lib.initialize(zoo.param_template(cfg), 0, device=device)
    opt = adamw_init(params, opt_cfg)
    ckpt = CheckpointManager(CKPT, interval=10)

    print("phase 1: 20 steps on the 'full fleet'")
    for step in range(20):
        params, opt, m = step_fn(params, opt, batch_at(step))
        ckpt.maybe_save(step + 1, {"params": params, "opt": opt})
    ckpt.wait()
    print(f"  step 19 loss = {float(m['loss']):.4f} (checkpointed)")

    print("phase 2: host 3 stops heartbeating -> remesh plan")
    hb = Heartbeats(hosts=[0, 1, 2, 3], timeout_s=1.0, clock=lambda: 100.0)
    for h in (0, 1, 2):
        hb.beat(h, at=100.0)
    hb.beat(3, at=90.0)                      # stale
    dead = hb.dead_hosts(now=100.0)
    plan = plan_remesh(hb.alive_hosts(now=100.0), chips_per_host=4,
                       model_axis=2, global_batch=8, dropped=dead)
    print(f"  dead={dead} -> new mesh data={plan.data_axis} x "
          f"model={plan.model_axis} on hosts {plan.hosts}, "
          f"global_batch={plan.global_batch} (a plan: the port runs on "
          f"one {device.type} device)")

    print("phase 3: restore + resume")
    template = {"params": params, "opt": opt}
    tree, start = ckpt.restore_latest(template, device=device)
    params2, opt2 = tree["params"], tree["opt"]
    for step in range(start, start + 10):
        params2, opt2, m2 = step_fn(params2, opt2, batch_at(step))
    print(f"  resumed step {start} -> {start + 9}, "
          f"loss = {float(m2['loss']):.4f} (continues smoothly)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
