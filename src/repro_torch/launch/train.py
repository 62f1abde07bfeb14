"""Training driver: config-driven, checkpointed, fault-tolerant; the port of
the reference's ``repro/launch/train.py`` on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \
      --device cpu

The card is the default device (no fallback); ``--device cpu`` runs the
same step on the CPU. ``--trace-out`` / ``--metrics-out`` trace every
step (``repro_torch.kvi.obs.spans``: the train step's spans on a host
and a device lane, stamped on the profiler's clock) and save the Chrome
trace and the metrics snapshot. Fault tolerance: periodic async checkpoints in the
reference's format, a preemption-triggered sync save, resume from
``LATEST``.

On a machine with a card, ``build_trainer`` has the caching allocator
grow its segments in place (expandable segments). A full-width step
makes its loss's float32 tensors anew (five of 6.16 GiB at mamba2-1.3b's
8 x 4096, each in a segment of its own), and AdamW's update then makes
each stacked leaf's new param, moments and temporaries (1.5 GiB apiece)
in those segments once they are free; with fixed segments the next
step's logits find no whole 6.16 GiB block, and the card runs out at
46.5 GiB allocated, 27 GiB of it cached in pieces.

On a mesh (``build_trainer(mesh=)``, a ``DeviceMesh`` over NCCL or gloo
ranks) the arch's own ``Parallelism`` holds (FSDP, sequence
parallelism, remat), as the reference's does; ``init_state`` and
``place_batch`` give params, moments and batches as DTensors placed by
``params.shardings``, and the train step runs unchanged over them.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager, latest_step
from repro_torch.configs import get_spec, reduced_model
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.kernels.common import resolve_device
from repro_torch.kvi.obs import Obs, spans
from repro_torch.models import model_zoo as zoo
from repro_torch.models import params as params_lib
from repro_torch.models import steps as steps_lib
from repro_torch.models.sharding import make_rules
from repro_torch.optim.optimizer import OptimizerConfig, adamw_init
from repro_torch.runtime.fault_tolerance import PreemptionGuard


def build_trainer(arch: str, *, reduced: bool, seq: int, batch: int,
                  steps: int, mesh=None, data_path=None, seed=0,
                  lr: float = 3e-4, overrides: dict = None):
    """The reference's ``build_trainer``; ``overrides`` (as the dry run's
    ``--override``) sets ``Parallelism`` or ``ModelConfig`` fields after
    the one-device rule. On a machine with a card the allocator's
    segments grow in place from here on (see the module's docstring)."""
    if torch.cuda.is_available():
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    spec = get_spec(arch)
    cfg = reduced_model(spec.model) if reduced else spec.model
    # one device: no remat, no FSDP, no sequence parallelism
    par = spec.parallelism if mesh is not None else \
        spec.parallelism.replace(remat="none", fsdp=False,
                                 sequence_parallel=False)
    for k, v in (overrides or {}).items():
        if hasattr(par, k):
            par = par.replace(**{k: v})
        else:
            cfg = cfg.replace(**{k: v})
    shape = ShapeConfig("train", "train", seq, batch)
    rules = make_rules(mesh, cfg, par)
    opt_cfg = OptimizerConfig(lr=lr, total_steps=steps,
                              warmup_steps=max(10, steps // 20),
                              moment_dtype=par.moment_dtype)
    train_step = steps_lib.make_train_step(cfg, rules, par, opt_cfg)
    data = DataPipeline(cfg, shape, DataConfig(
        source="file" if data_path else "synthetic", path=data_path,
        seed=seed))
    return cfg, par, shape, rules, train_step, data, opt_cfg


def init_state(cfg, rules, opt_cfg, seed: int = 0, device=None):
    """``(params, opt_state)``: seeded params on ``device`` (the card
    unless ``"cpu"``) and their AdamW state; on the rules' mesh both are
    DTensors, each rank keeping its blocks of the same seeded tensors."""
    template = zoo.param_template(cfg)
    params = params_lib.initialize(template, seed, device=device)
    if rules.mesh is not None:
        params = params_lib.place(params, params_lib.shardings(template,
                                                               rules),
                                  rules.mesh)
    return params, adamw_init(params, opt_cfg)


def place_batch(batch: dict, cfg, shape, rules, device=None) -> dict:
    """One step's numpy batch as tensors on ``device``; on the rules' mesh
    DTensors placed by the batch template's logical axes."""
    dev = resolve_device(device)
    out = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    if rules.mesh is None:
        return out
    return params_lib.place(out, params_lib.shardings(
        steps_lib.batch_template(cfg, shape), rules), rules.mesh)


def main(argv=None, *, report: dict = None) -> int:
    """Train and print the reference's lines. A caller that passes a dict
    as ``report`` gets the run back in it: ``params``, ``opt_state``,
    ``start_step``, ``steps`` (one dict a step run: ``step``, ``loss``,
    ``grad_norm``, ``lr``, ``seconds``, the last read after the step's
    metrics reach the host), ``train_step``, ``data``, ``cfg``,
    ``device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--data", default="", help="text file (byte tokenizer)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace of the train steps' spans "
                         "(host and device lanes)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot JSON (the "
                         "spans' device and host ms by name)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, par, shape, rules, train_step, data, opt_cfg = build_trainer(
        args.arch, reduced=args.reduced, seq=args.seq, batch=args.batch,
        steps=args.steps, data_path=args.data or None, seed=args.seed,
        lr=args.lr)

    n_params = zoo.param_count(cfg)
    print(f"arch={args.arch} reduced={args.reduced} params={n_params:,} "
          f"seq={args.seq} batch={args.batch}")

    params, opt_state = init_state(cfg, rules, opt_cfg, args.seed, device)
    start_step = 0

    ckpt = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval) \
        if args.ckpt_dir else None
    if ckpt and args.resume and latest_step(args.ckpt_dir) is not None:
        tree = {"params": params, "opt": opt_state}
        tree, start_step = ckpt.restore_latest(tree, device=device)
        params, opt_state = tree["params"], tree["opt"]
        print(f"resumed from step {start_step}")

    losses, steps_run = [], []
    t_last = time.time()
    obs = Obs.on() if args.trace_out or args.metrics_out else None
    with PreemptionGuard() as guard, \
            (spans.activate(obs) if obs else contextlib.nullcontext()):
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()
            batch = place_batch(data.batch_at(step), cfg, shape, rules,
                                device)
            params, opt_state, metrics = train_step(params, opt_state, batch)
            if report is not None:
                steps_run.append({k: float(metrics[k]) for k in
                                  ("loss", "grad_norm", "lr")})
                steps_run[-1].update(step=step,
                                     seconds=time.perf_counter() - t0)
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])
                losses.append((step, loss))
                dt = time.time() - t_last
                t_last = time.time()
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)",
                      flush=True)
                if obs is not None:     # the host has waited here anyway
                    spans.flush()
            if ckpt:
                ckpt.maybe_save(step + 1, {"params": params, "opt": opt_state},
                                force=guard.requested)
            if guard.requested:
                print("preemption requested: checkpoint saved, exiting")
                break
    if ckpt:
        ckpt.wait()
    if obs is not None:
        obs.save(trace_path=args.trace_out, metrics_path=args.metrics_out)
        for path in (args.trace_out, args.metrics_out):
            if path:
                print(f"telemetry -> {path}", file=sys.stderr)
    if len(losses) >= 2:
        print(f"loss {losses[0][1]:.4f} -> {losses[-1][1]:.4f} "
              f"({'improved' if losses[-1][1] < losses[0][1] else 'NOT improved'})")
    data.close()
    if report is not None:
        report.update(params=params, opt_state=opt_state,
                      start_step=start_step, steps=steps_run,
                      train_step=train_step, data=data, cfg=cfg,
                      device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
