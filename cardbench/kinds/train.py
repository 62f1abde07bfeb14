"""The training kind: the port's train step at the configuration's full
width, driven in a closed loop.

Set-up builds one trainer (``repro_torch.launch.train.build_trainer``
with the configuration's model and parallelism as overrides), makes the
benchmark's weights from the seed, the program's AdamW state
(``adamw_init``) and the traffic's batches, and drives the first
``check_steps`` steps through the window's own call and feed (each batch
through ``launch.train.place_batch``). Those steps warm up every shape
and are the ones the reference follows. The window then runs the same
object on: the next step starts when the previous one has ended (a
synchronise after each). With ``--trace 1`` on the card the window is
followed by ``traced_steps`` steps run the same way under
``torch.profiler``, recording the device's activity. Once the peak
memory has been read and the program's state freed, the plain reference
runs the first steps again from the same weights and batches, and the
comparison decides ``correct``.
"""
from __future__ import annotations

import gc
import math
import sys
import time

import torch

from cardbench.harness import compare, trace, traffic, weights
from cardbench.harness.manifest import load_code
from cardbench.harness.peaks import bf16_flops

# optimizer fields the configuration file states and the program's
# OptimizerConfig has to match
_OPT_FIELDS = ("lr", "warmup_steps", "total_steps", "b1", "b2", "eps",
               "weight_decay", "clip_norm")


def _log(msg: str) -> None:
    print(f"[cardbench] {msg}", file=sys.stderr, flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Trainer:
    """The program's train step and what it was built with."""

    def __init__(self, cell, device):
        from repro_torch.launch import train as launch
        from repro_torch.models import model_zoo as zoo
        from repro_torch.optim.optimizer import adamw_init

        c, mix = cell.config, cell.traffic
        self.dev = torch.device(device)
        self.batch, self.seq = mix["batch"], mix["seq"]
        overrides = dict(c["parallelism"], **c["model"])
        (self.cfg, self.par, self.shape, self.rules, self.train_step, data,
         self.opt_cfg) = launch.build_trainer(
            c["arch"], reduced=False, seq=self.seq, batch=self.batch,
            steps=c["optimizer"]["total_steps"], lr=c["optimizer"]["lr"],
            overrides=overrides)
        data.close()
        for k in _OPT_FIELDS:
            if getattr(self.opt_cfg, k) != c["optimizer"][k]:
                raise ValueError(f"the program's optimizer has {k}="
                                 f"{getattr(self.opt_cfg, k)!r}, the "
                                 f"configuration {c['optimizer'][k]!r}")
        self.specs = load_code("reference", c["reference"],
                               cell.bench_dir).param_specs(c)
        ours = {p: tuple(s) for p, s, _, _ in self.specs}
        theirs = {p: tuple(s.shape) for p, s in
                  weights.flatten(zoo.param_template(self.cfg)).items()}
        if ours != theirs:
            raise ValueError("the program's parameter tree differs from "
                             "the configuration's: " +
                             repr(sorted(set(ours.items()) ^
                                         set(theirs.items()))[:8]))
        self._place = launch.place_batch
        self._adamw_init = adamw_init

    def weights(self, seed: int) -> dict:
        return weights.make(self.specs, seed, self.dev)

    def init(self, seed: int):
        params = weights.nest(self.weights(seed))
        return params, self._adamw_init(params, self.opt_cfg)

    def step(self, params, opt_state, batch: dict):
        b = self._place(batch, self.cfg, self.shape, self.rules, self.dev)
        return self.train_step(params, opt_state, b)


def first_steps(tr: Trainer, seed: int, batches: list, n: int):
    """``n`` steps of the program from the seed's weights. Returns
    (params, opt_state, summary) with the summary the comparison reads:
    each step's loss, step 1's gradient norm, step 1's clipped gradient by
    leaf from the first moment, the change by leaf after step ``n``."""
    params, opt = tr.init(seed)
    b1 = tr.opt_cfg.b1
    losses = []
    for i in range(n):
        params, opt, met = tr.step(params, opt, batches[i])
        _sync(tr.dev)
        losses.append(met["loss"])
        if i == 0:
            gnorm = met["grad_norm"]
            grad = {k: torch.linalg.vector_norm(v.float()) / (1 - b1)
                    for k, v in weights.flatten(opt["m"]).items()}
    w0 = tr.weights(seed)
    cur = weights.flatten(params)
    change = {k: torch.linalg.vector_norm(cur[k].float() - w0[k])
              for k in w0}
    del w0, cur
    summary = {"loss": [float(x) for x in losses], "grad_norm": float(gnorm),
               "grad": {k: float(v) for k, v in grad.items()},
               "change": {k: float(v) for k, v in change.items()}}
    return params, opt, summary


def reference_steps(cell, seed: int, batches: list, n: int, device,
                    product=None) -> dict:
    """The plain reference's summary of the same ``n`` steps."""
    ref = load_code("reference", cell.config["reference"], cell.bench_dir)
    w0 = weights.make(ref.param_specs(cell.config), seed, device)
    feed = [(torch.from_numpy(b["tokens"]).to(device),
             torch.from_numpy(b["labels"]).to(device)) for b in batches[:n]]
    return ref.train(cell.config, w0, feed, product=product,
                     rows=cell.workload.get("reference_rows"))


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def make_batches(cell, seed: int) -> list:
    c, mix, wl = cell.config, cell.traffic, cell.workload
    return traffic.batches(mix, c["model"]["vocab_size"], seed,
                           wl["check_steps"] + mix["batches"])


def run(cell, seed: int, seconds: float, traced: bool, t_start: float,
        device="cuda", plant=None) -> dict:
    """One run of the cell. ``t_start`` is the process's start on the
    ``time.perf_counter`` clock; ``plant`` (tests) wraps the train step.
    Returns what the metrics' readers and the result line take."""
    dev = torch.device(device)
    wl, c = cell.workload, cell.config
    n_check = wl["check_steps"]
    batches = make_batches(cell, seed)
    _log(f"traffic made at {time.perf_counter() - t_start:.3f} s")
    tr = Trainer(cell, dev)
    if plant is not None:
        tr.train_step = plant(tr.train_step)
    _log(f"trainer built at {time.perf_counter() - t_start:.3f} s")
    params, opt, prog = first_steps(tr, seed, batches, n_check)
    _log(f"first {n_check} steps done at {time.perf_counter() - t_start:.3f}"
         f" s: {prog['loss']}, grad norm {prog['grad_norm']}")
    window = batches[n_check:]
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else None

    # ---- the measured window ----
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    losses, steps = [], 0
    while True:
        params, opt, met = tr.step(params, opt, window[steps % len(window)])
        _sync(dev)
        losses.append(met["loss"])
        steps += 1
        if time.perf_counter() >= deadline:
            break
    t1 = time.perf_counter()
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    _log(f"window: {steps} steps in {t1 - t0:.3f} s")

    reduced = None
    if traced and cuda:
        from torch.profiler import ProfilerActivity, profile
        k = wl["traced_steps"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _sync(dev)
            for i in range(k):
                params, opt, _ = tr.step(params, opt,
                                         window[(steps + i) % len(window)])
                _sync(dev)
        reduced = trace.reduce(prof.profiler.kineto_results.events(), k)
        del prof

    failed = sum(not math.isfinite(float(x)) for x in losses)
    del params, opt, met, tr
    free(dev)
    t2 = time.perf_counter()
    ref = reference_steps(cell, seed, batches, n_check, dev)
    _log(f"reference: {n_check} steps in {time.perf_counter() - t2:.3f} s: "
         f"{ref['loss']}, grad norm {ref['grad_norm']}")
    nums = compare.numbers(prog, ref)
    limits = wl["limits"]
    mix = cell.traffic
    fam = load_code("flops", c["model"]["family"], cell.bench_dir)
    flops = fam.train_step_flops(c["model"], mix["batch"], mix["seq"])
    peak = bf16_flops(torch.cuda.get_device_name(dev) if cuda else "")
    if peak:    # a figure derived from tokens/s, for reading; no metric
        _log(f"model FLOPs a step {flops:.6e}; the window's share of the "
             f"bf16 peak {100.0 * flops * steps / (t1 - t0) / peak:.4f} %")
    return {
        "kind": "train",
        "setup_s": t0 - t_start,
        "window_s": t1 - t0,
        "steps": steps,
        "tokens_per_step": mix["batch"] * mix["seq"],
        "flops_per_step": flops,
        "window_peak_bytes": window_peak,
        "memory_peak_bytes": (max(setup_peak, window_peak) if cuda
                              else None),
        "trace": reduced,
        "checks": nums,
        "limits": limits,
        "correct": failed == 0 and compare.judge(nums, limits),
        "attempted": steps,
        "failed": failed,
    }
