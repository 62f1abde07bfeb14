"""Serving entry point: batched request serving with continuous batching, the
port of the reference's ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --reduced --requests 16 --slots 4 --max-seq 128 --device cpu

The card is the default device; ``--device cpu`` runs the plain PyTorch
path on the CPU. Weights are random, made from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_spec, reduced_model
from repro_torch.kernels.common import resolve_device
from repro_torch.models import model_zoo as zoo
from repro_torch.models import params as params_lib
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None, *, report: dict = None) -> int:
    """Serve ``--requests`` random prompts and print the reference's
    summary line. A caller that passes a dict as ``report`` gets the run
    back in it: ``engine``, ``done`` (the finished requests), ``seconds``,
    ``tokens``, ``ttft_s`` (one a request) and ``line``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    spec = get_spec(args.arch)
    cfg = reduced_model(spec.model) if args.reduced else spec.model
    params = params_lib.initialize(zoo.param_template(cfg), args.seed,
                                   device=device)
    engine = ServingEngine(cfg, params, slots=args.slots,
                           max_seq=args.max_seq, device=device)
    rng = np.random.default_rng(args.seed)
    t0 = time.monotonic()
    for i in range(args.requests):
        plen = int(rng.integers(4, args.max_seq // 4))
        engine.submit(Request(
            rid=i, prompt=rng.integers(1, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=args.max_new))
    done = engine.run_until_drained()
    dt = time.monotonic() - t0
    total_new = sum(len(r.out_tokens) for r in done)
    ttfts = [r.first_token_at - r.submitted_at for r in done]
    line = (f"served {len(done)} requests, {total_new} tokens in {dt:.2f}s "
            f"({total_new / dt:.1f} tok/s), "
            f"TTFT p50={np.percentile(ttfts, 50):.2f}s "
            f"p99={np.percentile(ttfts, 99):.2f}s")
    print(line)
    if report is not None:
        report.update(engine=engine, done=done, seconds=dt, tokens=total_new,
                      ttft_s=ttfts, line=line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
