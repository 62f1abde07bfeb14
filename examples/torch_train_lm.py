"""End-to-end driver on the port: train the ~100M-parameter llama-style
model (llama100m) for a few hundred steps on synthetic data, with
checkpointing + restart, through ``python -m repro_torch.launch.train``.

The card is the default device; ``--device cpu`` runs the same step on
the CPU (slow at this size). ``--seq`` defaults to 128; pass 1024 for
the config's full sequence.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
"""
import argparse
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def build_args(ns):
    args = [
        "--arch", "llama100m",
        "--steps", str(ns.steps),
        "--batch", str(ns.batch),
        "--seq", str(ns.seq),
        "--log-every", "10",
        "--ckpt-interval", "100",
    ]
    if ns.ckpt_dir:
        args += ["--ckpt-dir", ns.ckpt_dir]
    if ns.resume:
        args += ["--resume"]
    if ns.device:
        args += ["--device", ns.device]
    return args


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ns = ap.parse_args()
    sys.exit(train_main(build_args(ns)))
