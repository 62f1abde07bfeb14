"""Serve a small model with batched requests (continuous batching demo)
on the port, through ``python -m repro_torch.launch.serve``. The card is
the default device; add ``--device cpu`` for the CPU.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import sys

from repro_torch.launch.serve import main as serve_main

if __name__ == "__main__":
    sys.exit(serve_main([
        "--arch", "llama3.2-1b", "--reduced",
        "--requests", "12", "--slots", "4",
        "--max-seq", "96", "--max-new", "16",
    ] + sys.argv[1:]))
