"""Quickstart on the port: write a KVI program ONCE, run it on three
backends.

  1. Author a program with KviProgramBuilder (named virtual vector regs),
  2. run it on the oracle (numpy), cyclesim (values + per-scheme cycle
     counts, the paper's Table 2 protocol) and torch (one ``kvi_walk``
     launch of the hand-written CUDA kernel on the card; its plain
     PyTorch version with ``--device cpu``) backends — same definition,
     three executors,
  3. sweep the paper's coprocessor taxonomy on the canonical kernels.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs.base import klessydra_taxonomy
from repro_torch.core.workloads import homogeneous_cycles
from repro_torch.kvi import KviProgramBuilder, available_backends, get_backend
from repro_torch.kvi.programs import conv2d_program, conv2d_result

BACKENDS = ("oracle", "cyclesim", "torch")


def backend(name: str, device=None):
    return get_backend(name, device=device) if name == "torch" else \
        get_backend(name)


def write_once_run_everywhere(device=None) -> dict:
    print("=== 1. One KVI program, three backends ===")
    b = KviProgramBuilder("relu3x")
    x = np.arange(-8, 8, dtype=np.int32)
    hin = b.mem_in("x", x)
    v = b.vreg("v", 16)
    b.kmemld(v, hin)                       # load vector into the SPM
    b.ksvmulsc(v, v, scalar=3)             # v = 3 * x
    b.krelu(v, v)                          # v = relu(v)
    hout = b.mem_out("y", 16)
    b.kmemstr(hout, v)                     # store back to main memory
    prog = b.build()

    outs = {}
    for name in BACKENDS:
        res = backend(name, device).run(prog)
        outs[name] = np.asarray(res.outputs["y"])
        line = f"  {name:9s} relu(3*x) = {outs[name][:6]}..."
        if res.cycles:
            line += f"  cycles={res.cycles}"
        print(line)
    print("  registered backends:", sorted(available_backends()))
    return outs


def conv_differential(device=None) -> dict:
    print("\n=== 2. conv2d 8x8 (3x3 gaussian): oracle vs cyclesim vs "
          "torch ===")
    rng = np.random.default_rng(0)
    img = rng.integers(-64, 64, (8, 8)).astype(np.int32)
    filt = np.asarray([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.int32)
    prog = conv2d_program(img, filt, shift=4)

    outs = {n: conv2d_result(backend(n, device).run(prog))
            for n in BACKENDS}
    assert np.array_equal(outs["oracle"], outs["cyclesim"])
    assert np.array_equal(outs["oracle"], outs["torch"])
    print("  all three backends agree; corner:", outs["oracle"][0, :4])
    timing = get_backend("cyclesim").run(prog).cycles
    print("  cycles:", timing,
          "(paper invariant: sym_mimd <= het_mimd <= shared)")
    return outs


def scheme_sweep():
    print("\n=== 3. Coprocessor scheme sweep (conv 32x32, 3x3) ===")
    for _name, cfg in klessydra_taxonomy().items():
        r = homogeneous_cycles(cfg, "conv32")
        print(f"  {cfg.name:16s} avg cycles/kernel = {r['avg_cycles']:8.0f} "
              f"(MFU util {r['mfu_util']:.2f})")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = ap.parse_args().device
    write_once_run_everywhere(dev)
    conv_differential(dev)
    scheme_sweep()
