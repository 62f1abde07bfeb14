"""The paper's composite workload on the port: conv + FFT + MatMul on
three harts, as a first-class :class:`~repro_torch.kvi.workload.KviWorkload`.

A workload is a batch of (program, hart-assignment, data-instance)
entries; entries pinned to the same hart execute back-to-back in entry
order, exactly the repeated-kernel streams of the paper's measurement
protocol. Every backend executes the same workload object through
``run_workload()``:

  1. cyclesim — per-hart traces with true inter-hart contention per
     coprocessor scheme (heterogeneous MIMD tracks symmetric MIMD within
     a few percent at 1/3 the functional units).
  2. oracle / torch — the same entries, bit-identical outputs; the torch
     backend groups entries by program structure and walks each group
     in one ``kvi_walk`` launch on the card.
  3. The SAME composite as ONE het-MIMD launch
     (``repro_torch.kernels.ops.het_mimd_composite``, ``csrc/het_mimd.cu``
     on the card): a block range per hart, dedicated shared memory.

The card is the default device; ``--device cpu`` runs the kernels' plain
PyTorch versions.

Run:  PYTHONPATH=src python examples/torch_composite_workload.py
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import KlessydraConfig
from repro_torch.core.workloads import COMPOSITE_KERNELS, composite_workload
from repro_torch.kernels import ops, ref
from repro_torch.kernels.common import resolve_device
from repro_torch.kvi import get_backend
from repro_torch.kvi.cyclesim import CycleSimBackend


def simulate():
    print("=== composite workload: cycle simulation ===")
    print(f"{'scheme':18s} {'conv32':>9s} {'fft256':>9s} {'matmul64':>9s}")
    reps = {"conv32": 6, "fft256": 6, "matmul64": 1}
    schemes = {name: KlessydraConfig(name, M=M, F=F, D=D)
               for name, M, F, D in [("SISD", 1, 1, 1), ("SIMD D=8", 1, 1, 8),
                                     ("Sym MIMD D=8", 3, 3, 8),
                                     ("Het MIMD D=8", 3, 1, 8)]}
    wl = composite_workload(next(iter(schemes.values())), reps)
    print(f"  ({wl}: conv32 on hart 0, fft256 on hart 1, matmul64 on "
          f"hart 2)")
    res = CycleSimBackend(schemes=schemes).run_workload(wl,
                                                        functional=False)
    for name, sim in res.timing.items():
        per_kernel = [sim.per_hart[h].finish_cycle / reps[k]
                      for h, k in enumerate(COMPOSITE_KERNELS)]
        print(f"{name:18s} " + " ".join(f"{c:9.0f}" for c in per_kernel))


def cross_backend(device=None) -> bool:
    print("\n=== composite workload: one object, three backends ===")
    # 64 KiB SPMs keep matmul64 on the SPM-resident path
    cfg = KlessydraConfig("x", M=3, F=1, D=8, spm_kbytes=64)
    wl = composite_workload(cfg, reps={"conv32": 1, "fft256": 1,
                                       "matmul64": 1})
    results = {"oracle": get_backend("oracle").run_workload(wl),
               "cyclesim": get_backend("cyclesim").run_workload(wl),
               "torch": get_backend("torch", device=device).run_workload(wl)}
    ok = all(
        np.array_equal(results["oracle"].entry_results[i].outputs[k],
                       res.entry_results[i].outputs[k])
        for res in results.values()
        for i in range(len(wl.entries))
        for k in results["oracle"].entry_results[i].outputs)
    print(f"  oracle == cyclesim == torch across "
          f"{len(wl.entries)} heterogeneous entries: {ok}")
    c = results["cyclesim"].cycles
    print(f"  cyclesim workload cycles: {c}")
    return ok


def het_mimd_launch(device=None) -> dict:
    print("\n=== composite workload: one het-MIMD launch ===")
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    F = 3

    def t(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).to(dev)

    img = t(34, 34)                     # pre-padded
    filt = t(F, F)
    fre, fim = t(4, 256), t(4, 256)
    A, B = t(64, 64), t(64, 64)
    conv, ore, oim, mm = ops.het_mimd_composite(img, filt, fre, fim, A, B)
    wre, _ = ref.fft_ref(fre.cpu(), fim.cpu())
    errs = {"fft": float((ore.cpu() - wre).abs().max()),
            "matmul": float((mm.cpu() - A.cpu().double().matmul(
                B.cpu().double()).float()).abs().max())}
    print("  conv tile[0,:3]   =", conv[0, :3].cpu().numpy())
    print("  fft err (vs ref)  =", errs["fft"])
    print("  matmul err        =", errs["matmul"])
    print("  -> three heterogeneous kernels, ONE launch, dedicated "
          "shared-memory blocks (the het-MIMD scheme)")
    return errs


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = ap.parse_args().device
    simulate()
    cross_backend(dev)
    het_mimd_launch(dev)
