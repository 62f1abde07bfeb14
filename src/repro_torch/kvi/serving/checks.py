"""The serving engine's output gate (the port of ``outputs_match_oracle``
in the reference's ``benchmarks/bench_kvi_serve.py``): sampled requests
of every template, run batched through a backend at every bucket size,
equal the MFU oracle bit for bit."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.kvi.backend import get_backend
from repro_torch.kvi.serving.load import KernelTemplate
from repro_torch.kvi.workload import KviWorkload

#: request ids of the sampled instances (the reference bench's)
CHECK_RID = 10_000
#: the batch sizes the gate runs (the serving engine's buckets at
#: max_batch 8)
CHECK_SIZES = (1, 2, 4, 8)


def check_against_oracle(templates: Dict[str, KernelTemplate], seed: int,
                         backend, others: Sequence = (),
                         sizes: Sequence[int] = CHECK_SIZES) -> int:
    """For each template, ``max(sizes)`` instances (``rid`` =
    ``CHECK_RID`` + i); ``backend`` runs the first ``size`` of them as one
    homogeneous batch for each of ``sizes``, and every entry must equal
    ``get_backend("oracle")`` on that instance bit for bit, dtype
    included, and each of ``others`` (backends) run on all the instances
    as one batch. Raises ``AssertionError`` naming the first difference
    or a batch whose result holds another number of entries; returns the
    number of entries compared, ``len(templates) * (len(others) *
    max(sizes) + sum(sizes))``."""
    oracle = get_backend("oracle")
    compared = 0
    for name in sorted(templates):
        tpl = templates[name]
        progs = [tpl.instantiate(seed, CHECK_RID + i)
                 for i in range(max(sizes))]
        want = [oracle.run(p).outputs for p in progs]
        runs = [(f"{o.name} x{len(progs)}", o.run_workload(
            KviWorkload.homogeneous(progs, name=f"check.{name}")))
            for o in others]
        runs += [(f"{backend.name} x{size}", backend.run_workload(
            KviWorkload.homogeneous(progs[:size],
                                    name=f"check.{name}.x{size}")))
            for size in sizes]
        for label, res in runs:
            n = len(res.workload.entries)
            if len(res.entry_results) != n:
                raise AssertionError(f"{name}: {label} returned "
                                     f"{len(res.entry_results)} results "
                                     f"for {n} instances")
            for i, got in enumerate(res.entry_results):
                for k, arr in want[i].items():
                    g = got.outputs[k]
                    if g.dtype != arr.dtype or not np.array_equal(g, arr):
                        raise AssertionError(
                            f"{name}: {label}, instance {i}, output {k} "
                            f"differs from the oracle")
                compared += 1
    return compared
