"""OracleBackend — pure-numpy functional execution (repro_torch.core.mfu);
the port's copy of ``repro.kvi.oracle``.

The reference semantics: int32 two's-complement fixed point, 64-bit
intermediate products wrapped to the element width, exactly the paper's
MFU datapath. No timing and no device: it runs the same on any machine.
Used as the ground truth the ``torch`` backend's outputs are held
against, on the CPU and on the card.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import KlessydraConfig
from repro_torch.kvi.backend import (BackendBase, BackendResult,
                                     register_backend)
from repro_torch.kvi.lowering import lower
from repro_torch.kvi.workload import (KviWorkload, WorkloadResult,
                                      dedup_entry_outputs)

# Functionally the SPM is just an address space: give the oracle a big one
# so any program the other backends accept lowers here too.
_ORACLE_CFG = KlessydraConfig("oracle", M=1, F=1, D=4, spm_kbytes=256)


@register_backend("oracle")
class OracleBackend(BackendBase):
    """Functional reference executor (no timing model). Workloads execute
    entry-by-entry — hart assignments do not change functional values.

    ``passes=()`` runs the raw, unoptimized program — the ground truth
    the differential fuzz tests compare every optimized run against."""

    def __init__(self, config: Optional[KlessydraConfig] = None,
                 passes=None, verify: bool = False):
        self.config = config or _ORACLE_CFG
        self.passes = passes
        self.verify = verify

    def run_workload(self, workload: KviWorkload,
                     verify: Optional[bool] = None) -> WorkloadResult:
        workload = self.optimize_workload(workload, verify=verify)
        outs = dedup_entry_outputs(
            workload.entries,
            lambda p: lower(p, self.config).execute())
        return WorkloadResult(
            self.name, workload,
            tuple(BackendResult(self.name, out) for out in outs))
