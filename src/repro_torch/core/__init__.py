"""repro_torch.core — the port's copy of the paper's executable model
(``repro.core``), as far as the KVI lowering and the serving engine need
it:

  isa/spm/mfu — the Table-1 scratchpad-resident vector ISA (functional;
                ``mfu`` is the MFU datapath the ``oracle`` backend runs)
  simulator   — the event-driven IMT + coprocessor cycle model
  programs    — ``_run_items``, the trace replay the lowering's
                ``execute`` drives

The rest of the reference's ``programs`` (the legacy ``Program``, the
deprecated ``ProgramBuilder`` and ``build_*`` helpers), ``baselines`` and
``workloads`` are not copied.
"""
from repro_torch.configs.base import KlessydraConfig, klessydra_taxonomy
from repro_torch.core import mfu, programs, simulator, spm
from repro_torch.core.isa import OPDEFS, Instr, Scalar, Unit
from repro_torch.core.simulator import SimResult, simulate

__all__ = ["KlessydraConfig", "klessydra_taxonomy", "mfu", "programs",
           "simulator", "spm", "OPDEFS", "Instr", "Scalar", "Unit",
           "SimResult", "simulate"]
