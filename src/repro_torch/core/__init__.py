"""repro_torch.core — the port's copy of the paper's executable model
(``repro.core``):

  isa/spm/mfu — the Table-1 scratchpad-resident vector ISA (functional;
                ``mfu`` is the MFU datapath the ``oracle`` backend runs)
  simulator   — the event-driven IMT + coprocessor cycle model
  programs    — the deprecated ``Program`` / ``ProgramBuilder`` /
                ``build_*`` layer over ``repro_torch.kvi.programs``, and
                ``_run_items``, the trace replay the lowering's
                ``execute`` drives
  workloads   — homogeneous/composite measurement protocol + energy model
  baselines   — T03 / RI5CY / ZeroRiscy comparison cores (calibrated)
"""
from repro_torch.configs.base import KlessydraConfig, klessydra_taxonomy
from repro_torch.core import (baselines, mfu, programs, simulator, spm,
                              workloads)
from repro_torch.core.isa import OPDEFS, Instr, Scalar, Unit
from repro_torch.core.simulator import SimResult, simulate

__all__ = ["KlessydraConfig", "klessydra_taxonomy", "baselines", "mfu",
           "programs", "simulator", "spm", "workloads", "OPDEFS", "Instr",
           "Scalar", "Unit", "SimResult", "simulate"]
