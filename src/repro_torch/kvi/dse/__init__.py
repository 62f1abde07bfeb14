"""repro_torch.kvi.dse — the port's design-space exploration over
coprocessor configs, so far its first two stages (copies of the
reference's ``repro.kvi.dse.space`` and ``repro.kvi.dse.cost``):

  1. :mod:`~repro_torch.kvi.dse.space` — declare the grid (scheme x M x
     F x D x sub-word precision x SPM capacity x pass toggles) as a
     :class:`DesignSpace`; enumeration is deterministic and validated.
     :func:`scheme_config` builds the paper's three schemes, which the
     cycle-sim backend and the analyzer CLI use.
  2. :mod:`~repro_torch.kvi.dse.cost` — analytic LUT/FF/DSP/BRAM area
     and energy-per-cycle for any :class:`KlessydraConfig` (one
     documented calibration table).

The rest of the reference's DSE — the sweep, its point cache and
executors, the Pareto analysis, the report and plots, the search and
the ``python -m`` CLI — is not ported yet (ROADMAP.md queue 1 item 3).
"""
from repro_torch.kvi.dse.cost import (CALIBRATION,
                                      CALIBRATION_FIT_MAX_REL_ERR,
                                      HardwareCost, KernelProfile,
                                      calibration_fit, energy_model,
                                      estimate_kernel, hardware_cost,
                                      kernel_profile)
from repro_torch.kvi.dse.space import (SCHEMES, DesignPoint, DesignSpace,
                                       SpaceConstraints, preflight_point,
                                       scheme_config)

__all__ = [
    "CALIBRATION", "CALIBRATION_FIT_MAX_REL_ERR", "HardwareCost",
    "KernelProfile", "calibration_fit", "energy_model",
    "estimate_kernel", "hardware_cost", "kernel_profile", "SCHEMES",
    "DesignPoint", "DesignSpace", "SpaceConstraints", "preflight_point",
    "scheme_config",
]
