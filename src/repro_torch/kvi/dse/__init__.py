"""repro_torch.kvi.dse — design-space exploration over coprocessor
configs (the port's copy of ``repro.kvi.dse``).

The paper's analysis, reproducible end to end:

  1. :mod:`~repro_torch.kvi.dse.space` — declare the grid (scheme x M x
     F x D x sub-word precision x SPM capacity x pass toggles) as a
     :class:`DesignSpace`; enumeration is deterministic and validated.
  2. :mod:`~repro_torch.kvi.dse.cost` — analytic LUT/FF/DSP/BRAM area
     and energy-per-cycle for any :class:`KlessydraConfig` (one
     documented calibration table).
  3. :mod:`~repro_torch.kvi.dse.sweep` — fan design points out through
     ``CycleSimBackend.run_workload`` (homogeneous + composite
     protocols), recording cycles, per-hart utilization, area, energy;
     optionally the device walltime stage (``measure_device``): each
     measurement class's workloads through ``TorchBackend`` — one
     ``kvi_walk`` launch per structural group on the card.
  4. :mod:`~repro_torch.kvi.dse.pareto` /
     :mod:`~repro_torch.kvi.dse.report` — non-dominated front over
     (cycles, area, energy), speedup-vs-D curves, and the paper's
     scheme-ordering story as checks.

Enumeration has a budget-constrained inverse:
:mod:`~repro_torch.kvi.dse.search` *searches* the same space — analytic
ranking (:func:`~repro_torch.kvi.dse.cost.estimate_kernel`) screens
sampled candidates, and only survivors spend cycle-accurate
simulations.

CLI::

    PYTHONPATH=src python -m repro_torch.kvi.dse --smoke   # CI-sized sweep
    PYTHONPATH=src python -m repro_torch.kvi.dse           # paper-scale sweep
    PYTHONPATH=src python -m repro_torch.kvi.dse --smoke --measure-device
    PYTHONPATH=src python -m repro_torch.kvi.dse search --smoke  # auto-tuner
"""
from repro_torch.kvi.dse.cost import (CALIBRATION,
                                      CALIBRATION_FIT_MAX_REL_ERR,
                                      HardwareCost, KernelProfile,
                                      calibration_fit, energy_model,
                                      estimate_kernel, hardware_cost,
                                      kernel_profile)
from repro_torch.kvi.dse.executors import (AUTO_SERIAL_MAX, EXECUTORS,
                                           PointJob, ProcessExecutor,
                                           SerialExecutor, SweepExecutor,
                                           ThreadExecutor, make_executor,
                                           resolve_auto)
from repro_torch.kvi.dse.pareto import (dominates, front_metrics,
                                        pareto_front)
from repro_torch.kvi.dse.pointcache import (PointCache, default_cache_dir,
                                            device_class_key, point_key,
                                            program_fingerprint)
from repro_torch.kvi.dse.report import (build_report, full_space,
                                        render_markdown, run_dse,
                                        smoke_space)
from repro_torch.kvi.dse.space import (SCHEMES, DesignPoint, DesignSpace,
                                       SpaceConstraints, preflight_point,
                                       scheme_config)
from repro_torch.kvi.dse.search import (STRATEGIES, CandidateSampler,
                                        SearchBudget, SearchResult,
                                        TwoFidelityEvaluator,
                                        front_recovery, run_search)
from repro_torch.kvi.dse.sweep import (PointRecord, SweepResult,
                                       measure_device_points,
                                       paper_kernel_factory, run_point,
                                       sweep)

__all__ = [
    "STRATEGIES", "CandidateSampler", "SearchBudget", "SearchResult",
    "TwoFidelityEvaluator", "front_recovery", "run_search",
    "CALIBRATION", "CALIBRATION_FIT_MAX_REL_ERR", "HardwareCost",
    "KernelProfile", "calibration_fit", "energy_model",
    "estimate_kernel", "hardware_cost", "kernel_profile",
    "AUTO_SERIAL_MAX", "EXECUTORS", "PointJob", "ProcessExecutor",
    "SerialExecutor", "SweepExecutor", "ThreadExecutor", "make_executor",
    "resolve_auto", "PointCache", "default_cache_dir", "device_class_key",
    "point_key", "program_fingerprint",
    "dominates", "front_metrics", "pareto_front", "build_report",
    "full_space", "render_markdown", "run_dse", "smoke_space", "SCHEMES",
    "DesignPoint", "DesignSpace", "SpaceConstraints", "preflight_point",
    "scheme_config",
    "PointRecord", "SweepResult", "measure_device_points",
    "paper_kernel_factory", "run_point", "sweep",
]
