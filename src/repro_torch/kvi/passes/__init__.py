"""repro_torch.kvi.passes — the optimizing pass pipeline over KviProgram.

Runs on the backend-neutral IR *before* any backend sees the program, so
every executor benefits identically:

  * :func:`~repro_torch.kvi.passes.copy_prop.copy_prop` — bypass whole-register
    ``kvcp`` moves (they break fusion regions and cost SPM copies),
  * :func:`~repro_torch.kvi.passes.dce.dce` — drop never-observed instructions
    and stranded vregs (liveness-driven),
  * :func:`~repro_torch.kvi.passes.fusion.fuse_regions` — plan maximal
    element-wise chains ONCE as :class:`~repro_torch.kvi.passes.fusion.
    FusedRegion` metadata (the torch backend launches each as one
    fused kernel),

driven by :class:`~repro_torch.kvi.passes.pipeline.PassPipeline`, with
register liveness (:mod:`~repro_torch.kvi.passes.liveness`).

Every pass is semantics-preserving: bit-identical outputs on every
backend, enforced by the differential fuzz tests.
"""
from repro_torch.kvi.passes.copy_prop import copy_prop
from repro_torch.kvi.passes.dce import dce
from repro_torch.kvi.passes.fusion import (FusedRegion, FusionPlan, MAX_FUSED_INPUTS,
                                     MAX_FUSED_OPS, META_KEY, fuse_regions,
                                     plan_fusion_regions)
from repro_torch.kvi.passes.liveness import (observable_items, peak_live_bytes,
                                       reg_intervals, total_vreg_bytes)
from repro_torch.kvi.passes.pipeline import (DEFAULT_PASSES, REGISTERED_PASSES,
                                       PassPipeline, PassVerificationError,
                                       default_pipeline, optimize_program)

__all__ = [
    "copy_prop", "dce", "fuse_regions", "plan_fusion_regions",
    "FusedRegion", "FusionPlan", "MAX_FUSED_OPS", "MAX_FUSED_INPUTS",
    "META_KEY", "observable_items", "peak_live_bytes", "reg_intervals",
    "total_vreg_bytes", "PassPipeline", "PassVerificationError",
    "DEFAULT_PASSES", "REGISTERED_PASSES", "default_pipeline",
    "optimize_program",
]
