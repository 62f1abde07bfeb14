"""repro_torch.kvi — the PyTorch/CUDA port of ``repro.kvi``.

Author a vector program once with :class:`KviProgramBuilder` (or carry a
reference program across with :func:`program_from_reference`), then run
it on the port's backend::

    from repro_torch.kvi import KviWorkload, get_backend
    res = get_backend("torch").run_workload(workload)   # on the card
    get_backend("torch", device="cpu").run(program)     # plain torch

``torch`` runs every planned fused element-wise region as one launch of
the hand-written CUDA interpreter kernel
(:mod:`repro_torch.kernels.fused_vops`) and every reduction as one launch
of the batched reduction kernel (:mod:`repro_torch.kernels.kdotp`), over
all N instances of a structure at once. On CPU tensors the same wrappers
run their plain PyTorch versions.
"""
from repro_torch.kvi.backend import (Backend, BackendBase, BackendResult,
                                     available_backends, get_backend,
                                     register_backend)
from repro_torch.kvi.interop import program_from_reference
from repro_torch.kvi.ir import (ELEMWISE_OPS, MEM_OPS, REDUCTION_OPS,
                                KviInstr, KviOp, KviProgram,
                                KviProgramBuilder, MemRef, Ref, ScalarBlock,
                                VReg, View)
from repro_torch.kvi.passes import (DEFAULT_PASSES, FusedRegion, FusionPlan,
                                    PassPipeline, default_pipeline,
                                    optimize_program, plan_fusion_regions)
from repro_torch.kvi.workload import (HartAssignment, KviWorkload,
                                      WorkloadEntry, WorkloadResult,
                                      structural_signature)

__all__ = [
    "Backend", "BackendBase", "BackendResult", "available_backends",
    "get_backend", "register_backend", "program_from_reference",
    "KviInstr", "KviOp", "KviProgram", "KviProgramBuilder", "MemRef", "Ref",
    "ScalarBlock", "VReg", "View", "ELEMWISE_OPS", "MEM_OPS",
    "REDUCTION_OPS", "PassPipeline", "DEFAULT_PASSES", "default_pipeline",
    "optimize_program", "plan_fusion_regions", "FusedRegion", "FusionPlan",
    "HartAssignment", "KviWorkload", "WorkloadEntry", "WorkloadResult",
    "structural_signature",
]
