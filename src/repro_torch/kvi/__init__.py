"""repro_torch.kvi — the PyTorch/CUDA port of ``repro.kvi``.

Author a vector program once with :class:`KviProgramBuilder` (or carry a
reference program across with :func:`program_from_reference`), then run
it on the port's backend::

    from repro_torch.kvi import KviWorkload, get_backend
    res = get_backend("torch").run_workload(workload)   # on the card
    get_backend("torch", device="cpu").run(program)     # plain torch

``torch`` runs a structure's whole walk — every copy, planned fused
element-wise region and reduction — as one launch of the hand-written
CUDA walk kernel (:mod:`repro_torch.kernels.kvi_walk`) over all N
instances at once; with ``device="cpu"`` the walk's plain PyTorch version
runs instead. ``oracle`` is the paper's MFU datapath in numpy
(:mod:`repro_torch.core.mfu`), reached through :func:`lower`, the
binding of a program's vregs to scratchpad addresses (an impossible fit
raises :class:`SpmOverflowError`). ``cyclesim``
(:class:`~repro_torch.kvi.cyclesim.CycleSimBackend`) adds the cycle
counts of the paper's three coprocessor schemes. Request-driven serving is
:mod:`repro_torch.kvi.serving` (``python -m repro_torch.kvi.serving``);
telemetry (``obs=``, a Chrome trace and a metrics snapshot) is
:mod:`repro_torch.kvi.obs` (``python -m repro_torch.kvi.obs``).
"""
from repro_torch.kvi.backend import (Backend, BackendBase, BackendResult,
                                     available_backends, get_backend,
                                     register_backend)
from repro_torch.kvi.interop import (array_from_reference,
                                     program_from_reference)
from repro_torch.kvi.ir import (ELEMWISE_OPS, MEM_OPS, REDUCTION_OPS,
                                KviInstr, KviOp, KviProgram,
                                KviProgramBuilder, MemRef, Ref, ScalarBlock,
                                VReg, View)
from repro_torch.kvi.lowering import LoweredTrace, SpmOverflowError, lower
from repro_torch.kvi.passes import (DEFAULT_PASSES, FusedRegion, FusionPlan,
                                    PassPipeline, default_pipeline,
                                    optimize_program, plan_fusion_regions)
from repro_torch.kvi.workload import (HartAssignment, KviWorkload,
                                      WorkloadEntry, WorkloadResult,
                                      structural_signature)

__all__ = [
    "Backend", "BackendBase", "BackendResult", "available_backends",
    "get_backend", "register_backend", "program_from_reference",
    "array_from_reference",
    "KviInstr", "KviOp", "KviProgram", "KviProgramBuilder", "MemRef", "Ref",
    "ScalarBlock", "VReg", "View", "ELEMWISE_OPS", "MEM_OPS",
    "REDUCTION_OPS", "LoweredTrace", "lower", "SpmOverflowError",
    "PassPipeline", "DEFAULT_PASSES", "default_pipeline",
    "optimize_program", "plan_fusion_regions", "FusedRegion", "FusionPlan",
    "HartAssignment", "KviWorkload", "WorkloadEntry", "WorkloadResult",
    "structural_signature",
]
