"""The execution-backend protocol for KVI programs (the port's copy of
``repro.kvi.backend``).

The unit of execution is a :class:`~repro_torch.kvi.workload.KviWorkload`
— a batch of (program, hart-assignment, data-instance) entries executed
by ``run_workload()``, which returns a
:class:`~repro_torch.kvi.workload.WorkloadResult`. The single-program
``run()`` wraps the program into a one-entry workload.

The port keeps its own registry: ``get_backend("torch")`` builds the
:class:`~repro_torch.kvi.torch_backend.TorchBackend`,
``get_backend("oracle")`` the numpy MFU datapath
(:class:`~repro_torch.kvi.oracle.OracleBackend`), and
``get_backend("cyclesim")`` the cycle-accurate scheme model
(:class:`~repro_torch.kvi.cyclesim.CycleSimBackend`). Nothing here is
shared with, or registered in, the reference package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (TYPE_CHECKING, Callable, Dict, Optional, Protocol,
                    runtime_checkable)

import numpy as np

from repro_torch.kvi.ir import KviProgram

if TYPE_CHECKING:                      # pragma: no cover - typing only
    from repro_torch.kvi.workload import KviWorkload, WorkloadResult


@dataclass
class BackendResult:
    """What one backend run produced.

    outputs — every ``mem_out`` buffer of the program, by name, reshaped
              to its declared shape.
    timing  — scheme name -> cycle result (timing backends only: the
              ``cyclesim`` backend).
    backend — the producing backend's registered name.
    """

    backend: str
    outputs: Dict[str, np.ndarray]
    timing: Optional[Dict[str, "object"]] = None

    @property
    def cycles(self) -> Optional[Dict[str, int]]:
        if self.timing is None:
            return None
        return {k: v.cycles for k, v in self.timing.items()}


@runtime_checkable
class Backend(Protocol):
    """Anything that can execute KVI work. ``run_workload`` is the
    primary protocol method; ``run`` is the single-program convenience."""

    name: str

    def run(self, program: KviProgram) -> BackendResult:
        ...

    def run_workload(self, workload: "KviWorkload") -> "WorkloadResult":
        ...


class BackendBase:
    """Shared backend behavior: ``run()`` is a thin wrapper over
    ``run_workload()`` on a one-entry workload, and
    ``optimize_workload()`` applies the optimizing pass pipeline
    (``repro_torch.kvi.passes``) that ``run_workload()`` calls first.

    ``self.passes`` selects the pipeline: ``None`` (the default) runs
    the full ``copy_prop -> dce -> fuse_regions`` pipeline, ``()``
    disables optimization entirely, and a sequence of pass names or
    callables runs a custom pipeline.

    ``verify`` gates the static analyzer (:mod:`repro_torch.kvi.analysis`)
    in front of execution: the workload is verified (structural checks,
    fusion audit, cross-hart race check) and rejected with a
    :class:`~repro_torch.kvi.analysis.KviVerificationError` on any
    error-severity diagnostic, and the pass pipeline re-verifies after
    every pass (:class:`~repro_torch.kvi.passes.PassVerificationError`
    names the offending pass). Every built-in backend ctor takes
    ``verify=``, and ``run_workload(verify=...)`` overrides it per call.
    """

    passes = None                    # None => default pipeline; () => off
    verify = False                   # True => static-verify before running

    def run(self, program: KviProgram) -> BackendResult:
        from repro_torch.kvi.workload import KviWorkload
        return self.run_workload(KviWorkload.single(program)).entry_result(0)

    def optimize_workload(self, workload: "KviWorkload",
                          verify: Optional[bool] = None) -> "KviWorkload":
        """The optimized workload this backend actually executes. Each
        distinct program object is optimized once; pipelines that change
        nothing hand back the identical workload object.

        ``verify=None`` defers to ``self.verify``; ``True`` statically
        verifies the workload first (raising
        :class:`~repro_torch.kvi.analysis.KviVerificationError` on errors)
        and runs the pipeline in its self-checking mode."""
        check = self.verify if verify is None else verify
        if check:
            from repro_torch.kvi.analysis import (DiagnosticReport,
                                                  KviVerificationError,
                                                  analyze_workload)
            rep = analyze_workload(workload)
            if not rep.ok:
                raise KviVerificationError(
                    DiagnosticReport(rep.errors),
                    context=f"backend {self.name!r} rejected workload "
                            f"{workload.name!r}")
        from repro_torch.kvi.passes import PassPipeline
        pipe = PassPipeline.from_spec(getattr(self, "passes", None),
                                      verify=check)
        if not pipe:
            return workload
        return workload.map_programs(pipe.run)


_REGISTRY: Dict[str, Callable[..., Backend]] = {}


def register_backend(name: str):
    """Class decorator registering a backend factory under ``name``."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_backend(name: str, **kwargs) -> Backend:
    """Instantiate a registered backend (kwargs forwarded to the ctor)."""
    _ensure_builtin_backends()
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; available: "
                       f"{sorted(_REGISTRY)}") from None
    return factory(**kwargs)


def available_backends() -> Dict[str, Callable[..., Backend]]:
    _ensure_builtin_backends()
    return dict(_REGISTRY)


def _ensure_builtin_backends():
    """Import the built-in backend modules so their ``@register_backend``
    decorators run. An import error propagates: a backend that fails to
    import is a fault, not an absent option."""
    from repro_torch.kvi import cyclesim, oracle, torch_backend  # noqa: F401
