"""The optimizing pass pipeline: runs a sequence of passes.

A *pass* is a pure function ``KviProgram -> KviProgram`` that preserves
functional semantics bit-for-bit. This is the port's copy of
``repro.kvi.passes.pipeline``; ``tests/test_torch_interop.py`` holds it
to the same fusion plans as the reference. A :class:`PassPipeline` applies
a sequence of passes; ``Backend.run_workload`` runs the default pipeline
on every entry before execution, with ``passes=()`` as the escape hatch
and ``passes=("dce",)``-style specs for custom selections.

Default order::

    copy_prop -> dce -> fuse_regions

``copy_prop`` first (it strands the moves it bypasses), ``dce`` second
(it sweeps them plus anything never observed), ``fuse_regions`` last (it
plans on the final instruction stream and only attaches metadata).

Passes that change nothing return the *same object*, so an unoptimizable
program flows through the pipeline untouched — important for callers
that key caches on program identity.

With ``verify=True`` the pipeline becomes its own sanitizer: the static
analyzer (:mod:`repro_torch.kvi.analysis`) runs on the input program and
again after **every** pass, and the first pass whose output carries a
diagnostic the previous stage did not raises
:class:`PassVerificationError` naming that pass — a miscompiling pass
is caught at the pass boundary instead of as a backend divergence.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple, Union

from repro_torch.kvi.ir import KviProgram
from repro_torch.kvi.passes.copy_prop import copy_prop
from repro_torch.kvi.passes.dce import dce
from repro_torch.kvi.passes.fusion import fuse_regions

Pass = Callable[[KviProgram], KviProgram]
PassSpec = Union[str, Pass]

#: name -> pass, the vocabulary accepted in ``passes=(...)`` specs
REGISTERED_PASSES: Dict[str, Pass] = {
    "copy_prop": copy_prop,
    "dce": dce,
    "fuse_regions": fuse_regions,
}

DEFAULT_PASSES: Tuple[str, ...] = ("copy_prop", "dce", "fuse_regions")


def _resolve(spec: PassSpec) -> Pass:
    if callable(spec):
        return spec
    try:
        return REGISTERED_PASSES[spec]
    except KeyError:
        raise KeyError(f"unknown pass {spec!r}; available: "
                       f"{sorted(REGISTERED_PASSES)}") from None


class PassVerificationError(RuntimeError):
    """A pass (or the pipeline's input) failed static verification.

    ``pass_name`` is the pass whose output first showed the new
    diagnostics (``"<input>"`` when the program was broken before any
    pass ran); ``report`` carries the offending diagnostics."""

    def __init__(self, pass_name: str, report, program_name: str):
        self.pass_name = pass_name
        self.report = report
        self.program_name = program_name
        where = ("input program" if pass_name == "<input>"
                 else f"pass {pass_name!r}")
        super().__init__(
            f"pipeline verification of {program_name!r}: {where} "
            f"introduced {len(report)} new diagnostic"
            f"{'s' if len(report) != 1 else ''}:\n"
            + report.render_text())


@dataclass(frozen=True)
class PassPipeline:
    """An ordered sequence of semantics-preserving program passes.

    ``verify=True`` runs the static analyzer between every pass and
    attributes the first new error to the pass that introduced it."""

    passes: Tuple[Pass, ...]
    verify: bool = False

    @classmethod
    def from_spec(cls, spec, verify: bool = False) -> "PassPipeline":
        """Build a pipeline from ``None`` (the default pipeline), an
        existing pipeline, or a sequence of pass names / callables
        (``()`` disables optimization entirely)."""
        if isinstance(spec, PassPipeline):
            if verify and not spec.verify:
                return dataclasses.replace(spec, verify=True)
            return spec
        if spec is None:
            spec = DEFAULT_PASSES
        elif isinstance(spec, (str, bytes)) or callable(spec):
            spec = (spec,)
        return cls(tuple(_resolve(s) for s in spec), verify=verify)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(getattr(p, "__name__", repr(p)) for p in self.passes)

    def run(self, program: KviProgram) -> KviProgram:
        if not self.verify:
            for p in self.passes:
                program = p(program)
            return program
        return self._run_verified(program)

    def _run_verified(self, program: KviProgram) -> KviProgram:
        """Analyze input + every intermediate; raise on the pass whose
        output first carries an error-severity diagnostic not already
        present before it ran. Diagnostic identity is the pass-stable
        ``Diagnostic.key`` (code + subject name), not item indices —
        indices shift as passes delete instructions."""
        from repro_torch.kvi.analysis import DiagnosticReport, analyze_program
        rep = analyze_program(program)
        if not rep.ok:
            raise PassVerificationError(
                "<input>", DiagnosticReport(rep.errors), program.name)
        baseline = rep.keys()
        for p, name in zip(self.passes, self.names):
            program = p(program)
            rep = analyze_program(program)
            new = [d for d in rep.errors if d.key not in baseline]
            if new:
                raise PassVerificationError(
                    name, DiagnosticReport(new), program.name)
            baseline |= rep.keys()
        return program

    def __bool__(self) -> bool:
        return bool(self.passes)


def default_pipeline() -> PassPipeline:
    return PassPipeline.from_spec(None)


def optimize_program(program: KviProgram, passes=None) -> KviProgram:
    """One-shot convenience: run ``program`` through a pipeline spec."""
    return PassPipeline.from_spec(passes).run(program)
