"""KVI static analysis: program verifier, hazard analyzer, lint CLI.

The sanitizer layer of the KVI stack — checks programs and workloads
**without executing them** and reports typed
:class:`~repro_torch.kvi.analysis.diagnostics.Diagnostic` records with stable
codes (``KVI1xx`` structural, ``KVI2xx`` hazard, ``KVI3xx`` resource):

    from repro_torch.kvi.analysis import analyze_program
    report = analyze_program(prog, config=cfg)
    if not report.ok:
        print(report.render_text())

Integration points:

  * ``PassPipeline.from_spec(spec, verify=True)`` re-verifies after
    every pass and attributes the first new diagnostic to the pass
    that introduced it,
  * every backend takes ``verify=True`` (ctor or ``run_workload``) to
    reject bad workloads with a :class:`KviVerificationError` instead
    of a backend traceback,
  * the DSE preflight rejects over-pressure points from the static
    :func:`spm_pressure` estimate before touching the allocator,
  * ``python -m repro_torch.kvi.analysis --all`` lints every registered
    program/workload (``--format text|json``, ``--fail-on
    error|warning``).
"""
from repro_torch.kvi.analysis.diagnostics import (CODES, Diagnostic,
                                            DiagnosticReport,
                                            KviVerificationError,
                                            Severity, merge_reports)
from repro_torch.kvi.analysis.hazards import (DepEdge, DependenceGraph,
                                        SpmPressure, analyze_program,
                                        analyze_workload,
                                        audit_fusion_plan,
                                        check_spm_pressure,
                                        check_workload, dependence_graph,
                                        spm_pressure, windows_overlap)
from repro_torch.kvi.analysis.verifier import instr_effects, verify_program

__all__ = [
    "CODES", "Diagnostic", "DiagnosticReport", "KviVerificationError",
    "Severity", "merge_reports",
    "DepEdge", "DependenceGraph", "SpmPressure",
    "analyze_program", "analyze_workload", "audit_fusion_plan",
    "check_spm_pressure", "check_workload", "dependence_graph",
    "spm_pressure", "windows_overlap",
    "instr_effects", "verify_program",
]
