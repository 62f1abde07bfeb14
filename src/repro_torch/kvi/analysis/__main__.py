"""CLI: ``python -m repro_torch.kvi.analysis [TARGET...] [options]``

Lints registered KVI programs/workloads (see
:mod:`repro_torch.kvi.analysis.registry`) through the static verifier and
hazard analyzer — no backend ever executes.

    python -m repro_torch.kvi.analysis --all --fail-on error     # the CI gate
    python -m repro_torch.kvi.analysis conv32 fft256 --format json
    python -m repro_torch.kvi.analysis --list

Exit status: 0 when no target reaches the ``--fail-on`` severity,
1 otherwise, 2 on usage errors. ``--optimize`` lints the program as
the default pass pipeline would actually execute it (fusion plan
attached); ``--D`` / ``--spm-kbytes`` select the machine configuration
for the static SPM-pressure check.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.kvi.analysis.diagnostics import (DiagnosticReport, Severity,
                                            merge_reports)
from repro_torch.kvi.analysis.hazards import analyze_program, analyze_workload
from repro_torch.kvi.analysis.registry import build_target, registered_targets
from repro_torch.kvi.ir import KviProgram


def lint_target(name: str, optimize: bool = False,
                config=None) -> DiagnosticReport:
    """Build one registered target and analyze it."""
    target = build_target(name)
    if isinstance(target, KviProgram):
        if optimize:
            from repro_torch.kvi.passes import optimize_program
            target = optimize_program(target)
        return analyze_program(target, config=config)
    if optimize:
        from repro_torch.kvi.passes import PassPipeline
        target = target.map_programs(PassPipeline.from_spec(None).run)
    return analyze_workload(target, config=config)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.kvi.analysis")
    ap.add_argument("targets", nargs="*",
                    help="registered program/workload names to lint")
    ap.add_argument("--all", action="store_true",
                    help="lint every registered target")
    ap.add_argument("--list", action="store_true",
                    help="list registered targets and exit")
    ap.add_argument("--optimize", action="store_true",
                    help="lint the optimized program (default pass "
                         "pipeline, fusion plan audited)")
    ap.add_argument("--format", default="text", choices=("text", "json"),
                    help="diagnostic output format")
    ap.add_argument("--fail-on", default="error",
                    choices=("error", "warning", "never"),
                    help="lowest severity that fails the lint (exit 1)")
    ap.add_argument("--D", type=int, default=4,
                    help="lane count of the SPM-pressure config")
    ap.add_argument("--spm-kbytes", type=int, default=64,
                    help="per-bank SPM KiB of the SPM-pressure config")
    args = ap.parse_args(argv)

    names = sorted(registered_targets())
    if args.list:
        for n in names:
            print(n)
        return 0
    if args.all:
        targets = names
    elif args.targets:
        unknown = [t for t in args.targets if t not in names]
        if unknown:
            ap.error(f"unknown target(s) {unknown}; see --list")
        targets = args.targets
    else:
        ap.error("name at least one target, or pass --all / --list")

    from repro_torch.kvi.dse.space import scheme_config
    config = scheme_config("shared", D=args.D,
                           spm_kbytes=args.spm_kbytes, name="lint")

    reports = {}
    for name in targets:
        reports[name] = lint_target(name, optimize=args.optimize,
                                    config=config)
    merged = merge_reports(reports.values())

    if args.format == "json":
        print(json.dumps(
            {"targets": {n: r.as_dicts() for n, r in reports.items()},
             "n_errors": len(merged.errors),
             "n_warnings": len(merged.warnings)},
            indent=2, sort_keys=True))
    else:
        for name, rep in reports.items():
            status = ("clean" if rep.clean else
                      f"{len(rep.errors)} error(s), "
                      f"{len(rep.warnings)} warning(s)")
            print(f"{name:20s} {status}")
            for d in rep:
                print(f"  {d.render()}")
        print(f"# linted {len(targets)} target(s): "
              f"{len(merged.errors)} error(s), "
              f"{len(merged.warnings)} warning(s)")

    if args.fail_on == "never":
        return 0
    gate = Severity.ERROR if args.fail_on == "error" else Severity.WARNING
    return 1 if merged.at_least(gate) else 0


if __name__ == "__main__":
    sys.exit(main())
