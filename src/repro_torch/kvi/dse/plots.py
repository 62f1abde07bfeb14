"""SVG figures rendered next to ``dse_report.md``.

Two figures per kernel, both drawn with the stdlib-only chart writer
(:mod:`repro_torch.kvi.obs.svg` — no matplotlib dependency, byte-stable
output):

  * ``dse_speedup_<kernel>.svg`` — the paper's speedup-vs-D curves,
    one line per (scheme, precision) series, log-scaled lane axis;
  * ``dse_pareto_<kernel>.svg``  — the (area, cycles) plane, one
    scatter series per scheme with the report's Pareto front overlaid
    as a staircase line.

:func:`write_plots` returns ``{kernel: [filenames]}`` so the markdown
renderer can link every figure from the matching section.

The port's copy of ``repro.kvi.dse.plots``.
"""
from __future__ import annotations

import os
from typing import Dict, List

from repro_torch.kvi.obs.svg import line_chart, scatter_chart


def write_search_plots(result, out_dir: str) -> List[str]:
    """``dse_search_trajectory.svg`` — the auto-tuner's best-so-far
    workload-mix cycles against cycle-accurate evaluations spent, the
    anytime curve that shows what each additional simulation bought.
    Returns the written filenames (empty when the trajectory never
    produced a feasible best)."""
    points = [(t["high_evals"], float(t["best_mix_cycles"]))
              for t in result.trajectory
              if t.get("best_mix_cycles") is not None]
    if not points:
        return []
    svg = line_chart(
        f"{result.strategy} (seed {result.seed}): best-so-far",
        "cycle-accurate evaluations",
        "best workload-mix cycles",
        {result.strategy: points})
    fname = "dse_search_trajectory.svg"
    with open(os.path.join(out_dir, fname), "w") as f:
        f.write(svg + "\n")
    return [fname]


def _kernel_measure(rec, kern: str):
    if kern == "composite":
        return rec.composite
    return rec.kernels.get(kern)


def write_plots(result, report: Dict[str, object],
                out_dir: str) -> Dict[str, List[str]]:
    """Write every figure for ``report`` into ``out_dir``; returns the
    per-kernel filename lists (relative to ``out_dir``, ready to embed
    as markdown image links)."""
    ok = result.ok_records
    plots: Dict[str, List[str]] = {}
    for kern, data in report["kernels"].items():
        files: List[str] = []

        curves = data.get("speedup_vs_lanes") or {}
        if curves:
            series = {
                label: [(int(d[1:]), s) for d, s in by_d.items()]
                for label, by_d in sorted(curves.items())}
            svg = line_chart(f"{kern}: speedup vs lane count D",
                             "D (vector lanes, log)",
                             "speedup vs smallest swept D",
                             series, log_x=True)
            fname = f"dse_speedup_{kern}.svg"
            with open(os.path.join(out_dir, fname), "w") as f:
                f.write(svg + "\n")
            files.append(fname)

        by_scheme: Dict[str, List[tuple]] = {}
        for r in ok:
            k = _kernel_measure(r, kern)
            if k is None:
                continue
            by_scheme.setdefault(r.point.scheme, []).append(
                (r.area.area_luteq, int(k["cycles"])))
        front = [(row["area_luteq"], row["cycles"])
                 for row in data.get("front") or []]
        if by_scheme:
            svg = scatter_chart(f"{kern}: cycles vs area",
                                "area (LUT-equivalents)",
                                "cycles",
                                {s: by_scheme[s]
                                 for s in sorted(by_scheme)},
                                front=front or None)
            fname = f"dse_pareto_{kern}.svg"
            with open(os.path.join(out_dir, fname), "w") as f:
                f.write(svg + "\n")
            files.append(fname)

        if files:
            plots[kern] = files
    return plots
