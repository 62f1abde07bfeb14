"""Pareto analysis + report generation over a finished sweep (the port's
copy of ``repro.kvi.dse.report``).

Reproduces the paper's scheme-comparison story as machine-checkable
facts per kernel (conv / matmul / fft) and for the composite workload:

  * the fastest point on the Pareto front is symmetric MIMD,
  * the cheapest point is the shared scheme,
  * heterogeneous MIMD sits on the front strictly between them
    (near-sym cycles at sub-sym area — the paper's headline trade-off),
  * sub-word 8-bit points cut cycles >= 2x vs 32-bit on the MFU-bound
    kernels (conv, matmul) at matched scheme/D,

plus per-kernel speedup-vs-D curves and the non-dominated front over
(cycles, area, energy). Rendered as JSON (``build_report``) and
markdown (``render_markdown``); :func:`run_dse` is the one-call
orchestrator the CLI and the benchmark harness share.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.kvi.dse.pareto import pareto_front
from repro_torch.kvi.dse.space import DesignSpace
from repro_torch.kvi.dse.sweep import (PointRecord, SweepResult,
                                       paper_kernel_factory, sweep)

#: kernels the paper treats as MFU-bound (long vector streams; the FFT's
#: bit-reversal copies make it TLP- rather than DLP-bound)
MFU_BOUND_KERNELS = ("conv", "matmul")

#: how much faster than sym-MIMD a het-MIMD point may be before the
#: "sym fastest" checks call it a violation. The paper's own Table 2
#: has het edging sym on composite cells (conv32 D=2: 15973 vs 16144,
#: ~1%) — "1% to 7%" is het's TYPICAL overhead, but the sign flips at
#: high D where SPMI streaming, not the shared units, binds.
SYM_TIE_TOLERANCE = 1.02


def _measures(rec: PointRecord) -> Dict[str, Dict[str, object]]:
    out = dict(rec.kernels)
    if rec.composite is not None:
        out["composite"] = rec.composite
    return out


def _match_key(rec: PointRecord) -> tuple:
    """Everything but the scheme AND its M/F replication — the shared
    scheme always has M=F=1, so a matched shared/sym/het triple can
    only form when replication is excluded from the key. With several
    replication values on the axis, each (sym, het) pair at one M is
    compared against the same shared point."""
    p = rec.point
    return (p.D, p.precision_bits, p.spm_kbytes, p.chaining, p.passes,
            p.fu_counts)


def _precision_key(rec: PointRecord) -> tuple:
    """Everything but the precision — for the sub-word speedup pairs."""
    p = rec.point
    return (p.scheme, p.M, p.F, p.D, p.spm_kbytes, p.chaining, p.passes,
            p.fu_counts)


def kernel_front(records: List[PointRecord], kernel: str,
                 ) -> List[Dict[str, object]]:
    """Non-dominated records over (cycles, area, energy) for one
    kernel, as compact report rows."""
    front = pareto_front(records, key=lambda r: r.metrics(kernel))
    rows = []
    for r in sorted(front, key=lambda r: r.metrics(kernel)[0]):
        cyc, area, energy = r.metrics(kernel)
        rows.append({"point": r.point.name, "scheme": r.point.scheme,
                     "D": r.point.D,
                     "precision_bits": r.point.precision_bits,
                     "cycles": int(cyc), "area_luteq": round(area, 1),
                     "energy_nj": round(energy, 1)})
    return rows


def speedup_vs_lanes(records: List[PointRecord], kernel: str,
                     ) -> Dict[str, Dict[str, float]]:
    """Per (scheme, precision): cycles normalized to the smallest swept
    D of that series — the paper's speedup-vs-D curves."""
    series: Dict[tuple, Dict[int, int]] = {}
    labels: Dict[tuple, str] = {}
    for r in records:
        p = r.point
        if p.chaining or p.passes is not None:
            continue                  # curves use the default pipeline
        key = (p.scheme, p.precision_bits, p.spm_kbytes, p.fu_counts,
               p.M, p.F)
        series.setdefault(key, {})[p.D] = int(r.metrics(kernel)[0])
        # label omits the D-independent suffix when it is unambiguous
        labels[key] = p.name.replace(f"_D{p.D}", "")
    out: Dict[str, Dict[str, float]] = {}
    for key, by_d in sorted(series.items()):
        if len(by_d) < 2:
            continue
        base_d = min(by_d)
        out[labels[key]] = {
            f"D{d}": round(by_d[base_d] / by_d[d], 3)
            for d in sorted(by_d)}
    return out


def scheme_ordering_checks(records: List[PointRecord], kernel: str,
                           ) -> Dict[str, bool]:
    """The paper's qualitative ordering, checked on the front and on
    every matched (same-everything-but-scheme) group."""
    front = pareto_front(records, key=lambda r: r.metrics(kernel))
    fastest = min(front, key=lambda r: r.metrics(kernel)[0])
    cheapest = min(front, key=lambda r: r.metrics(kernel)[1])
    # "fastest is sym" by cycle VALUE, not point identity: when harts
    # go issue-bound (wide lanes + sub-word + chaining) het ties sym
    # exactly and, being cheaper, dominates it off the front — the
    # paper's own "het within 1-7% of sym" convergence, not a failure
    best_sym = min((r.metrics(kernel)[0] for r in records
                    if r.point.scheme == "sym_mimd"), default=float("inf"))
    best_shared_area = min((r.metrics(kernel)[1] for r in records
                            if r.point.scheme == "shared"),
                           default=float("inf"))
    het_front = [r for r in front if r.point.scheme == "het_mimd"]
    het_between = any(
        r.metrics(kernel)[0] <= cheapest.metrics(kernel)[0]
        and r.metrics(kernel)[1] <= fastest.metrics(kernel)[1]
        for r in het_front)

    # matched groups: same everything-but-scheme/replication; within a
    # group, each MIMD replication level M pairs sym(M)/het(M) against
    # the (unique) shared point
    groups: Dict[tuple, Dict[tuple, PointRecord]] = {}
    for r in records:
        groups.setdefault(_match_key(r), {})[
            (r.point.scheme, r.point.M)] = r
    sym_fastest_matched = True
    shared_cheapest_matched = True
    n_matched = 0
    for g in groups.values():
        shared_rec = g.get(("shared", 1))
        if shared_rec is None:
            continue
        for (scheme, m), sym_rec in g.items():
            if scheme != "sym_mimd":
                continue
            het_rec = g.get(("het_mimd", m))
            if het_rec is None:
                continue
            n_matched += 1
            cyc = [rec.metrics(kernel)[0]
                   for rec in (sym_rec, het_rec, shared_rec)]
            area = [rec.metrics(kernel)[1]
                    for rec in (shared_rec, het_rec, sym_rec)]
            if not (cyc[0] <= cyc[1] * SYM_TIE_TOLERANCE
                    and cyc[1] <= cyc[2]):
                sym_fastest_matched = False
            if not (area[0] < area[1] < area[2]):
                shared_cheapest_matched = False
    # no matched triple at all would make both checks vacuous — treat
    # that as a failure so the gate cannot pass by accident
    if n_matched == 0:
        sym_fastest_matched = shared_cheapest_matched = False
    return {
        "front_fastest_is_sym":
            best_sym <= fastest.metrics(kernel)[0] * SYM_TIE_TOLERANCE,
        "front_cheapest_is_shared":
            best_shared_area <= cheapest.metrics(kernel)[1],
        "het_on_front_between": bool(het_front) and het_between,
        "sym_fastest_matched_groups": sym_fastest_matched,
        "shared_cheapest_matched_groups": shared_cheapest_matched,
        "n_matched_groups": n_matched,
    }


def hart_utilization_by_scheme(records: List[PointRecord], kernel: str,
                               ) -> Dict[str, Dict[str, object]]:
    """Per scheme, the per-hart busy/stall/idle breakdown of that
    scheme's fastest default-pipeline point on ``kernel`` — the record
    that explains *why* het-MIMD tracks sym-MIMD (its harts stall on the
    shared MFU instead of idling). Deterministic representative: lowest
    cycles, then point name."""
    out: Dict[str, Dict[str, object]] = {}
    for scheme in ("shared", "sym_mimd", "het_mimd"):
        cands = [r for r in records
                 if r.point.scheme == scheme and not r.point.chaining
                 and r.point.passes is None and kernel in _measures(r)]
        if not cands:
            continue
        best = min(cands, key=lambda r: (r.metrics(kernel)[0],
                                         r.point.name))
        k = _measures(best)[kernel]
        out[scheme] = {"point": best.point.name,
                       "cycles": int(k["cycles"]),
                       "harts": [dict(h) for h in k["hart_utilization"]]}
    return out


def device_summary(records: List[PointRecord], kernel: str,
                   ) -> List[Dict[str, object]]:
    """The walltime axis, one row per measured (precision, passes)
    class: real device walltime — split into one-time compile and warm
    steady-state when the sweep measured both — plus the kernel-launch
    count next to the best simulated cycle count of the
    class's points — the cycles-vs-walltime trade the co-design argument
    needs measured, not modeled."""
    rows: Dict[tuple, Dict[str, object]] = {}
    for r in records:
        k = _measures(r).get(kernel)
        if not k or "kernel_launches" not in k:
            continue
        key = (r.point.precision_bits, r.point.passes)
        row = rows.get(key)
        if row is None:
            row = rows[key] = {
                "precision_bits": r.point.precision_bits,
                "passes": list(r.point.passes)
                if r.point.passes is not None else None,
                "device_walltime_s": k["device_walltime_s"],
                "kernel_launches": k["kernel_launches"],
                "best_cycles": int(k["cycles"]),
                "n_points": 0}
            for col in ("device_compile_s", "device_steady_s"):
                if col in k:
                    row[col] = k[col]
        row["best_cycles"] = min(row["best_cycles"], int(k["cycles"]))
        row["n_points"] += 1
    return [rows[key] for key in sorted(
        rows, key=lambda t: (t[0], t[1] is not None, t[1] or ()))]


def subword_speedups(records: List[PointRecord], kernel: str,
                     ) -> Dict[str, object]:
    """cycles(32-bit) / cycles(8-bit) for every matched configuration
    pair — the sub-word SIMD payoff."""
    by_cfg: Dict[tuple, Dict[int, PointRecord]] = {}
    for r in records:
        by_cfg.setdefault(_precision_key(r), {})[
            r.point.precision_bits] = r
    pairs = []
    for _cfg_key, by_prec in sorted(by_cfg.items()):
        if 8 in by_prec and 32 in by_prec:
            c32 = by_prec[32].metrics(kernel)[0]
            c8 = by_prec[8].metrics(kernel)[0]
            pairs.append({"point_8bit": by_prec[8].point.name,
                          "D": by_prec[8].point.D,
                          "cycles_32": int(c32), "cycles_8": int(c8),
                          "speedup": round(c32 / max(c8, 1), 3)})
    best = max((p["speedup"] for p in pairs), default=0.0)
    # the narrow-lane pairs are where a kernel is genuinely MFU-bound
    # (at wide D + sub-word, setup latency and scalar issue dominate and
    # the ratio legitimately decays toward 1 — Amdahl, not a bug), so
    # the gate below also requires EVERY smallest-D pair to clear the
    # threshold, not just the single best configuration
    min_d = min((p["D"] for p in pairs), default=0)
    floor = min((p["speedup"] for p in pairs if p["D"] == min_d),
                default=0.0)
    return {"pairs": pairs, "max_speedup": best,
            "min_lanes": min_d, "min_speedup_at_min_lanes": floor}


def build_report(result: SweepResult,
                 subword_min_speedup: float = 2.0) -> Dict[str, object]:
    """The full analysis: per-kernel fronts, curves and checks, plus
    the aggregate pass/fail booleans the acceptance gate reads."""
    ok = result.ok_records
    kernels = list(result.kernel_names)
    if any(r.composite is not None for r in ok):
        kernels.append("composite")

    per_kernel: Dict[str, object] = {}
    ordering_ok = True
    subword_ok = True
    for kern in kernels:
        recs = [r for r in ok
                if kern in _measures(r)]
        if not recs:
            continue
        front = kernel_front(recs, kern)
        checks = scheme_ordering_checks(recs, kern)
        sub = subword_speedups(recs, kern)
        per_kernel[kern] = {"front": front,
                            "speedup_vs_lanes":
                                speedup_vs_lanes(recs, kern),
                            "subword": sub, "checks": checks,
                            "hart_utilization":
                                hart_utilization_by_scheme(recs, kern)}
        device = device_summary(recs, kern)
        if device:
            per_kernel[kern]["device"] = device
        # the checks dict mixes pass/fail booleans with integer
        # diagnostics (n_matched_groups) — gate on the booleans only,
        # the same contract __main__ uses when listing failures
        ordering_ok &= all(v for v in checks.values()
                           if isinstance(v, bool))
        if kern in MFU_BOUND_KERNELS:
            subword_ok &= (sub["max_speedup"] >= subword_min_speedup
                           and sub["min_speedup_at_min_lanes"]
                           >= subword_min_speedup)

    schemes_covered = sorted({r.point.scheme for r in ok})
    return {
        "meta": dict(result.meta),
        "kernels": per_kernel,
        "checks": {
            "n_points_ok": len(ok),
            "all_schemes_covered":
                schemes_covered == ["het_mimd", "shared", "sym_mimd"],
            "pareto_ordering_ok": ordering_ok,
            "subword_2x_on_mfu_bound": subword_ok,
        },
    }


#: width of one utilization bar in characters
_BAR_WIDTH = 30


def _utilization_bar(busy: int, stall: int, total: int,
                     width: int = _BAR_WIDTH) -> str:
    """busy/stall/idle as one fixed-width bar: ``█`` busy, ``▒`` stall,
    ``·`` idle. Cumulative rounding so the segments always sum to
    ``width``."""
    total = max(total, 1)
    n_busy = round(width * busy / total)
    n_stall = round(width * (busy + stall) / total) - n_busy
    n_idle = width - n_busy - n_stall
    return "█" * n_busy + "▒" * n_stall + "·" * n_idle


def render_markdown(report: Dict[str, object],
                    plots: Optional[Dict[str, List[str]]] = None) -> str:
    """A human-readable walkthrough of the sweep. ``plots`` maps kernel
    names to SVG filenames (written next to the markdown by
    :func:`repro_torch.kvi.dse.plots.write_plots`) to embed as images."""
    lines = ["# Klessydra-T design-space exploration", ""]
    meta = report["meta"]
    lines += [f"- points swept: {meta['n_points']} "
              f"({meta['n_ok']} ok, {meta['n_incompatible']} "
              f"incompatible), wall {meta['wall_s']}s",
              f"- schemes: {', '.join(meta['schemes'])}", ""]

    lines += ["## Checks", ""]
    for k, v in report["checks"].items():
        lines.append(f"- `{k}`: **{v}**")
    lines.append("")

    for kern, data in report["kernels"].items():
        lines += [f"## {kern}", ""]
        for fname in (plots or {}).get(kern, ()):
            lines.append(f"![{os.path.splitext(fname)[0]}]({fname})")
        if (plots or {}).get(kern):
            lines.append("")
        lines += ["### Pareto front "
                  "(cycles / area / energy, all minimized)", "",
                  "| point | scheme | D | bits | cycles | area (LUTeq) "
                  "| energy (nJ) |",
                  "|---|---|---|---|---|---|---|"]
        for row in data["front"]:
            lines.append(
                f"| {row['point']} | {row['scheme']} | {row['D']} | "
                f"{row['precision_bits']} | {row['cycles']} | "
                f"{row['area_luteq']} | {row['energy_nj']} |")
        lines.append("")
        if data["speedup_vs_lanes"]:
            lines += ["### Speedup vs lane count (baseline: smallest "
                      "swept D per series)", ""]
            for series, by_d in data["speedup_vs_lanes"].items():
                cells = ", ".join(f"{d}: {s}x"
                                  for d, s in by_d.items())
                lines.append(f"- `{series}`: {cells}")
            lines.append("")
        sub = data["subword"]
        if sub["pairs"]:
            lines.append(f"### Sub-word: best 32-bit -> 8-bit speedup "
                         f"{sub['max_speedup']}x")
            lines.append("")
        util = data.get("hart_utilization") or {}
        if util:
            lines += ["### Hart utilization (fastest default-pipeline "
                      "point per scheme; █ busy, ▒ stall, · idle)", ""]
            for scheme, u in util.items():
                lines.append(f"- `{scheme}` — `{u['point']}` "
                             f"({u['cycles']} cycles)")
                for h, hb in enumerate(u["harts"]):
                    bar = _utilization_bar(hb["busy"], hb["stall"],
                                           hb["total"])
                    lines.append(
                        f"  - hart{h} `{bar}` "
                        f"{100 * hb['busy'] // max(hb['total'], 1)}% busy, "
                        f"{100 * hb['stall'] // max(hb['total'], 1)}% "
                        f"stall, "
                        f"{100 * hb['idle'] // max(hb['total'], 1)}% idle")
            lines.append("")
        device = data.get("device")
        if device:
            lines += ["### Device walltime (measured, homogeneous "
                      "batch; one measurement per precision/pipeline "
                      "class; compile = one-time cost, steady = warm "
                      "per-batch cost)", "",
                      "| bits | pipeline | walltime (s) | compile (s) "
                      "| steady (s) | kernel_launches "
                      "| best sim cycles | points |",
                      "|---|---|---|---|---|---|---|---|"]
            for row in device:
                pipe = "default" if row["passes"] is None else \
                    ("raw" if row["passes"] == [] else
                     "-".join(row["passes"]))
                lines.append(
                    f"| {row['precision_bits']} | {pipe} | "
                    f"{row['device_walltime_s']} | "
                    f"{row.get('device_compile_s', '-')} | "
                    f"{row.get('device_steady_s', '-')} | "
                    f"{row['kernel_launches']} | {row['best_cycles']} | "
                    f"{row['n_points']} |")
            lines.append("")
    return "\n".join(lines)


#: appended to ``dse_report.md`` when the auto-tuner's trajectory
#: figure sits next to it (either tool may run first — both link it).
SEARCH_TRAJECTORY_SECTION = (
    "\n## Auto-tuner trajectory\n\n"
    "The budget-constrained search (`python -m repro_torch.kvi.dse search`) "
    "over this space — best-so-far workload-mix cycles per "
    "cycle-accurate evaluation spent (details in `dse_search.md`):\n\n"
    "![search trajectory](dse_search_trajectory.svg)\n")


def smoke_space() -> DesignSpace:
    """The CI sweep: 3 schemes x D in (2,4,8,16) x 8/16/32-bit = 36
    points, seconds of wall time."""
    return DesignSpace()


def full_space() -> DesignSpace:
    """The paper-scale sweep: adds the chaining toggle axis and the FU
    replication axis (het-MIMD with a second MAC instance — the shared
    multiplier is exactly what its three harts serialize on, so the
    dual-MAC point lands on the matmul Pareto front between base het
    and sym). Gated out of the smoke space so CI stays at 36 points."""
    return DesignSpace(chaining=(False, True),
                       fu_counts=((), (("multiplier", 2),)))


def run_dse(smoke: bool = False, seed: int = 0,
            emit: Optional[Callable[[str], None]] = None,
            out_dir: Optional[str] = None,
            max_workers: int = 4,
            space: Optional[DesignSpace] = None,
            executor: Optional[str] = None,
            measure_device: bool = False,
            cache=None, obs=None, device=None,
            ) -> Tuple[SweepResult, Dict[str, object]]:
    """Sweep + report (+ artifacts). Writes ``dse_sweep.json``,
    ``dse_sweep.csv``, ``dse_report.md`` (with SVG speedup/Pareto
    figures alongside) and ``BENCH_torch_kvi_dse.json`` into ``out_dir``
    when given (the reference's ``BENCH_kvi_dse.json`` is never
    written). ``executor`` selects the sweep executor
    (serial/thread/process/auto); ``measure_device`` adds the device
    walltime stage to every point, on ``device`` (the card when
    ``None``, ``"cpu"`` on request). ``cache`` attaches a persistent
    :class:`~repro_torch.kvi.dse.pointcache.PointCache` — the sweep then
    recomputes only points whose inputs changed, and
    ``dse_cache_stats.json`` lands next to the other artifacts.
    ``obs`` threads a telemetry bundle through the sweep."""
    t0 = time.perf_counter()
    space = space or (smoke_space() if smoke else full_space())
    result = sweep(space, paper_kernel_factory(smoke=smoke, seed=seed),
                   emit=emit, max_workers=max_workers,
                   executor=executor,
                   measure_device=True if measure_device else None,
                   device=device, cache=cache, obs=obs)
    report = build_report(result)
    report["meta"]["smoke"] = smoke
    report["meta"]["seed"] = seed
    report["meta"]["total_wall_s"] = round(time.perf_counter() - t0, 3)
    if out_dir is not None:
        import json

        from repro_torch.kvi.dse.plots import write_plots
        os.makedirs(out_dir, exist_ok=True)
        result.save_json(os.path.join(out_dir, "dse_sweep.json"))
        result.save_csv(os.path.join(out_dir, "dse_sweep.csv"))
        plots = write_plots(result, report, out_dir)
        md = render_markdown(report, plots=plots)
        if os.path.exists(os.path.join(out_dir,
                                       "dse_search_trajectory.svg")):
            md += SEARCH_TRAJECTORY_SECTION
        with open(os.path.join(out_dir, "dse_report.md"), "w") as f:
            f.write(md)
        with open(os.path.join(out_dir, "BENCH_torch_kvi_dse.json"),
                  "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        if cache is not None:
            stats = dict(cache.stats)
            stats["total_wall_s"] = report["meta"]["total_wall_s"]
            with open(os.path.join(out_dir,
                                   "dse_cache_stats.json"), "w") as f:
                json.dump(stats, f, indent=2, sort_keys=True)
    return result, report
