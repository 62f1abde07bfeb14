"""CLI: ``python -m repro_torch.kvi.dse [--smoke] [--out-dir DIR] ...``
     or ``python -m repro_torch.kvi.dse search [--smoke] [--strategy S] ...``
(the port's copy of ``python -m repro.kvi.dse``).

Without a subcommand, runs the exhaustive design-space sweep over the
paper's kernels, writes the artifacts (``dse_sweep.json``,
``dse_sweep.csv``, ``dse_report.md``, ``BENCH_torch_kvi_dse.json``,
``dse_cache_stats.json``) and exits non-zero when any acceptance check
fails (all schemes covered, Pareto scheme ordering, sub-word >= 2x on
the MFU-bound kernels).

``search`` runs the budget-constrained auto-tuner instead
(:mod:`repro_torch.kvi.dse.search`): sample feasible candidates, rank them
with the analytic cost model, spend cycle-accurate simulations only on
survivors. Writes ``dse_search.json`` / ``dse_search_canonical.json``
/ ``dse_search.md`` / ``dse_search_trajectory.svg`` /
``BENCH_torch_kvi_search.json``; with ``--smoke`` it also confirms the rest
of the grid and exits non-zero unless the search recovered the full
exhaustive Pareto front within half the grid's simulations.

``--executor {auto,serial,thread,process}`` selects the sweep executor
(default ``auto``: serial for small uncached fan-outs, the spawn
process pool otherwise; all executors produce identical canonical
results). ``--measure-device`` adds the walltime axis: each point's
programs also run through ``TorchBackend`` (one ``kvi_walk`` launch per
structural group) and the artifacts gain walltime + kernel-launch-count
columns. ``--device cuda`` (the default) measures on the card and
raises without one; ``--device cpu`` runs the walk's plain version.

Sweeps are **incremental** by default: measured points persist in a
content-addressed cache (``~/.cache/klessydra-dse-torch`` or
``--cache-dir``) and a re-run with unchanged inputs resolves every
point — and every ``--measure-device`` class — from the store.
``--no-cache`` restores the cold-sweep behavior; ``--cache-stats``
prints the store's counters and shape after the run.
"""
from __future__ import annotations

import argparse
import json
import sys


def search_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kvi.dse search",
        description="budget-constrained design-space auto-tuner")
    ap.add_argument("--smoke", action="store_true",
                    help="36-point CI space + exhaustive yardstick: "
                         "fails unless the full Pareto front is "
                         "recovered within half the grid's sims")
    ap.add_argument("--strategy", default="successive_halving",
                    help="search strategy (default successive_halving)")
    ap.add_argument("--budget", type=int, default=None,
                    help="max cycle-accurate evaluations (default: "
                         "half the grid, capped)")
    ap.add_argument("--pool", type=int, default=None,
                    help="candidate pool screened analytically "
                         "(default: 8x budget, capped at the grid)")
    ap.add_argument("--eps", type=float, default=None,
                    help="low-fidelity dominance relaxation (default "
                         "0.02 — the estimator's error margin)")
    ap.add_argument("--max-area", type=float, default=None,
                    metavar="LUTEQ",
                    help="feasibility constraint: analytic area budget")
    ap.add_argument("--max-static-nj", type=float, default=None,
                    metavar="NJ",
                    help="feasibility constraint: static nJ/cycle "
                         "budget")
    ap.add_argument("--compare-exhaustive", action="store_true",
                    help="confirm the remaining grid afterwards and "
                         "score front recovery (implied by --smoke)")
    ap.add_argument("--out-dir", default=".",
                    help="where to write search artifacts")
    ap.add_argument("--seed", type=int, default=0,
                    help="search RNG + kernel input data seed")
    ap.add_argument("--jobs", type=int, default=4,
                    help="confirmation worker count")
    ap.add_argument("--executor", default="auto",
                    choices=("auto", "serial", "thread", "process"),
                    help="confirmation executor (default auto: serial "
                         "for tiny budgets, persistent process pool "
                         "otherwise)")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="persistent point-cache directory (shared "
                         "with the exhaustive sweep)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the persistent point cache")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress progress lines")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto-loadable Chrome trace")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot JSON")
    args = ap.parse_args(argv)
    if args.no_cache and args.cache_dir:
        ap.error("--no-cache and --cache-dir are mutually exclusive")

    from repro_torch.kvi.dse.search import STRATEGIES, run_search
    if args.strategy not in STRATEGIES:
        ap.error(f"unknown strategy {args.strategy!r}; choose from "
                 f"{', '.join(sorted(STRATEGIES))}")
    constraints = None
    if args.max_area is not None or args.max_static_nj is not None:
        from repro_torch.kvi.dse.space import SpaceConstraints
        constraints = SpaceConstraints(
            max_area_luteq=args.max_area,
            max_static_nj_per_cycle=args.max_static_nj)
    cache = None
    if not args.no_cache:
        from repro_torch.kvi.dse.pointcache import PointCache
        cache = PointCache(cache_dir=args.cache_dir)
    obs = None
    if args.trace_out or args.metrics_out:
        from repro_torch.kvi.obs import Obs
        obs = Obs.on()
    result = run_search(
        strategy=args.strategy, smoke=args.smoke, seed=args.seed,
        budget=args.budget, pool=args.pool,
        **({"eps": args.eps} if args.eps is not None else {}),
        constraints=constraints,
        compare_exhaustive=True if (args.smoke
                                    or args.compare_exhaustive)
        else None,
        emit=None if args.quiet else print, out_dir=args.out_dir,
        max_workers=args.jobs, executor=args.executor,
        cache=cache, obs=obs)
    if obs is not None:
        obs.save(trace_path=args.trace_out,
                 metrics_path=args.metrics_out)

    ev = result.evaluations
    frac = result.exhaustive_fraction
    print(f"\n# search[{result.strategy}] seed {result.seed}: "
          f"{ev['high_evals']} sims "
          f"({frac:.1%} of the {result.meta['grid_size']}-point grid), "
          f"{ev['low_evals']} analytic scores, "
          f"front size {len(result.front)} "
          f"in {result.meta['walltime_s']}s")
    if result.best is not None:
        print(f"# best: {result.best.point.name}")
    failed = []
    rec = result.meta.get("recovery")
    if rec is not None:
        print(f"# front recovery: {rec['front_recovery']:.1%} of "
              f"{rec['exhaustive_front_size']} exhaustive front "
              f"members (exhaustive confirm took "
              f"{rec['walltime_s']}s)")
        if args.smoke:
            if rec["front_recovery"] < 1.0:
                failed.append("front_recovery == 1.0")
            if frac is not None and frac > 0.5:
                failed.append("high_evals <= 50% of grid")
    print(f"# wrote dse_search.json / dse_search.md / "
          f"BENCH_torch_kvi_search.json under {args.out_dir}")
    if failed:
        print(f"# FAILED checks: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "search":
        return search_main(argv[1:])
    ap = argparse.ArgumentParser(prog="python -m repro_torch.kvi.dse")
    ap.add_argument("--smoke", action="store_true",
                    help="small kernels + default axes (CI-sized, <60s)")
    ap.add_argument("--full", action="store_true",
                    help="explicit paper-scale sweep (the default when "
                         "--smoke is absent): adds the chaining and "
                         "fu_counts axes")
    ap.add_argument("--out-dir", default=".",
                    help="where to write sweep/report artifacts")
    ap.add_argument("--seed", type=int, default=0,
                    help="kernel input data seed (reproducible BENCH)")
    ap.add_argument("--jobs", type=int, default=4,
                    help="sweep worker count (threads or processes)")
    ap.add_argument("--executor", default="auto",
                    choices=("auto", "serial", "thread", "process"),
                    help="sweep executor (default auto: serial for <8 "
                         "uncached points, process pool otherwise)")
    ap.add_argument("--measure-device", action="store_true",
                    help="also measure real device walltime + kernel "
                         "launch counts per point (one execution per "
                         "precision/pipeline class; cached across runs "
                         "like any other measurement)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where --measure-device runs (default cuda: "
                         "the card, no CPU fallback)")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="persistent point-cache directory (default: "
                         "$XDG_CACHE_HOME/klessydra-dse-torch or "
                         "~/.cache/klessydra-dse-torch)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the persistent point cache: compute "
                         "every point cold and store nothing")
    ap.add_argument("--cache-stats", action="store_true",
                    help="print point-cache counters and store shape "
                         "after the sweep")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-point progress lines")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto-loadable Chrome trace of the "
                         "sweep (per-point wall spans)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot JSON")
    args = ap.parse_args(argv)
    if args.smoke and args.full:
        ap.error("--smoke and --full are mutually exclusive")
    if args.no_cache and args.cache_dir:
        ap.error("--no-cache and --cache-dir are mutually exclusive")

    from repro_torch.kvi.dse.report import run_dse
    cache = None
    if not args.no_cache:
        from repro_torch.kvi.dse.pointcache import PointCache
        cache = PointCache(cache_dir=args.cache_dir)
    emit = None if args.quiet else print
    obs = None
    if args.trace_out or args.metrics_out:
        from repro_torch.kvi.obs import Obs
        obs = Obs.on()
    result, report = run_dse(smoke=args.smoke, seed=args.seed,
                             emit=emit, out_dir=args.out_dir,
                             max_workers=args.jobs,
                             executor=args.executor,
                             measure_device=args.measure_device,
                             device=args.device, cache=cache, obs=obs)
    if obs is not None:
        obs.save(trace_path=args.trace_out,
                 metrics_path=args.metrics_out)

    meta = report["meta"]
    print(f"\n# swept {meta['n_points']} points "
          f"({meta['n_ok']} ok) in {meta['total_wall_s']}s "
          f"[executor={meta['executor']}, lowering cache "
          f"{meta['lowering']['hits']} hits / "
          f"{meta['lowering']['misses']} misses]")
    if cache is not None:
        pc = meta["point_cache"]
        print(f"# point cache: {pc['hits']} hits / {pc['misses']} "
              f"misses / {pc['invalidations']} invalidations "
              f"(device: {pc['device_hits']} hits / "
              f"{pc['device_misses']} misses)")
        if args.cache_stats:
            print(f"# cache stats: {json.dumps(pc, sort_keys=True)}")
    if "device" in meta:
        dm = meta["device"]
        print(f"# device walltime: {dm['n_measured_points']} points in "
              f"{dm['n_measurement_classes']} measurement classes on "
              f"{dm['device_name']} ({dm['wall_s']}s; host sweep "
              f"{meta['wall_s']}s)")
    failed = [k for k, v in report["checks"].items()
              if isinstance(v, bool) and not v]
    for k, v in report["checks"].items():
        print(f"#   {k} = {v}")
    print(f"# wrote dse_sweep.json / dse_sweep.csv / dse_report.md / "
          f"BENCH_torch_kvi_dse.json under {args.out_dir}")
    if failed:
        print(f"# FAILED checks: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
