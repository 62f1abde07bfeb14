"""``BENCHMARK.json`` and the files it names, found by name alone:

- ``configs/<config>.json``: the configuration as it is run;
- ``workloads/<cell>.json``: the cell's kind, configuration, traffic,
  chips and limits;
- ``traffic/<mix>.json``: the traffic mix's parameters;
- ``metrics/<metric>.py``: a metric's reader (``read(ctx)``) with its
  ``UNIT``, ``LAYER`` and ``MOVES``;
- ``kinds/<kind>.py``, ``reference/<reference>.py``,
  ``flops/<family>.py``: the code a cell's kind, its configuration's
  reference and its FLOP count take.

Nothing here branches on a cell's, a configuration's or a metric's
name."""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list      # the manifest's metric entries this cell reports
    per_layer: list
    bench_dir: Path

    @property
    def kind(self) -> str:
        return self.workload["kind"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(manifest_path: Path, name: str,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of the manifest, with its files read from
    ``bench_dir``. Raises ``KeyError`` for a cell the manifest lacks."""
    man = load_json(manifest_path)
    entry = {w["name"]: w for w in man["workloads"]}[name]
    wl = load_json(bench_dir / "workloads" / f"{name}.json")
    for k in ("config", "traffic", "chips"):
        if wl[k] != entry[k]:
            raise ValueError(f"{name}: workload file says {k}={wl[k]!r}, "
                             f"the manifest {entry[k]!r}")
    cfg = load_json(bench_dir / "configs" / f"{wl['config']}.json")
    mix = load_json(bench_dir / "traffic" / f"{wl['traffic']}.json")
    return Cell(name, wl, cfg, mix,
                [m for m in man["end_to_end"] if _reports(m, name)],
                [m for m in man["per_layer"] if _reports(m, name)],
                bench_dir)


def load_metric(name: str, bench_dir: Path = BENCH_DIR):
    """The module of ``metrics/<name>.py`` (names may hold dots)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "cardbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_code(group: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module ``<group>/<name>.py`` of the benchmark: a kind, a
    reference or a FLOP count."""
    path = bench_dir / group / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cardbench_{group}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(man: dict, bench_dir: Path = BENCH_DIR) -> list:
    """What in the manifest breaks the benchmark's contract on names,
    units, files and references (an empty list when nothing does)."""
    bad = []
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[group]:
            if not NAME.match(e["name"]):
                bad.append(f"{group}: bad name {e['name']!r}")
            if e["name"] in names:
                bad.append(f"{group}: {e['name']!r} named twice")
            names.add(e["name"])
    configs = {c["name"] for c in man["configs"]}
    cells = {w["name"] for w in man["workloads"]}
    for c in man["configs"]:
        if not (bench_dir.parent / c["file"]).is_file():
            bad.append(f"config {c['name']}: no file {c['file']}")
        for k in c["reduced"]:
            if not NAME.match(k):
                bad.append(f"config {c['name']}: bad reduced key {k!r}")
    for w in man["workloads"]:
        if w["config"] not in configs:
            bad.append(f"cell {w['name']}: unknown config {w['config']}")
        if not NAME.match(w["traffic"]):
            bad.append(f"cell {w['name']}: bad traffic {w['traffic']!r}")
        if w["chips"] not in (1, 4):
            bad.append(f"cell {w['name']}: chips {w['chips']}")
        if not 1 <= len(w["why"]) <= 200 or "\n" in w["why"]:
            bad.append(f"cell {w['name']}: why of {len(w['why'])} chars")
        for sub, ext in (("workloads", w["name"]), ("traffic", w["traffic"])):
            if not (bench_dir / sub / f"{ext}.json").is_file():
                bad.append(f"cell {w['name']}: no {sub}/{ext}.json")
    for group in ("end_to_end", "per_layer"):
        for m in man[group]:
            if not UNIT.match(m["unit"]):
                bad.append(f"metric {m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                bad.append(f"metric {m['name']}: better {m['better']!r}")
            for c in m.get("workloads", []):
                if c not in cells:
                    bad.append(f"metric {m['name']}: unknown cell {c}")
            if not (bench_dir / "metrics" / f"{m['name']}.py").is_file():
                bad.append(f"metric {m['name']}: no reader file")
    return bad
