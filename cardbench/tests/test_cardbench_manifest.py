"""``BENCHMARK.json`` against the benchmark's contract: keys, names,
units, files, the time a full check takes, and each metric's reader
file against its entry."""
import json
import re

from conftest import ROOT

from cardbench.harness import manifest

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
WIDTH = re.compile(r"hidden|intermediate|latent|state|proj|_dim$|_rank$|"
                   r"head|expand|window|experts_per|d_model|d_inner")


def test_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}


def test_names_units_and_files():
    assert manifest.problems(MAN) == []
    assert len(json.dumps(MAN)) <= 64 * 1024
    for p in MAN["paths"]:
        assert manifest.NAME.match(p.replace("/", "_"))
        assert (ROOT / p).is_dir()
    for path in (ROOT / "cardbench").rglob("*"):
        if "__pycache__" not in path.parts:
            rel = path.relative_to(ROOT).as_posix()
            assert all(manifest.NAME.match(part) for part in rel.split("/")), rel


def test_a_full_check_fits_with_24_cells():
    rs = MAN["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_and_cells_agree_with_their_files():
    for c in MAN["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        # no width is ever cut; each changed key has its departure
        for k in cfg["reduced"]:
            assert not WIDTH.search(k), k
        assert set(cfg["reduced"]) <= {d["key"] for d in cfg["departures"]}
        assert set(cfg["published"]) >= set(cfg["reduced"])
    for w in MAN["workloads"]:
        cell = manifest.load_cell(ROOT / "BENCHMARK.json", w["name"])
        assert set(cell.workload["limits"]) == {
            "loss_gap", "grad_norm_gap", "grad_gap", "change_gap"}
        assert cell.end_to_end and cell.per_layer
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_metric_files_match_their_entries():
    for group in ("end_to_end", "per_layer"):
        for m in MAN[group]:
            mod = manifest.load_metric(m["name"])
            assert mod.UNIT == m["unit"]
            if group == "per_layer":
                assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
            assert mod.read({}) is None        # nothing to read, no number
