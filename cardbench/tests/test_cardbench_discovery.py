"""A new configuration, cell and per-layer metric are found from new
files and manifest entries alone: no file that was there changes."""
import hashlib
import json

from conftest import add_cell

from cardbench.harness import manifest
from cardbench.run import make_result

NEW_METRIC = '''"""Steps the window ran (a test's metric)."""
UNIT, LAYER, MOVES = "steps", "train step", "train_tokens_per_s"


def read(ctx):
    return ctx.get("steps")
'''


def _digests(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "cardbench").rglob("*") if p.is_file()}


def test_new_files_alone_add_a_cell_a_config_and_a_metric(bench):
    before = _digests(bench)
    name = add_cell(bench)
    (bench / "cardbench" / "metrics" / "window_steps.train.py").write_text(
        NEW_METRIC)
    man = json.loads((bench / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "window_steps.train", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "train step",
                             "moves": "train_tokens_per_s",
                             "workloads": [name]})
    (bench / "BENCHMARK.json").write_text(json.dumps(man))
    after = _digests(bench)
    assert {k: after[k] for k in before} == before     # nothing edited
    assert manifest.problems(man, bench / "cardbench") == []

    cell = manifest.load_cell(bench / "BENCHMARK.json", name,
                              bench / "cardbench")
    assert cell.config["name"] == "tiny-ssm"
    assert [m["name"] for m in cell.per_layer][-1] == "window_steps.train"
    kind = manifest.load_code("kinds", cell.kind, cell.bench_dir)
    ctx = kind.run(cell, 3, 0.2, True, 0.0, device="cpu")
    ctx["device_kind"] = "cpu"
    res = make_result(cell, ctx, True, 1)
    assert res["metrics"]["window_steps.train"] == {
        "value": ctx["steps"], "unit": "steps"}
    res = make_result(cell, ctx, False, 1)
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert list(res)[-1] == "checks" and res["correct"]
