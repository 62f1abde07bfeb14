"""Shared set-up of the benchmark's CPU tests: the checkout and the
port's sources importable, and a copy of the benchmark that holds tiny
training cells besides the real ones (new files and manifest entries
alone)."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MODEL = {"num_layers": 2, "d_model": 64, "vocab_size": 500,
              "ssm_state": 16, "ssm_headdim": 16, "ssm_chunk": 16}
# limits of the tiny cells, set from CPU readings at their size over
# seeds 1-12 (tied and untied head) as the real cell's are from chip
# readings at its size: sound bf16 runs read at most loss 2.2e-4, grad
# norm 1.1e-3, grad 6.6e-3, change 7.7e-3; the fp8 control's grad at
# least 0.0199 on every seed; half the batch reads a grad norm gap of 0.32
# and more, a state left unchanged 1 on grad and change
TINY_LIMITS = {"loss_gap": 5e-4, "grad_norm_gap": 5e-3, "grad_gap": 0.015,
               "change_gap": 0.015}


def tiny_config(dtype: str = "bfloat16", tie: bool = True) -> dict:
    """The mamba2 configuration at a tiny size, its head tied or not."""
    cfg = json.loads((ROOT / "cardbench" / "configs" /
                      "mamba2-1.3b.json").read_text())
    cfg["name"] = f"tiny-ssm{'' if tie else '-untied'}"
    cfg["model"].update(TINY_MODEL, dtype=dtype, tie_embeddings=tie)
    cfg["padded_vocab"] = 512
    return cfg


def add_cell(bench: Path, dtype: str = "bfloat16", tie: bool = True) -> str:
    """A tiny training cell added to the copy at ``bench`` (its root) as
    new files and manifest entries. Returns its name."""
    cfg = tiny_config(dtype, tie)
    name = f"train.{cfg['name']}.{dtype}"
    cb = bench / "cardbench"
    (cb / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (cb / "traffic" / "tiny-4x64.json").write_text(json.dumps({
        "kind": "token_stream", "batch": 4, "seq": 64, "batches": 2}))
    wl = {"name": name, "kind": "train", "config": cfg["name"],
          "traffic": "tiny-4x64", "chips": 1, "why": "a tiny CPU cell",
          "check_steps": 3, "traced_steps": 2, "reference_rows": 2,
          "limits": TINY_LIMITS}
    (cb / "workloads" / f"{name}.json").write_text(json.dumps(wl))
    man_path = bench / "BENCHMARK.json"
    man = json.loads(man_path.read_text())
    if cfg["name"] not in {c["name"] for c in man["configs"]}:
        man["configs"].append({"name": cfg["name"], "source": "tests",
                               "file": f"cardbench/configs/{cfg['name']}.json",
                               "reduced": ["num_layers"], "why": "tests"})
    man["workloads"].append({k: wl[k] for k in ("name", "config", "traffic",
                                                 "chips", "why")})
    man_path.write_text(json.dumps(man))
    return name


@pytest.fixture
def bench(tmp_path) -> Path:
    """A copy of the benchmark (``BENCHMARK.json`` and ``cardbench/``)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path
