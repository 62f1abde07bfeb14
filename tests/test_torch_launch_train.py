"""``python -m repro_torch.launch.train`` on the CPU (``--device cpu``):
the reference's lines, checkpoints in the reference's format, resume
equal bit for bit to a straight run, the one-device rule, and no silent
CPU fallback."""
import io
import re
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint.manager import latest_step
from repro_torch.launch import train
from repro_torch.models import params as params_lib

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--arch", "llama3.2-1b", "--reduced", "--batch", "2", "--seq", "32",
        "--device", "cpu"]


def run(argv):
    report, buf = {}, io.StringIO()
    with redirect_stdout(buf):
        assert train.main(argv, report=report) == 0
    return report, buf.getvalue().splitlines()


def state_bits(report):
    out = {}
    for name, x in params_lib.tree_leaves({"params": report["params"],
                                           "opt": report["opt_state"]}):
        out[name] = (x.dtype, x.numpy().tobytes())
    return out


def test_prints_the_reference_lines(tmp_path):
    report, lines = run(BASE + ["--steps", "5", "--log-every", "2"])
    assert lines[0] == ("arch=llama3.2-1b reduced=True params=102,720 "
                        "seq=32 batch=2")
    step_re = re.compile(r"step +(\d+) loss \d+\.\d{4} gnorm \d+\.\d{3} "
                         r"lr \d\.\d\de-\d\d \(\d+\.\ds\)")
    assert [int(step_re.fullmatch(x).group(1)) for x in lines[1:-1]] == \
        [0, 2, 4]
    assert re.fullmatch(r"loss \d+\.\d{4} -> \d+\.\d{4} \((improved|NOT "
                        r"improved)\)", lines[-1])
    assert [s["step"] for s in report["steps"]] == list(range(5))
    assert report["device"] == torch.device("cpu")


def test_resume_equals_a_straight_run(tmp_path):
    """6 steps with a checkpoint every 3, against 3 steps then --resume
    for 3 more: params and optimizer state equal bit for bit, the
    checkpoints in the reference's layout."""
    straight, _ = run(BASE + ["--steps", "6", "--ckpt-dir",
                              str(tmp_path / "a"), "--ckpt-interval", "3"])
    assert latest_step(tmp_path / "a") == 6
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == \
        ["LATEST", "step_000000003", "step_000000006"]
    first, _ = run(BASE + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b"),
                           "--ckpt-interval", "3"])
    resumed, lines = run(BASE + ["--steps", "6", "--ckpt-dir",
                                 str(tmp_path / "b"), "--ckpt-interval", "3",
                                 "--resume"])
    assert "resumed from step 3" in lines
    assert resumed["start_step"] == 3
    assert [s["step"] for s in resumed["steps"]] == [3, 4, 5]
    assert state_bits(resumed) == state_bits(straight)
    assert [s["loss"] for s in resumed["steps"]] == \
        [s["loss"] for s in straight["steps"][3:]]
    assert int(resumed["opt_state"]["count"]) == 6


def test_resume_without_a_checkpoint_starts_at_zero(tmp_path):
    report, lines = run(BASE + ["--steps", "2", "--ckpt-dir",
                                str(tmp_path), "--resume"])
    assert report["start_step"] == 0
    assert not any(x.startswith("resumed") for x in lines)


def test_int8_moments_and_a_text_file(tmp_path):
    """grok's int8 moments through the driver, on the byte tokenizer."""
    text = tmp_path / "t.txt"
    text.write_text("klessydra vector coprocessor " * 50)
    report, _ = run(["--arch", "grok-1-314b", "--reduced", "--batch", "2",
                     "--seq", "32", "--steps", "2", "--data", str(text),
                     "--device", "cpu"])
    assert report["opt_state"]["m"]["embed"]["q"].dtype == torch.int8


def test_build_trainer_keeps_the_one_device_rule():
    cfg, par, shape, rules, step, data, opt_cfg = train.build_trainer(
        "llama3.2-1b", reduced=True, seq=32, batch=2, steps=40)
    assert (par.remat, par.fsdp, par.sequence_parallel) == \
        ("none", False, False)
    assert (opt_cfg.total_steps, opt_cfg.warmup_steps) == (40, 10)
    assert shape.kind == "train" and step.__name__ == "train_step"
    # a mesh takes the arch's own Parallelism (tests/test_torch_mesh_train.py
    # runs it); anything else is refused
    with pytest.raises(TypeError, match="a mesh is a DeviceMesh"):
        train.build_trainer("llama3.2-1b", reduced=True, seq=32, batch=2,
                            steps=4, mesh=object())


def test_the_card_is_the_default_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal shows only without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--reduced", "--steps", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert "step" not in r.stdout
