"""The tiny cells on the card: a sound run comes out correct, the
lower-precision control does not. Run on a machine with a card:

    python -m pytest -q -m cuda cardbench/tests/test_cardbench_card.py
"""
import pytest
import torch
from conftest import add_cell

from cardbench.harness import compare, manifest
from cardbench.kinds import train as kt
from cardbench.run import make_result


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tie", [True, False])
def test_tiny_cell_on_the_card(bench, tie):
    dev = _card()
    name = add_cell(bench, tie=tie)
    cell = manifest.load_cell(bench / "BENCHMARK.json", name,
                              bench / "cardbench")
    ctx = kt.run(cell, 2 ** 31 + 1, 0.5, True, 0.0, device=dev)
    ctx["device_kind"] = torch.cuda.get_device_name(0)
    res = make_result(cell, ctx, True, 1)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    for seed in (1, 2, 3):
        batches = kt.make_batches(cell, seed)
        ref = kt.reference_steps(cell, seed, batches, 3, dev)
        ctrl = kt.reference_steps(cell, seed, batches, 3, dev, product="fp8")
        assert not compare.judge(compare.numbers(ctrl, ref),
                                 cell.workload["limits"])
