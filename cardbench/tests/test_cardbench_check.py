"""The comparison that decides ``correct``: the rest of a run, the look
for a chip skipped, on tiny cells on the CPU. A sound run comes out
correct; a run with the timed path broken underneath, and the plain
reference in the lower-precision control's place, come out not
correct."""
import pytest
import torch
from conftest import add_cell

from cardbench.harness import compare, faults, manifest
from cardbench.kinds import train as kt
from cardbench.run import make_result


def _run(bench, seed, plant=None, tie=True):
    name = add_cell(bench, tie=tie)
    cell = manifest.load_cell(bench / "BENCHMARK.json", name,
                              bench / "cardbench")
    ctx = kt.run(cell, seed, 0.1, False, 0.0, device="cpu", plant=plant)
    ctx["device_kind"] = "cpu"
    return make_result(cell, ctx, False, 1)


@pytest.mark.parametrize("tie", [True, False])
def test_a_sound_run_is_correct(bench, tie):
    res = _run(bench, 2 ** 31 + 9, tie=tie)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_fault_under_the_timed_path_is_not_correct(bench, fault):
    res = _run(bench, 5, plant=faults.FAULTS[fault])
    assert not res["correct"], res["checks"]


def test_the_fp8_control_is_not_correct(bench):
    name = add_cell(bench)
    cell = manifest.load_cell(bench / "BENCHMARK.json", name,
                              bench / "cardbench")
    cpu = torch.device("cpu")
    for seed in (1, 2, 3):
        batches = kt.make_batches(cell, seed)
        ref = kt.reference_steps(cell, seed, batches, 3, cpu)
        ctrl = kt.reference_steps(cell, seed, batches, 3, cpu, product="fp8")
        nums = compare.numbers(ctrl, ref)
        assert not compare.judge(nums, cell.workload["limits"]), nums


@pytest.mark.parametrize("tie", [True, False])
def test_the_reference_is_the_program_in_float32(bench, tie):
    """At float32 activations the program's first steps and the
    reference's (in blocks of rows) agree to float32 rounding."""
    name = add_cell(bench, dtype="float32", tie=tie)
    cell = manifest.load_cell(bench / "BENCHMARK.json", name,
                              bench / "cardbench")
    batches = kt.make_batches(cell, 11)
    _, _, prog = kt.first_steps(kt.Trainer(cell, "cpu"), 11, batches, 3)
    ref = kt.reference_steps(cell, 11, batches, 3, torch.device("cpu"))
    for k, v in compare.numbers(prog, ref).items():
        assert v < 1e-5, (k, v)


def test_non_finite_numbers_fail():
    prog = {"loss": [float("nan")], "grad_norm": 1.0, "grad": {"a": 1.0},
            "change": {"a": 1.0}}
    ref = {"loss": [1.0], "grad_norm": 1.0, "grad": {"a": 1.0},
           "change": {"a": 1.0}}
    nums = compare.numbers(prog, ref)
    assert nums["loss_gap"] == float("inf")
    assert not compare.judge(nums, {k: 1.0 for k in nums})


def test_reference_rows_in_blocks_are_the_whole_batch(bench):
    """The reference's gradients summed over blocks of rows are the
    whole batch's."""
    name = add_cell(bench, dtype="float32")
    cell = manifest.load_cell(bench / "BENCHMARK.json", name,
                              bench / "cardbench")
    batches = kt.make_batches(cell, 4)
    cpu = torch.device("cpu")
    blocks = kt.reference_steps(cell, 4, batches, 2, cpu)
    cell.workload["reference_rows"] = None
    whole = kt.reference_steps(cell, 4, batches, 2, cpu)
    for k, v in compare.numbers(blocks, whole).items():
        assert v < 1e-5, (k, v)
