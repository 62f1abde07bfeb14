"""The root ``conftest.py``: a pytest-xdist worker runs torch on its share
of the cores, so the workers do not oversubscribe the CPU."""
import os

import pytest
import torch


def test_a_worker_takes_its_share_of_the_cores():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        pytest.skip("runs in a pytest-xdist worker (pytest -n)")
    share = max(1, (os.cpu_count() or 1) // int(workers))
    assert torch.get_num_threads() == int(os.environ["OMP_NUM_THREADS"])
    assert torch.get_num_threads() <= share
