"""Give each pytest-xdist worker its share of the CPU's cores.

Under ``pytest -n W`` every worker is a process of its own, and torch
starts each with as many intra-op threads as the machine has cores: W
workers oversubscribe the CPU W times over, and small eager tensors then
spend most of their time in thread contention. In a worker this caps
torch's intra-op threads at ``os.cpu_count() // W`` (at least 1):
``OMP_NUM_THREADS`` is set before torch is imported, so the processes
that tests spawn (gloo ranks, command-line runs) inherit it, and
``torch.set_num_threads`` applies it if torch is already loaded. A value
of ``OMP_NUM_THREADS`` the environment sets is kept. Outside xdist this
does nothing: the program, its benchmark and its command-line tools keep
torch's defaults.

pytest loads this file before ``tests/conftest.py``, in the controller
and in every worker.
"""
import os
import sys

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    os.environ.setdefault(
        "OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // int(_workers))))
    if "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(
            int(os.environ["OMP_NUM_THREADS"]))
