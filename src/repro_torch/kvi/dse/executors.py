"""Pluggable sweep executors: how design points fan out over compute
(the port's copy of ``repro.kvi.dse.executors``).

The sweep driver (:mod:`repro_torch.kvi.dse.sweep`) hands every executor the
same list of :class:`PointJob` units — a design point plus the
pre-optimized kernel programs it should run — and expects the matching
:class:`~repro_torch.kvi.dse.sweep.PointRecord` list back **in job order**.
Because each job is independent and the merge is order-preserving, every
executor produces identical results; ``SweepResult.canonical_json()``
byte-equality across executors is pinned by tests.

  * :class:`SerialExecutor`  — in-process, one job at a time. The
    reference semantics everything else must match.
  * :class:`ThreadExecutor`  — in-process thread pool. Cheap to start,
    shares the optimized-program cache by reference, but the cyclesim
    inner loop is pure Python so the GIL caps real speedup.
  * :class:`ProcessExecutor` — a ``spawn`` process pool. Jobs (points +
    programs — all plain dataclasses and numpy buffers) are pickled to
    the workers and records pickled back; each worker builds its own
    per-point :class:`~repro_torch.kvi.lowering.TraceCache`, so cache counters
    are deterministic and identical to serial execution. This is the
    executor that actually scales the paper-sized space on multi-core
    hosts.

``spawn`` (not ``fork``) is used deliberately: the parent may already
hold a CUDA context (the device walltime stage, ``chip_smoke.py``), and
a forked child must never inherit one — CUDA cannot be re-initialized
in a forked process. Workers import ``torch`` (the port's modules do)
but run only the cycle simulator on the host and never resolve a
device — the device stage runs in the parent after the fan-out.
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass
from typing import (TYPE_CHECKING, Dict, Iterator, List, Sequence, Union)

from repro_torch.kvi.dse.space import DesignPoint
from repro_torch.kvi.ir import KviProgram

if TYPE_CHECKING:                      # pragma: no cover - typing only
    from repro_torch.kvi.dse.sweep import PointRecord


@dataclass(frozen=True)
class PointJob:
    """One unit of sweep work: a design point plus the kernel programs
    (already run through the point's pass pipeline) it executes. Fully
    picklable — the :class:`ProcessExecutor` serializes jobs verbatim."""

    point: DesignPoint
    kernels: Dict[str, KviProgram]
    composite: bool = True


def run_job(job: PointJob) -> "PointRecord":
    """Execute one job. Module-level so process pools can pickle it by
    reference; the import is deferred to dodge the sweep<->executor
    module cycle."""
    from repro_torch.kvi.dse.sweep import run_point
    return run_point(job.point, job.kernels, composite=job.composite,
                     preoptimized=True)


class SweepExecutor:
    """Protocol: map jobs to records, order-preserving.

    ``imap_jobs`` is the primitive — a generator yielding records in job
    order as they complete, which is what lets the sweep driver report
    live progress (points/s, ETA) mid-fan-out. ``map_jobs`` is the
    drain-everything convenience every executor inherits."""

    name = "base"

    def imap_jobs(self, jobs: Sequence[PointJob]
                  ) -> Iterator["PointRecord"]:
        raise NotImplementedError

    def map_jobs(self, jobs: Sequence[PointJob]) -> List["PointRecord"]:
        return list(self.imap_jobs(jobs))

    def close(self) -> None:
        """Release any held worker pool. A no-op for per-call executors;
        persistent executors (see :class:`ProcessExecutor`) shut their
        long-lived pool down here. Idempotent."""


class SerialExecutor(SweepExecutor):
    """One job at a time in the calling thread — the reference order."""

    name = "serial"

    def __init__(self, max_workers: int = 1):
        del max_workers                  # uniform ctor across executors

    def imap_jobs(self, jobs: Sequence[PointJob]
                  ) -> Iterator["PointRecord"]:
        for j in jobs:
            yield run_job(j)


class ThreadExecutor(SweepExecutor):
    """In-process thread pool (the pre-executor sweep behavior)."""

    name = "thread"

    def __init__(self, max_workers: int = 4):
        self.max_workers = max(1, max_workers)

    def imap_jobs(self, jobs: Sequence[PointJob]
                  ) -> Iterator["PointRecord"]:
        with ThreadPoolExecutor(max_workers=self.max_workers) as ex:
            yield from ex.map(run_job, jobs)


class ProcessExecutor(SweepExecutor):
    """``spawn`` process pool: real multi-core speedup past the GIL.

    ``ex.map`` yields results in submission order, so the merged record
    list is deterministic and identical to :class:`SerialExecutor` —
    per-point trace-cache counters included, since every worker runs the
    same per-point ``run_point`` code on the same pickled programs.

    ``persistent=True`` keeps the spawn pool alive across ``imap_jobs``
    calls instead of paying interpreter start-up per call — built for
    multi-round drivers (the search tuner confirms a small survivor
    batch per rung) where a fresh pool per rung would cost more than
    the rung's simulation. Persistent instances must be :meth:`close`\\
    d (or used as a context manager) by whoever constructed them."""

    name = "process"

    def __init__(self, max_workers: int = 4, persistent: bool = False):
        self.max_workers = max(1, max_workers)
        self.persistent = persistent
        self._pool = None

    def _make_pool(self) -> ProcessPoolExecutor:
        ctx = multiprocessing.get_context("spawn")
        return ProcessPoolExecutor(max_workers=self.max_workers,
                                   mp_context=ctx)

    def imap_jobs(self, jobs: Sequence[PointJob]
                  ) -> Iterator["PointRecord"]:
        # chunk so each worker amortizes its interpreter start over
        # several points instead of one round-trip per point
        chunk = max(1, len(jobs) // (self.max_workers * 4))
        if self.persistent:
            if self._pool is None:
                self._pool = self._make_pool()
            yield from self._pool.map(run_job, jobs, chunksize=chunk)
            return
        with self._make_pool() as ex:
            yield from ex.map(run_job, jobs, chunksize=chunk)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self) -> "ProcessExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


EXECUTORS = {cls.name: cls
             for cls in (SerialExecutor, ThreadExecutor, ProcessExecutor)}

#: ``"auto"`` fan-outs below this many *uncached* jobs run serially —
#: a spawn pool's interpreter start-up costs more than it saves on a
#: handful of points (exactly the warm-re-sweep case, where the
#: persistent point cache resolves most jobs in the parent and the
#: executor sees only the delta).
AUTO_SERIAL_MAX = 8


def resolve_auto(spec: Union[str, SweepExecutor, None],
                 n_jobs: int) -> Union[str, SweepExecutor, None]:
    """Resolve the ``"auto"`` executor spec against the number of jobs
    that will actually dispatch (cache hits already excluded): serial
    below :data:`AUTO_SERIAL_MAX`, the process pool otherwise. Every
    other spec — an explicit name, an instance, ``None`` — passes
    through untouched: explicit flags stay authoritative."""
    if spec != "auto":
        return spec
    return "serial" if n_jobs < AUTO_SERIAL_MAX else "process"


def make_executor(spec: Union[str, SweepExecutor, None],
                  max_workers: int = 4) -> SweepExecutor:
    """Resolve an executor: an instance passes through, a name
    instantiates from the registry, ``None`` keeps the legacy behavior
    (threads when ``max_workers > 1``, else serial). ``"auto"`` must be
    resolved by the caller first (:func:`resolve_auto` — it needs the
    uncached-job count, which only the sweep driver knows)."""
    if isinstance(spec, SweepExecutor):
        return spec
    if spec is None:
        spec = "thread" if max_workers and max_workers > 1 else "serial"
    try:
        cls = EXECUTORS[spec]
    except KeyError:
        raise ValueError(f"unknown sweep executor {spec!r}; available: "
                         f"{sorted(EXECUTORS)} (or 'auto' at the sweep "
                         f"level)") from None
    return cls(max_workers=max_workers)
