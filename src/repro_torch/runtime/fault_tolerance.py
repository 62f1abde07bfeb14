"""Fault-tolerance runtime for 1000+-node operation (a copy of the
reference's ``repro/runtime/fault_tolerance.py``).

Components (all host-side, framework-agnostic, unit-tested):

  * Heartbeats        — per-host liveness registry; detects missing hosts
                        within `timeout_s` and emits a remesh plan.
  * plan_remesh       — elastic scaling: given surviving hosts, pick the
                        largest (data' x model) mesh that keeps the model
                        axis intact (TP groups must be co-located) and
                        rebalance global batch; returns a RemeshPlan the
                        trainer applies by re-lowering + elastic restore
                        (checkpoint/manager.restore with new shardings).
  * StragglerDetector — per-step-time EMA + MAD outlier test; flags hosts
                        that exceed `k` deviations for `patience` steps
                        (mitigation: report / drop into remesh plan).
  * PreemptionGuard   — SIGTERM/SIGINT handler that requests a synchronous
                        checkpoint at the next step boundary (the classic
                        preemptible-VM save-on-signal pattern).
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


@dataclass(frozen=True)
class FaultToleranceConfig:
    heartbeat_timeout_s: float = 60.0
    straggler_k: float = 4.0            # MAD multiplier
    straggler_patience: int = 5
    min_data_parallel: int = 1


# ---------------------------------------------------------------------------
# liveness
# ---------------------------------------------------------------------------

class Heartbeats:
    def __init__(self, hosts: Sequence[int], timeout_s: float = 60.0,
                 clock=time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.last: Dict[int, float] = {h: clock() for h in hosts}

    def beat(self, host: int, at: Optional[float] = None):
        self.last[host] = self.clock() if at is None else at

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = self.clock() if now is None else now
        return sorted(h for h, t in self.last.items()
                      if now - t > self.timeout)

    def alive_hosts(self, now: Optional[float] = None) -> List[int]:
        dead = set(self.dead_hosts(now))
        return sorted(h for h in self.last if h not in dead)


# ---------------------------------------------------------------------------
# elastic remesh planning
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RemeshPlan:
    data_axis: int
    model_axis: int
    hosts: tuple
    global_batch: int
    dropped_hosts: tuple

    @property
    def n_chips(self) -> int:
        return self.data_axis * self.model_axis


def plan_remesh(alive_hosts: Sequence[int], chips_per_host: int,
                model_axis: int, global_batch: int,
                *, min_data_parallel: int = 1,
                dropped: Sequence[int] = ()) -> RemeshPlan:
    """Largest power-of-two data axis that the surviving chips support,
    keeping the model (TP) axis intact. Batch stays divisible by rounding
    down to a multiple of the new data axis."""
    chips = len(alive_hosts) * chips_per_host
    if chips < model_axis * min_data_parallel:
        raise RuntimeError(
            f"only {chips} chips alive; need >= {model_axis * min_data_parallel}")
    data = chips // model_axis
    # keep power-of-two data axis for clean batch math
    p = 1
    while p * 2 <= data:
        p *= 2
    data = p
    used_hosts = alive_hosts[: (data * model_axis) // chips_per_host]
    gb = max((global_batch // data) * data, data)
    return RemeshPlan(data, model_axis, tuple(used_hosts), gb,
                      tuple(dropped))


# ---------------------------------------------------------------------------
# stragglers
# ---------------------------------------------------------------------------

class StragglerDetector:
    """Median + MAD over per-host step durations; robust to the stragglers
    it is trying to detect."""

    def __init__(self, hosts: Sequence[int], k: float = 4.0,
                 patience: int = 5):
        self.k = k
        self.patience = patience
        self.strikes: Dict[int, int] = {h: 0 for h in hosts}

    def observe(self, step_times: Dict[int, float]) -> List[int]:
        import numpy as np
        vals = np.array(list(step_times.values()))
        med = float(np.median(vals))
        mad = float(np.median(np.abs(vals - med))) + 1e-9
        flagged = []
        for h, t in step_times.items():
            if (t - med) / (1.4826 * mad) > self.k:
                self.strikes[h] = self.strikes.get(h, 0) + 1
            else:
                self.strikes[h] = 0
            if self.strikes.get(h, 0) >= self.patience:
                flagged.append(h)
        return sorted(flagged)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

class PreemptionGuard:
    """``with PreemptionGuard() as g: ... if g.requested: save+exit``."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self.requested = False
        self._old = {}

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        for s in self.signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, old in self._old.items():
            signal.signal(s, old)
        return False
