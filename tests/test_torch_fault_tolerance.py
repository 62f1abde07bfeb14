"""The port's fault-tolerance runtime (repro_torch.runtime.
fault_tolerance, a copy of the reference's): the reference's checks
(tests/test_fault_tolerance.py) re-run on the port, and the remesh plan
and straggler verdicts equal the reference's over a grid of inputs."""
import itertools
import os
import signal

import numpy as np
import pytest

from repro.runtime import fault_tolerance as rft
from repro_torch.runtime.fault_tolerance import (FaultToleranceConfig,
                                                 Heartbeats, PreemptionGuard,
                                                 StragglerDetector,
                                                 plan_remesh)


class TestHeartbeats:
    def test_detects_dead(self):
        t = [0.0]
        hb = Heartbeats([0, 1, 2], timeout_s=10, clock=lambda: t[0])
        t[0] = 5.0
        hb.beat(0)
        hb.beat(1)
        t[0] = 14.0
        assert hb.dead_hosts() == [2]
        assert hb.alive_hosts() == [0, 1]

    def test_recovery(self):
        t = [0.0]
        hb = Heartbeats([0, 1], timeout_s=1, clock=lambda: t[0])
        t[0] = 5.0
        assert hb.dead_hosts() == [0, 1]
        hb.beat(0)
        hb.beat(1)
        assert hb.dead_hosts() == []


class TestRemesh:
    def test_keeps_model_axis(self):
        plan = plan_remesh(list(range(31)), chips_per_host=8, model_axis=16,
                           global_batch=256)
        assert plan.model_axis == 16
        assert plan.data_axis * 16 <= 31 * 8
        assert plan.global_batch % plan.data_axis == 0

    def test_power_of_two_data_axis(self):
        plan = plan_remesh(list(range(13)), chips_per_host=4, model_axis=4,
                           global_batch=64)
        assert plan.data_axis & (plan.data_axis - 1) == 0

    def test_raises_when_insufficient(self):
        with pytest.raises(RuntimeError):
            plan_remesh([0], chips_per_host=4, model_axis=16, global_batch=8)

    @pytest.mark.parametrize("hosts,cph,model", [
        (1, 1, 1), (3, 8, 16), (64, 8, 16), (5, 3, 7), (1, 4, 16),
        (17, 2, 5), (64, 1, 1), (2, 8, 1)])
    def test_plan_always_fits_surviving_chips(self, hosts, cph, model):
        """The reference's property, on a fixed grid (hypothesis is not
        installed here)."""
        try:
            plan = plan_remesh(list(range(hosts)), chips_per_host=cph,
                               model_axis=model, global_batch=512)
        except RuntimeError:
            assert hosts * cph < model
            return
        assert plan.n_chips <= hosts * cph
        assert plan.model_axis == model


class TestStragglers:
    def test_flags_persistent_outlier(self):
        det = StragglerDetector([0, 1, 2, 3], k=3.0, patience=3)
        flagged = []
        for _step in range(5):
            flagged = det.observe({0: 1.0, 1: 1.02, 2: 0.98, 3: 5.0})
        assert flagged == [3]

    def test_transient_spike_not_flagged(self):
        det = StragglerDetector([0, 1, 2, 3], k=3.0, patience=3)
        det.observe({0: 1.0, 1: 1.0, 2: 1.0, 3: 9.0})
        flagged = det.observe({0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0})
        assert flagged == []


class TestPreemption:
    def test_sigterm_sets_flag(self):
        with PreemptionGuard() as g:
            assert not g.requested
            os.kill(os.getpid(), signal.SIGTERM)
            assert g.requested
        assert signal.getsignal(signal.SIGTERM) != g._handler


def test_remesh_plans_equal_the_reference():
    for hosts, cph, model, gb in itertools.product(
            (1, 2, 3, 7, 16, 33), (1, 4, 8), (1, 2, 16), (8, 100, 512)):
        alive = list(range(hosts))
        try:
            want = rft.plan_remesh(alive, cph, model, gb, dropped=(99,))
        except RuntimeError as e:
            with pytest.raises(RuntimeError, match=str(e)):
                plan_remesh(alive, cph, model, gb, dropped=(99,))
            continue
        got = plan_remesh(alive, cph, model, gb, dropped=(99,))
        assert (got.data_axis, got.model_axis, got.hosts, got.global_batch,
                got.dropped_hosts, got.n_chips) == \
            (want.data_axis, want.model_axis, want.hosts, want.global_batch,
             want.dropped_hosts, want.n_chips)


def test_straggler_verdicts_equal_the_reference():
    rng = np.random.default_rng(0)
    got_det = StragglerDetector(range(6), k=3.0, patience=2)
    want_det = rft.StragglerDetector(range(6), k=3.0, patience=2)
    for _ in range(40):
        times = {h: float(t) for h, t in enumerate(
            rng.gamma(4.0, 0.25, 6) * np.where(rng.random(6) < 0.15, 4, 1))}
        assert got_det.observe(times) == want_det.observe(times)
    assert got_det.strikes == want_det.strikes


def test_config_defaults_equal_the_reference():
    assert FaultToleranceConfig() == FaultToleranceConfig(
        **rft.FaultToleranceConfig().__dict__)
