"""The trace reduction on a made-up trace: the window between the first
and last device synchronise, busy time as the union of the device's
intervals, idle gaps named by the host's runtime calls."""
import pytest

from cardbench.harness import trace


class Ev:
    def __init__(self, name, start, dur, device=False, annotation=False):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._ann = device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._ann


def test_reduce_a_made_up_trace():
    s = 10 ** 9
    events = [
        Ev("cudaDeviceSynchronize", 0, s),                # window opens at 1 s
        Ev("cudaLaunchKernel", s, 10), Ev("gemm_bf16", s + 100, s, True),
        Ev("cudaLaunchKernel", s + 50, 10),
        Ev("add_f32", s + s // 2, s, True),               # overlaps the gemm
        Ev("cudaStreamSynchronize", 2 * s, s // 2),
        Ev("mul_f32", 3 * s, s // 2, True),               # 0.5 s gap before
        Ev("cudaDeviceSynchronize", 3 * s, s),            # window closes at 4 s
        Ev("outside", 5 * s, s, True),
        Ev("a mark", s, s, True, annotation=True),
    ]
    r = trace.reduce(events, 2)
    assert r["window_s"] == pytest.approx(3.0)
    assert r["busy_s"] == pytest.approx(1.5 - 1e-7 + 0.5)
    assert r["device_s"] == pytest.approx({"gemm_bf16": 1.0, "add_f32": 1.0,
                                           "mul_f32": 0.5})
    gaps = r["idle_gap_s"]
    assert gaps["in cudaLaunchKernel"] == pytest.approx(1e-7)
    assert gaps["after cudaStreamSynchronize"] == pytest.approx(0.5)
    assert gaps["in cudaDeviceSynchronize"] == pytest.approx(0.5)
    assert sum(gaps.values()) == pytest.approx(r["window_s"] - r["busy_s"])
    assert trace.top(r["device_s"], 2)[0][1] == pytest.approx(1.0)


def test_a_trace_without_its_bounds_is_refused():
    with pytest.raises(RuntimeError):
        trace.reduce([Ev("k", 0, 5, True)], 1)
