"""The reduction of a ``torch.profiler`` trace of the traced steps to
what the per-layer metrics and the breakdown read.

The trace records the device's activity alone (``ProfilerActivity.CUDA``:
kernels, copies, sets, and the host's CUDA runtime calls), which costs
the host far less than recording every host operation. The traced window
runs from the end of the first ``cudaDeviceSynchronize`` to the end of
the last, which the kind places before the first traced step and after
each. Busy time is the union of the device operations' intervals inside
the window; an idle gap is named after the host's last runtime call
when it begins: ``in cudaLaunchKernel`` while one runs, ``after
cudaStreamSynchronize`` once one has returned."""
from __future__ import annotations

import bisect
from collections import defaultdict

SYNC = "cudaDeviceSynchronize"


def _is_device(e) -> bool:
    return str(e.device_type()).rsplit(".", 1)[-1] in ("CUDA", "PrivateUse1")


def reduce(events, steps: int) -> dict:
    """``events``: the profiler's kineto events (``prof.profiler.
    kineto_results.events()``). Returns ``window_s``, ``busy_s``,
    ``steps``, ``device_s`` (seconds by device operation name, summed)
    and ``idle_gap_s`` (seconds of idle gaps by the host's runtime
    call)."""
    syncs = sorted(e.start_ns() + e.duration_ns() for e in events
                   if e.name() == SYNC and not _is_device(e))
    if len(syncs) < 2:
        raise RuntimeError(f"the trace holds {len(syncs)} {SYNC} calls, "
                           f"not the two that bound the window")
    w0, w1 = syncs[0], syncs[-1]
    dev, host = [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if d <= 0 or s + d <= w0 or s >= w1 or e.is_user_annotation():
            continue
        if _is_device(e):
            dev.append((max(s, w0), min(s + d, w1), e.name()))
        else:
            host.append((s, s + d, e.name()))
    device_s = defaultdict(float)
    for s, t, name in dev:
        device_s[name] += (t - s) * 1e-9
    # union of the device intervals, and the gaps between them
    busy, gaps, cur = 0, [], w0
    for s, t, _ in sorted(dev):
        if s > cur:
            gaps.append((cur, s))
        if t > cur:
            busy += t - max(s, cur)
            cur = t
    if cur < w1:
        gaps.append((cur, w1))
    host.sort()
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0) - 1
        if i < 0:
            name = "(no runtime call yet)"
        else:
            name = ("in " if host[i][1] > g0 else "after ") + host[i][2]
        idle[name] += (g1 - g0) * 1e-9
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9,
            "steps": steps, "device_s": dict(device_s),
            "idle_gap_s": dict(idle)}


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
