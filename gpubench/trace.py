"""The traced segment of a ``--trace 1`` run, reduced to numbers.

``torch.profiler`` records the host's operators and the device's kernels,
copies and memsets (CUPTI; kernels inside a replayed CUDA graph too).  The
device was busy for the union of its events' intervals, not their sum:
events on two streams can overlap.  The breakdown lists the device
operations that took most time, and the idle gaps between device events
by the outermost host operator running at the gap's middle: what the host
was doing while the device waited.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Callable, Dict, List, Tuple

TOP = 10


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_events(device: List[Tuple[str, float, float]], host: List[Tuple[str, float, float]],
                  window_s: float) -> Dict:
    """``device`` and ``host``: (name, start_us, end_us) events, host ones
    outermost per thread.  Returns busy_s, window_s, the device seconds by
    operation name and the breakdown."""
    busy = _union([(a, b) for _, a, b in device])
    busy_s = sum(b - a for a, b in busy) / 1e6
    by_op = collections.defaultdict(float)
    for name, a, b in device:
        by_op[name] += (b - a) / 1e6
    host = sorted(host, key=lambda e: e[1])
    starts = [e[1] for e in host]
    gaps = collections.defaultdict(float)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = (end + start) / 2
        i = bisect.bisect_right(starts, mid)
        # the latest-starting outermost operator that still runs at mid
        # (threads interleave, so look back over a few)
        name = next((host[j][0] for j in range(i - 1, max(i - 65, -1), -1)
                     if host[j][2] >= mid), "(no host operator)")
        gaps[name] += (start - end) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {"busy_s": busy_s, "window_s": window_s, "device_s_by_name": dict(by_op),
            "breakdown": {"device_ops": top(by_op), "idle_gaps": top(gaps)}}


def traced(fn: Callable[[], None], synchronize: Callable[[], None]) -> Dict:
    """Run ``fn`` under torch.profiler (CPU and CUDA) and reduce its trace;
    the window is ``fn`` and a synchronise, by the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        synchronize()
        t0 = time.perf_counter()
        fn()
        synchronize()
        window_s = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            device.append(span)
        elif e.cpu_parent is None:
            host.append(span)
    return reduce_events(device, host, window_s)
