"""The program's own spans and counters (``dusty_gan_torch/utils/
profiling.py``) in a cell's traced run, read by the per-layer metrics of
``METRICS``.

``segments(fn, synchronize, units)`` runs a cell's traced segment again
(``fn``: ``units`` chunks or rounds) twice with the program's tracer on:

1. without a profiler: the spans' host seconds by name and the counters,
   the context's ``program``;
2. under torch.profiler, where each span is a user annotation: each idle
   stretch of the segment's window (the gaps between the device's busy
   intervals, the union of its events as ``trace.reduce_events`` takes
   them, and the stretches from the window's start to the first event and
   from the last to its end) is put down to the innermost span open at
   its middle, or to none, the context's ``program_idle``.

``attribute``, ``recorded``, ``profiled``, ``segments`` and ``METRICS``
are what a driver's ``traced`` is to call.  It does not call them yet: the
drivers and the entries of ``BENCHMARK.json`` are files this benchmark
already has.  Until then the command

    python3 -m gpubench.spans --workload <cell> --seed <n> --seconds <s>

runs a cell as ``python3 -m gpubench.run ... --trace 1`` does, through
the harness, with a driver whose ``traced`` runs the two segments after
its own (which keeps the tracer off, so its breakdown still names the
host's operators), and with ``METRICS`` among the per-layer metrics; the
synthesis driver's check still reads the traced segment's round.  Its
result line adds ``program``: each span's milliseconds, the
counters, the idle milliseconds by span a unit, and the units a second
of segment 1 beside the window's and beside those of the segment run once
more with the tracer off, just before it (what tracing costs when on).
That scaffold (``run_cell``, ``main``, ``segment_of``, ``summary`` and the
driver subclass ``run_cell`` patches in) goes when the drivers' ``traced``
call ``segments`` themselves.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import importlib
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple
from unittest import mock

from gpubench import harness, trace

NO_SPAN = "(no span)"
WINDOW = "gpubench.segment"  # the annotation that marks a profiled segment's window
# CUPTI's event for a launch that waits until the device's command buffer
# has room: the host waits there for the device, as in a synchronise
BLOCKED = "Command Buffer Full"
TRAIN = ["dusty2_kitti.train", "dusty1_mpo.train"]
SYNTH = ["dusty2_kitti.synth_cd"]
METRICS = [
    {"name": "train_draws_ms_per_chunk", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "chunk loop", "moves": "train_scans_per_s",
     "workloads": TRAIN},
    {"name": "train_boundary_idle_ms_per_chunk", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "chunk loop", "moves": "train_scans_per_s",
     "workloads": TRAIN},
    {"name": "fps_idle_ms_per_round", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "FPS", "moves": "synth_pairs_per_s",
     "workloads": SYNTH},
    {"name": "fps_host_us_per_step", "unit": "us", "better": "lower",
     "source": "program_span", "layer": "FPS", "moves": "synth_pairs_per_s",
     "workloads": SYNTH},
    {"name": "cd_scores_ms_per_round", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "pairwise CD", "moves": "synth_pairs_per_s",
     "workloads": SYNTH},
]


def by_span(intervals: List[Tuple[float, float]],
            spans: List[Tuple[str, float, float]]) -> Dict[str, float]:
    """Seconds of ``intervals`` (start_us, end_us) by the innermost span
    open at each one's middle (``NO_SPAN`` where none is); ``spans``:
    (name, start_us, end_us), nested as one thread opens them."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    out: Dict[str, float] = collections.defaultdict(float)
    for a, b in intervals:
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        # the latest-starting span still open at mid is the innermost
        name = next((spans[j][0] for j in range(i - 1, -1, -1) if spans[j][2] >= mid),
                    NO_SPAN)
        out[name] += (b - a) / 1e6
    return dict(out)


def attribute(device: List[Tuple[str, float, float]],
              spans: List[Tuple[str, float, float]],
              window: Optional[Tuple[float, float]] = None) -> Tuple[Dict[str, float], float]:
    """Idle seconds by span (``by_span``) and busy seconds of ``device``'s
    events (name, start_us, end_us).  The idle stretches are the gaps
    between busy intervals and, given the ``window`` (start_us, end_us),
    its stretches before the first and after the last."""
    busy = trace._union([(a, b) for _, a, b in device])
    gaps = [(end, start) for (_, end), (start, _) in zip(busy, busy[1:])]
    if window is not None:
        edges = [busy[0][0], busy[-1][1]] if busy else [window[1], window[1]]
        gaps = [(window[0], edges[0])] + gaps + [(edges[1], window[1])]
    return by_span(gaps, spans), sum(b - a for a, b in busy) / 1e6


def _timed(fn: Callable[[], None], synchronize: Callable[[], None]) -> float:
    synchronize()
    t0 = time.perf_counter()
    fn()
    synchronize()
    return time.perf_counter() - t0


def recorded(fn, synchronize, units: int) -> dict:
    """Segment 1: ``fn`` with the tracer on and no profiler."""
    from dusty_gan_torch.utils import profiling

    profiling.drain()
    profiling.enable()
    try:
        window_s = _timed(fn, synchronize)
    finally:
        profiling.disable()
    rec = profiling.drain()
    spans_s = collections.defaultdict(list)
    for name, _, a, b in rec["spans"]:
        spans_s[name].append((b - a) / 1e9)
    return {"units": units, "window_s": window_s, "spans_s": dict(spans_s),
            "counters": rec["counters"]}


def profiled(fn, synchronize, units: int) -> dict:
    """Segment 2: ``fn`` with the tracer on under torch.profiler (CPU and
    CUDA): its idle seconds by span over the window, each span's host
    seconds, and the seconds launches waited for room in the device's
    command buffer (CUPTI's ``BLOCKED``) by span, which are the device's
    time, not the host's work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from dusty_gan_torch.utils import profiling

    profiling.drain()
    profiling.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                window_s = _timed(fn, synchronize)
    finally:
        profiling.disable()
    names = {s[0] for s in profiling.drain()["spans"]} | {WINDOW}
    device, spans, blocked, window = [], [], [], None
    for e in prof.events():
        interval = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name in names:  # an annotation; its copy on the device is no work
            if e.device_type != DeviceType.CPU:
                continue
            if e.name == WINDOW:
                window = interval[1:]
            else:
                spans.append(interval)
        elif e.name == BLOCKED:
            blocked.append(interval[1:])
        elif e.device_type == DeviceType.CUDA:
            device.append(interval)
    idle_s, busy_s = attribute(device, spans, window)
    spans_s = collections.defaultdict(list)
    for name, a, b in sorted(spans, key=lambda s: s[1]):
        spans_s[name].append((b - a) / 1e6)
    return {"units": units, "window_s": window_s, "busy_s": busy_s, "idle_s": idle_s,
            "spans_s": dict(spans_s), "blocked_s": by_span(blocked, spans)}


def segments(fn, synchronize, units: int) -> dict:
    """The context's ``program`` and ``program_idle``."""
    return {"program": recorded(fn, synchronize, units),
            "program_idle": profiled(fn, synchronize, units)}


def segment_of(run) -> Optional[tuple]:
    """(work, units, the window's units a second) of a driver's traced
    segment: ``trace_chunks`` chunks of a training cell, one round of the
    synthesis cell; None for a cell whose spans no metric reads."""
    ctx = run.context
    if hasattr(run, "_chunk"):
        n = int(run.traffic["trace_chunks"])
        return (lambda: [run._chunk() for _ in range(n)], n,
                ctx["window_steps"] / run.K / ctx["window_s"])
    if hasattr(run, "_round"):
        return run._round, 1, ctx["rounds"] / ctx["window_s"]
    return None


def summary(ctx: dict, units_per_s: dict) -> dict:
    """The segments' spans (milliseconds, each; segment 2's under the
    profiler), counters, idle and blocked milliseconds by span a unit, and
    units a second beside ``units_per_s``'s."""
    prog, idle = ctx["program"], ctx["program_idle"]
    ms = lambda d: {k: [x * 1e3 for x in v] for k, v in d.items()}  # noqa: E731
    per_unit = lambda d: {k: v / idle["units"] * 1e3 for k, v in d.items()}  # noqa: E731
    return {"span_ms": ms(prog["spans_s"]), "profiled_span_ms": ms(idle["spans_s"]),
            "counters": prog["counters"],
            "idle_ms_per_unit": per_unit(idle["idle_s"]),
            "blocked_ms_per_unit": per_unit(idle["blocked_s"]),
            "units_per_s": dict(units_per_s, traced=prog["units"] / prog["window_s"],
                                profiled=idle["units"] / idle["window_s"])}


def run_cell(name: str, seed: int, seconds: float, device, spec: Optional[dict] = None) -> dict:
    """``harness.run_cell`` with ``--trace 1``, the two segments after the
    driver's traced one, and ``METRICS`` among the per-layer metrics."""
    spec = spec or harness.cell_spec(name)
    bench = dict(spec["bench"], per_layer=spec["bench"]["per_layer"] + METRICS)
    spec = dict(spec, bench=bench)
    driver = importlib.import_module(f"gpubench.drivers.{spec['traffic']['driver']}")
    seen: dict = {}

    class Run(driver.Run):
        def traced(self):
            out = super().traced()
            segment = segment_of(self)
            if segment is not None:
                fn, units, window = segment
                last = getattr(self, "last", None)  # the round the check reads
                # the segment once more with the tracer off, against which
                # segment 1 shows what tracing costs
                plain = units / _timed(fn, self._sync)
                self.context.update(segments(fn, self._sync, units))
                if last is not None:
                    self.last = last
                seen["program"] = summary(self.context, {"window": window, "plain": plain})
            return out

    with mock.patch.object(driver, "Run", Run):
        out = harness.run_cell(name, seed, seconds, True, device, spec=spec)
    out.update(seen)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    harness.pin_caches()
    spec = harness.cell_spec(args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench.spans: {args.workload} needs {chips} CUDA device(s)", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, torch.device("cuda", 0), spec)
    found = harness.forbidden_modules()
    if found:
        print(f"gpubench.spans: the run loaded {found}", file=sys.stderr)
        return 4
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
