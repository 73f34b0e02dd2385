"""Trace summaries (``dusty_gan_tpu/utils/profiling.py``): a torch.profiler
trace of a few train steps, read back as a per-op table without
TensorBoard: the device time a step, the time by the trace's event
category and the top ops.

``start_trace`` / ``stop_trace`` record CPU and, on a GPU, CUDA activity
and write a Chrome trace (``*.pt.trace.json``) into a directory;
``summarize_trace`` reads the newest one back.  On a GPU the ops are the
device events: kernels, memory copies and memsets (categories
``kernel``, ``gpu_memcpy``, ``gpu_memset``).  A CPU run's trace has none,
and there the ops are the outermost ``cpu_op`` events of each thread (the
operators the program called, without the ones nested in them).

The tracer: ``span(name)`` times a stretch of the program and ``count(name,
n)`` adds to a counter, at the places where the work happens
(``train/graphs.py``'s chunk, ``metrics/fps.py``, the scores of
``metrics/cov_mmd_1nna.py``).  Both are off until ``enable()``: a span is
then one flag check and a shared do-nothing context, a count one flag
check.  On, a span keeps (name, parent, start_ns, end_ns) in memory, by
``time.perf_counter_ns``, its parent the innermost span open on the same
thread; while a torch.profiler records, it also opens
``torch.profiler.record_function(name)``, so that the span is a user
annotation in the profiler's trace, on the clock of the device's kernels
and copies.  ``drain()`` returns what was recorded and clears it;
``disable()`` stops recording.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import os.path as osp
import threading
import time
from typing import Dict, List, Optional

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class _Record:
    """What the tracer recorded, and whether it records."""

    def __init__(self):
        self.on = False
        self.spans: List[tuple] = []
        self.counters: Dict[str, int] = collections.Counter()
        self.lock = threading.Lock()
        self.local = threading.local()  # each thread's stack of open spans

    def stack(self) -> List[str]:
        if not hasattr(self.local, "open"):
            self.local.open = []
        return self.local.open


_RECORD = _Record()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "parent", "start", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _RECORD.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _RECORD.stack().pop()
        with _RECORD.lock:
            _RECORD.spans.append((self.name, self.parent, self.start, end))
        return False


def span(name: str):
    """A context that records the stretch it encloses as span ``name``
    while the tracer is on."""
    if not _RECORD.on:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while the tracer is on."""
    if not _RECORD.on:
        return
    with _RECORD.lock:
        _RECORD.counters[name] += int(n)


def enable() -> None:
    _RECORD.on = True


def disable() -> None:
    _RECORD.on = False


def drain() -> Dict:
    """{"spans": [(name, parent, start_ns, end_ns)], "counters": {name: n}}
    recorded since the last drain, which this clears."""
    with _RECORD.lock:
        out = {"spans": list(_RECORD.spans), "counters": dict(_RECORD.counters)}
        _RECORD.spans.clear()
        _RECORD.counters.clear()
    return out


def start_trace(device):
    """A started torch.profiler profile of the CPU and, for a CUDA
    ``device``, the GPU."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, trace_dir: str, name: str) -> str:
    """Stop ``prof`` (after the caller has waited for the device) and write
    its Chrome trace ``<trace_dir>/<name>.pt.trace.json``; returns the path."""
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = osp.join(trace_dir, f"{name}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def _load_latest_trace(trace_dir: str) -> Optional[dict]:
    files = glob.glob(osp.join(trace_dir, "**", "*.pt.trace.json"), recursive=True)
    if not files:
        return None
    with open(max(files, key=osp.getmtime)) as f:
        return json.load(f)


def _outermost(events: List[dict]) -> List[dict]:
    """The events of each thread that no earlier event of it encloses."""
    out, ends = [], {}
    for e in sorted(events, key=lambda e: (e.get("pid"), e.get("tid"), float(e["ts"]))):
        thread, ts = (e.get("pid"), e.get("tid")), float(e["ts"])
        if ts >= ends.get(thread, float("-inf")):
            out.append(e)
            ends[thread] = ts + float(e.get("dur", 0.0))
    return out


def summarize_trace(trace_dir: str, top: int = 20, steps: int = 1) -> Optional[Dict]:
    """Op durations of the newest trace in ``trace_dir``, per step over
    ``steps`` captured steps; None when there is no trace or no op."""
    tr = _load_latest_trace(trace_dir)
    if tr is None:
        return None
    complete = [e for e in tr.get("traceEvents", []) if e.get("ph") == "X" and "ts" in e]
    ops = [e for e in complete if e.get("cat") in DEVICE_CATEGORIES]
    if not ops:
        ops = _outermost([e for e in complete if e.get("cat") == "cpu_op"])
    if not ops:
        return None

    by_cat, cat_n = collections.Counter(), collections.Counter()
    by_op, op_n = collections.defaultdict(float), collections.Counter()
    for e in ops:
        dur = float(e.get("dur", 0.0))
        cat, name = e.get("cat", "(uncategorized)"), e.get("name", "?")
        by_cat[cat] += dur
        cat_n[cat] += 1
        by_op[name] += dur
        op_n[name] += 1

    return {
        "total_ms_per_step": sum(by_cat.values()) / steps / 1e3,
        "num_op_events": len(ops),
        "by_category": [
            {"category": c, "us_per_step": round(d / steps, 1), "count": cat_n[c] // steps}
            for c, d in by_cat.most_common()
        ],
        "top_ops": [
            {"op": n, "us_per_step": round(d / steps, 1), "count": op_n[n] // steps}
            for n, d in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        ],
    }


def format_summary(summary: Dict, top: int = 12) -> str:
    lines: List[str] = [
        f"op time: {summary['total_ms_per_step']:.3f} ms/step "
        f"({summary['num_op_events']} op events)",
        "-- by category --",
    ]
    for row in summary["by_category"][:10]:
        lines.append(f"{row['us_per_step']:10.1f} us/step  x{row['count']:5d}  {row['category']}")
    lines.append("-- top ops --")
    for row in summary["top_ops"][:top]:
        lines.append(f"{row['us_per_step']:10.1f} us/step  x{row['count']:3d}  {row['op'][:90]}")
    return "\n".join(lines)
