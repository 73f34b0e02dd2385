"""The benchmark's machinery, shared by every cell and driven by data.

``BENCHMARK.json`` names the cells.  A cell ``<config>.<traffic>`` finds

* its configuration in the file its ``configs`` entry names
  (``gpubench/configs/<config>.json``),
* its traffic in ``gpubench/workloads/<cell>.json``, whose ``driver`` key
  names the module ``gpubench/drivers/<driver>.py`` that sets it up, runs
  its window and checks its outputs,
* each per-layer metric in ``gpubench/layer_metrics/<metric>.py``, whose
  ``read(ctx)`` returns the metric from the run's context, or None where
  the run has nothing for it to read.

A new cell, configuration or per-layer metric is new files and entries.

A run: the driver's ``setup`` (timed as ``setup_s``), its ``window``
(the end-to-end metrics; with ``--trace 1`` also the context the readers
read, and a profiled segment after the window), the device's memory
peak, ``release`` of the program's state, then ``check``: the comparison
with the plain reference, each number beside its limit.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dusty_gan_tpu")


def pin_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds; set before torch is imported."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, root: Path = ROOT) -> dict:
    """The cell's entry of BENCHMARK.json with its configuration (the
    file's content under ``config_data``) and its traffic (``traffic``)."""
    bench = load_json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {"bench": bench, "cell": cell, "config": config,
            "config_data": load_json(root / config["file"]),
            "traffic": load_json(root / "gpubench" / "workloads" / f"{name}.json"),
            "root": root}


def metrics_of(entries: List[dict], cell: str) -> List[dict]:
    """The entries whose ``workloads`` list the cell; an entry without the
    key (``setup_s``) is every cell's."""
    return [m for m in entries if cell in m.get("workloads", [cell])]


class Recorder:
    """Host-clock spans, in memory: (name, start, end)."""

    def __init__(self):
        self.spans: List[tuple] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def durations(self, name: str) -> List[float]:
        return [b - a for n, a, b in self.spans if n == name]


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30).stdout.split()
        return float(out[0]) if out else None
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def read_layer_metric(name: str, ctx: dict, root: Path = ROOT):
    path = root / "gpubench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_layer_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             root: Path = ROOT, spec: Optional[dict] = None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``spec`` replaces the files' (the tests shrink a cell)."""
    import torch

    spec = spec or cell_spec(name, root)
    driver = importlib.import_module(f"gpubench.drivers.{spec['traffic']['driver']}")
    rec = Recorder()
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)

    t0 = time.perf_counter()
    run = driver.Run(spec, int(seed), device, rec)
    run.setup()
    sync()
    setup_s = time.perf_counter() - t0
    e2e = run.window(float(seconds), bool(trace))
    sync()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    traced = run.traced() if trace else None
    run.release()
    t0 = time.perf_counter()
    checks = run.check()
    check_s = time.perf_counter() - t0
    correct = all(c["value"] <= c["limit"] for c in checks) and run.failed == 0

    bench, cell = spec["bench"], spec["cell"]["name"]
    values = dict(e2e, setup_s=setup_s)
    if trace:
        ctx = dict(run.context, trace=traced, setup_s=setup_s, **e2e)
        metrics = {}
        for m in metrics_of(bench["per_layer"], cell):
            v = read_layer_metric(m["name"], ctx, Path(spec.get("root", root)))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(bench["end_to_end"], cell) if m["name"] in values}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(spec["cell"]["chips"]), "memory_peak_bytes": int(peak),
           "power_limit_w": power_limit_w() if cuda else None}
    out = {"correct": bool(correct), "attempted": int(run.attempted), "failed": int(run.failed),
           "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        out["breakdown"] = traced["breakdown"]
    out["check_s"] = check_s
    if "setup_parts_s" in run.context:
        out["setup_parts_s"] = run.context["setup_parts_s"]
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def emit(result: dict) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error; then the result as the last line of standard output."""
    parts = result.get("setup_parts_s")
    if parts:
        print("setup parts (s): " + json.dumps(parts), file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
