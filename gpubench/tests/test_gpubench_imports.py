"""Nothing the benchmark loads is JAX or the JAX package, and its plain
reference loads nothing of the program: each module's top-level name (the
part before the first dot) is compared whole, in a fresh interpreter."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from gpubench import harness

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dusty_gan_tpu")

LOADED = """
import importlib, json, pkgutil, sys
import gpubench
for m in pkgutil.walk_packages(gpubench.__path__, "gpubench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
from gpubench import harness
bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
for m in bench["per_layer"]:
    harness.read_layer_metric(m["name"], {})
%s
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

RUN_A_CELL = """
import torch
from gpubench.conftest import shrink
spec = shrink(harness.cell_spec("dusty2_kitti.synth_cd"))
harness.run_cell("dusty2_kitti.synth_cd", 3, 0.2, False, torch.device("cpu"), spec=spec)
"""

REFERENCE = """
import importlib, json, pkgutil, sys
import gpubench.reference
for m in pkgutil.walk_packages(gpubench.reference.__path__, "gpubench.reference."):
    importlib.import_module(m.name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level_names(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_a_run_load_no_jax():
    names = top_level_names(LOADED % RUN_A_CELL)
    assert "dusty_gan_torch" in names  # the run did load the program
    assert not names & set(FORBIDDEN)


def test_the_reference_loads_neither_jax_nor_the_program():
    names = top_level_names(REFERENCE)
    assert not names & set(FORBIDDEN + ("dusty_gan_torch",))
