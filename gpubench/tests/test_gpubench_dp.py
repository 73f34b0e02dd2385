"""The data-parallel training cell (``dusty2_kitti.train_dp4``, driver
``train_chunks_dp``) on the CPU: two ranks over gloo at tiny widths.  A
sound run is correct with every rank's weights equal to rank 0's; a rank
that keeps its own gradients fails ``rank_gap``; a rank that dies ends the
run within its timeout."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
import time

import torch

from gpubench import harness
from gpubench.conftest import shrink
from gpubench.drivers import train_chunks_dp

CPU = torch.device("cpu")
CELL = "dusty2_kitti.train_dp4"
SEED = 2 ** 31 + 17


def dp_spec(**traffic) -> dict:
    """The cell at tiny widths on two ranks."""
    spec = shrink(harness.cell_spec(CELL))
    spec["traffic"].update(ranks=2, group_timeout_s=60, deadline_s=240)
    spec["traffic"].update(traffic)
    return spec


def test_two_ranks_run_correct_with_equal_weights():
    torch.set_num_threads(2)
    out = harness.run_cell(CELL, SEED, 0.2, True, CPU, spec=dp_spec())
    assert out["correct"], out["checks"]
    assert out["checks"]["rank_gap"]["value"] == 0.0
    assert list(out["checks"]) == list(train_chunks_dp.NUMBERS)
    assert {"train_host_ms_per_chunk", "device_idle_share.train"} <= set(out["metrics"])


SELFISH = textwrap.dedent("""
    import sys
    from dusty_gan_torch.parallel import mesh
    from gpubench.drivers import train_chunks_dp

    real = mesh.all_reduce_mean_

    def selfish(tensors):  # takes part in the all-reduce, keeps its own
        real([t.clone() for t in tensors])

    mesh.all_reduce_mean_ = selfish
    sys.exit(train_chunks_dp.main(sys.argv[1:]))
""")


def test_a_rank_that_keeps_its_own_gradients_fails_rank_gap(monkeypatch):
    torch.set_num_threads(2)
    argv = train_chunks_dp.child_argv
    monkeypatch.setattr(train_chunks_dp, "child_argv", lambda *a: [
        sys.executable, "-c", SELFISH] + argv(*a)[3:])
    out = harness.run_cell(CELL, SEED, 0.2, False, CPU, spec=dp_spec())
    c = out["checks"]["rank_gap"]
    assert not out["correct"] and c["value"] > c["limit"], out["checks"]


DEAD = textwrap.dedent("""
    import json, sys
    import torch
    from gpubench import harness
    from gpubench.drivers import train_chunks_dp

    train_chunks_dp.child_argv = lambda *a: [sys.executable, "-c", "raise SystemExit(1)"]
    spec = json.loads(sys.argv[1])
    spec["root"] = harness.ROOT
    harness.run_cell(spec["cell"]["name"], 1, 0.2, False, torch.device("cpu"), spec=spec)
""")


def test_a_dead_rank_ends_the_run_within_its_timeout():
    spec = dp_spec(group_timeout_s=30)
    t0 = time.monotonic()
    done = subprocess.run([sys.executable, "-c", DEAD, json.dumps(spec, default=str)],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert done.returncode == train_chunks_dp.EXIT_RANK_LOST, done.stderr[-2000:]
    assert time.monotonic() - t0 < 30
    assert "exited with an error" in done.stderr
