"""``cli.train`` on two CPU ranks over gloo (``parallel/mesh.py``), per
step and in chunks.

* ``num_devices=2 device=cpu``: rank 0 alone writes (each scalar logged
  once), a resumed run ends bit-identical to the uninterrupted one, a
  SIGTERM sent to rank 1 alone stops both ranks at one iteration with
  rank 0's checkpoint and exit 0 (``multihost=1`` ranks, as torchrun
  starts them), and ``multihost=1`` with a partial environment names what
  is missing.
* In chunks (``steps_per_call=2 cache_device=true``; on the CPU a chunk
  runs its steps eagerly through the graph's buffers): the run ends
  bit-identical to the per-step run and logs its scalars at chunk ends,
  and a SIGTERM to rank 1 stops both ranks at one chunk end, where rank
  0 checkpoints, with equal states (the JAX package's
  ``test_one_rank_sigterm_stops_chunk_pod``).

The train step on two ranks is tested in ``tests/test_torch_multigpu.py``,
the evaluation CLIs' ``--multihost`` in ``tests/test_torch_parallel.py``.
"""

import json
import os
import os.path as osp
import signal
import time

import pytest
import torch

from dusty_gan_torch.cli.train import main as train_main
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.parallel import mesh

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import launch_ranks, rank_env, wait_ranks

TINY = ["model=dusty2_dcgan_eqlr", "model.gen.in_ch=16", "model.gen.ch_base=8",
        "model.gen.ch_max=16", "model.dis.ch_base=8", "model.dis.ch_max=16"]
CADENCE = ["solver.batch_size=4", "solver.checkpoint.save_stats=2",
           "solver.checkpoint.test=4", "solver.checkpoint.save_model=3",
           "validate_samples=6", "device=cpu"]
CHUNKED = ["steps_per_call=2", "cache_device=true"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_synthetic_kitti(str(tmp_path_factory.mktemp("multigpu") / "data"),
                                 n_scans_per_seq=16, w0=512, sequences=(0, 8))


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    return tmp_path_factory.mktemp("shim")


def _train_args(root, run_dir, *extra):
    return [*TINY, f"dataset.root={root}", f"run_dir={run_dir}", *CADENCE, *extra]


@pytest.fixture(scope="module")
def spawned(root, shim, tmp_path_factory):
    """``num_devices=2``: a 6-iteration run, and one resumed from its
    iteration-3 checkpoint."""
    base = tmp_path_factory.mktemp("spawned")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in rank_env(shim).items():
            mp.setenv(k, v)
        full = train_main(_train_args(root, base / "full", "num_devices=2",
                                      "total_iterations=6"))
        mid = osp.join(full, "models", "checkpoint_0000000012.pth")
        resumed = train_main(_train_args(root, base / "resumed", "num_devices=2",
                                         "total_iterations=6", f"resume={mid}"))
    return full, resumed


def test_spawned_ranks_write_once(spawned):
    full, _ = spawned
    with open(osp.join(full, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    seen = [(r["step"], k) for r in rows for k in r if k not in ("t", "step")]
    assert len(seen) == len(set(seen))
    assert {s for s, _ in seen} == {4, 8, 16, 24}
    assert (16, "score/mmd-cd") in seen and (24, "perf/scans_per_sec") in seen
    assert osp.exists(osp.join(full, ".hydra", "config.yaml"))
    assert sorted(os.listdir(osp.join(full, "models"))) == [
        "checkpoint_0000000012.pth", "checkpoint_0000000024.pth"]
    ckpt = torch.load(osp.join(full, "models", "checkpoint_0000000024.pth"),
                      weights_only=True)
    assert ckpt["step"] == 24


def test_spawned_resume_is_bit_identical(spawned):
    a, b = (torch.load(osp.join(d, "models", "checkpoint_0000000024.pth"), weights_only=True)
            for d in spawned)
    for net in ("G", "D", "G_ema"):
        for k, v in a[net].items():
            assert torch.equal(v, b[net][k]), (net, k)
    for opt in ("optim_G", "optim_D"):
        for i, s in a[opt]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(s[k], b[opt]["state"][i][k]), (opt, i, k)


def test_sigterm_to_one_rank_stops_both(root, shim, tmp_path):
    run_dir = tmp_path / "run"
    procs = launch_ranks(["-m", "dusty_gan_torch.cli.train",
                          *_train_args(root, run_dir, "multihost=1", "total_iterations=400",
                                       "solver.checkpoint.test=1000", "preempt_sync=2")],
                         shim)
    try:
        deadline = time.monotonic() + 90
        while not osp.exists(run_dir / "scalars.jsonl") or \
                '"step": 8' not in (run_dir / "scalars.jsonl").read_text():
            assert time.monotonic() < deadline and procs[0].poll() is None
            time.sleep(0.2)
        os.kill(procs[1].pid, signal.SIGTERM)
    finally:
        res = wait_ranks(procs, timeout=90)
    assert [code for code, _ in res] == [0, 0], res[1][1][-3000:]
    k0 = [int(line.split("iteration ")[1].split(":")[0]) for line in res[0][1].splitlines()
          if line.startswith("SIGTERM: checkpointed")]
    k1 = [int(line.rsplit(" ", 1)[1]) for line in res[1][1].splitlines()
          if line.startswith("SIGTERM vote: rank 1 stopped")]
    assert len(k0) == 1 and k0 == k1 and k0[0] % 2 == 0 and 2 < k0[0] < 400
    assert osp.exists(run_dir / "models" / f"checkpoint_{k0[0] * 4:010d}.pth")
    assert "saved final" not in res[0][1]


def test_multihost_names_missing_environment(root, tmp_path, monkeypatch):
    for k in mesh.ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    with pytest.raises(SystemExit, match="missing: WORLD_SIZE, LOCAL_RANK, MASTER_ADDR"):
        train_main(_train_args(root, tmp_path, "multihost=1", "total_iterations=1"))
    assert not mesh.distributed()


@pytest.fixture(scope="module")
def chunk_spawned(root, shim, tmp_path_factory):
    """``num_devices=2 steps_per_call=2 cache_device=true``: the 6
    iterations of ``spawned``'s uninterrupted run in chunks of 2."""
    base = tmp_path_factory.mktemp("chunks")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in rank_env(shim).items():
            mp.setenv(k, v)
        return train_main(_train_args(root, base / "run", "num_devices=2", *CHUNKED,
                                      "total_iterations=6",
                                      "solver.checkpoint.save_model=6"))


def test_chunks_in_a_group_equal_per_step(chunk_spawned, spawned):
    """Chunks on two ranks end bit-identical to the per-step run on two
    ranks (on the CPU the chunk runs the same steps eagerly): weights,
    G_ema and Adam's moments."""
    a, b = (torch.load(osp.join(d, "models", "checkpoint_0000000024.pth"), weights_only=True)
            for d in (chunk_spawned, spawned[0]))
    for net in ("G", "D", "G_ema"):
        for k, v in a[net].items():
            assert torch.equal(v, b[net][k]), (net, k)
    for opt in ("optim_G", "optim_D"):
        for i, s in a[opt]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(s[k], b[opt]["state"][i][k]), (opt, i, k)


def test_chunks_in_a_group_log_the_per_step_scalars(chunk_spawned, spawned):
    """Rank 0 alone logs, at chunk ends, the global means the per-step run
    logged at those iterations (no ``stop/agreed``), validates once and
    writes the final checkpoint."""
    logs = []
    for d in (chunk_spawned, spawned[0]):
        with open(osp.join(d, "scalars.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        seen = [(r["step"], k) for r in rows for k in r if k not in ("t", "step")]
        assert len(seen) == len(set(seen))
        logs.append({r["step"]: {k: v for k, v in r.items() if k.startswith("loss/")}
                     for r in rows if any(k.startswith("loss/") for k in r)})
    chunked, per_step = logs
    assert sorted(chunked) == [8, 16, 24]
    assert all(chunked[s] == per_step[s] for s in chunked)
    with open(osp.join(chunk_spawned, "scalars.jsonl")) as f:
        text = f.read()
    assert "stop/agreed" not in text and text.count("score/mmd-cd") == 1
    assert os.listdir(osp.join(chunk_spawned, "models")) == ["checkpoint_0000000024.pth"]


CHILD_CLI = """
import sys
import dusty_gan_torch.cli.train as cli
from dusty_gan_torch.parallel import mesh
from dusty_gan_torch.train.checkpoint import save_checkpoint

made = []


class Recorded(cli.Trainer):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        made.append(self)


cli.Trainer = Recorded
rank = int(__import__("os").environ["RANK"])
cli.main(sys.argv[2:])
save_checkpoint(sys.argv[1] % rank, made[0].state, made[0].seed)
"""


def test_sigterm_to_one_rank_stops_both_chunk_runs(root, shim, tmp_path):
    """``multihost=1`` ranks in chunks of 2 (``preempt_sync=2``): a SIGTERM
    to rank 1 alone stops both at one chunk end, where rank 0 checkpoints;
    both ranks' states there are equal, and equal to the checkpoint (the
    JAX package's ``test_one_rank_sigterm_stops_chunk_pod``)."""
    run_dir = tmp_path / "run"
    procs = launch_ranks(["-c", CHILD_CLI, str(tmp_path / "state_%d.pth"),
                          *_train_args(root, run_dir, "multihost=1", *CHUNKED,
                                       "total_iterations=400", "preempt_sync=2",
                                       "solver.checkpoint.test=1000",
                                       "solver.checkpoint.save_model=1000")], shim)
    try:
        deadline = time.monotonic() + 90
        while not osp.exists(run_dir / "scalars.jsonl") or \
                '"step": 8' not in (run_dir / "scalars.jsonl").read_text():
            assert time.monotonic() < deadline and procs[0].poll() is None
            time.sleep(0.2)
        os.kill(procs[1].pid, signal.SIGTERM)
    finally:
        res = wait_ranks(procs, timeout=90)
    assert [code for code, _ in res] == [0, 0], res[1][1][-3000:]
    k0 = [int(line.split("iteration ")[1].split(":")[0]) for line in res[0][1].splitlines()
          if line.startswith("SIGTERM: checkpointed")]
    k1 = [int(line.rsplit(" ", 1)[1]) for line in res[1][1].splitlines()
          if line.startswith("SIGTERM vote: rank 1 stopped")]
    assert len(k0) == 1 and k0 == k1 and k0[0] % 2 == 0 and 2 < k0[0] < 400
    assert "saved final" not in res[0][1]
    ckpt = torch.load(run_dir / "models" / f"checkpoint_{k0[0] * 4:010d}.pth",
                      weights_only=True)
    states = [torch.load(tmp_path / f"state_{r}.pth", weights_only=True) for r in range(2)]
    for net in ("G", "D", "G_ema"):
        for k, v in ckpt[net].items():
            assert torch.equal(states[0][net][k], v) and torch.equal(states[1][net][k], v), \
                (net, k)
