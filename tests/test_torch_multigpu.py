"""Multi-process training and evaluation of dusty_gan_torch on the CPU,
two ranks over gloo (``parallel/mesh.py``).

* The train step: two ranks, each on its half of a global batch with its
  rows of the global draws (``Trainer.draws``), against one process on
  the whole batch with the same draws: the averaged gradients within
  rtol 1e-5 and an absolute 1e-5 of the leaf's largest gradient, at
  least 1e-7 (each rank's backward sums its half of the batch's pixels,
  and the mean of the two halves reassociates the sum: measured up to
  3.6e-6 of a leaf's largest gradient), the logged scalars (global means) within rtol 1e-5 / atol
  1e-6, the weights after two steps within the Adam slack of
  ``tests/test_torch_train_step.py`` (``torch_parity.update_slack``), taken
  at each step's own gradients (one D entry of the A = 2 path-length case
  has a first gradient of 1.1e-8, in eps's range, and a second of 1.5e-4,
  which its second moment shows alone), and
  the two ranks' weights, gradients and scalars bit-equal to each other.
  Cases: DUSty-II at A = 1 with the path-length penalty on (its baseline
  takes the mean over ranks), A = 2 accumulation rounds a rank, and A = 2
  with the path-length penalty (its baseline carried from round to round:
  local round r holds global round r's path-length rows).
* The same two-rank step against the JAX package's step
  (``make_train_step``) on the whole batch: ``torch_parity``'s
  ``dusty2_accum2_pl`` (DUSty-II, A = 2, path-length penalty, two steps)
  with JAX's draws, each rank on its rows of them, rank 0 held by the
  checks and tolerances of ``tests/test_torch_train_step.py``, the two
  ranks bit-equal.
* ``cli.train`` with ``num_devices=2 device=cpu``: rank 0 alone writes
  (each scalar logged once), a resumed run ends bit-identical to the
  uninterrupted one, a SIGTERM sent to rank 1 alone stops both ranks at
  one iteration with rank 0's checkpoint and exit 0 (``multihost=1``
  ranks, as torchrun starts them), ``steps_per_call=2`` in a group
  raises, and ``multihost=1`` with a partial environment names what is
  missing.  A relativistic loss refuses more than one rank.

The evaluation CLIs' ``--multihost`` is tested in
``tests/test_torch_parallel.py``.
"""

import json
import os
import os.path as osp
import signal
import time
import types

import numpy as np
import pytest
import torch

from dusty_gan_torch.cli.train import main as train_main
from dusty_gan_torch.config import compose
from dusty_gan_torch.data.datasets import define_dataset
from dusty_gan_torch.data.loader import Loader
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.parallel import mesh
from dusty_gan_torch.train.step import TrainStep
from dusty_gan_torch.train.trainer import Trainer

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import (check_step_adam, check_step_discriminator, check_step_generators,
                          check_step_scalars, jax_step_case, launch_ranks, rank_env,
                          run_ranks, update_slack, wait_ranks)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG_DIR = osp.join(REPO, "configs")
TINY = ["model=dusty2_dcgan_eqlr", "model.gen.in_ch=16", "model.gen.ch_base=8",
        "model.gen.ch_max=16", "model.dis.ch_base=8", "model.dis.ch_max=16"]
CADENCE = ["solver.batch_size=4", "solver.checkpoint.save_stats=2",
           "solver.checkpoint.test=4", "solver.checkpoint.save_model=3",
           "validate_samples=6", "device=cpu"]
# batch, rounds, pl weight
STEP_CASES = {"A1_pl": (4, 1, 1.0), "A2": (8, 2, 0.0), "A2_pl": (8, 2, 1.0)}
JAX_CASE = "dusty2_accum2_pl"  # torch_parity.STEP_CASES: A = 2 with the path-length term

CHILD_STEP = """
import json, sys
import numpy as np, torch
from dusty_gan_torch.config import compose
from dusty_gan_torch.parallel import mesh
from dusty_gan_torch.train.step import TrainStep, local_draws
from dusty_gan_torch.train.trainer import Trainer

mesh.init_distributed("cpu")
for name, overrides in json.loads(sys.argv[2]).items():
    trainer = Trainer(compose(sys.argv[1], overrides), torch.device("cpu"), verbose=False)
    with np.load(sys.argv[3] % name) as z:
        batches = [z["b1"], z["b2"]]
    rows = mesh.local_batch_slice(batches[0].shape[0])
    out = {"scalars1": trainer.step(1, {"depth": batches[0][rows]})}
    st = trainer.state
    out["grads"] = {f"{m}.{n}": p.grad.clone() for m, net in (("G", st.G), ("D", st.D))
                    for n, p in net.named_parameters()}
    out["scalars2"] = trainer.step(2, {"depth": batches[1][rows]})
    out["state"] = {m: getattr(st, m).state_dict() for m in ("G", "D", "G_ema")}
    out["pl_ema"] = st.pl_ema
    torch.save(out, sys.argv[4] % (name, mesh.rank()))
case = torch.load(sys.argv[5], weights_only=False)
step, state = case["step"], case["state"]
step.distributed = True  # made outside the group
scalars = []
for batch, draws in case["inputs"]:
    rows = mesh.local_batch_slice(batch["depth"].shape[0])
    scalars.append(step(state, {"depth": batch["depth"][rows]},
                        local_draws(draws, mesh.rank(), mesh.world_size())))
torch.save({"state": state, "scalars": scalars}, sys.argv[4] % ("jax", mesh.rank()))
mesh.shutdown()
"""

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_synthetic_kitti(str(tmp_path_factory.mktemp("multigpu") / "data"),
                                 n_scans_per_seq=16, w0=512, sequences=(0, 8))


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    return tmp_path_factory.mktemp("shim")


def _step_overrides(root, name):
    batch, rounds, pl = STEP_CASES[name]
    return TINY + [f"dataset.root={root}", "enable_amp=false", "cache_dataset=false",
                   f"solver.batch_size={batch}", f"solver.num_accumulation={rounds}",
                   f"solver.loss.pl={pl}"]


@pytest.fixture(scope="module")
def step_runs(root, shim, tmp_path_factory):
    """Each case's two batches, and its two steps on two ranks; and
    ``JAX_CASE`` run in JAX, its steps on two ranks (one launch for
    every case)."""
    base = tmp_path_factory.mktemp("steps")
    jax_case = jax_step_case(JAX_CASE, jit=True)
    torch.save({"state": jax_case.state, "step": jax_case.step, "inputs": jax_case.inputs},
               base / "jax_case.pt")
    overrides = {name: _step_overrides(root, name) for name in STEP_CASES}
    batches = {}
    for name, ov in overrides.items():
        cfg = compose(CONFIG_DIR, ov)
        it = Loader(define_dataset(cfg.dataset, phase="train"), cfg.solver.batch_size).epoch(0)
        batches[name] = [next(it)["depth"] for _ in range(2)]
        np.savez(base / f"batches_{name}.npz", b1=batches[name][0], b2=batches[name][1])
    run_ranks(["-c", CHILD_STEP, CONFIG_DIR, json.dumps(overrides),
               str(base / "batches_%s.npz"), str(base / "%s_%d.pt"),
               str(base / "jax_case.pt")], shim)
    return base, overrides, batches, jax_case


@pytest.fixture(scope="module", params=sorted(STEP_CASES))
def step_case(request, step_runs):
    """One case's two ranks, and one process on the whole batches."""
    base, overrides, batches, _ = step_runs
    name = request.param
    ranks = [torch.load(base / f"{name}_{r}.pt", weights_only=False) for r in range(2)]
    one = Trainer(compose(CONFIG_DIR, overrides[name]), torch.device("cpu"), verbose=False)
    want = {"scalars1": one.step(1, {"depth": batches[name][0]})}
    st = one.state
    want["grads"] = {f"{m}.{n}": p.grad.clone() for m, net in (("G", st.G), ("D", st.D))
                     for n, p in net.named_parameters()}
    want["scalars2"] = one.step(2, {"depth": batches[name][1]})
    want["grads2"] = {f"{m}.{n}": p.grad.clone() for m, net in (("G", st.G), ("D", st.D))
                      for n, p in net.named_parameters()}
    want["state"] = {m: getattr(st, m).state_dict() for m in ("G", "D", "G_ema")}
    want["pl_ema"] = st.pl_ema
    want["nu"] = {m: {n: opt.state[p]["exp_avg_sq"] for n, p in net.named_parameters()}
                  for m, net, opt in (("G", st.G, st.opt_G), ("D", st.D, st.opt_D))}
    return ranks, want


def test_step_gradients_equal_one_process(step_case):
    ranks, want = step_case
    assert set(ranks[0]["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k]), k
        atol = max(1e-7, 1e-5 * float(g.abs().max()))
        np.testing.assert_allclose(ranks[0]["grads"][k].numpy(), g.numpy(), rtol=1e-5,
                                   atol=atol, err_msg=k)


def test_step_scalars_are_global_means(step_case):
    ranks, want = step_case
    for step in ("scalars1", "scalars2"):
        got = {k: v for k, v in ranks[0][step].items() if k != "stop/agreed"}
        assert set(got) == set(want[step])
        assert float(ranks[0][step]["stop/agreed"]) == 0.0
        for k, v in want[step].items():
            assert torch.equal(ranks[0][step][k], ranks[1][step][k]), k
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_step_weights_after_two_steps(step_case):
    ranks, want = step_case
    for m in ("G", "D", "G_ema"):
        net = "D" if m == "D" else "G"
        steps = [{k[len(net) + 1:]: g for k, g in want[grads].items() if k.startswith(net + ".")}
                 for grads in ("grads", "grads2")]
        slack = update_slack(want["nu"][net], 2, steps)
        for k, w in want["state"][m].items():
            a, b = ranks[0]["state"][m][k], ranks[1]["state"][m][k]
            assert torch.equal(a, b), (m, k)
            tol = 1e-6 + 1e-5 * w.abs() + slack.get(k, 0.0)
            assert not bool(((a - w).abs() > tol).any()), (m, k, float((a - w).abs().max()))
    assert torch.equal(ranks[0]["pl_ema"], ranks[1]["pl_ema"])
    np.testing.assert_allclose(float(ranks[0]["pl_ema"]), float(want["pl_ema"]), rtol=1e-5)


@pytest.fixture(scope="module")
def jax_ranks(step_runs):
    """``JAX_CASE`` on two ranks, each on its rows of JAX's global draws, as
    ``torch_parity``'s checks take it (rank 0's state and scalars), and the
    two ranks' outputs."""
    base, _, _, case = step_runs
    ranks = [torch.load(base / f"jax_{r}.pt", weights_only=False) for r in range(2)]
    got = types.SimpleNamespace(**vars(case))
    got.state = ranks[0]["state"]
    got.scalars = [({k: v for k, v in sc.items() if k != "stop/agreed"}, jsc)
                   for sc, jsc in zip(ranks[0]["scalars"], case.jscalars)]
    return got, ranks


@pytest.mark.parametrize("check", [check_step_scalars, check_step_generators,
                                   check_step_discriminator, check_step_adam],
                         ids=lambda f: f.__name__)
def test_two_ranks_match_jax_step(jax_ranks, check):
    check(jax_ranks[0])


def test_two_ranks_of_jax_case_are_equal(jax_ranks):
    _, (a, b) = jax_ranks
    for m in ("G", "D", "G_ema"):
        for k, v in getattr(a["state"], m).state_dict().items():
            assert torch.equal(v, getattr(b["state"], m).state_dict()[k]), (m, k)
    assert torch.equal(a["state"].pl_ema, b["state"].pl_ema)
    for sa, sb in zip(a["scalars"], b["scalars"]):
        assert all(torch.equal(v, sb[k]) for k, v in sa.items())


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


def test_steps_per_call_in_a_group_raises(root, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_main(_train_args(root, tmp_path, "num_devices=2", "steps_per_call=2",
                               "cache_device=true", "total_iterations=2"))


def test_multihost_names_missing_environment(root, tmp_path, monkeypatch):
    for k in mesh.ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    with pytest.raises(SystemExit, match="missing: WORLD_SIZE, LOCAL_RANK, MASTER_ADDR"):
        train_main(_train_args(root, tmp_path, "multihost=1", "total_iterations=1"))
    assert not mesh.distributed()


@pytest.mark.parametrize("mode", ["ragan", "rahinge", "ralsgan"])
def test_relativistic_modes_refuse_more_than_one_rank(monkeypatch, mode):
    TrainStep(None, gan_mode=mode)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match=mode):
        TrainStep(None, gan_mode=mode)
    TrainStep(None, gan_mode="nsgan")
