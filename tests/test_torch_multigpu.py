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
  local round r holds global round r's path-length rows); and the
  relativistic modes, whose losses take each side's mean over the global
  batch (``mesh.global_mean``): ragan at A = 2 (each round's own global
  rows), rahinge, ralsgan with the path-length penalty.  In those modes a
  constant added to every logit cancels from each difference, so D's last
  bias has a gradient of exactly 0 in one process, and the ranks' sum of
  cancelling terms rounds: that leaf is held at 1e-5 of D's largest
  gradient; Adam then moves the bias by up to one learning rate, so the
  raw logit means logged at step 2 (``loss/D/output/*``) are held at that
  much more (the losses, which the bias cancels from, keep 1e-6).
* The same two-rank step against the JAX package's step
  (``make_train_step``) on the whole batch: ``torch_parity``'s
  ``dusty2_accum2_pl`` (DUSty-II, A = 2, path-length penalty, two steps)
  and one case of each relativistic mode (``JAX_RELATIVISTIC``) with JAX's
  draws, each rank on its rows of them, rank 0 held by the checks and
  tolerances of ``tests/test_torch_train_step.py`` (scalars, weights,
  Adam's moments: after one step with beta1 = 0 the first moments are the
  gradients), the two ranks bit-equal.
* ``mesh.global_mean`` on two ranks: its input gradients against autograd
  of the summed losses in one process (rtol 1e-6, atol 1e-7), which holds
  that its all-reduce's backward sums; a chunk's stop buffer votes.

``cli.train`` on two ranks, per step and in chunks, is tested in
``tests/test_torch_multigpu_cli.py``, the evaluation CLIs' ``--multihost``
in ``tests/test_torch_parallel.py``.
"""

import json
import os.path as osp
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dusty_gan_torch.config import compose
from dusty_gan_torch.data.datasets import define_dataset
from dusty_gan_torch.data.loader import Loader
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.models.losses import RELATIVISTIC
from dusty_gan_torch.parallel import mesh
from dusty_gan_torch.train.trainer import Trainer

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import (check_step_adam, check_step_discriminator, check_step_generators,
                          check_step_scalars, jax_step_case, run_ranks, update_slack)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG_DIR = osp.join(REPO, "configs")
TINY = ["model=dusty2_dcgan_eqlr", "model.gen.in_ch=16", "model.gen.ch_base=8",
        "model.gen.ch_max=16", "model.dis.ch_base=8", "model.dis.ch_max=16"]
# batch, rounds, pl weight, gan_mode
STEP_CASES = {"A1_pl": (4, 1, 1.0, "nsgan"), "A2": (8, 2, 0.0, "nsgan"),
              "A2_pl": (8, 2, 1.0, "nsgan"), "ragan_A2": (8, 2, 0.0, "ragan"),
              "rahinge": (4, 1, 0.0, "rahinge"), "ralsgan_pl": (4, 1, 1.0, "ralsgan")}
JAX_CASE = "dusty2_accum2_pl"  # torch_parity.STEP_CASES: A = 2 with the path-length term
# torch_parity.STEP_CASES of the relativistic modes: ragan at A = 2 (the
# mean over each round's global rows), rahinge on the plain generator,
# ralsgan on DUSty-I with the path-length term
JAX_RELATIVISTIC = {"ragan": "dusty2_ragan_accum2", "rahinge": "plain_rahinge",
                    "ralsgan": "dusty1_ralsgan_pl"}
CHUNKED = ["steps_per_call=2", "cache_device=true"]

CHILD_STEP = """
import json, sys
import numpy as np, torch
import torch.nn.functional as F
from dusty_gan_torch.config import compose
from dusty_gan_torch.parallel import mesh
from dusty_gan_torch.train.step import TrainStep, local_draws
from dusty_gan_torch.train.trainer import Trainer

mesh.init_distributed("cpu")
cases = json.loads(sys.argv[2])


def rank_rows(n, rounds):
    # this rank's rows of a global batch of n: its share of each round
    b = n // rounds
    return np.concatenate([np.arange(b)[mesh.local_batch_slice(b)] + r * b
                           for r in range(rounds)])


for name, overrides in cases.items():
    trainer = Trainer(compose(sys.argv[1], overrides), torch.device("cpu"), verbose=False)
    with np.load(sys.argv[3] % name) as z:
        batches = [z["b1"], z["b2"]]
    rows = rank_rows(batches[0].shape[0], trainer.num_accumulation)
    out = {"scalars1": trainer.step(1, {"depth": batches[0][rows]})}
    st = trainer.state
    out["grads"] = {f"{m}.{n}": p.grad.clone() for m, net in (("G", st.G), ("D", st.D))
                    for n, p in net.named_parameters()}
    out["scalars2"] = trainer.step(2, {"depth": batches[1][rows]})
    out["state"] = {m: getattr(st, m).state_dict() for m in ("G", "D", "G_ema")}
    out["pl_ema"] = st.pl_ema
    torch.save(out, sys.argv[4] % (name, mesh.rank()))
for name, case in torch.load(sys.argv[5], weights_only=False).items():
    step, state = case["step"], case["state"]
    step.distributed = True  # made outside the group
    scalars = []
    for batch, draws in case["inputs"]:
        rows = rank_rows(batch["depth"].shape[0], step.A)
        scalars.append(step(state, {"depth": batch["depth"][rows]},
                            local_draws(draws, mesh.rank(), mesh.world_size())))
    torch.save({"state": state, "scalars": scalars}, sys.argv[4] % ("jax_" + name, mesh.rank()))

# global_mean: forward and the gradient of this rank's loss
gen = torch.Generator().manual_seed(0)
x, w = torch.randn(8, 3, generator=gen), torch.rand(8, 3, generator=gen)
rows = mesh.local_batch_slice(8)
xr = x[rows].clone().requires_grad_(True)
m = mesh.global_mean(xr)
(F.softplus(xr - m) * w[rows]).mean().backward()
out = {"mean": m.detach(), "grad": xr.grad}

# a chunk with rank 1's stop flag set, then one with none set
cfg = compose(sys.argv[1], cases["A2"] + CHUNKED)
trainer = Trainer(cfg, torch.device("cpu"), verbose=False)
ix = trainer.loader.index_stream(0)
for k, stop in ((1, mesh.rank() == 1), (3, False)):
    rows = np.stack([trainer.device_cache.rows(*next(ix)) for _ in range(2)])
    out[f"agreed_{k}"] = trainer.step_chunk([k, k + 1], rows, stop=stop)["stop/agreed"]
torch.save(out, sys.argv[4] % ("global", mesh.rank()))
mesh.shutdown()
""".replace("CHUNKED", repr(CHUNKED))

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_synthetic_kitti(str(tmp_path_factory.mktemp("multigpu") / "data"),
                                 n_scans_per_seq=16, w0=512, sequences=(0, 8))


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    return tmp_path_factory.mktemp("shim")


def _step_overrides(root, name):
    batch, rounds, pl, mode = STEP_CASES[name]
    return TINY + [f"dataset.root={root}", "enable_amp=false", "cache_dataset=false",
                   f"solver.batch_size={batch}", f"solver.num_accumulation={rounds}",
                   f"solver.loss.pl={pl}", f"solver.gan_mode={mode}"]


@pytest.fixture(scope="module")
def step_runs(root, shim, tmp_path_factory):
    """Each case's two batches, and its two steps on two ranks; ``JAX_CASE``
    and ``JAX_RELATIVISTIC`` run in JAX, their steps on two ranks;
    ``global_mean`` on two ranks; two chunks with stop flags (one launch
    for all)."""
    base = tmp_path_factory.mktemp("steps")
    jax_cases = {name: jax_step_case(name, jit=True)
                 for name in (JAX_CASE, *JAX_RELATIVISTIC.values())}
    torch.save({name: {"state": c.state, "step": c.step, "inputs": c.inputs}
                for name, c in jax_cases.items()}, base / "jax_case.pt")
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
    return base, overrides, batches, jax_cases


@pytest.fixture(scope="module", params=sorted(STEP_CASES))
def step_case(request, step_runs):
    """One case's two ranks, and one process on the whole batches."""
    base, overrides, batches, _ = step_runs
    name = request.param
    ranks = [torch.load(base / f"{name}_{r}.pt", weights_only=False) for r in range(2)]
    cfg = compose(CONFIG_DIR, overrides[name])
    one = Trainer(cfg, torch.device("cpu"), verbose=False)
    want = {"scalars1": one.step(1, {"depth": batches[name][0]}),
            "relativistic": STEP_CASES[name][3] in RELATIVISTIC,
            "lr_D": float(cfg.solver.lr.alpha.dis)}
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
    d_max = max(float(g.abs().max()) for k, g in want["grads"].items() if k.startswith("D."))
    for k, g in want["grads"].items():
        assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k]), k
        atol = max(1e-7, 1e-5 * float(g.abs().max()))
        if want["relativistic"] and not g.any():
            # D's last bias: a constant added to every logit cancels from
            # each relativistic difference, so one process's gradient is
            # exactly 0 and the ranks' sum of cancelling terms rounds
            atol = 1e-5 * d_max
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
            atol = 1e-6
            if want["relativistic"] and step == "scalars2" and "/output/" in k:
                # the raw logits carry D's last bias, which step 1 moved by
                # up to one learning rate on the ranks' rounding (above)
                atol += want["lr_D"]
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=atol,
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
    return _jax_ranks(step_runs, JAX_CASE)


def _jax_ranks(step_runs, name):
    base, _, _, cases = step_runs
    case = cases[name]
    ranks = [torch.load(base / f"jax_{name}_{r}.pt", weights_only=False) for r in range(2)]
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
    _assert_ranks_equal(jax_ranks[1])


@pytest.fixture(scope="module", params=sorted(JAX_RELATIVISTIC))
def jax_relativistic(request, step_runs):
    """A relativistic mode's JAX case on two ranks (see ``jax_ranks``)."""
    return _jax_ranks(step_runs, JAX_RELATIVISTIC[request.param])


@pytest.mark.parametrize("check", [check_step_scalars, check_step_generators,
                                   check_step_discriminator, check_step_adam],
                         ids=lambda f: f.__name__)
def test_relativistic_two_ranks_match_jax_step(jax_relativistic, check):
    """Each side's mean over the global batch: the two ranks' step against
    JAX's on the whole batch (Adam's first moments are the gradients)."""
    check(jax_relativistic[0])


def test_relativistic_two_ranks_are_equal(jax_relativistic):
    _assert_ranks_equal(jax_relativistic[1])


def _assert_ranks_equal(ranks):
    a, b = ranks
    for m in ("G", "D", "G_ema"):
        for k, v in getattr(a["state"], m).state_dict().items():
            assert torch.equal(v, getattr(b["state"], m).state_dict()[k]), (m, k)
    assert torch.equal(a["state"].pl_ema, b["state"].pl_ema)
    for sa, sb in zip(a["scalars"], b["scalars"]):
        assert all(torch.equal(v, sb[k]) for k, v in sa.items())


def test_global_mean_gradient_sums_over_ranks(step_runs):
    """``mesh.global_mean`` on two ranks: the forward is the whole batch's
    mean, and each rank's input gradient of its own loss equals the rows
    of the gradient of the sum of both ranks' losses in one process (so
    the all-reduce's backward sums; with the step's 1/W average of the
    parameter gradients, that is the gradient of the mean loss)."""
    base = step_runs[0]
    ranks = [torch.load(base / f"global_{r}.pt", weights_only=False) for r in range(2)]
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(8, 3, generator=gen), torch.rand(8, 3, generator=gen)
    x.requires_grad_(True)
    m = x.mean(dim=0, keepdim=True)
    total = 0.0
    for r in range(2):
        rows = mesh.local_batch_slice(8, r, 2)
        total = total + (F.softplus(x[rows] - m) * w[rows]).mean()
    total.backward()
    for r, got in enumerate(ranks):
        rows = mesh.local_batch_slice(8, r, 2)
        np.testing.assert_allclose(got["mean"].numpy(), m.detach().numpy(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(got["grad"].numpy(), x.grad[rows].numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_chunk_stop_buffer_votes(step_runs):
    """A chunk on two ranks where rank 1 alone passed its stop flag
    returns ``stop/agreed`` 0.5 on both; the next chunk, with no flag,
    0."""
    base = step_runs[0]
    for r in range(2):
        got = torch.load(base / f"global_{r}.pt", weights_only=False)
        assert float(got["agreed_1"]) == 0.5 and float(got["agreed_3"]) == 0.0, got
