"""Tolerance tuning against the JAX package, on the CPU.

* ``utils/tpe.py``: the same seed gives the JAX copy's trials exactly,
  sequential and batched.
* ``tolerance_scores`` (the objective 1-NNA + 100 MMD - COV + 10 JSD and its
  terms) on the same generated images, real clouds and real-real matrix
  against the composition of the JAX package's ``inv_to_xyz``, FPS,
  ``_pairwise_distance``, ``_compute_cov_mmd``, ``_compute_nna`` and
  ``compute_jsd``: within rtol 1e-4, with COV and the 1-NNA counts equal
  (the port forms distances from differences, JAX's CPU path as
  x^2 + y^2 - 2xy).
* A tiny CLI run writes the JAX CLI's JSON layout with the JAX CLI's
  trial keys and tolerances, TPE and random."""

import glob
import json
import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_tpu.cli.tune_tolerance import main as jax_main
from dusty_gan_tpu.geometry.lidar import Lidar as JaxLidar
from dusty_gan_tpu.geometry.lidar import tanh_to_sigmoid as jax_tanh_to_sigmoid
from dusty_gan_tpu.metrics.cov_mmd_1nna import (_compute_cov_mmd, _compute_nna,
                                                _pairwise_distance)
from dusty_gan_tpu.metrics.fps import downsample_point_clouds as jax_fps
from dusty_gan_tpu.metrics.jsd import compute_jsd as jax_jsd
from dusty_gan_tpu.utils import tpe as jax_tpe

from dusty_gan_torch.cli.tune_tolerance import main, tolerance_scores
from dusty_gan_torch.config import compose, save_config
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.geometry.lidar import Lidar
from dusty_gan_torch.models.factory import define_G
from dusty_gan_torch.utils import tpe

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG_DIR = osp.join(REPO, "configs")


def _bumpy(x: float) -> float:
    return float(np.sin(7 * np.log(x)) + (np.log(x) + 4.0) ** 2)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("seed", [0, 5])
def test_tpe_trials_equal_jax(batch, seed):
    kw = dict(num_samples=17, seed=seed, n_startup=5, log_space=True, batch=batch)
    evaluate = lambda xs: [_bumpy(x) for x in xs]  # noqa: E731
    got = tpe.tpe_minimize_batched(evaluate, 1e-3, 1e-1, **kw)
    want = jax_tpe.tpe_minimize_batched(evaluate, 1e-3, 1e-1, **kw)
    assert got == want
    assert tpe.tpe_minimize(_bumpy, 1e-3, 1e-1, num_samples=9, seed=seed, n_startup=3) == \
        jax_tpe.tpe_minimize(_bumpy, 1e-3, 1e-1, num_samples=9, seed=seed, n_startup=3)


def _grid(h, w):
    pitch = np.radians(np.linspace(2.0, -24.8, h))[:, None] * np.ones((1, w))
    yaw = np.linspace(np.pi, -np.pi, w, endpoint=False)[None, :] * np.ones((h, 1))
    return np.stack([pitch, yaw]).astype(np.float32)


def _images(rng, b, hw):
    """Inverse depth in [-1, 1] with dropped pixels at -1 and a spread of
    pixels just above it (1e-4 to 3e-1 after tanh_to_sigmoid), where the
    tolerance decides."""
    inv = rng.uniform(-0.2, 0.9, (b,) + hw + (1,))
    near = rng.rand(*inv.shape) < 0.3
    inv[near] = 2.0 * np.exp(rng.uniform(np.log(1e-4), np.log(3e-1), near.sum())) - 1.0
    inv[rng.rand(*inv.shape) < 0.15] = -1.0
    return inv.astype(np.float32)


@pytest.mark.parametrize("tol", [1e-3, 1.3e-2, 0.09])
def test_objective_equals_jax_composition(tol):
    hw, n_points, cd_batch = (16, 64), 96, 5
    rng = np.random.RandomState(0)
    ang = _grid(*hw)
    jl = JaxLidar.from_angle_array(ang, hw, 0.9, 120.0)
    tl = Lidar.from_angle_array(ang, hw, 0.9, 120.0)
    real_2d, fake_2d = _images(rng, 12, hw), _images(rng, 10, hw)

    def jax_points(inv, t):
        xyz = jl.inv_to_xyz(jnp.clip(jax_tanh_to_sigmoid(jnp.asarray(inv)), 0.0, 1.0), t)
        return jax_fps(xyz.reshape(xyz.shape[0], -1, 3), n_points)

    real_3d = jax_points(real_2d, 1e-8)
    fake_3d = jax_points(fake_2d, tol)
    m_rr = _pairwise_distance(real_3d, real_3d, cd_batch, ("cd",))["cd"]
    m_rg = _pairwise_distance(real_3d, fake_3d, cd_batch, ("cd",))["cd"]
    m_gg = _pairwise_distance(fake_3d, fake_3d, cd_batch, ("cd",))["cd"]
    want = {"jsd": float(jax_jsd(fake_3d / 2.0, real_3d / 2.0))}
    want.update({f"{k}-cd": v for k, v in _compute_cov_mmd(m_rg).items()})
    want.update({f"1-nn-{k}-cd": v for k, v in _compute_nna(m_rr, m_rg, m_gg).items()})
    want["score"] = (want["1-nn-accuracy-cd"] + 100.0 * want["mmd-cd"] - want["cov-cd"]
                     + 10.0 * want["jsd"])

    got = tolerance_scores(torch.from_numpy(fake_2d), torch.from_numpy(np.array(real_3d)),
                           m_rr, tol, tl, n_points, cd_batch)
    assert set(got) == set(want)
    for k in ("cov-cd", "1-nn-tp-cd", "1-nn-fp-cd", "1-nn-fn-cd", "1-nn-tn-cd",
              "1-nn-accuracy-cd"):
        assert got[k] == want[k], k
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7, err_msg=k)
    assert want["jsd"] > 0 and want["mmd-cd"] > 0


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A synthetic tree with a val split, its config and a reference-format
    .pth of a tiny DUSty-II generator with seeded random weights."""
    base = tmp_path_factory.mktemp("tune")
    root = build_synthetic_kitti(str(base / "data"), n_scans_per_seq=6, w0=512,
                                 sequences=(8,))
    cfg = compose(CONFIG_DIR, ["model=dusty2_dcgan_eqlr", "model.gen.in_ch=16",
                               "model.gen.ch_base=8", "model.gen.ch_max=16",
                               f"dataset.root={root}", "solver.batch_size=4"])
    cfg_path = save_config(cfg, str(base / "run"))
    cfg.model.gen.shape = list(cfg.dataset.shape)
    torch.manual_seed(0)
    sd = define_G(cfg).state_dict()
    pth = str(base / "checkpoint.pth")
    torch.save({"step": 8, "G": sd, "G_ema": sd}, pth)
    return {"base": base, "cfg": cfg_path, "pth": pth}


def _args(run, out, *extra):
    return ["--model-path", run["pth"], "--config-path", run["cfg"], "--save-dir-path",
            str(out), "--num-samples", "4", "--num-points", "32", "--cd-batch", "3",
            "--trial-batch", "1", *extra]


@pytest.mark.parametrize("algo", ["tpe", "random"])
def test_cli_writes_the_jax_clis_layout(run, tmp_path, algo):
    timings = {}
    best = main(_args(run, tmp_path / "torch", "--algo", algo, "--device", "cpu"),
                timings=timings)
    jax_main(_args(run, tmp_path / "jax", "--algo", algo))
    (got_path,) = glob.glob(str(tmp_path / "torch" / "tune_*.json"))
    (want_path,) = glob.glob(str(tmp_path / "jax" / "tune_*.json"))
    with open(got_path) as f:
        got = json.load(f)
    with open(want_path) as f:
        want = json.load(f)
    assert set(got) == set(want) == {"best", "trials"}
    assert len(got["trials"]) == len(want["trials"]) == 4
    assert [set(t) for t in got["trials"]] == [set(t) for t in want["trials"]]
    assert got["best"] == best == min(got["trials"], key=lambda t: t["score"])
    assert all(np.isfinite(v) for t in got["trials"] for v in t.values())
    # the tolerances drawn before any score steers the search are JAX's
    n_fixed = 4 if algo == "tpe" else 3
    np.testing.assert_allclose([t["tol"] for t in got["trials"][:n_fixed]],
                               [t["tol"] for t in want["trials"][:n_fixed]], rtol=1e-12)
    assert set(timings) == {"reals_s", "generation_s", "m_rr_s", "trials_s"}


def test_cli_refuses_cpu_fallback_without_gpu(run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="GPU"):
        main(_args(run, tmp_path))
