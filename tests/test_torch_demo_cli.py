"""dusty_gan_torch's demo CLI and the train CLI's image logging against the
JAX package's on the CPU, from one narrow DUSty-II checkpoint (a
JAX-initialised generator exported as a reference-format ``.pth``) on a
tiny synthetic tree.

Both demo CLIs run with JAX's draws (latents, corruption, z0, per-step
noise) and JAX's fixed Gumbel noise handed to the port, and with float32
generators on both sides (the CLIs' single-code generator is bf16 by
default, whose CPU rounding differs between the frameworks); the PNGs are
decoded with PIL and compared panel by panel.  ``Trainer.generate`` is held
against the JAX trainer's ``generate`` with the same latent and noise, and
the train CLI's image tags against the JAX CLI's, per step and in chunk
mode.  Each test states its tolerance."""

import functools
import glob
import importlib
import os.path as osp
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import dusty_gan_tpu.cli.train as jax_train_cli
import dusty_gan_tpu.geometry.normals as jax_normals
import dusty_gan_tpu.geometry.render as jax_render
import dusty_gan_tpu.utils.setup as jax_setup
from dusty_gan_tpu.cli import demo as jax_demo
from dusty_gan_tpu.core.dtypes import FP32_POLICY as JAX_FP32
from dusty_gan_tpu.data.datasets import define_dataset as jax_define_dataset
from dusty_gan_tpu.data.loader import Loader as JaxLoader
from dusty_gan_tpu.geometry.lidar import Lidar as JaxLidar
from dusty_gan_tpu.models.factory import define_G as jax_define_G
from dusty_gan_tpu.train.logging import RunLogger as JaxRunLogger
from dusty_gan_tpu.train.step import make_g_apply
from dusty_gan_tpu.train import trainer as jax_trainer_module
from dusty_gan_tpu.train.trainer import Trainer as JaxTrainer
from dusty_gan_tpu.utils.torch_import import generator_params_from_torch

import dusty_gan_torch.utils.setup as torch_setup
from dusty_gan_torch.cli import demo
from dusty_gan_torch.cli import train as train_cli
from dusty_gan_torch.config import compose, load_config, save_config
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.models.factory import define_G
from dusty_gan_torch.train.logging import RunLogger
from dusty_gan_torch.train.trainer import Trainer
from dusty_gan_torch.utils.weights import generator_state_dict

jax_postprocess_module = importlib.import_module("dusty_gan_tpu.utils.postprocess")

from tests.torch_parity import (JaxCorruptionDraws, jax_step_noise, nchw,  # noqa: F401
                                one_torch_thread, recorded_gumbel)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG_DIR = osp.join(REPO, "configs")
ARCH = "dusty2/dcgan_eqlr"
SHAPE = (32, 32)
IN_CH = 16
TINY = ["model=dusty2_dcgan_eqlr", f"model.gen.in_ch={IN_CH}", "model.gen.ch_base=8",
        "model.gen.ch_max=16", "model.dis.ch_base=8", "model.dis.ch_max=16",
        f"dataset.shape=[{SHAPE[0]},{SHAPE[1]}]", "solver.batch_size=8"]  # JAX: 8 devices
NUM_STEP = 3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic tree (train 00, val 08, test 11), a narrow DUSty-II config,
    a reference-format .pth of random weights and biases (initialised by the
    port: a JAX init compiles for seconds), the JAX generator, its params
    from the JAX package's importer, and its fixed Gumbel noise."""
    base = tmp_path_factory.mktemp("demo")
    root = build_synthetic_kitti(str(base / "data"), n_scans_per_seq=8, w0=512,
                                 sequences=(0, 8, 11))
    cfg = compose(CONFIG_DIR, TINY + [f"dataset.root={root}"])
    cfg_path = save_config(cfg, str(base / "run"))
    cfg.model.gen.shape = list(cfg.dataset.shape)
    with torch.random.fork_rng(devices=[]), torch.no_grad():
        torch.manual_seed(5)
        G = define_G(cfg)
        for p in G.parameters():
            p.add_(0.1 * torch.randn(p.shape))
    sd = G.state_dict()
    pth = str(base / "checkpoint.pth")
    torch.save({"step": 3, "G": sd, "G_ema": sd}, pth)
    jcfg = load_config(cfg_path)
    jcfg.model.gen.shape = list(jcfg.dataset.shape)
    Gj = jax_define_G(jcfg)
    params = generator_params_from_torch(sd, ARCH)
    return types.SimpleNamespace(base=base, root=root, cfg=cfg_path, pth=pth, Gj=Gj,
                                 params=params,
                                 noise=jax_setup.make_fixed_noise(Gj, SHAPE))


class JaxDemoDraws:
    """The draws of ``dusty_gan_tpu.cli.demo`` for ``--seed seed``, in the
    form of ``dusty_gan_torch.cli.demo.Draws``."""

    def __init__(self, seed, num_step):
        self.key = jax.random.PRNGKey(seed)
        self.num_step = num_step

    def latents(self, n, in_ch):
        return torch.from_numpy(np.array(jax.random.normal(self.key, (n, in_ch))))

    z0 = latents

    def corruption(self):
        return JaxCorruptionDraws(self.key)

    def noise(self, device):
        return jax_step_noise(jax.random.fold_in(self.key, 1), self.num_step, (1, IN_CH))


@pytest.fixture(scope="module", autouse=True)
def compiled_jax_helpers():
    """The JAX package's postprocess, normals and renderer, wherever its
    CLIs and trainer call them, as compiled programs: the same functions
    without a compile for each primitive and shape, which op by op costs
    ~50 ms each here."""
    post = jax.jit(jax_postprocess_module.postprocess, static_argnames=("normal_mode",))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_postprocess_module, "postprocess", post)
        mp.setattr(jax_trainer_module, "postprocess", post)
        mp.setattr(jax_normals, "xyz_to_normal",
                   jax.jit(jax_normals.xyz_to_normal, static_argnames=("mode",)))
        mp.setattr(jax_render, "render_point_clouds",
                   jax.jit(jax_render.render_point_clouds, static_argnames=("L",)))
        yield


def jax_apply_g(G):
    """``make_g_apply(G)``'s function, compiled."""
    return jax.jit(make_g_apply(G)[0], static_argnums=(3,), static_argnames=("train",))


@pytest.fixture
def float32_demos(tree, monkeypatch):
    """Both demo CLIs on float32 generators (the JAX one compiled), the
    port on JAX's fixed Gumbel noise."""
    make_gen = jax_setup.make_eval_generator
    monkeypatch.setattr(jax_setup, "make_eval_generator", lambda G, params, noise: jax.jit(
        make_gen(G, params, noise, compute_dtype=jnp.float32)))
    monkeypatch.setattr(demo, "make_eval_generator", functools.partial(
        torch_setup.make_eval_generator, compute_dtype=None))
    noise = {k: nchw(np.asarray(v)) for k, v in tree.noise.items()}
    monkeypatch.setattr(torch_setup, "make_fixed_noise",
                        lambda G, shape, device="cpu": {k: v.to(device) for k, v in noise.items()})


def _pngs(d):
    return {osp.basename(p): np.asarray(Image.open(p).convert("RGB")).astype(np.int64)
            for p in sorted(glob.glob(osp.join(d, "*.png")))}


def _hold_panels(got_dir, want_dir, max_share):
    """Equal panel names; per panel, the share of pixels that differ by
    more than one level in a channel at most ``max_share``."""
    got, want = _pngs(got_dir), _pngs(want_dir)
    assert sorted(got) == sorted(want) and got
    for name in want:
        assert got[name].shape == want[name].shape, name
        off = (np.abs(got[name] - want[name]) > 1).any(axis=-1)
        assert off.mean() <= max_share, (name, off.mean())
    return got


def _args(tree, mode, out, *extra):
    return [mode, "--model-path", tree.pth, "--config-path", tree.cfg, "--out", str(out),
            *extra]


def test_synthesis_against_jax_cli(tree, float32_demos, tmp_path):
    """``synthesis --latent-type slerp --video`` of 8 samples, top-down
    BEV: the same 7 panels a sample and the same video file; pixels differing by more than
    one level in at most 0.5% of a panel (a colour-map index that a
    float32 rounding moves across a step)."""
    extra = ["--num-samples", "8", "--latent-type", "slerp", "--video"]
    jax_demo.main(_args(tree, "synthesis", tmp_path / "jax", *extra))
    res = demo.main(_args(tree, "synthesis", tmp_path / "torch", *extra, "--device", "cpu"),
                    draws=JaxDemoDraws(0, 0))
    got = _hold_panels(tmp_path / "torch", tmp_path / "jax", 5e-3)
    assert len(got) == 8 * 7 and len(res.names) == 7
    videos = lambda d: sorted(osp.basename(p) for p in glob.glob(osp.join(d, "slerp.*")))  # noqa
    assert videos(tmp_path / "torch") == videos(tmp_path / "jax") == [osp.basename(res.video)]


def _final_loss(text):
    return float(re.search(r"final loss: \[([-0-9.e+]+)\]", text).group(1))


@pytest.mark.parametrize("case", [
    ("single", ["--corruption", "dropout", "--distance", "l1,l2,chamfer", "--view-zoom", "40",
                "--view-yaw", "-30", "--view-pitch", "50"]),
    ("multi", ["--corruption", "random lines", "--distance", "chamfer,l1", "--num-code", "3",
               "--compose-layer", "2"])], ids=lambda c: c[0])
def test_inversion_against_jax_cli(tree, float32_demos, tmp_path, capsys, case):
    """3 inversion steps of a corrupted test scan, single-code (BEV through
    a camera) and multi-code (chamfer on the nearest-neighbour plain
    version here): the same
    panels, pixels differing by more than one level in at most 1% of a
    panel (Adam's normalised steps amplify the Chamfer terms' rounding:
    JAX's CPU search forms x^2 + y^2 - 2xy); the single-code run's final
    loss within rtol 1e-4."""
    name, extra = case
    extra = [*extra, "--num-step", str(NUM_STEP), "--index", "1"]
    jax_demo.main(_args(tree, "inversion", tmp_path / "jax", *extra))
    jax_out = capsys.readouterr().out
    res = demo.main(_args(tree, "inversion", tmp_path / "torch", *extra, "--device", "cpu"),
                    draws=JaxDemoDraws(0, NUM_STEP))
    out = capsys.readouterr().out
    got = _hold_panels(tmp_path / "torch", tmp_path / "jax", 1e-2)
    assert set(got) == {f"{n}.png" for n in res.names} and len(got) == 7
    with torch.no_grad():
        assert float(res.loss(res.latent).sum()) < float(res.loss(res.start).sum())
    if name == "single":
        np.testing.assert_allclose(_final_loss(out), _final_loss(jax_out), rtol=1e-4)
    else:
        assert res.latent["alpha"].shape == (3, 16, 1, 1)  # ch(1) of the narrow G


def test_inversion_rejects_an_unknown_distance(tree, tmp_path):
    with pytest.raises(ValueError, match="huber"):
        demo.main(_args(tree, "inversion", tmp_path, "--distance", "l1,huber",
                        "--device", "cpu"))


def test_demo_refuses_cpu_fallback_without_gpu(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="GPU"):
        demo.main(_args(tree, "synthesis", tmp_path))


def test_seeded_draws():
    """The port's own draws repeat for a seed and differ across seeds and
    across the draws of one seed."""
    a, b = demo.Draws(0), demo.Draws(1)
    assert torch.equal(a.latents(2, 8), demo.Draws(0).latents(2, 8))
    assert not torch.equal(a.latents(2, 8), b.latents(2, 8))
    assert not torch.equal(a.latents(2, 8), a.z0(2, 8))
    n = a.noise("cpu")
    assert not torch.equal(n(0, (1, 8)), n(1, (1, 8)))


# ------------------------------------------------------------ image logging


def _trainer_cfg(tree, *extra):
    return compose(CONFIG_DIR, TINY + [f"dataset.root={tree.root}", *extra])


def test_generate_against_jax(tree):
    """``Trainer.generate(ema=False)`` with a latent and the Gumbel noise
    that JAX's ``generate`` draws from its key, in float32: every output
    within rtol 1e-5 / atol 1e-5, the mask exactly, the normal map within
    atol 1e-3 (the random masks leave three quarters of each cloud at the
    origin, so most normals are ill conditioned: float32 moves them by a
    few 1e-4).  The fixed latents repeat for a seed."""
    trainer = Trainer(_trainer_cfg(tree, "enable_amp=false", "cache_dataset=false"),
                      torch.device("cpu"), verbose=False)
    trainer.state.G.load_state_dict(generator_state_dict(tree.params, ARCH), strict=True)
    assert trainer.fixed_latent.shape == (8, IN_CH)
    again = Trainer(_trainer_cfg(tree, "cache_dataset=false"), torch.device("cpu"), verbose=False)
    assert torch.equal(trainer.fixed_latent, again.fixed_latent)
    z = np.random.RandomState(6).randn(8, IN_CH).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jlidar = JaxLidar.from_angle_file(osp.join(tree.root, "angles.npy"), SHAPE, 0.9, 120.0)
    fake = types.SimpleNamespace(
        state=types.SimpleNamespace(params_G=tree.params, params_G_ema=tree.params),
        mesh=None, eval_mesh=None, apply_g=jax_apply_g(tree.Gj), policy=JAX_FP32,
        lidar=jlidar)
    want = JaxTrainer.generate(fake, ema=False, latent=jnp.asarray(z), key=key)
    noise = recorded_gumbel(tree.Gj, tree.params, jnp.asarray(z), key, jit=True)
    got = trainer.generate(ema=False, latent=torch.from_numpy(z), noise={"pixel": noise["pixel"]})
    assert set(got) == set(want)
    for k in want:
        if k == "mask":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                       atol=1e-3 if k == "normals" else 1e-5, err_msg=k)


CADENCE = ["total_iterations=4", "solver.checkpoint.save_image=2",
           "solver.checkpoint.save_stats=2", "solver.checkpoint.test=100",
           "solver.checkpoint.save_model=100"]


def _record_images(monkeypatch, cls):
    """Records (tag, shape, step) of every ``cls.image`` call, and keeps
    TensorBoard out of the run (its import costs seconds; nothing reads
    its events here)."""
    seen = []
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(cls, "image",
                        lambda self, tag, img, step: seen.append((tag, img.shape, step)))
    return seen


@pytest.fixture(scope="module")
def jax_tags(tree, tmp_path_factory):
    """The JAX CLI's (tag, grid shape, image step) of a 4-iteration run.
    Its trainer is a stand-in that gives the CLI the JAX trainer's first
    batch, ``fetch_reals_host`` and ``generate`` (on the tree's weights),
    and skips the train step and the checkpoint: image logging alone is
    compared, without building and compiling a JAX train step."""
    class StandIn:
        steps_per_call, start_iteration = 0, 0

        def __init__(self, cfg):
            self.cfg, self.batch_size = cfg, int(cfg.solver.batch_size)
            self.lidar = JaxLidar.from_angle_file(osp.join(tree.root, "angles.npy"), SHAPE,
                                                  0.9, 120.0)
            self.loader = JaxLoader(jax_define_dataset(cfg.dataset, phase="train"),
                                    batch_size=self.batch_size, shuffle=True, drop_last=True,
                                    seed=0, keys=("depth",))
            self.state = types.SimpleNamespace(params_G=tree.params, params_G_ema=tree.params)
            self.mesh = self.eval_mesh = None
            self.apply_g, self.policy = jax_apply_g(tree.Gj), JAX_FP32
            self.fixed_latent = jax.random.normal(jax.random.PRNGKey(1), (8, IN_CH))
            self.root_key = jax.random.PRNGKey(0)

        fetch_reals_host = JaxTrainer.fetch_reals_host
        generate = JaxTrainer.generate

        def device_iter(self):
            while True:
                yield None

        def step(self, i, batch):
            return {}

        def save(self, models_dir, step):
            return "not written"

    with pytest.MonkeyPatch.context() as mp:
        seen = _record_images(mp, JaxRunLogger)
        mp.setattr(jax_trainer_module, "Trainer", StandIn)
        jax_train_cli.main(TINY + [f"dataset.root={tree.root}", *CADENCE,
                                   f"run_dir={tmp_path_factory.mktemp('jax_run')}"])
    return seen


@pytest.mark.parametrize("mode", ["per_step", "chunks"])
def test_train_cli_image_tags_equal_jax(tree, jax_tags, tmp_path, monkeypatch, mode):
    """The port's train CLI logs the JAX CLI's image tags, grid shapes and
    image steps: ``real/*`` once at the start, ``synth/*`` at every
    ``save_image``, per step and in chunk mode (between chunks)."""
    seen = _record_images(monkeypatch, RunLogger)
    extra = ["cache_device=true", "steps_per_call=2"] if mode == "chunks" else []
    train_cli.main(TINY + [f"dataset.root={tree.root}", *CADENCE, f"run_dir={tmp_path}",
                           "device=cpu", *extra])
    assert sorted(seen) == sorted(jax_tags)
    tags = {t for t, _, _ in seen}
    assert {"real/inv", "real/bev", "real/mask", "synth/inv/orig", "synth/confidence/pix",
            "synth/confidence/img", "synth/mask/pix", "synth/mask/img"} <= tags
    assert {s for t, _, s in seen if t.startswith("synth/")} == {2 * 8, 4 * 8}
