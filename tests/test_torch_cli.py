"""dusty_gan_torch.cli.evaluate_synthesis on the CPU on a tiny synthetic
tree: the JSON key set equals the JAX CLI's on the same reference-format
.pth, with --metrics cd,emd and with --calibrate-drop-rate too, the scores
do not depend on the batch size, the CLI refuses to run without a GPU
unless --device cpu is given, unknown metrics raise, and no module of the port (nor chip_smoke.py) imports JAX,
msgpack or the JAX package, even while it reads a JAX .ckpt."""

import glob
import json
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dusty_gan_tpu.cli.evaluate_synthesis import main as jax_main
from dusty_gan_tpu.models.factory import define_G as jax_define_G
from dusty_gan_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from dusty_gan_tpu.train.state import TrainState as JaxTrainState
from dusty_gan_tpu.utils import torch_export as te

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from dusty_gan_torch.cli.evaluate_synthesis import main, latents
from dusty_gan_torch.config import compose, load_config, save_config
from dusty_gan_torch.data.synthetic import build_synthetic_kitti

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG_DIR = osp.join(REPO, "configs")
TINY = ["--num-test", "4", "--num-points", "64", "--cd-batch", "3"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A synthetic tree, a resolved config and a reference-format .pth of a
    JAX-initialised tiny DUSty-II generator."""
    base = tmp_path_factory.mktemp("cli")
    root = build_synthetic_kitti(str(base / "data"), n_scans_per_seq=5, w0=512,
                                 sequences=(0, 11))
    cfg = compose(CONFIG_DIR, [
        "model=dusty2_dcgan_eqlr", "model.gen.in_ch=16", "model.gen.ch_base=8",
        "model.gen.ch_max=16", f"dataset.root={root}", "solver.batch_size=3"])
    cfg_path = save_config(cfg, str(base / "run"))
    jcfg = load_config(cfg_path)
    jcfg.model.gen.shape = list(jcfg.dataset.shape)
    Gj = jax_define_G(jcfg)
    params = Gj.init({"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
                     jnp.zeros((1, 16)))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          te.generator_state_dict(params, "dusty2/dcgan_eqlr", -1.0).items()}
    pth = str(base / "checkpoint.pth")
    torch.save({"step": 12, "G": sd, "G_ema": sd}, pth)
    return {"base": base, "root": root, "cfg": cfg_path, "pth": pth}


def _args(run, *extra):
    return ["--model-path", run["pth"], "--config-path", run["cfg"],
            "--save-dir-path", str(run["base"] / "out"), *TINY, *extra]


def test_key_set_equals_jax_cli(run, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    want = jax_main(_args(run, "--compute-gt"))
    gt = main(_args(run, "--compute-gt", "--device", "cpu"))
    fake = main(_args(run, "--device", "cpu"))
    assert set(gt) == set(fake) == set(want)
    assert all(np.isfinite(v) for v in fake.values())
    # the real-vs-real floor is computed from the same real tensors
    for k in ("swd-mean", "jsd", "mmd-cd"):
        np.testing.assert_allclose(gt[k], want[k], rtol=1e-3, err_msg=k)
    assert glob.glob(str(tmp_path / "outputs/logs/*/gt/evaluation/tol=0/*.json"))
    saved = sorted(glob.glob(str(run["base"] / "out" / "*.json")))
    with open(saved[-1]) as f:
        assert json.load(f) == pytest.approx(fake)
    caches = glob.glob(osp.join(run["root"], "cache", "torch_eval_*_64_*.npz"))
    assert len(caches) == 2  # train + test, apart from the JAX caches


def test_mask_threshold_reports_drop_rate(run):
    s = main(_args(run, "--device", "cpu", "--mask-threshold", "0.3"))
    assert s["mask_threshold"] == 0.3 and 0.0 <= s["drop_rate/fake"] <= 1.0


def test_scores_do_not_depend_on_batch_size(run, tmp_path):
    cfg = load_config(run["cfg"])
    cfg.solver.batch_size = 2
    other = save_config(cfg, str(tmp_path))
    a = main(_args(run, "--device", "cpu"))
    b = main(["--model-path", run["pth"], "--config-path", other,
              "--save-dir-path", str(tmp_path), *TINY, "--device", "cpu"])
    assert a == b


def test_prepare_only(run, tmp_path):
    assert main(_args(run, "--device", "cpu", "--prepare-only",
                      "--num-points", "32")) == {"prepared": True}
    assert glob.glob(osp.join(run["root"], "cache", "torch_eval_*_32_*.npz"))


def test_latents_per_sample_index():
    a = latents(0, 5, 8)
    np.testing.assert_array_equal(latents(3, 5, 8).numpy(), a[3:].numpy())
    assert a.shape == (5, 8) and not torch.equal(a[0], a[1])


def test_refuses_cpu_fallback_without_gpu(run):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="GPU"):
        main(_args(run))


def test_emd_key_set_equals_jax_cli(run, tmp_path, monkeypatch):
    """--metrics cd,emd adds the twelve -emd keys; the real-vs-real EMD floor
    is computed from the same real tensors as the JAX CLI's."""
    monkeypatch.chdir(tmp_path)
    want = jax_main(_args(run, "--compute-gt", "--metrics", "cd,emd"))
    timings = {}
    gt = main(_args(run, "--compute-gt", "--metrics", "cd,emd", "--device", "cpu"),
              timings=timings)
    assert set(gt) == set(want) and len([k for k in gt if k.endswith("-emd")]) == 12
    assert {"pairwise_cd", "pairwise_emd"} <= set(timings)
    for k in ("mmd-emd", "mmd-sample-emd", "mmd-cd"):
        np.testing.assert_allclose(gt[k], want[k], rtol=1e-3, err_msg=k)


def test_generated_scores_with_emd(run):
    """The generated run scores each metric asked for; neither metric's
    scores change when the other is added."""
    cd = main(_args(run, "--device", "cpu"))
    both = main(_args(run, "--device", "cpu", "--metrics", "cd,emd"))
    emd = main(_args(run, "--device", "cpu", "--metrics", "emd"))
    assert all(np.isfinite(v) for v in both.values())
    assert len([k for k in both if k.endswith("-emd")]) == 12
    assert not any(k.endswith("-cd") for k in emd)
    assert cd == {k: v for k, v in both.items() if not k.endswith("-emd")}
    assert emd == {k: v for k, v in both.items() if not k.endswith("-cd")}


def test_calibrate_drop_rate_matches_jax_cli(run):
    """The same keys as the JAX CLI; the target is the real train set's
    drop rate, equal on both sides; the calibrated rate is the target's up
    to one pixel step of the calibration images, or sits at an end of the
    threshold interval.  The calibration latents differ (torch generators
    against JAX keys), so the thresholds are not compared."""
    args = ["--calibrate-drop-rate", "--calib-samples", "6"]
    want = jax_main(_args(run, *args))
    got = main(_args(run, "--device", "cpu", *args))
    assert set(got) == set(want)
    assert got["drop_rate/target"] == want["drop_rate/target"]
    step = 1.0 / (6 * 64 * 256)
    at_end = got["mask_threshold"] in (1e-3, 1.0 - 1e-3)
    assert at_end or abs(got["drop_rate/calibrated"] - got["drop_rate/target"]) <= 2 * step
    assert 0.0 <= got["drop_rate/fake"] <= 1.0


def test_calibration_latents_are_apart_from_eval_latents():
    from dusty_gan_torch.cli.evaluate_synthesis import CALIB_SEED

    cal, ev = latents(0, 4, 8, CALIB_SEED), latents(0, 4, 8)
    assert not any(torch.equal(c, e) for c in cal for e in ev)
    np.testing.assert_array_equal(latents(2, 4, 8, CALIB_SEED).numpy(), cal[2:].numpy())


@pytest.mark.parametrize("metrics", ["cd,xyz", "emd2", ","])
def test_unknown_metric_raises(run, metrics):
    with pytest.raises(ValueError, match="metrics"):
        main(_args(run, "--device", "cpu", "--metrics", metrics))


def test_port_never_imports_jax(tmp_path):
    """Import every module of the port and chip_smoke.py, build and load the
    native data library, and read a JAX ``.ckpt`` (written here by the JAX
    package), in a fresh interpreter whose ``msgpack`` import fails: neither
    JAX, flax, optax, msgpack nor the JAX package may be loaded."""
    opt = optax.adam(1e-3)
    params = {"params": {"w": np.ones((2, 3), np.float32)}}
    state = JaxTrainState(step=jnp.asarray(3, jnp.int32), params_G=params, params_D=params,
                          params_G_ema=params, opt_G=opt.init(params), opt_D=opt.init(params),
                          pl_ema=jnp.asarray(0.5, jnp.float32))
    ckpt = jax_save_checkpoint(str(tmp_path / "checkpoint_0000000003.ckpt"), state)
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['msgpack'] = None\n"
        "import dusty_gan_torch\n"
        "for m in pkgutil.walk_packages(dusty_gan_torch.__path__, 'dusty_gan_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from dusty_gan_torch.data import native\n"
        "native.load()\n"
        "from dusty_gan_torch.utils.jax_checkpoint import adam_entry, read_jax_checkpoint\n"
        f"st = read_jax_checkpoint({ckpt!r})['state']\n"
        "assert int(st['step']) == 3 and adam_entry(st['opt_G'], 'opt_G')[0] == 0\n"
        "assert st['params_G']['params']['w'].shape == (2, 3)\n"
        "bad = sorted(k for k, v in sys.modules.items() if v is not None and k.split('.')[0]\n"
        "             in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'dusty_gan_tpu'))\n"
        "print(len([k for k in sys.modules if k.startswith('dusty_gan_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20
