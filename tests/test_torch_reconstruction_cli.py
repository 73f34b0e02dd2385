"""The reconstruction CLI of dusty_gan_torch on the CPU
(``cli/evaluate_reconstruction.py``), against the JAX CLI on a synthetic
tree: the CSV's layout, ``--max-batches`` and a short last batch, the GPU
requirement, and the frozen generator that ``setup`` returns.  (The
batch-level parity with the JAX functions is in
``test_torch_reconstruction.py``; the CLI runs sit apart so that the
test workers share them out.)"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from dusty_gan_torch.cli import evaluate_reconstruction as er
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.utils.setup import make_eval_generator

CONFIG_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "configs")
SHAPE = (32, 128)


# -------------------------------------------------------------- CLI surface

CLI_STEPS = ["--num-step", "2", "--batch-size", "2"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A synthetic tree with 5 test scans, a narrow DUSty-II config at
    SHAPE and a reference-format .pth of a JAX-initialised generator."""
    from dusty_gan_tpu.models.factory import define_G as jax_define_G
    from dusty_gan_tpu.utils import torch_export as te

    from dusty_gan_torch.config import compose, load_config, save_config

    base = tmp_path_factory.mktemp("rec_cli")
    root = build_synthetic_kitti(str(base / "data"), n_scans_per_seq=5, w0=512,
                                 sequences=(11,))
    cfg = compose(CONFIG_DIR, [
        "model=dusty2_dcgan_eqlr", "model.gen.in_ch=16", "model.gen.ch_base=8",
        "model.gen.ch_max=16", f"dataset.root={root}",
        f"dataset.shape=[{SHAPE[0]},{SHAPE[1]}]"])
    cfg_path = save_config(cfg, str(base / "run"))
    jcfg = load_config(cfg_path)
    jcfg.model.gen.shape = list(jcfg.dataset.shape)
    params = jax_define_G(jcfg).init(
        {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)}, jnp.zeros((1, 16)))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          te.generator_state_dict(params, "dusty2/dcgan_eqlr", -1.0).items()}
    pth = str(base / "checkpoint.pth")
    torch.save({"step": 3, "G": sd, "G_ema": sd}, pth)
    return {"base": base, "cfg": cfg_path, "pth": pth}


def _cli_args(run, out, *extra):
    return ["--model-path", run["pth"], "--config-path", run["cfg"],
            "--save-dir-path", str(out), *CLI_STEPS, *extra]


def _read_csv(out_dir):
    import csv
    import glob

    (path,) = glob.glob(str(out_dir / "*.csv"))
    with open(path) as f:
        return list(csv.reader(f))


def test_cli_csv_layout_equals_jax_cli(cli_run, tmp_path):
    from dusty_gan_tpu.cli.evaluate_reconstruction import main as jax_main

    want = jax_main(_cli_args(cli_run, tmp_path / "jax", "--max-batches", "1"))
    got = er.main(_cli_args(cli_run, tmp_path / "torch", "--max-batches", "1",
                            "--device", "cpu"))
    assert list(got) == list(want) == [k for k in er.RESULT_KEYS if k != "index"]
    jrows, trows = _read_csv(tmp_path / "jax"), _read_csv(tmp_path / "torch")
    assert trows[0] == jrows[0]
    assert len(trows) == len(jrows) == 3  # header + one batch of 2
    assert [r[0] for r in trows[1:]] == ["0", "1"]
    assert all(np.isfinite(float(v)) for r in trows[1:] for v in r[1:])


def test_cli_max_batches_and_short_last_batch(cli_run, tmp_path):
    """5 scans in batches of 2: 2, 2 and a short 1.  A batch's rows do not
    depend on which other batches ran (z0 and the noise are keyed by the
    batch index)."""
    stats = {}
    full = er.main(_cli_args(cli_run, tmp_path / "full", "--device", "cpu"), stats=stats)
    assert len(full["cd"]) == 5 and stats["batches"] == 3
    assert len(_read_csv(tmp_path / "full")) == 6
    two = er.main(_cli_args(cli_run, tmp_path / "two", "--device", "cpu", "--max-batches", "2"))
    assert len(two["cd"]) == 4
    for k in two:
        assert two[k] == full[k][:4], k
    assert all(np.isfinite(full[k]).all() for k in full)


def test_cli_refuses_cpu_fallback_without_gpu(cli_run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="GPU"):
        er.main(_cli_args(cli_run, tmp_path))


def test_differentiable_generator_freezes_weights(cli_run):
    """``setup`` returns G frozen; the eval generator over it carries a
    gradient for a latent that asks for one, and builds no graph for a
    latent that does not."""
    from dusty_gan_torch.utils.setup import setup

    cfg, G, _, fixed_noise = setup(cli_run["pth"], cli_run["cfg"], "cpu")
    assert not any(p.requires_grad for p in G.parameters())
    gen = make_eval_generator(G, fixed_noise, compute_dtype=None)
    in_ch = int(cfg.model.gen.in_ch)
    assert not gen(torch.randn(2, in_ch))["depth_orig"].requires_grad
    z = torch.randn(2, in_ch, requires_grad=True)
    (g,) = torch.autograd.grad(gen(z)["depth_orig"].sum(), z)
    assert g.shape == z.shape and float(g.abs().sum()) > 0
