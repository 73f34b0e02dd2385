"""DUSty-II over the port's StyleGAN2 backbone (``models/stylegan2.py``)
against the benchmark's plain reference (``gpubench/reference/
stylegan2.py``, ``train_step_sg2.py``: plain torch, the literal grouped
per-sample-weight modulated convolution, NVlabs' ``upfirdn2d_ref``), on
the CPU at a tiny size (8x32 images, three levels, widths up to 32, a
mapping of width 32, batch 4), both sides in float32 from one set of
seeded weights.

Tolerances: rtol 1e-5 on module outputs, as the norm of the difference
over the reference's norm (measured: 2e-7 to 7e-7).  The two sides sum in
different orders: the port convolves the style-scaled input with the
shared weight and scales the output by the demodulation coefficient,
where the reference convolves with each sample's own modulated weight,
and the port's coefficient sums the squared styles against the weight's
squared norms as a matrix product; float32 rounding of those sums moves
an output by a few ulps.  An elementwise rtol would not do: the skip
image sums levels of both signs, so a pixel near 0 carries the absolute
rounding of its larger terms.  One train step's scalars, gradients and
updated weights take the envelope of the port's other one-step tests
(1e-4, each leaf by its norm): R1 and the path length differentiate
twice, where the rounding grows.
"""

import math
import os.path as osp

import numpy as np
import pytest
import torch

from dusty_gan_torch.config import compose
from dusty_gan_torch.core.dtypes import FP32_POLICY
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.geometry.lidar import Lidar
from dusty_gan_torch.models import stylegan2
from dusty_gan_torch.models.factory import define_D, define_G
from dusty_gan_torch.ops.modulated import modulated_conv2d
from dusty_gan_torch.ops.upfirdn import setup_filter
from dusty_gan_torch.train.state import create_train_state
from dusty_gan_torch.train.step import TrainStep, sample_draws
from dusty_gan_torch.train.trainer import Trainer
from dusty_gan_torch.utils import profiling
from gpubench.reference import stylegan2 as ref
from gpubench.reference import train_step_sg2 as ref_step

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG_DIR = osp.join(REPO, "configs")
SHAPE, B = (8, 32), 4
RTOL, RTOL_STEP = 1e-5, 1e-4
MODEL = {"gen": {"arch": "dusty2/stylegan2", "in_ch": 32, "w_dim": 32, "mapping_layers": 2,
                 "mapping_lr_mul": 0.01, "channels": [32, 16, 8],
                 "out_ch": {"depth": 1, "confidence": 2}, "drop_const": -1.0,
                 "shape": list(SHAPE), "tau": 1.0},
         "dis": {"arch": "stylegan2", "in_ch": 1, "channels": [8, 16, 32], "fc_dim": 32,
                 "mbstd_group": 4, "mbstd_channels": 1, "shape": list(SHAPE)}}
TINY = ["model=dusty2_stylegan2", "model.gen.in_ch=32", "model.gen.w_dim=32",
        "model.gen.mapping_layers=2", "model.gen.channels=[32,16,8]",
        "model.dis.channels=[8,16,32]", "model.dis.fc_dim=32", "solver.batch_size=4",
        "dataset.shape=[8,32]", "cache_device=true", "solver.loss.pl=2",
        "solver.mix_prob=0.9"]


def _models(seed=0):
    """The port's G and D holding the reference's seeded weights."""
    torch.manual_seed(seed)
    G, D = define_G({"model": MODEL}), define_D({"model": MODEL})
    g = torch.Generator().manual_seed(seed)
    pg = ref.make_params(ref.generator_spec(MODEL, SHAPE), g, "cpu")
    pd = ref.make_params(ref.discriminator_spec(MODEL, SHAPE), g, "cpu")
    for module, params in ((G, pg), (D, pd)):
        named = dict(module.named_parameters())
        assert set(named) == set(params)
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(params[k])
    return G, D, pg, pd


def _draws(G, mix_prob, seed=1, use_pl=False):
    g = torch.Generator().manual_seed(seed)
    return sample_draws(g, "cpu", G, rounds=1, b=B, in_ch=32, shape=SHAPE, use_pl=use_pl,
                        mix_prob=mix_prob)[0]


def _close(got, want, rtol, what=""):
    """|got - want| / |want| <= rtol, in the 2-norm."""
    err = float(torch.linalg.vector_norm((got - want).double()))
    scale = float(torch.linalg.vector_norm(want.double()))
    assert err <= rtol * scale, (what, err / max(scale, 1e-30))


def _style(s):
    return {"z_mix": s.z_mix, "cutoff": s.cutoff, "noise": s.noise}


@pytest.mark.parametrize("mix_prob", [0.0, 1.0])
def test_generator_matches_the_reference(mix_prob):
    G, _, pg, _ = _models()
    d = _draws(G, mix_prob)
    if mix_prob:
        assert 1 <= int(d.style.cutoff) < 6
    got = G(d.z, None, train=True, fixed_noise=d.gumbel, style=d.style)
    want = ref.generator(pg, d.z, _style(d.style), d.gumbel, MODEL)
    for k in ("depth_orig", "confidence", "mask", "depth"):
        _close(got[k].detach(), want[k], RTOL, k)
    # mixing and noise reach the output
    if mix_prob:
        unmixed = ref.generator(pg, d.z, dict(_style(d.style), z_mix=None), d.gumbel, MODEL)
        assert (unmixed["depth_orig"] - want["depth_orig"]).abs().max() > 1e-3
    quiet = ref.generator(pg, d.z, dict(_style(d.style), noise=[0 * n for n in d.style.noise]),
                          d.gumbel, MODEL)
    assert (quiet["depth_orig"] - want["depth_orig"]).abs().max() > 1e-3


def test_discriminator_matches_the_reference():
    _, D, _, pd = _models()
    x = torch.rand((B, 1) + SHAPE, generator=torch.Generator().manual_seed(3)) * 2 - 1
    _close(D(x).reshape(-1).detach(), ref.discriminator(pd, x, MODEL), RTOL)


@pytest.mark.parametrize("up", [False, True])
def test_modulated_conv_equals_the_grouped_form(up):
    g = torch.Generator().manual_seed(4)
    x = torch.randn((B, 16, 4, 8), generator=g)
    w = torch.randn((8, 16, 3, 3), generator=g) / 12.0
    s = torch.randn((B, 16), generator=g) + 1.0
    got = modulated_conv2d(x, w, s, up=up, resample_filter=setup_filter())
    _close(got, ref.modulated_conv(x, w, s, up=up), RTOL)
    plain = modulated_conv2d(x, w, s, demodulate=False)
    _close(plain, ref.modulated_conv(x, w, s, demodulate=False), RTOL)


def test_one_train_step_matches_the_reference():
    G, D, pg, pd = _models()
    d = _draws(G, 0.9, use_pl=True)
    depth = torch.rand((B, 1) + SHAPE, generator=torch.Generator().manual_seed(5))
    depth = torch.where(depth > 0.1, depth, torch.zeros_like(depth))
    cfg = {"model": MODEL, "dataset": {"shape": list(SHAPE), "min_depth": 0.9,
                                       "max_depth": 120.0},
           "solver": {"lr": {"alpha": {"gen": 0.002, "dis": 0.002}, "beta1": 0.0,
                             "beta2": 0.99},
                      "loss": {"gan": 1.0, "gp": 1.0, "pl": 2.0}, "batch_size": B,
                      "smoothing_kimg": 10}}
    hp = ref_step.HyperSG2.from_config(cfg)
    st_ref = ref_step.State.fresh(pg, pd)
    draws = {"z": d.z, "gumbel": d.gumbel, "aug_d_real": d.aug_d_real,
             "aug_d_fake": d.aug_d_fake, "aug_g_fake": d.aug_g_fake,
             "style": _style(d.style), "pl": d.pl, "pl_style": _style(d.pl_style)}
    losses, grads, y_real, _, _ = ref_step.step(st_ref, depth, draws, hp)

    lidar = Lidar(angle=torch.zeros(SHAPE + (2,)), min_depth=0.9, max_depth=120.0)
    st = create_train_state(G, D, lr_G=0.002, lr_D=0.002, beta1=0.0, beta2=0.99)
    step = TrainStep(lidar, loss_weight={"gan": 1.0, "gp": 1.0, "pl": 2.0}, batch_size=B,
                     ema_decay=hp.ema_decay, policy=FP32_POLICY)
    scalars = step(st, {"depth": depth}, [d])
    for k, v in losses.items():
        np.testing.assert_allclose(float(scalars[k]), v, rtol=RTOL_STEP, err_msg=k)
    assert losses["loss/G/path_length"] > 0
    for m, net in (("D", D), ("G", G)):
        for k, p in net.named_parameters():
            _close(p.grad, grads[m][k], RTOL_STEP, f"{m}.{k}")
    for k, p in G.named_parameters():
        _close(p.detach(), st_ref.G[k], RTOL_STEP, k)


def test_the_counters_and_spans_of_a_generator_call():
    model = {"gen": dict(MODEL["gen"], channels=[8] * 5, shape=[32, 64])}
    torch.manual_seed(0)
    G = define_G({"model": model})
    g = torch.Generator().manual_seed(1)
    d = sample_draws(g, "cpu", G, rounds=1, b=2, in_ch=32, shape=(32, 64), mix_prob=1.0)[0]
    profiling.enable()
    try:
        profiling.drain()
        G(d.z, None, train=True, fixed_noise=d.gumbel, style=d.style)
        got = profiling.drain()
    finally:
        profiling.disable()
    assert got["counters"] == {"g.modconv": 14, "g.mixed_rows": 2}
    assert [s[0] for s in got["spans"]] == ["g.mapping", "g.synthesis"]


def test_the_model_config_builds_the_published_widths():
    cfg = compose(CONFIG_DIR, ["model=dusty2_stylegan2", "dataset.shape=[64,256]"])
    for net in ("gen", "dis"):
        cfg.model[net].shape = [64, 256]
    G, D = define_G(cfg), define_D(cfg)
    net = G.backbone
    assert isinstance(net, stylegan2.Generator) and net.num_ws == 10
    assert net.synthesis.const.shape == (512, 4, 16)
    assert [G.backbone.synthesis.get_submodule(f"l{i}.conv1").bias.numel()
            for i in range(5)] == [512, 512, 512, 512, 256]
    assert D.epilogue["fc"].weight.shape == (512, 512 * 4 * 16)
    n = sum(p.numel() for p in G.parameters()) + sum(p.numel() for p in D.parameters())
    assert 55e6 < n < 70e6, n
    assert math.isclose(net.mapping.fc0.weight_gain, 0.01 / math.sqrt(512))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_synthetic_kitti(str(tmp_path_factory.mktemp("sg2") / "data"),
                                 n_scans_per_seq=10, w0=512, sequences=(0, 8))


def test_a_chunk_equals_the_per_step_path(root):
    def trainer(*extra):
        cfg = compose(CONFIG_DIR, TINY + [f"dataset.root={root}", *extra])
        return Trainer(cfg, torch.device("cpu"), verbose=False)

    per_step, chunked = trainer(), trainer("steps_per_call=2")
    assert per_step.draws(1)[0].style.cutoff is not None
    it = per_step.device_iter()
    ix = chunked.loader.index_stream(0)
    rows = np.stack([chunked.device_cache.rows(*next(ix)) for _ in range(2)])
    got = chunked.step_chunk(range(1, 3), rows)
    for i in (1, 2):
        want = per_step.step(i, next(it))
    assert got.keys() == want.keys() and "loss/G/path_length" in want
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for a, b in zip(per_step.state.G_ema.parameters(), chunked.state.G_ema.parameters()):
        assert torch.equal(a, b)


def test_mix_prob_needs_a_w_space(root):
    cfg = compose(CONFIG_DIR, ["model=dusty2_dcgan_eqlr", "model.gen.in_ch=16",
                               "model.gen.ch_base=8", "model.gen.ch_max=16",
                               "model.dis.ch_base=8", "model.dis.ch_max=16",
                               "solver.batch_size=4", "dataset.shape=[32,64]",
                               f"dataset.root={root}", "solver.mix_prob=0.9"])
    trainer = Trainer(cfg, torch.device("cpu"), verbose=False)
    with pytest.raises(ValueError, match="w-space"):
        trainer.draws(1)
    G = define_G(cfg)
    with pytest.raises(ValueError, match="w-space"):
        sample_draws(torch.Generator(), "cpu", G, rounds=1, b=2, in_ch=16, shape=(32, 64),
                     mix_prob=0.5)
