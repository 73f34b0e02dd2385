"""dusty_gan_torch generators against the JAX package: weights carried by
``utils/weights.py`` and loaded with strict=True, the same z and Gumbel
noise, JAX ``compute_dtype=None`` against the port at float32
(rtol 1e-5 / atol 1e-6).  Then the generator's contract in
``models/dusty.py`` (``noise_fields``, ``generate``, ``w_space``,
``has_masker``) for every masker over both backbones, held bit for bit to
the explicit draws and direct module calls it stands for."""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_tpu.config import compose as jax_compose
from dusty_gan_tpu.models.factory import define_G as jax_define_G
from dusty_gan_tpu.utils import torch_export as te

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from dusty_gan_torch.config import compose
from dusty_gan_torch.models.dusty import (DUSty1, DUSty2, generate, has_masker, noise_fields,
                                          w_space)
from dusty_gan_torch.models.factory import define_G
from dusty_gan_torch.ops.gumbel import logistic_noise
from dusty_gan_torch.train.step import apply_g, draw_style
from dusty_gan_torch.utils.weights import generator_state_dict, load_reference_checkpoint

from tests.torch_parity import (CH_BASE, CH_MAX, IN_CH, TOL_F32, _out_ch, jax_generator,
                                logistic, nchw, nhwc, port_generator)

CONFIG_DIR = osp.join(osp.dirname(__file__), "../configs")
SHAPE = (32, 64)
ARCHS = ["none/dcgan_eqlr", "dusty1/dcgan_eqlr", "dusty2/dcgan_eqlr"]


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_matches_torch_export(arch):
    """The port's weight map writes what the JAX package's reference-.pth
    exporter writes, key for key and value for value."""
    _, params = jax_generator(arch, SHAPE, tau=None)
    got = generator_state_dict(params, arch, -1.0)
    want = te.generator_state_dict(params, arch, -1.0)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_strict_load_key_set(arch):
    G = port_generator(arch, SHAPE, jax_generator(arch, SHAPE)[1])
    sd = G.state_dict()
    want = te.generator_state_dict(jax_generator(arch, SHAPE)[1], arch, -1.0)
    assert set(sd) == set(want)


def _jax_forward(G, params, z, train, noise):
    kw = {}
    if noise is not None:
        kw = dict(train=train, fixed_noise=noise, rngs={"gumbel": jax.random.PRNGKey(0)})
    return G.apply(params, jnp.asarray(z), compute_dtype=None, **kw)


@pytest.mark.parametrize("arch,train", [
    ("none/dcgan_eqlr", True),  # the plain backbone has no train/eval switch
    ("dusty1/dcgan_eqlr", True), ("dusty1/dcgan_eqlr", False),
    ("dusty2/dcgan_eqlr", True), ("dusty2/dcgan_eqlr", False),
])
def test_generator_forward(arch, train):
    rng = np.random.RandomState(5)
    Gj, params = jax_generator(arch, SHAPE)
    Gt = port_generator(arch, SHAPE, params)
    z = rng.randn(3, IN_CH).astype(np.float32)
    h, w = SHAPE
    masker = arch.split("/")[0]
    noise_j = noise_t = None
    if masker == "dusty1":
        noise_j = logistic(rng, (1, h, w, 1))
        noise_t = nchw(noise_j)
    elif masker == "dusty2":
        pix, img = logistic(rng, (3, h, w, 1)), logistic(rng, (3, 1, 1, 1))
        noise_j = {"pixel": jnp.asarray(pix), "image": jnp.asarray(img)}
        noise_t = {"pixel": nchw(pix), "image": nchw(img)}
    want = _jax_forward(Gj, params, z, train, noise_j)
    with torch.no_grad():
        if masker == "none":
            got = Gt(torch.from_numpy(z))
        else:
            got = Gt(torch.from_numpy(z), train=train, fixed_noise=noise_t)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(nhwc(got[k]), np.asarray(want[k]), err_msg=k,
                                   **TOL_F32)
    if masker != "none":
        # masks are hard: their values agree exactly
        np.testing.assert_array_equal(nhwc(got["mask"]) > 0.5,
                                      np.asarray(want["mask"]) > 0.5)


def test_learnable_temperature_weights_carried():
    """tau=None adds gumbel*.weight; it crosses over and is used."""
    arch = "dusty2/dcgan_eqlr"
    Gj, params = jax_generator(arch, SHAPE, tau=None)
    Gt = port_generator(arch, SHAPE, params, tau=None)
    assert "gumbel_pixel.weight" in Gt.state_dict()
    rng = np.random.RandomState(6)
    z = rng.randn(2, IN_CH).astype(np.float32)
    pix, img = logistic(rng, (2, 32, 64, 1)), logistic(rng, (2, 1, 1, 1))
    want = Gj.apply(params, jnp.asarray(z), compute_dtype=None, train=True,
                    fixed_noise={"pixel": jnp.asarray(pix), "image": jnp.asarray(img)})
    with torch.no_grad():
        got = Gt(torch.from_numpy(z), train=True,
                 fixed_noise={"pixel": nchw(pix), "image": nchw(img)})
    np.testing.assert_allclose(nhwc(got["depth"]), np.asarray(want["depth"]), **TOL_F32)


def test_factory_and_reference_pth_roundtrip(tmp_path):
    """define_G builds from the repo's configs, and a reference-format .pth
    written by the JAX exporter loads strictly into it."""
    over = ["model=dusty2_dcgan_eqlr", f"model.gen.in_ch={IN_CH}",
            "model.gen.ch_base=8", "model.gen.ch_max=16", "dataset.shape=[32,64]"]
    cfg, jcfg = compose(CONFIG_DIR, over), jax_compose(CONFIG_DIR, over)
    for c in (cfg, jcfg):
        c.model.gen.shape = [32, 64]
    G = define_G(cfg)
    assert isinstance(G, DUSty2) and isinstance(define_G(
        compose(CONFIG_DIR, ["model=dusty1_dcgan_eqlr", "model.gen.shape=[32,64]"])), DUSty1)
    Gj = jax_define_G(jcfg)
    params = Gj.init({"params": jax.random.PRNGKey(2), "gumbel": jax.random.PRNGKey(3)},
                     jnp.zeros((1, IN_CH)))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          te.generator_state_dict(params, "dusty2/dcgan_eqlr", -1.0).items()}
    path = str(tmp_path / "g.pth")
    torch.save({"step": 7, "G": sd, "G_ema": sd}, path)
    loaded, step = load_reference_checkpoint(path, "G_ema")
    G.load_state_dict(loaded, strict=True)
    assert step == 7


def test_bf16_compute_close_to_f32():
    """The evaluation default runs the convolutions in bf16; the depth stays
    within bf16 rounding of the float32 forward."""
    arch = "none/dcgan_eqlr"
    _, params = jax_generator(arch, SHAPE)
    G = port_generator(arch, SHAPE, params)
    z = torch.from_numpy(np.random.RandomState(7).randn(2, IN_CH).astype(np.float32))
    with torch.no_grad():
        f32 = G(z)["depth"]
        b16 = G(z, compute_dtype=torch.bfloat16)["depth"]
    assert b16.dtype == torch.float32
    np.testing.assert_allclose(b16.numpy(), f32.numpy(), atol=0.1)


# every masker over both backbones; StyleGAN2 at tests/test_torch_stylegan2.py's
# tiny widths and size
ALL_ARCHS = [f"{m}/{b}" for b in ("dcgan_eqlr", "stylegan2") for m in ("none", "dusty1", "dusty2")]
WIDTHS = {"dcgan_eqlr": ({"in_ch": IN_CH, "ch_base": CH_BASE, "ch_max": CH_MAX}, SHAPE),
          "stylegan2": ({"in_ch": 32, "w_dim": 32, "mapping_layers": 2, "mapping_lr_mul": 0.01,
                         "channels": [32, 16, 8]}, (8, 32))}


def _any_generator(arch):
    """(G with seeded random weights in eval mode, its (H, W))."""
    widths, shape = WIDTHS[arch.split("/")[1]]
    gen = {"arch": arch, "out_ch": _out_ch(arch), "drop_const": -1.0, "tau": 1.0,
           "shape": list(shape), **widths}
    torch.manual_seed(0)
    return define_G({"model": {"gen": gen}}).eval(), shape


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_noise_fields_equal_the_explicit_draws(arch):
    """``noise_fields`` draws what the train step and the fixed evaluation
    noise drew explicitly before it: the same fields in the same order from
    the same generator, bit for bit, leaving the generator where they did."""
    G, shape = _any_generator(arch)
    masker = arch.split("/")[0]
    assert has_masker(G) == (masker != "none")
    assert (w_space(G) is not None) == arch.endswith("stylegan2")
    g_new, g_old = (torch.Generator().manual_seed(11) for _ in range(2))
    got = noise_fields(G, g_new, 3, shape)
    if masker == "none":
        assert got is None
    elif masker == "dusty1":
        assert torch.equal(got, logistic_noise(g_old, 3, shape, pixelwise=True))
    else:
        want = {"pixel": logistic_noise(g_old, 3, shape, pixelwise=True),
                "image": logistic_noise(g_old, 3, shape, pixelwise=False)}
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert torch.equal(torch.rand(5, generator=g_new), torch.rand(5, generator=g_old))


# the old call sites' combinations: the train step (training mode, the
# round's fields, StyleGAN2's style draws), the evaluation generator (fixed
# batch-1 fields, eval mode, a keep threshold, bf16), the trainer's image
# logging and validation (fields drawn from a generator, either mode), the
# demo's multi-code composition (DCGAN only)
MODES = ["step", "eval_fixed", "drawn_train", "drawn_eval", "composed"]
GENERATE_CASES = [(a, m) for a in ALL_ARCHS for m in MODES
                  if m != "composed" or a.endswith("dcgan_eqlr")]


@pytest.mark.parametrize("arch,mode", GENERATE_CASES)
def test_generate_equals_the_direct_module_call(arch, mode):
    """``generate`` gives what calling the module directly gave, bit for
    bit: a masked G takes the masker's arguments, a bare backbone only the
    latent, the compute dtype and the backbone's own keywords."""
    G, shape = _any_generator(arch)
    b = 3
    g = torch.Generator().manual_seed(21)
    z = torch.randn((b, WIDTHS[arch.split("/")[1]][0]["in_ch"]), generator=g)
    masker_kw = {"train": mode in ("step", "drawn_train"), "threshold": 0.5,
                 "fixed_noise": None}
    backbone_kw, cdt = {}, None
    if mode == "step":
        masker_kw["fixed_noise"] = noise_fields(G, g, b, shape)
        style = draw_style(G, b, 0.9 if w_space(G) else 0.0, g, None)
        backbone_kw = {} if style is None else {"style": style}
    elif mode == "eval_fixed":
        masker_kw.update(threshold=0.3, fixed_noise=noise_fields(G, g, 1, shape))
        cdt = torch.bfloat16
    elif mode == "composed":
        masker_kw["fixed_noise"] = noise_fields(G, g, 1, shape)
        alpha = torch.rand((b, getattr(G, "backbone", G).ch(2), 1, 1), generator=g)
        backbone_kw = {"compose_layer": 1, "compose_alpha": alpha}
    seed = int(torch.randint(1 << 30, (), generator=g))
    g_new, g_old = (torch.Generator().manual_seed(seed) for _ in range(2))
    with torch.no_grad():
        got = generate(G, z, cdt, train=masker_kw["train"], threshold=masker_kw["threshold"],
                       noise=masker_kw["fixed_noise"], generator=g_new, **backbone_kw)
        if has_masker(G):
            want = G(z, cdt, generator=g_old, **masker_kw, **backbone_kw)
        else:
            want = G(z, cdt, **backbone_kw)
        if mode == "step":  # the train step's own name for the call
            stepped = apply_g(G, z, masker_kw["fixed_noise"], cdt, backbone_kw.get("style"))
            assert all(torch.equal(stepped[k], want[k]) for k in want)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(torch.rand(5, generator=g_new), torch.rand(5, generator=g_old))
