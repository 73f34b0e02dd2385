"""dusty_gan_torch generators against the JAX package: weights carried by
``utils/weights.py`` and loaded with strict=True, the same z and Gumbel
noise, JAX ``compute_dtype=None`` against the port at float32
(rtol 1e-5 / atol 1e-6)."""

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
from dusty_gan_torch.models.dusty import DUSty1, DUSty2
from dusty_gan_torch.models.factory import define_G
from dusty_gan_torch.utils.weights import generator_state_dict, load_reference_checkpoint

from tests.torch_parity import (IN_CH, TOL_F32, jax_generator, logistic, nchw,
                                nhwc, port_generator)

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
