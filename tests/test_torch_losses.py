"""The port's GAN objectives and penalties against
``dusty_gan_tpu/models/losses.py`` on the CPU: 7 modes x {D, G}, R1 and the
one-centred penalty (value and parameter gradient through the double
backward) on a tiny discriminator carried from a JAX init, and the
path-length penalty (value, new EMA and parameter gradient) on a tiny
generator.  float32; tolerance rtol 1e-5 (module outputs, as the
generator parity tests) with an absolute floor of 1e-6 of each
gradient's largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_tpu.models import losses as jl

from dusty_gan_torch.models import losses as tl
from dusty_gan_torch.utils.weights import discriminator_state_dict, generator_state_dict

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import (IN_CH, jax_discriminator, jax_generator, nchw, port_discriminator,
                          port_generator)

H, W = 32, 64
TOL = dict(rtol=1e-5, atol=1e-6)


def _grads(module):
    """Parameter gradients; None (no path to the loss) as zeros, as JAX."""
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in module.named_parameters()}


def _close_grads(got_sd, want_sd):
    for k, want in want_sd.items():
        want = want.numpy()
        np.testing.assert_allclose(got_sd[k].numpy(), want, rtol=1e-5,
                                   atol=1e-6 * max(float(np.abs(want).max()), 1e-30),
                                   err_msg=k)


def _preds(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(6).astype(np.float32) * 2, rng.randn(6).astype(np.float32) * 2


@pytest.mark.parametrize("mode", jl.GAN_MODES)
def test_d_loss_matches_jax(mode):
    pr, pf = _preds(0)
    want = float(jl.gan_loss_d(mode, jnp.asarray(pr), jnp.asarray(pf), smoothing=0.9))
    got = float(tl.gan_loss_d(mode, torch.from_numpy(pr), torch.from_numpy(pf), 0.9))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", jl.GAN_MODES)
def test_g_loss_matches_jax(mode):
    pr, pf = _preds(1)
    want = float(jl.gan_loss_g(mode, jnp.asarray(pr), jnp.asarray(pf)))
    got = float(tl.gan_loss_g(mode, torch.from_numpy(pr), torch.from_numpy(pf)))
    np.testing.assert_allclose(got, want, **TOL)


def test_unknown_mode_raises():
    x = torch.zeros(2)
    with pytest.raises(NotImplementedError):
        tl.gan_loss_d("bce", x, x)
    with pytest.raises(NotImplementedError):
        tl.gan_loss_g("bce", x, x)


@pytest.fixture(scope="module")
def disc():
    D, params = jax_discriminator((H, W), seed=3)
    x = np.random.RandomState(4).uniform(-1, 1, (4, H, W, 1)).astype(np.float32)
    return D, params, x


@pytest.mark.parametrize("penalty", ["r1", "one_centered"])
def test_gradient_penalty_and_its_param_grad_match_jax(disc, penalty):
    """Penalty value, logits and d penalty / d params: the double backward."""
    D, params, x = disc
    jfn = {"r1": jl.r1_penalty, "one_centered": jl.gradient_penalty_one_centered}[penalty]
    tfn = {"r1": tl.r1_penalty, "one_centered": tl.gradient_penalty_one_centered}[penalty]

    def loss(p):
        pen, logits = jfn(lambda v: D.apply(p, v).reshape(-1), jnp.asarray(x))
        return pen, logits

    (want_pen, want_logits), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    port = port_discriminator((H, W), params)
    pen, logits = tfn(lambda v: port(v).reshape(-1), nchw(x))
    pen.backward()
    np.testing.assert_allclose(pen.item(), float(want_pen), **TOL)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), **TOL)
    _close_grads(_grads(port),
                 {k: v for k, v in discriminator_state_dict(want_grads).items()
                  if "blur" not in k})


@pytest.mark.parametrize("arch", ["none/dcgan_eqlr", "dusty2/dcgan_eqlr"])
def test_path_length_penalty_matches_jax(arch):
    """Penalty, new EMA and d penalty / d params; the noise fields are
    passed in (JAX draws its image noise from a key: reproduced here)."""
    G, params = jax_generator(arch, (H, W), seed=5)
    rng = np.random.RandomState(6)
    z = rng.randn(3, IN_CH).astype(np.float32)
    gum = {"pixel": rng.logistic(size=(3, H, W, 1)).astype(np.float32),
           "image": rng.logistic(size=(3, 1, 1, 1)).astype(np.float32)}
    key = jax.random.PRNGKey(7)
    masked = arch.startswith("dusty")

    def g_depth(p, zz):
        if masked:
            return G.apply(p, zz, train=True, fixed_noise={k: jnp.asarray(v)
                                                           for k, v in gum.items()})["depth"]
        return G.apply(p, zz)["depth"]

    def loss(p):
        return jl.path_length_penalty(lambda zz: g_depth(p, zz), jnp.asarray(z), key,
                                      jnp.float32(0.3), 0.01)

    (want_pen, want_ema), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    noise = np.asarray(jax.random.normal(key, (3, H, W, 1), jnp.float32))
    noise = noise / np.sqrt(np.float32(H * W))

    port = port_generator(arch, (H, W), params)
    tgum = {k: nchw(v) for k, v in gum.items()}
    fn = (lambda zz: port(zz, train=True, fixed_noise=tgum)["depth"]) if masked else (
        lambda zz: port(zz)["depth"])
    pen, ema = tl.path_length_penalty(fn, torch.from_numpy(z).requires_grad_(True), nchw(noise),
                                      torch.tensor(0.3), 0.01)
    pen.backward()
    np.testing.assert_allclose(pen.item(), float(want_pen), **TOL)
    np.testing.assert_allclose(float(ema), float(want_ema), **TOL)
    assert not ema.requires_grad
    sd = generator_state_dict(want_grads, arch)
    _close_grads(_grads(port),
                 {n: sd[n] for n, _ in port.named_parameters()})


def test_path_length_noise_scale():
    n = tl.path_length_noise((64, 1, H, W), torch.Generator().manual_seed(0))
    assert n.shape == (64, 1, H, W)
    np.testing.assert_allclose(float(n.std()) * np.sqrt(H * W), 1.0, rtol=0.01)


@pytest.mark.parametrize("distance", ["l1", "l2"])
def test_masked_loss_matches_jax(distance):
    rng = np.random.RandomState(8)
    a, b = rng.rand(2, 3, H, W, 1).astype(np.float32)
    m = (rng.rand(3, H, W, 1) > 0.3).astype(np.float32)
    want = np.asarray(jl.masked_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m), distance))
    got = tl.masked_loss(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(m), distance)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
