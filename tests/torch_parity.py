"""Shared pieces of the dusty_gan_torch parity tests: tiny model sizes,
JAX-initialised generators carried into the port, numpy noise, and the
JAX package's SWD draws in the form the port's ``compute_swd`` takes."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dusty_gan_tpu.models.dcgan_eqlr import Generator as JaxGenerator
from dusty_gan_tpu.models.dusty import DUSty1 as JaxDUSty1
from dusty_gan_tpu.models.dusty import DUSty2 as JaxDUSty2

from dusty_gan_torch.models.dcgan_eqlr import Generator
from dusty_gan_torch.models.dusty import DUSty1, DUSty2
from dusty_gan_torch.utils.weights import generator_state_dict

IN_CH, CH_BASE, CH_MAX = 32, 8, 16
OUT_CH = {"depth": 1, "confidence": 2}
TOL_F32 = dict(rtol=1e-5, atol=1e-6)  # module outputs at float32


def jax_generator(arch, shape, tau=1.0, seed=0):
    """(flax module, params) with random weights and biases, so the biases
    are exercised too (a fresh init leaves them at zero)."""
    masker = arch.split("/")[0]
    out_ch = OUT_CH if masker == "dusty2" else (
        {"depth": 1, "confidence": 1} if masker == "dusty1" else {"depth": 1})
    backbone = JaxGenerator(in_ch=IN_CH, out_ch=out_ch, ch_base=CH_BASE,
                            ch_max=CH_MAX, shape=shape)
    G = {"none": lambda: backbone,
         "dusty1": lambda: JaxDUSty1(backbone=backbone, tau=tau),
         "dusty2": lambda: JaxDUSty2(backbone=backbone, tau=tau)}[masker]()
    z = jnp.zeros((1, IN_CH))
    params = G.init({"params": jax.random.PRNGKey(seed),
                     "gumbel": jax.random.PRNGKey(1)}, z)
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda p: p + jnp.asarray(0.1 * rng.randn(*p.shape), p.dtype), params)
    return G, params


def port_generator(arch, shape, params, tau=1.0, drop_const=-1.0):
    """The port's generator with the JAX weights, loaded strictly."""
    masker = arch.split("/")[0]
    out_ch = OUT_CH if masker == "dusty2" else (
        {"depth": 1, "confidence": 1} if masker == "dusty1" else {"depth": 1})
    backbone = Generator(IN_CH, out_ch, CH_BASE, CH_MAX, shape)
    G = {"none": lambda: backbone,
         "dusty1": lambda: DUSty1(backbone, tau=tau, drop_const=drop_const),
         "dusty2": lambda: DUSty2(backbone, tau=tau, drop_const=drop_const)}[masker]()
    G.load_state_dict(generator_state_dict(params, arch, drop_const), strict=True)
    return G.eval()


def logistic(rng, shape):
    """The reference's logistic noise field from numpy uniforms."""
    u1 = rng.uniform(size=shape).astype(np.float32)
    u2 = rng.uniform(size=shape).astype(np.float32)
    eps = np.float32(1e-10)
    return (-np.log(np.log(u1 + eps) / np.log(u2 + eps) + eps)).astype(np.float32)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().cpu().numpy(), (0, 2, 3, 1))


class JaxDraws:
    """The patch permutations and projection directions that
    ``dusty_gan_tpu.metrics.swd.compute_swd(key=key)`` draws."""

    def __init__(self, key, dir_repeats=4):
        self.key = key
        self.dir_repeats = dir_repeats

    def patches(self, start, level, n, count):
        kl = jax.random.fold_in(jax.random.fold_in(self.key, start), level)
        return torch.from_numpy(
            np.asarray(jax.random.permutation(kl, n)[:count]).astype(np.int64))

    def directions(self, level, repeat, dim, count):
        keys = jax.random.split(jax.random.fold_in(self.key, 1000 + level),
                                self.dir_repeats)
        return torch.from_numpy(np.array(
            jax.random.normal(keys[repeat], (dim, count), jnp.float32)))


def jax_step_noise(key, num_steps, shape):
    """The per-step latent noise that ``dusty_gan_tpu.utils.inversion.
    make_inversion_loop`` draws from ``key``, as the port's noise function
    ``noise(step, shape)``."""
    draws = [np.array(jax.random.normal(jax.random.fold_in(key, i), shape))
             for i in range(num_steps)]

    def noise(step, shape_):
        assert tuple(shape_) == tuple(shape)
        return torch.from_numpy(draws[step])

    return noise
