"""Shared pieces of the dusty_gan_torch parity tests: tiny model sizes,
JAX-initialised generators and discriminators carried into the port, numpy
noise, the JAX package's SWD draws in the form the port's ``compute_swd``
takes, the DiffAugment draws that ``dusty_gan_tpu.ops.diff_augment`` takes
from a key, in the form the port's ``diff_augment`` takes, and the
one-train-step comparison of ``test_torch_train_step*.py``."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dusty_gan_tpu.models.dusty as jdusty
from dusty_gan_tpu.core.dtypes import FP32_POLICY as JAX_FP32
from dusty_gan_tpu.geometry.lidar import Lidar as JaxLidar
from dusty_gan_tpu.train.state import TrainState as JaxTrainState
from dusty_gan_tpu.train.state import make_optimizer
from dusty_gan_tpu.train.step import make_train_step

from dusty_gan_tpu.models.dcgan_eqlr import Discriminator as JaxDiscriminator
from dusty_gan_tpu.models.dcgan_eqlr import Generator as JaxGenerator
from dusty_gan_tpu.models.dusty import DUSty1 as JaxDUSty1
from dusty_gan_tpu.models.dusty import DUSty2 as JaxDUSty2

from dusty_gan_torch.core.dtypes import FP32_POLICY
from dusty_gan_torch.geometry.lidar import Lidar
from dusty_gan_torch.models.dcgan_eqlr import Discriminator, Generator
from dusty_gan_torch.models.dusty import DUSty1, DUSty2
from dusty_gan_torch.ops.diff_augment import DEFAULT_POLICY as AUGMENT_POLICY
from dusty_gan_torch.ops.diff_augment import cutout_size, translation_shifts
from dusty_gan_torch.train.state import create_train_state
from dusty_gan_torch.train.step import PL_BATCH_SHRINK, RoundDraws, TrainStep
from dusty_gan_torch.utils.weights import (adam_state_dict, discriminator_state_dict,
                                          generator_state_dict)

IN_CH, CH_BASE, CH_MAX = 32, 8, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one CPU thread while a module runs (import the fixture into
    the module to use it).  The training tests run thousands of tiny ops;
    with a thread per core, each op's parallel region waits on threads that
    the other test workers' load has descheduled (measured: 9.7 s a tiny
    train step on 8 threads on a loaded 8-core host, 0.1 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
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


def perturb(params, seed):
    """params + 0.1 N(0, 1), so that zero-initialised biases are exercised."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: p + jnp.asarray(0.1 * rng.randn(*p.shape), p.dtype), params)


def jax_discriminator(shape, seed=0):
    """(flax module, params) of a tiny discriminator with random biases."""
    D = JaxDiscriminator(in_ch=1, ch_base=CH_BASE, ch_max=CH_MAX, shape=shape)
    params = jax.jit(D.init)(jax.random.PRNGKey(seed), jnp.zeros((1, *shape, 1)))
    return D, perturb(params, seed + 100)


def port_discriminator(shape, params):
    """The port's discriminator with the JAX weights, loaded strictly."""
    D = Discriminator(1, CH_BASE, CH_MAX, shape)
    D.load_state_dict(discriminator_state_dict(params), strict=True)
    return D


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
    return torch.from_numpy(np.array(np.transpose(np.asarray(a), (0, 3, 1, 2)), order="C"))


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


COLOUR_OPS = ("brightness", "saturation", "contrast")


def jax_augment_draws(key, b, h, w, policy):
    """The draws ``dusty_gan_tpu.ops.diff_augment.diff_augment(key, x,
    policy)`` takes for a (b, h, w, 1) batch, reproduced by the same
    jax.random calls, as the port's ``draw_augment`` pairs (at the default
    p = 1 the op's Bernoulli gate keeps every image: its draw is skipped)."""
    t = lambda a: torch.from_numpy(np.array(a)).reshape(b)  # noqa: E731
    out = []
    for i, name in enumerate(policy):
        k = jax.random.fold_in(key, i)
        if name in COLOUR_OPS:
            ku, _ = jax.random.split(k)
            out.append((name, {"u": t(jax.random.uniform(ku, (b, 1, 1, 1), jnp.float32,
                                                          -1.0, 1.0))}))
        elif name == "translation":
            kh, kw, _ = jax.random.split(k, 3)
            sh, sw = translation_shifts(h, w)
            out.append((name, {
                "th": t(jax.random.randint(kh, (b, 1), -sh, sh + 1)).long(),
                "tw": t(jax.random.randint(kw, (b, 1), -sw, sw + 1)).long()}))
        elif name == "cutout":
            kx, ky, _ = jax.random.split(k, 3)
            ch, cw = cutout_size(h, w)
            out.append((name, {
                "off_h": t(jax.random.randint(kx, (b, 1, 1), 0, h + (1 - ch % 2))).long(),
                "off_w": t(jax.random.randint(ky, (b, 1, 1), 0, w + (1 - cw % 2))).long()}))
        else:
            raise ValueError(name)
    return out


# ---------------------------------------------------------------------------
# one train step, port against JAX (test_torch_train_step*.py); the module
# docstring of test_torch_train_step.py states the tolerances
# ---------------------------------------------------------------------------

SH, SW = 32, 64
LR, BETA1, BETA2, EPS = 2e-3, 0.0, 0.99, 1e-8

STEP_CASES = {
    # name: (arch, A, gan_mode, loss weights, (decay gamma, step size), steps
    #        [, {"beta1": ..., "init_count": Adam updates made before}])
    "dusty2": ("dusty2/dcgan_eqlr", 1, "nsgan", {"gan": 1.0, "gp": 1.0, "pl": 0.0}, (1.0, 1), 1),
    "dusty1_accum2": ("dusty1/dcgan_eqlr", 2, "nsgan", {"gan": 1.0, "gp": 1.0, "pl": 0.0},
                      (1.0, 1), 1),
    "dusty2_ragan_pl": ("dusty2/dcgan_eqlr", 1, "ragan", {"gan": 1.0, "gp": 1.0, "pl": 2.0},
                        (1.0, 1), 1),
    # from random Adam moments after 3 updates, carried by adam_state_dict:
    # the learning rate halves between the two steps (updates 3 and 4)
    "plain_decay": ("none/dcgan_eqlr", 1, "hinge", {"gan": 1.0, "gp": 0.5, "pl": 0.0},
                    (0.5, 2), 2, {"beta1": 0.5, "init_count": 3}),
}
BATCH = 8


def step_angles():
    pitch = np.linspace(0.2, -0.3, SH)[:, None] * np.ones((1, SW))
    yaw = np.linspace(np.pi, -np.pi, SW, endpoint=False)[None, :] * np.ones((SH, 1))
    return np.stack([pitch, yaw]).astype(np.float32)


def depth_batch(seed):
    """Depths in [0.05, 1] with a fifth of the pixels dropped to 0, no mask
    (the trainer's depth-only batches)."""
    rng = np.random.RandomState(seed)
    depth = rng.uniform(0.05, 1.0, (BATCH, SH, SW, 1)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    return depth


def _gumbel_fields(G, params, z, key):
    seen = []
    real = jdusty.logistic_noise

    def record(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdusty, "logistic_noise", record)
        G.apply(params, z, train=True, rngs={"gumbel": key})
    return seen


_JIT_GUMBEL_FIELDS = {}  # id(G) -> (G, its compiled _gumbel_fields)


def _jit_gumbel_fields(G, params, z, key):
    held, fn = _JIT_GUMBEL_FIELDS.get(id(G), (None, None))
    if held is not G:
        fn = jax.jit(lambda *a: _gumbel_fields(G, *a))
        _JIT_GUMBEL_FIELDS[id(G)] = (G, fn)
    return fn(params, z, key)


def recorded_gumbel(G, params, z, key, jit=False):
    """The Gumbel noise fields the JAX generator draws for latents ``z``
    with Gumbel key ``key``, in the port's form (NCHW); ``jit`` records
    them from one compiled generator pass instead of op by op."""
    if not isinstance(G, (jdusty.DUSty1, jdusty.DUSty2)):
        return None
    seen = (_jit_gumbel_fields if jit else _gumbel_fields)(G, params, z, key)
    seen = [nchw(np.asarray(s)) for s in seen]
    if isinstance(G, jdusty.DUSty2):
        return {"pixel": seen[0], "image": seen[1]}
    return seen[0]


def jax_step_draws(key, G, params_G, A, b, relativistic, use_pl, in_ch=IN_CH,
                   shape=(SH, SW), jit=False, policy=AUGMENT_POLICY):
    """The draws ``make_train_step`` takes from ``key``, as RoundDraws
    (``jit``: see ``recorded_gumbel``; ``policy``: the DiffAugment ops)."""
    sh, sw = shape
    k_z, k_gum, k_augd, k_augg, k_pl = jax.random.split(key, 5)
    zs = jax.random.normal(k_z, (A, b, in_ch), jnp.float32)
    gks, kds, kgs, pls = (jax.random.split(k, A) for k in (k_gum, k_augd, k_augg, k_pl))
    aug = lambda k, n: jax_augment_draws(k, n, sh, sw, policy)  # noqa: E731
    out = []
    for r in range(A):
        d_real, d_fake = jax.random.split(kds[r])
        g_real, g_fake = jax.random.split(kgs[r])
        d = RoundDraws(z=torch.from_numpy(np.array(zs[r])),
                       gumbel=recorded_gumbel(G, params_G, zs[r], gks[r], jit),
                       aug_d_real=aug(d_real, b), aug_d_fake=aug(d_fake, b),
                       aug_g_fake=aug(g_fake, b),
                       aug_g_real=aug(g_real, b) if relativistic else None)
        if use_pl:
            b_pl = b // PL_BATCH_SHRINK
            z_pl = jax.random.normal(jax.random.fold_in(pls[r], 0), (b_pl, in_ch))
            noise = jax.random.normal(jax.random.fold_in(pls[r], 1), (b_pl, sh, sw, 1),
                                      jnp.float32) / np.sqrt(np.float32(sh * sw))
            d.pl = (torch.from_numpy(np.array(z_pl)), nchw(np.asarray(noise)),
                    recorded_gumbel(G, params_G, z_pl, gks[r], jit))
        out.append(d)
    return out


def adam_of(opt_state):
    (adam,) = [el for el in opt_state if isinstance(el, optax.ScaleByAdamState)]
    return adam


def moment_atol(sd):
    return 1e-5 * max(float(v.abs().max()) for v in sd.values())


def assert_moments(opt, module, mu_sd, nu_sd, count, what):
    mu_atol, nu_atol = moment_atol(mu_sd), moment_atol(nu_sd)
    for p, (name, _) in zip(module.parameters(), module.named_parameters()):
        s = opt.state[p]
        assert int(s["step"]) == count, what
        for got, want, atol, m in ((s["exp_avg"], mu_sd[name], mu_atol, "mu"),
                                   (s["exp_avg_sq"], nu_sd[name], nu_atol, "nu")):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=atol,
                                       err_msg=f"{what} {m} {name}")


def update_slack(nu_sd, steps):
    """Per-entry slack of the parameter hold: Adam's update
    g / (|g| + eps) moves by eps * dg / (|g| + eps)^2 for a gradient error
    dg, at most 2; dg is the moment tolerance, |g| read from JAX's second
    moment.  Negligible where |g| >> sqrt(eps * dg), up to 2 lr a step where
    the gradient's sign is below the tolerance."""
    g = {k: (v / (1 - BETA2)).sqrt() for k, v in nu_sd.items()}
    dg = moment_atol(g)
    return {k: LR * steps * torch.clamp(EPS * dg / (v + EPS) ** 2, max=2.0)
            for k, v in g.items()}


def assert_module(module, want_sd, nu_sd, steps, what):
    """Each entry within 1e-6 + 1e-5 |want| + its update slack (buffers
    exactly)."""
    got = module.state_dict()
    assert set(got) == set(want_sd), what
    slack = update_slack(nu_sd, steps)
    for k, want in want_sd.items():
        tol = 1e-6 + 1e-5 * want.abs() + slack.get(k, 0.0)
        bad = (got[k] - want).abs() > tol
        assert not bool(bad.any()), (f"{what} {k}: {int(bad.sum())} entries off, "
                                     f"max {float((got[k] - want).abs().max())}")


def run_step_case(name):
    """Run ``STEP_CASES[name]`` in both frameworks from the same state, batch
    and draws."""
    arch, A, mode, lw, (gamma, step_size), steps, *opts = STEP_CASES[name]
    opts = opts[0] if opts else {}
    beta1 = opts.get("beta1", BETA1)
    Gj, pG = jax_generator(arch, (SH, SW), seed=1)
    Dj, pD = jax_discriminator((SH, SW), seed=2)
    opt_g = make_optimizer(LR, beta1, BETA2, decay_gamma=gamma, decay_step_size=step_size)
    opt_d = make_optimizer(LR, beta1, BETA2, decay_gamma=gamma, decay_step_size=step_size)
    ema_decay = 0.5 ** (BATCH / 10000.0)
    jstep = jax.jit(make_train_step(
        Gj, Dj, JaxLidar.from_angle_array(step_angles(), (SH, SW), 0.9, 120.0),
        optimizer_g=opt_g, optimizer_d=opt_d, gan_mode=mode, loss_weight=lw,
        num_accumulation=A, ema_decay=ema_decay, batch_size=BATCH, policy=JAX_FP32))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params_G=pG, params_D=pD,
                           params_G_ema=jax.tree.map(jnp.copy, pG), opt_G=opt_g.init(pG),
                           opt_D=opt_d.init(pD), pl_ema=jnp.zeros((), jnp.float32))

    G = port_generator(arch, (SH, SW), pG)
    state = create_train_state(G, port_discriminator((SH, SW), pD), lr_G=LR, lr_D=LR,
                               beta1=beta1, beta2=BETA2, decay_gamma=gamma,
                               decay_step_size=step_size)
    if "init_count" in opts:
        count = opts["init_count"]
        jstate = jstate.replace(opt_G=random_adam(jstate.opt_G, count, 3),
                                opt_D=random_adam(jstate.opt_D, count, 4))
        for opt, module, jopt, to_sd in (
                (state.opt_G, state.G, jstate.opt_G, lambda t: generator_state_dict(t, arch)),
                (state.opt_D, state.D, jstate.opt_D, discriminator_state_dict)):
            adam = adam_of(jopt)
            opt.load_state_dict(adam_state_dict(module, to_sd(adam.mu), to_sd(adam.nu), count,
                                                LR, (beta1, BETA2)))
    step = TrainStep(Lidar.from_angle_array(step_angles(), (SH, SW), 0.9, 120.0), gan_mode=mode,
                     loss_weight=lw, num_accumulation=A, ema_decay=ema_decay,
                     batch_size=BATCH, policy=FP32_POLICY)
    scalars = []
    for i in range(steps):
        key = jax.random.PRNGKey(10 + i)
        depth = depth_batch(i)
        draws = jax_step_draws(key, Gj, jstate.params_G, A, BATCH // A,
                               step.relativistic, step.use_pl)
        jstate, jsc = jstep(jstate, {"depth": jnp.asarray(depth)}, key)
        sc = step(state, {"depth": nchw(depth)}, draws)
        scalars.append((sc, jsc))
    return types.SimpleNamespace(arch=arch, state=state, jstate=jstate, scalars=scalars,
                                 steps=steps, updates=opts.get("init_count", 0) + steps)


def random_adam(opt_state, count, seed):
    """An optax Adam state after ``count`` updates with random moments (the
    schedule's count too)."""
    rng = np.random.RandomState(seed)
    rand = lambda tree, scale: jax.tree.map(  # noqa: E731
        lambda p: jnp.asarray(scale * rng.rand(*p.shape) - scale / 2, p.dtype), tree)
    out = []
    for el in opt_state:
        if isinstance(el, optax.ScaleByAdamState):
            el = el._replace(mu=rand(el.mu, 1e-2), nu=jax.tree.map(jnp.abs, rand(el.nu, 1e-4)))
        if "count" in getattr(el, "_fields", ()):
            el = el._replace(count=jnp.asarray(count, el.count.dtype))
        out.append(el)
    return type(opt_state)(out)


def check_step_scalars(case):
    for sc, jsc in case.scalars:
        assert set(sc) == set(jsc)
        for k in jsc:
            np.testing.assert_allclose(float(sc[k]), float(jsc[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def check_step_generators(case):
    arch, state, jstate, steps = case.arch, case.state, case.jstate, case.steps
    nu = generator_state_dict(adam_of(jstate.opt_G).nu, arch)
    assert_module(state.G, generator_state_dict(jstate.params_G, arch), nu, steps, "G")
    assert_module(state.G_ema, generator_state_dict(jstate.params_G_ema, arch), nu, steps,
                  "G_ema")


def check_step_discriminator(case):
    state, jstate, steps = case.state, case.jstate, case.steps
    nu = discriminator_state_dict(adam_of(jstate.opt_D).nu)
    assert_module(state.D, discriminator_state_dict(jstate.params_D), nu, steps, "D")


def check_step_adam(case):
    arch, state, jstate, updates = case.arch, case.state, case.jstate, case.updates
    for opt, module, jopt, to_sd in (
            (state.opt_G, state.G, jstate.opt_G, lambda t: generator_state_dict(t, arch)),
            (state.opt_D, state.D, jstate.opt_D, discriminator_state_dict)):
        adam = adam_of(jopt)
        assert int(adam.count) == updates
        assert_moments(opt, module, to_sd(adam.mu), to_sd(adam.nu), updates,
                       type(module).__name__)
    assert state.step == int(jstate.step) == case.steps * BATCH
    np.testing.assert_allclose(float(state.pl_ema), float(jstate.pl_ema), rtol=1e-5)
