"""The reconstruction-evaluation slice of dusty_gan_torch against the JAX
package on the CPU, in float32 on both sides: masked loss, depth metrics,
surface normals, postprocess, the inversion utilities and loop, and one
test batch of ``evaluate_reconstruction`` as a whole, with JAX's z0,
per-step latent noise and fixed Gumbel noise handed to the port.  Each
test states its tolerance."""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_tpu.data import datasets as jds
from dusty_gan_tpu.geometry import lidar as jl
from dusty_gan_tpu.geometry.normals import xyz_to_normal as jax_xyz_to_normal
from dusty_gan_tpu.metrics.chamfer import compute_cd as jax_compute_cd
from dusty_gan_tpu.metrics import depth as jax_depth
from dusty_gan_tpu.models.losses import masked_loss as jax_masked_loss
from dusty_gan_tpu.utils import inversion as jinv
from dusty_gan_tpu.utils.postprocess import postprocess as jax_postprocess
from dusty_gan_tpu.utils.setup import make_eval_generator as jax_make_eval_generator

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from dusty_gan_torch.cli import evaluate_reconstruction as er
from dusty_gan_torch.data import datasets as tds
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.geometry import lidar as tl
from dusty_gan_torch.geometry.normals import xyz_to_normal
from dusty_gan_torch.metrics import depth
from dusty_gan_torch.models.losses import masked_loss
from dusty_gan_torch.utils import inversion as tinv
from dusty_gan_torch.utils.postprocess import postprocess
from dusty_gan_torch.utils.setup import make_eval_generator

from tests.torch_parity import (IN_CH, jax_generator, jax_step_noise, logistic, nchw,
                                nhwc, port_generator)

CONFIG_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "configs")
SHAPE = (32, 128)
TOL_F32 = dict(rtol=1e-5, atol=1e-6)


def _lidar_pair(root):
    angles = np.load(f"{root}/angles.npy")
    return (jl.Lidar.from_angle_array(angles, SHAPE, 0.9, 120.0),
            tl.Lidar.from_angle_array(angles, SHAPE, 0.9, 120.0))


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Three synthetic KITTI test scans at SHAPE, read by both packages."""
    root = build_synthetic_kitti(str(tmp_path_factory.mktemp("rec")), n_scans_per_seq=3,
                                 w0=512, sequences=(11,))
    js, ts = jds.KITTIOdometry(root, "test", shape=SHAPE), tds.KITTIOdometry(root, "test", shape=SHAPE)
    jb = {k: np.stack([js.item(i)[k] for i in range(3)]) for k in ("depth", "mask", "xyz")}
    tb = {k: np.stack([ts.item(i)[k] for i in range(3)]) for k in ("depth", "mask", "xyz")}
    for k in jb:  # the two packages' float32 norms may differ by one ulp
        np.testing.assert_allclose(tb[k], jb[k], rtol=1e-6, atol=0)
    return {"root": root, "batch": tb}


# ------------------------------------------------------------- elementwise


@pytest.mark.parametrize("distance", ["l1", "l2"])
def test_masked_loss(distance):
    rng = np.random.RandomState(0)
    a, b = rng.rand(3, 8, 16, 1).astype(np.float32), rng.rand(3, 8, 16, 1).astype(np.float32)
    m = (rng.rand(3, 8, 16, 1) > 0.3).astype(np.float32)
    want = np.asarray(jax_masked_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m), distance))
    got = masked_loss(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(m), distance)
    np.testing.assert_allclose(got.numpy(), want, **TOL_F32)


def test_masked_loss_rejects_unknown_distance():
    t = torch.ones(1, 2, 2, 1)
    with pytest.raises(NotImplementedError):
        masked_loss(t, t, t, "huber")


@pytest.mark.parametrize("with_mask", [True, False])
def test_depth_error_and_accuracy(with_mask):
    rng = np.random.RandomState(1)
    ref = rng.uniform(1, 80, (3, 8, 16, 1)).astype(np.float32)
    gen = (ref * rng.uniform(0.6, 1.6, ref.shape)).astype(np.float32)
    m = (rng.rand(*ref.shape) > 0.3).astype(np.float32) if with_mask else None
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.from_numpy(m)
    for jfn, tfn in ((jax_depth.compute_depth_error, depth.compute_depth_error),
                     (jax_depth.compute_depth_accuracy, depth.compute_depth_accuracy)):
        want = jfn(jnp.asarray(ref), jnp.asarray(gen), jm)
        got = tfn(torch.from_numpy(ref), torch.from_numpy(gen), tm)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL_F32)


def _assert_normals_close(got, want, xyz, mode="closest"):
    """Normal maps agree within rtol 1e-5 / atol 1e-5 wherever float32
    computes them accurately.  Where a normal is ill conditioned (nearly
    collinear neighbour vectors, cross products that cancel exactly in
    "mean" mode, two neighbour pairs of nearly equal length in "closest"
    mode), float32 rounding moves it by far more.  Those pixels are the ones
    where either float32 result is more than 1e-3 from the float64 one, or
    where the float64 normal is zero (0.5 in the map) and a float32 one is
    not; they must be under 0.5% of the image."""
    exact = xyz_to_normal(torch.as_tensor(xyz).double(), mode=mode).numpy()
    zero = np.all(exact == 0.5, axis=-1)
    ill = np.zeros(exact.shape[:-1], bool)
    for n in (got, want):
        ill |= (np.abs(n - exact) > 1e-3).any(axis=-1) | (zero & ~np.all(n == 0.5, axis=-1))
    assert ill.mean() < 5e-3
    np.testing.assert_allclose(got[~ill], want[~ill], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["closest", "mean"])
def test_xyz_to_normal(scans, mode):
    """On the scans' own clouds, whose dropped pixels sit at the origin and
    whose top and bottom rows see the +inf pad, so the NaN and inf handling
    has to agree too (``_assert_normals_close``)."""
    xyz = scans["batch"]["xyz"]
    want = np.asarray(jax_xyz_to_normal(jnp.asarray(xyz), mode=mode))
    got = xyz_to_normal(torch.from_numpy(xyz), mode=mode).numpy()
    assert got.shape == xyz.shape
    _assert_normals_close(got, want, xyz, mode)


@pytest.mark.parametrize("arch", ["dusty1", "dusty2", "none"])
def test_postprocess(scans, arch):
    """Generator-like output dicts of each model kind, (B, H, W, C), with
    the scans' depths as the depth map and random masks and confidences:
    rtol 1e-5 / atol 1e-5, the normals as in ``_assert_normals_close``."""
    jlid, tlid = _lidar_pair(scans["root"])
    rng = np.random.RandomState(2)
    b, (h, w) = 3, SHAPE
    batch = scans["batch"]
    inv = np.asarray(tlid.invert_depth(torch.from_numpy(batch["depth"])))
    synth = {"depth": np.where(batch["mask"] > 0, 2.0 * inv - 1.0, -1.0).astype(np.float32)}
    if arch != "none":
        ch = 2 if arch == "dusty2" else 1
        synth["depth_orig"] = (2.0 * inv - 1.0).astype(np.float32)
        synth["confidence"] = rng.randn(b, h, w, ch).astype(np.float32)
        synth["mask"] = (rng.rand(b, h, w, ch) > 0.2).astype(np.float32)
        synth["depth"] = np.where(synth["mask"][..., :1] > 0, synth["depth"], -1.0)
    want = jax_postprocess({k: jnp.asarray(v) for k, v in synth.items()}, jlid, tol=0.0)
    got = postprocess({k: torch.from_numpy(v) for k, v in synth.items()}, tlid, tol=0.0)
    assert set(got) == set(want)
    for k in want:
        if k == "normals":
            _assert_normals_close(got[k].numpy(), np.asarray(want[k]), got["points"])
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k,
                                       rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- inversion


def test_schedule_and_noise_strength():
    """Exact up to JAX's float32 rounding (the port computes in Python
    floats): rtol 1e-6, atol 1e-7."""
    n = 1000
    steps = np.arange(n)
    want_lr = np.asarray(jax.vmap(lambda i: jinv.stylegan2_lr_schedule(i, n))(steps))
    want_ns = np.asarray(jax.vmap(lambda i: jinv.latent_noise_strength(i, n))(steps))
    got_lr = np.array([tinv.stylegan2_lr_schedule(i, n) for i in steps])
    got_ns = np.array([tinv.latent_noise_strength(i, n) for i in steps])
    np.testing.assert_allclose(got_lr, want_lr, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_ns, want_ns, rtol=1e-6, atol=1e-7)
    assert got_lr[0] == 0.0 and got_ns[-1] < got_ns[0]


def test_project_sphere():
    z = np.random.RandomState(3).randn(4, 16).astype(np.float32)
    want = np.asarray(jinv.project_sphere(jnp.asarray(z)))
    got = tinv.project_sphere(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), want, **TOL_F32)
    np.testing.assert_allclose((got ** 2).mean(1).numpy(), 1.0, rtol=1e-5)


def test_inversion_loop_quadratic():
    """200 Adam steps on a per-sample quadratic with JAX's own per-step
    noise: z* within rtol 1e-4 / atol 1e-5 (float32 Adam in other orders of
    operations, 200 times)."""
    rng = np.random.RandomState(4)
    target = rng.randn(3, 8).astype(np.float32)
    z0 = rng.randn(3, 8).astype(np.float32)
    key = jax.random.PRNGKey(7)
    tt = torch.from_numpy(target)
    jrun = jinv.make_inversion_loop(
        lambda z: jnp.sum((z - jnp.asarray(target)) ** 2, axis=1), num_steps=200)
    trun = tinv.make_inversion_loop(lambda z: ((z - tt) ** 2).sum(dim=1), num_steps=200)
    jz, jl_ = jax.jit(jrun)(jnp.asarray(z0), key)
    tz, tl_ = trun(torch.from_numpy(z0), jax_step_noise(key, 200, z0.shape))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), rtol=1e-4, atol=1e-5)
    assert float(tl_.sum()) < float(((tinv.project_sphere(torch.from_numpy(z0)) - tt) ** 2).sum())


def _generators(arch):
    """The narrow JAX generator and the port's with the same weights and
    fixed Gumbel noise, float32 convolutions on both sides; the port's G
    frozen, as ``setup`` returns it."""
    rng = np.random.RandomState(5)
    pix, img = logistic(rng, (1,) + SHAPE + (1,)), logistic(rng, (1, 1, 1, 1))
    Gj, params = jax_generator(arch, SHAPE)
    Gt = port_generator(arch, SHAPE, params).requires_grad_(False)
    jnoise = {"pixel": jnp.asarray(pix), "image": jnp.asarray(img)}
    tnoise = {"pixel": nchw(pix), "image": nchw(img)}
    if arch.startswith("dusty1"):
        jnoise, tnoise = jnoise["pixel"], tnoise["pixel"]
    elif not arch.startswith("dusty"):
        jnoise = tnoise = None
    gen_j = jax_make_eval_generator(Gj, params, jnoise, compute_dtype=jnp.float32)
    gen_t = make_eval_generator(Gt, tnoise, compute_dtype=None)
    return gen_j, gen_t, Gt


def test_inversion_loop_through_generator(scans):
    """20 steps through the narrow DUSty-II generator against a scan's
    masked L1, JAX's noise injected: z* within rtol 1e-3 / atol 1e-4 (a
    float32 generator and its gradient, other orders of operations, fed
    back 20 times through Adam's normalised step)."""
    gen_j, gen_t, _ = _generators("dusty2/dcgan_eqlr")
    jlid, tlid = _lidar_pair(scans["root"])
    batch = scans["batch"]
    mask = batch["mask"]
    inv_j = jlid.invert_depth(jnp.asarray(batch["depth"])) * mask
    inv_t = tlid.invert_depth(torch.from_numpy(batch["depth"])) * torch.from_numpy(mask)
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), **TOL_F32)
    z0 = np.random.RandomState(6).randn(3, IN_CH).astype(np.float32)
    key = jax.random.PRNGKey(8)

    def jloss(z):
        return jax_masked_loss(inv_j, jl.tanh_to_sigmoid(gen_j(z)["depth_orig"]),
                               jnp.asarray(mask), "l1")

    def tloss(z):
        return masked_loss(inv_t, tl.tanh_to_sigmoid(gen_t(z)["depth_orig"]),
                           torch.from_numpy(mask), "l1")

    jz, jls = jax.jit(jinv.make_inversion_loop(jloss, num_steps=20))(jnp.asarray(z0), key)
    tz, tls = tinv.make_inversion_loop(tloss, num_steps=20)(
        torch.from_numpy(z0), jax_step_noise(key, 20, z0.shape))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tls.numpy(), np.asarray(jls), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------- the slice as a whole

NUM_STEP = 10


def _jax_batch(gen_j, jlid, batch, z0, key, tol, is_dusty):
    """One batch of dusty_gan_tpu/cli/evaluate_reconstruction.py, from the
    JAX functions it calls, unsharded."""
    mask_ref = jnp.asarray(batch["mask"])
    inv_ref = jlid.invert_depth(jnp.asarray(batch["depth"])) * mask_ref
    k = "depth_orig" if is_dusty else "depth"

    def loss_fn(latent):
        return jax_masked_loss(inv_ref, jl.tanh_to_sigmoid(gen_j(latent)[k]), mask_ref, "l1")

    z_star, _ = jax.jit(jinv.make_inversion_loop(loss_fn, num_steps=NUM_STEP, lr=0.1))(z0, key)
    raw = gen_j(z_star)
    out = jax_postprocess(raw, jlid, tol=tol)
    b = z0.shape[0]
    depth_gen = jlid.revert_depth(jl.tanh_to_sigmoid(raw[k]), norm=False)
    depth_ref = jlid.revert_depth(inv_ref, norm=False)
    res = {"cd": jax_compute_cd(jnp.asarray(batch["xyz"]).reshape(b, -1, 3),
                                out["points"].reshape(b, -1, 3))}
    res.update(jax_depth.compute_depth_accuracy(depth_ref, depth_gen, mask_ref))
    res.update(jax_depth.compute_depth_error(depth_ref, depth_gen, mask_ref))
    h, w = out["depth"].shape[1:3]
    if is_dusty:
        res["drop_gen"] = (1 - out["mask"]).sum(axis=(1, 2, 3)) / (h * w)
    else:
        m = (jnp.abs(out["depth"] - 0.0) > tol).astype(jnp.float32)
        res["drop_gen"] = (1 - m).sum(axis=(1, 2, 3)) / (h * w)
    res["drop_ref"] = (1 - mask_ref).sum(axis=(1, 2, 3)) / (h * w)
    return {k: np.asarray(v) for k, v in res.items()}, np.asarray(z_star)


@pytest.fixture(scope="module", params=["dusty2/dcgan_eqlr", "none/dcgan_eqlr"])
def batch_pair(request, scans):
    arch = request.param
    is_dusty = arch.startswith("dusty")
    gen_j, gen_t, _ = _generators(arch)
    jlid, tlid = _lidar_pair(scans["root"])
    bi = 0
    z0 = np.array(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(1), bi),
                                    (3, IN_CH)))
    key = jax.random.fold_in(jax.random.PRNGKey(2), bi)
    want, jz = _jax_batch(gen_j, jlid, scans["batch"], jnp.asarray(z0), key, 0.0, is_dusty)
    stats = {}
    got = er.reconstruct_batch(gen_t, tlid, scans["batch"], torch.from_numpy(z0),
                               jax_step_noise(key, NUM_STEP, z0.shape), is_dusty,
                               num_step=NUM_STEP, tol=0.0, stats=stats)
    return want, {k: v.numpy() for k, v in got.items()}, stats, is_dusty


def test_batch_columns_match_jax(batch_pair):
    """Every per-sample column of one batch.  CD within atol 1e-5 / rtol
    1e-4: on the CPU the JAX package's nearest-neighbour search uses
    x^2 + y^2 - 2xy, whose cancellation costs a few 1e-7 per distance, and
    z* differs at float32 rounding.  Depth errors and accuracies within
    rtol 1e-4 / atol 1e-5; drop rates exactly equal."""
    want, got, _, _ = batch_pair
    assert set(got) == set(er.RESULT_KEYS) - {"tol", "index"}
    for k in sorted(want):
        if k.startswith("drop"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_batch_loss_falls_and_drop_rate_layout(batch_pair):
    """The inversion lowers the masked loss; DUSty-II's drop_gen counts both
    mask channels [pixel, image], as the JAX CLI does, so it lies in [0, 2]."""
    _, got, stats, is_dusty = batch_pair
    assert stats["loss_zstar"] < stats["loss_z0"]
    assert np.all((got["drop_ref"] >= 0) & (got["drop_ref"] <= 1))
    assert np.all((got["drop_gen"] >= 0) & (got["drop_gen"] <= (2 if is_dusty else 1)))
    assert set(stats) >= {"inversion_s", "cd_s", "rest_s"}


def test_seeded_draws_depend_on_batch_index_only():
    a = er.initial_latent(3, 4, 8, "cpu")
    np.testing.assert_array_equal(a.numpy(), er.initial_latent(3, 4, 8, "cpu").numpy())
    assert not torch.equal(a, er.initial_latent(4, 4, 8, "cpu"))
    n1, n2 = er.step_noise(3, "cpu"), er.step_noise(3, "cpu")
    first = n1(0, (2, 8))
    np.testing.assert_array_equal(first.numpy(), n2(0, (2, 8)).numpy())
    assert not torch.equal(first, n1(1, (2, 8)))
    # z0 and the step noise of one batch are different draws
    assert not torch.equal(er.initial_latent(3, 2, 8, "cpu"), er.step_noise(3, "cpu")(0, (2, 8)))
