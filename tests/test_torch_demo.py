"""The demo's modules in dusty_gan_torch against the JAX package on the CPU,
on the same numpy inputs: the composed (multi-code) generator, the camera
rotation, the BEV renderer, the colour tables, the corruptions (the random
ones with JAX's draws handed in), latent interpolation, the multi-code
inversion loop, the image and video writers, and the Streamlit app's
argument lists.  Each test states its tolerance."""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dusty_gan_tpu.cli import demo as jax_demo
from dusty_gan_tpu.geometry import render as jrender
from dusty_gan_tpu.geometry.normals import (
    euler_angles_to_rotation_matrix as jax_euler)
from dusty_gan_tpu.utils import corruption as jcor
from dusty_gan_tpu.utils import inversion as jinv
from dusty_gan_tpu.utils.postprocess import cmap_table as jax_cmap_table
from dusty_gan_tpu.utils.postprocess import colorize as jax_colorize

from dusty_gan_torch.cli import demo
from dusty_gan_torch.geometry.normals import euler_angles_to_rotation_matrix
from dusty_gan_torch.geometry.render import render_point_clouds
from dusty_gan_torch.utils import corruption, postprocess
from dusty_gan_torch.utils import inversion as tinv
from dusty_gan_torch.utils import video

from tests.torch_parity import (IN_CH, JaxCorruptionDraws, generator_pair,  # noqa: F401
                                logistic, nchw, nhwc, one_torch_thread)

SHAPE = (32, 64)
# the JAX demo CLI's --corruption choices
CORRUPTIONS = ("none", "additive noise", "low resolution", "dropout", "closing", "half",
               "quarter", "vlines", "hlines", "random lines")


# ------------------------------------------------------ composed generator


@pytest.fixture(scope="module")
def generators():
    """{arch: (JAX module, params, the port's generator with those weights,
    the JAX module's apply compiled)}."""
    out = {}
    for arch in ("dusty2/dcgan_eqlr", "none/dcgan_eqlr"):
        Gj, params, Gt = generator_pair(arch, SHAPE)
        out[arch] = (Gj, params, Gt.requires_grad_(False),
                     jax.jit(Gj.apply, static_argnames=("compute_dtype", "compose_layer",
                                                        "train")))
    return out


@pytest.mark.parametrize("layer", [0, 1, 2, 3])
@pytest.mark.parametrize("arch", ["dusty2/dcgan_eqlr", "none/dcgan_eqlr"])
def test_composed_generator(generators, arch, layer):
    """Three codes blended after stage ``layer`` with random weights, in
    float32 with fixed Gumbel noise: every output within rtol 1e-5 / atol
    1e-5 (the mask exactly).  JAX's alpha (N, 1, 1, C) enters the port as
    (N, C, 1, 1)."""
    _, params, Gt, apply = generators[arch]
    rng = np.random.RandomState(layer)
    ch = Gt.backbone.ch(3 - layer) if arch.startswith("dusty") else Gt.ch(3 - layer)
    z = rng.randn(3, IN_CH).astype(np.float32)
    alpha = rng.rand(3, 1, 1, ch).astype(np.float32)
    kw = dict(compute_dtype=jnp.float32, compose_layer=layer, compose_alpha=jnp.asarray(alpha))
    tkw = dict(compose_layer=layer, compose_alpha=torch.from_numpy(alpha.transpose(0, 3, 1, 2)))
    if arch.startswith("dusty"):
        pix, img = logistic(rng, (1,) + SHAPE + (1,)), logistic(rng, (1, 1, 1, 1))
        want = apply(params, jnp.asarray(z), train=False, rngs={"gumbel": jax.random.PRNGKey(0)},
                     fixed_noise={"pixel": jnp.asarray(pix), "image": jnp.asarray(img)}, **kw)
        tkw.update(train=False, fixed_noise={"pixel": nchw(pix), "image": nchw(img)})
    else:
        want = apply(params, jnp.asarray(z), **kw)
    with torch.no_grad():
        got = Gt(torch.from_numpy(z), None, **tkw)
    assert set(got) == set(want)
    for k in want:
        g, w = nhwc(got[k]), np.asarray(want[k])
        assert g.shape == w.shape == (1,) + SHAPE + w.shape[-1:], k
        if k == "mask":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=k)


# ------------------------------------------------------------ camera, BEV


def test_rotation_matrix():
    """rtol 1e-6 / atol 1e-7 (float32 cos, sin and two 3x3 products)."""
    for theta in ([0.0, 0.0, 0.0], [0.3, -1.2, 2.5], [0.0, np.pi / 3, np.pi / 4]):
        want = np.asarray(jax_euler(np.asarray(theta)))
        got = euler_angles_to_rotation_matrix(np.asarray(theta)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-6)


@pytest.mark.parametrize("view", [(None, None, None), (30.0, None, None), (90.0, 120.0, 10.0)])
def test_camera(view):
    """The demo's BEV camera of its view flags: rtol 1e-6 / atol 1e-7."""
    R, t = demo._camera(*view)
    jR, jt = jax_demo._camera(*view)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-7)
    if jR is None:
        assert R is None
    else:
        np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("view", [(None, None, None), (40.0, -45.0, 60.0)])
def test_render_point_clouds(view):
    """Two 3000-point clouds of the demo's kind (a fifth at the origin) at
    L = 64, top-down and through a rotated camera: within rtol 1e-5 / atol
    1e-6 (float32 splats summed in the same order on both sides); through
    the rotated camera atol 5e-4, since the two frameworks' ``xyz @ R``
    round apart by ulps, which moves a splat by ~1e-5 pixel and a pixel's
    weighted mean colour by up to ~1e-4."""
    rng = np.random.RandomState(7)
    xyz = rng.uniform(-0.8, 0.8, (2, 3000, 3)).astype(np.float32)
    xyz[rng.rand(2, 3000) < 0.2] = 0.0
    col = rng.rand(2, 3000, 3).astype(np.float32)
    R, t = demo._camera(*view)
    jR, jt = jax_demo._camera(*view)
    render = jax.jit(jrender.render_point_clouds, static_argnames=("L",))
    want = np.asarray(render(jnp.asarray(xyz), jnp.asarray(col), L=64, R=jR, t=jt))
    got = render_point_clouds(torch.from_numpy(xyz), torch.from_numpy(col), L=64, R=R, t=t)
    assert got.shape == (2, 64, 64, 3)
    assert float((got.sum(-1) > 0).float().mean()) > 0.05  # points land in view
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 if view[0] is None else 5e-4)
    bare = render_point_clouds(torch.from_numpy(xyz), torch.from_numpy(col), L=64)
    np.testing.assert_allclose(bare.numpy(), np.asarray(render(
        jnp.asarray(xyz), jnp.asarray(col), L=64)), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- colours


def test_turbo_table_is_matplotlibs():
    """The embedded table equals matplotlib's turbo on this host exactly."""
    import matplotlib.cm as cm

    want = np.asarray(cm.turbo(np.linspace(0, 1, 256))[:, :3], np.float32)
    np.testing.assert_array_equal(postprocess.cmap_table("turbo").numpy(), want)
    np.testing.assert_array_equal(postprocess.cmap_table("viridis").numpy(),
                                  jax_cmap_table("viridis"))


def test_cmap_without_matplotlib_raises(monkeypatch):
    """Turbo needs no matplotlib; any other name raises without it."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert postprocess.cmap_table().shape == (256, 3)
    with pytest.raises(RuntimeError, match="matplotlib"):
        postprocess.cmap_table("viridis")


@pytest.mark.parametrize("layout", ["bhw1", "bhw"])
def test_colorize_bit_for_bit(layout):
    """Against the JAX package's colorize, bit for bit, on values outside
    [0, 1] and on exact half steps (rounded half to even on both sides)."""
    rng = np.random.RandomState(8)
    x = rng.uniform(-0.2, 1.2, (2, 8, 16, 1)).astype(np.float32)
    x[0, 0, :8, 0] = (np.arange(8) + 0.5) / 255.0 * 1.0
    x = x if layout == "bhw1" else x[..., 0]
    for name in ("turbo", "viridis"):
        want = jax_colorize(x, jax_cmap_table(name))
        got = postprocess.colorize(torch.from_numpy(x), postprocess.cmap_table(name))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(postprocess.colorize(torch.from_numpy(x)).numpy(),
                                  jax_colorize(x))


# -------------------------------------------------------------- corruption


def _scan(seed=9):
    """A (1, 32, 64, 1) inverse depth with a fifth of the pixels and a 6x6
    block dropped, and its mask."""
    rng = np.random.RandomState(seed)
    inv = rng.uniform(0.05, 1.0, (1, 32, 64, 1)).astype(np.float32)
    mask = (rng.rand(1, 32, 64, 1) > 0.2).astype(np.float32)
    mask[:, 10:16, 20:26] = 0.0
    return inv * mask, mask


@pytest.mark.parametrize("name", CORRUPTIONS)
def test_corruption(name):
    """Each corruption against the JAX package's, the random ones with its
    uniform, permutation and normal draws of the same key handed in:
    exactly equal, but additive noise within atol 1e-7 (a float32 sum)."""
    inv, mask = _scan()
    key = jax.random.PRNGKey(11)
    jd, jm = jcor.apply_corruption(key, jnp.asarray(inv), jnp.asarray(mask), name)
    td, tm = corruption.apply_corruption(JaxCorruptionDraws(key), torch.from_numpy(inv),
                                         torch.from_numpy(mask), name)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-7)
    if name == "closing":
        assert float(td.min()) > 0 and float((torch.from_numpy(inv) == 0).sum()) > 0


def test_corruption_names():
    assert tuple(demo.CORRUPTIONS) == CORRUPTIONS
    with pytest.raises(NotImplementedError):
        corruption.apply_corruption(None, torch.zeros(1, 2, 2, 1), torch.ones(1, 2, 2, 1),
                                    "blur")


def test_closing_is_bounded():
    """An all-zero scan never fills: the loop stops after 64 rounds (JAX's
    bound) and both give zeros."""
    z = np.zeros((1, 8, 16, 1), np.float32)
    np.testing.assert_array_equal(corruption.closing(torch.from_numpy(z)).numpy(),
                                  np.asarray(jcor.closing(jnp.asarray(z))))


def test_seeded_corruption_draws_repeat():
    inv, mask = (torch.from_numpy(a) for a in _scan())
    a = corruption.apply_corruption(demo.Draws(3).corruption(), inv, mask, "dropout")[1]
    b = corruption.apply_corruption(demo.Draws(3).corruption(), inv, mask, "dropout")[1]
    c = corruption.apply_corruption(demo.Draws(4).corruption(), inv, mask, "dropout")[1]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0.05 < float(a.sum() / mask.sum()) < 0.15  # dropout keeps a tenth


# ------------------------------------------------------------ interpolation


def test_lerp_and_slerp():
    """rtol 1e-5 / atol 1e-6 at the ends and between (float32 arccos and
    sines); the ends are the end points."""
    rng = np.random.RandomState(12)
    ends = rng.randn(2, IN_CH).astype(np.float32)
    lo, hi = torch.from_numpy(ends[:1]), torch.from_numpy(ends[1:])
    for w in np.linspace(0, 1, 5):
        for jf, tf in ((jinv.lerp, tinv.lerp), (jinv.slerp, tinv.slerp)):
            want = np.asarray(jf(w, jnp.asarray(ends[:1]), jnp.asarray(ends[1:])))
            np.testing.assert_allclose(tf(float(w), lo, hi).numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tinv.slerp(1.0, lo, hi).numpy(), ends[1:], rtol=1e-5, atol=1e-5)


def test_multicode_loop_against_jax(generators):
    """20 steps of multi-code inversion through the narrow DUSty-II
    generator (3 codes composed after up0) against a masked L1 target:
    z within rtol 1e-3 / atol 1e-4 and alpha within atol 1e-6 (two float32
    Adams in other orders of operations, fed back 20 times)."""
    Gj, params, Gt, _ = generators["dusty2/dcgan_eqlr"]
    rng = np.random.RandomState(13)
    pix, img = logistic(rng, (1,) + SHAPE + (1,)), logistic(rng, (1, 1, 1, 1))
    target = rng.rand(1, *SHAPE, 1).astype(np.float32)
    mask = (rng.rand(1, *SHAPE, 1) > 0.3).astype(np.float32)
    z0 = rng.randn(3, IN_CH).astype(np.float32)
    ch = Gt.backbone.ch(2)

    def jloss(lat):
        out = Gj.apply(params, lat["z"], compute_dtype=jnp.float32, train=False,
                       fixed_noise={"pixel": jnp.asarray(pix), "image": jnp.asarray(img)},
                       compose_layer=1, compose_alpha=lat["alpha"],
                       rngs={"gumbel": jax.random.PRNGKey(0)})
        d = jnp.abs((out["depth_orig"] + 1) / 2 - target) * mask
        return d.sum(axis=(1, 2, 3)) / mask.sum()

    noise = {"pixel": nchw(pix), "image": nchw(img)}
    tt, tm = torch.from_numpy(target.transpose(0, 3, 1, 2)), torch.from_numpy(
        mask.transpose(0, 3, 1, 2))

    def tloss(lat):
        out = Gt(lat["z"], None, train=False, fixed_noise=noise, compose_layer=1,
                 compose_alpha=lat["alpha"])
        d = torch.abs((out["depth_orig"] + 1) / 2 - tt) * tm
        return d.sum(dim=(1, 2, 3)) / tm.sum()

    lat0 = {"z": jinv.project_sphere(jnp.asarray(z0)), "alpha": jnp.full((3, 1, 1, ch), 1 / 3)}
    want = jax.jit(jinv.make_multicode_loop(jloss, num_steps=20))(lat0)
    got = tinv.make_multicode_loop(tloss, num_steps=20)(
        {"z": torch.from_numpy(np.array(lat0["z"])), "alpha": torch.full((3, ch, 1, 1), 1 / 3)})
    np.testing.assert_allclose(got["z"].numpy(), np.asarray(want["z"]), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["alpha"].numpy(),
                               np.asarray(want["alpha"]).transpose(0, 3, 1, 2), atol=1e-6)
    assert float(tloss(got)) < float(tloss({"z": torch.from_numpy(np.array(lat0["z"])),
                                            "alpha": torch.full((3, ch, 1, 1), 1 / 3)}))


# ---------------------------------------------------------- image writers


def test_png_round_trip(tmp_path):
    """RGB and paletted PNGs decode to their pixels exactly (PIL)."""
    rng = np.random.RandomState(14)
    rgb = rng.randint(0, 256, (13, 29, 3)).astype(np.uint8)
    video.write_png(str(tmp_path / "a.png"), rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png").convert("RGB")), rgb)
    idx = rng.randint(0, 4, (7, 5)).astype(np.uint8)
    pal = ((0, 0, 0), (255, 0, 0), (0, 255, 0), (1, 2, 3))
    video.write_png(str(tmp_path / "p.png"), idx, pal)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png").convert("RGB")),
                                  np.asarray(pal, np.uint8)[idx])


def test_gif_without_cv2(tmp_path, monkeypatch):
    """Without cv2 ``save_video`` writes a GIF that PIL decodes: the frame
    count, the size, every pixel its nearest palette entry, so within half
    a level step of the frame (18 for red and green, 42 for blue), on
    frames larger than one clear group."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    rng = np.random.RandomState(15)
    frames = [rng.rand(40, 70, 3).astype(np.float32) for _ in range(3)]
    path = video.save_video(frames, str(tmp_path / "slerp"), fps=10.0)
    assert path.endswith("slerp.gif")
    im = Image.open(path)
    assert im.n_frames == 3 and im.size == (70, 40)
    for i, f in enumerate(frames):
        im.seek(i)
        got = np.asarray(im.convert("RGB")).astype(np.int64)
        want8 = np.asarray(np.clip(f, 0, 1) * 255, np.uint8)
        np.testing.assert_array_equal(got, video.gif_palette()[video.quantize(want8)])
        assert (np.abs(got - want8).max(axis=(0, 1)) <= (18, 18, 42)).all()


# ---------------------------------------------------------------- the app


class _Streamlit(types.ModuleType):
    """A stand-in ``streamlit``: every widget returns its default, every
    button is pressed, decorators and contexts do nothing."""

    def __init__(self):
        super().__init__("streamlit")
        self.sidebar = self

    def __getattr__(self, name):
        return lambda *a, **k: None

    def cache_resource(self, fn):
        return fn

    def expander(self, *a, **k):
        return _Ctx()

    spinner = expander

    def slider(self, label, **k):
        return k["value"]

    def number_input(self, label, value=0, **k):
        return value

    def selectbox(self, label, options, index=0):
        return options[index]

    def multiselect(self, label, options, default=()):
        return list(default)

    def checkbox(self, label, value=False):
        return value

    def button(self, label):
        return True


class _Ctx:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.mark.parametrize("page", ["synthesis", "inversion"])
def test_app_builds_the_jax_apps_argv(page, monkeypatch):
    """Under a stub ``streamlit`` both apps pass the demo CLI the same
    arguments (the output directory aside); without streamlit the port's
    app exits naming the port's demo CLI."""
    from dusty_gan_torch.cli import app

    st = _Streamlit()
    monkeypatch.setitem(sys.modules, "streamlit", st)
    import dusty_gan_tpu.cli.app as jax_app

    seen = {}
    monkeypatch.setattr(jax_app.demo_cli, "main", lambda argv: seen.__setitem__("jax", argv))
    monkeypatch.setattr(app.demo_cli, "main", lambda argv: seen.__setitem__("torch", argv))
    getattr(jax_app, f"{page}_ui")("m.pth", "c.yaml")
    getattr(app, f"{page}_ui")(st, "m.pth", "c.yaml")
    out = lambda argv: argv[argv.index("--out") + 1]  # noqa: E731
    assert out(seen["torch"]).endswith(page) and out(seen["jax"]).endswith(page)
    strip = lambda argv: [a for a in argv if a != out(argv)]  # noqa: E731
    assert strip(seen["torch"]) == strip(seen["jax"])
    monkeypatch.setitem(sys.modules, "streamlit", None)
    with pytest.raises(SystemExit, match="dusty_gan_torch.cli.demo"):
        app.main()
