"""dusty_gan_torch metrics against the JAX package on the same numpy inputs:
FPS indices (exact), JSD (exact occupancy counts; the divergence within
atol 1e-5, since numpy and XLA sum the ~10k float32 terms of ~10-bit
entropies in different orders and with different log2 routines: 1.9e-6
seen), SWD
with the JAX draws passed in (rtol 1e-4: float32 pyramids and projections
summed in other orders), the plain Chamfer block against the Pallas kernel
in interpret mode (rtol 1e-5 / atol 1e-6, as tests/test_chamfer_pallas.py),
and COV/MMD/1-NNA (values rtol 1e-4, counts equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_tpu.metrics import jsd as jjsd
from dusty_gan_tpu.metrics.chamfer_pallas import cd_block_pallas
from dusty_gan_tpu.metrics.cov_mmd_1nna import compute_cov_mmd_1nna as jax_cov
from dusty_gan_tpu.metrics.fps import downsample_point_clouds as jax_downsample
from dusty_gan_tpu.metrics.fps import furthest_point_sampling as jax_fps
from dusty_gan_tpu.metrics.swd import compute_swd as jax_swd

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from dusty_gan_torch import kernels
from dusty_gan_torch.metrics import jsd as tjsd
from dusty_gan_torch.metrics.chamfer_cuda import cd_block, cd_block_reference
from dusty_gan_torch.metrics.cov_mmd_1nna import (block_schedule, compute_cov_mmd_1nna,
                                                  pairwise_cd)
from dusty_gan_torch.metrics.fps import (downsample_point_clouds, furthest_point_sampling,
                                         furthest_point_sampling_reference)
from dusty_gan_torch.metrics.swd import TorchDraws, compute_swd

from tests.torch_parity import JaxDraws

COUNT_KEYS = ("cov-cd", "1-nn-tp-cd", "1-nn-fp-cd", "1-nn-fn-cd", "1-nn-tn-cd",
              "1-nn-accuracy-cd")


def _clouds(seed, b, n, dropped=0.0, scale=1.0):
    rng = np.random.RandomState(seed)
    p = (scale * rng.uniform(-1, 1, (b, n, 3))).astype(np.float32)
    p[rng.uniform(size=(b, n)) < dropped] = 0.0
    return p


@pytest.mark.parametrize("dropped", [0.0, 0.3])
def test_fps_indices_exact(dropped):
    """First index 0, dropped origin points never picked, argmax ties to
    the first index: the same indices as the JAX loop."""
    p = _clouds(0, 3, 256, dropped)
    want = np.asarray(jax_fps(jnp.asarray(p), 40))
    got = furthest_point_sampling(torch.from_numpy(p), 40).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == 0).all()
    np.testing.assert_array_equal(
        downsample_point_clouds(torch.from_numpy(p), 40).numpy(),
        np.asarray(jax_downsample(jnp.asarray(p), 40)))


def test_fps_skips_points_near_the_origin():
    """Points with |p|^2 <= 1e-3 are never picked, even when they are the
    furthest from a tight far-away cluster."""
    rng = np.random.RandomState(15)
    p = (0.5 + 0.01 * rng.randn(2, 64, 3)).astype(np.float32)
    p[:, [5, 17]] = 0.015  # |p|^2 = 6.75e-4
    p[:, 30] = 0.0
    want = np.asarray(jax_fps(jnp.asarray(p), 20))
    got = furthest_point_sampling(torch.from_numpy(p), 20).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.isin(got, [5, 17, 30]).any()


def test_fps_ties_go_to_first_index():
    """A duplicated grid makes many equal distances."""
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    p = np.concatenate([g, g])[None].astype(np.float32) / 3.0
    want = np.asarray(jax_fps(jnp.asarray(p), 30))
    np.testing.assert_array_equal(furthest_point_sampling(torch.from_numpy(p), 30).numpy(),
                                  want)


def test_fps_cpu_tensors_take_the_plain_loop(monkeypatch):
    """On the CPU the wrapper returns the plain loop's indices, builds no
    kernel and launches none."""
    monkeypatch.setattr(kernels, "load", lambda name: pytest.fail(f"loaded {name}"))
    p = torch.from_numpy(_clouds(4, 2, 300, 0.2))
    got = furthest_point_sampling(p, 50)
    np.testing.assert_array_equal(got.numpy(),
                                  furthest_point_sampling_reference(p, 50).numpy())
    assert furthest_point_sampling.launches == 0


@pytest.mark.parametrize("fn", [furthest_point_sampling, furthest_point_sampling_reference])
@pytest.mark.parametrize("shape,dtype,k,error,match", [
    ((2, 10), torch.float32, 4, ValueError, r"\(B, N, 3\)"),
    ((2, 10, 2), torch.float32, 4, ValueError, r"\(B, N, 3\)"),
    ((2, 10, 3), torch.float64, 4, TypeError, "float32"),
    ((2, 10, 3), torch.bfloat16, 4, TypeError, "float32"),
    ((2, 10, 3), torch.float32, 0, ValueError, "k >= 1"),
    ((2, 0, 3), torch.float32, 4, ValueError, "non-empty"),
])
def test_fps_rejects_bad_arguments(fn, shape, dtype, k, error, match):
    with pytest.raises(error, match=match):
        fn(torch.ones(shape, dtype=dtype), k)


def test_fps_never_falls_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on CUDA raises, and does not
    take the plain loop."""
    with pytest.raises(ValueError, match="cpu or cuda"):
        furthest_point_sampling(torch.empty((2, 10, 3), device="meta"), 4)


def test_fps_library_is_declared():
    assert set(kernels.SIGNATURES["fps"]) == {"fps_launch", "fps_staged_points",
                                             "fps_error_string"}
    assert kernels.library_path("fps").name.startswith("libfps-")
    src = (kernels.CSRC / "fps.cu").read_text()
    for fn in kernels.SIGNATURES["fps"]:
        assert f" {fn}(" in src, fn


def test_jsd_exact_counts():
    a = _clouds(1, 4, 300, 0.1, 0.55)  # some points outside the sphere
    b = _clouds(2, 3, 300, 0.1, 0.5)
    for p in (a, b):
        want, _ = jjsd.occupancy_counts(p, 28, True, need_bernoulli=False)
        np.testing.assert_array_equal(tjsd.occupancy_counts(p), np.asarray(want))
    want = jjsd.compute_jsd(a, b)
    got = tjsd.compute_jsd(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the double-epsilon quirk: identical sets are not at exactly 0
    assert tjsd.compute_jsd(a, a) == pytest.approx(jjsd.compute_jsd(a, a), abs=1e-5)
    assert tjsd.compute_jsd(a, a) > 1e-3


def test_swd_with_jax_draws():
    rng = np.random.RandomState(3)
    a = np.tanh(rng.randn(6, 64, 256, 1)).astype(np.float32)
    b = np.tanh(rng.randn(6, 64, 256, 1) + 0.3).astype(np.float32)
    key = jax.random.PRNGKey(0)
    want = jax_swd(jnp.asarray(a), jnp.asarray(b), key=key, batch_size=4)
    got = compute_swd(torch.from_numpy(a), torch.from_numpy(b), JaxDraws(key),
                      batch_size=4)
    assert list(got) == list(want) == ["swd-16", "swd-32", "swd-64", "swd-mean"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_swd_default_draws_are_seeded():
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.randn(3, 32, 128, 1).astype(np.float32))
    b = torch.from_numpy(rng.randn(3, 32, 128, 1).astype(np.float32))
    s1, s2 = compute_swd(a, b), compute_swd(a, b, TorchDraws(0))
    assert s1 == s2 and list(s1) == ["swd-16", "swd-32", "swd-mean"]
    assert compute_swd(a, a)["swd-mean"] == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("shapes", [((5, 256), (3, 128)), ((4, 100), (2, 77)),
                                    ((3, 64), (4, 200)), ((2, 300), (3, 300)),
                                    ((3, 1), (4, 64)),     # 1-point row clouds
                                    ((3, 64), (2, 1)),     # 1-point column clouds
                                    ((2, 500), (3, 5)),    # N >> M
                                    ((3, 200), None),      # a self pair
                                    # M past the Pallas kernel's one-pass tile
                                    # (_TM = 2048): its two-pass branch
                                    ((2, 64), (2, 2049))])
def test_cd_block_reference_matches_pallas(shapes):
    (r, n), cm = shapes
    a = _clouds(5, r, n)
    b = a if cm is None else _clouds(6, *cm)
    c, m = b.shape[:2]
    want = np.asarray(cd_block_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = cd_block_reference(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (r, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if cm is None:
        np.testing.assert_array_equal(np.diag(got.numpy()), 0.0)


def test_cd_block_wrapper_on_cpu_uses_plain_version():
    a, b = torch.from_numpy(_clouds(7, 3, 50)), torch.from_numpy(_clouds(8, 2, 60))
    before = cd_block.launches
    np.testing.assert_array_equal(cd_block(a, b).numpy(), cd_block_reference(a, b).numpy())
    assert cd_block.launches == before  # no kernel launch on the CPU


def test_cd_block_reference_chunks_columns(monkeypatch):
    """The plain version bounds its distance tile; the chunked result equals
    the unchunked one."""
    from dusty_gan_torch.metrics import chamfer_cuda

    a, b = torch.from_numpy(_clouds(9, 2, 40)), torch.from_numpy(_clouds(10, 7, 30))
    full = cd_block_reference(a, b)
    monkeypatch.setattr(chamfer_cuda, "_REFERENCE_BUDGET", 40 * 30 * 2)
    np.testing.assert_array_equal(cd_block_reference(a, b).numpy(), full.numpy())


@pytest.mark.parametrize("bad", [
    lambda a, b: (a.double(), b.double()),
    lambda a, b: (a[..., :2], b[..., :2]),
    lambda a, b: (a[0], b),
    lambda a, b: (a[:, :0], b),
])
def test_cd_block_rejects_bad_inputs(bad):
    a, b = torch.from_numpy(_clouds(11, 2, 8)), torch.from_numpy(_clouds(12, 2, 8))
    with pytest.raises((ValueError, TypeError)):
        cd_block(*bad(a, b))


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels.os.path, "exists",
                        lambda p: False if str(p).endswith("nvcc") else True)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.nvcc()
    assert kernels.library_path("cd_block").name.startswith("libcd_block-")


@pytest.mark.parametrize("symmetric", [True, False])
def test_pairwise_matrix_and_scores(symmetric):
    gen = _clouds(13, 9, 64, 0.1, 0.5)
    ref = _clouds(14, 7, 64, 0.1, 0.5)
    if symmetric:
        # the self matrices take the upper-triangle path with the mirror
        t = torch.from_numpy(ref)
        m = pairwise_cd(t, t, 3)
        np.testing.assert_array_equal(m, m.T)
        full = pairwise_cd(t, t.clone(), 3)
        np.testing.assert_allclose(m, full, rtol=1e-5, atol=1e-6)
    want = jax_cov(jnp.asarray(gen), jnp.asarray(ref), 4, ("cd",))
    got = compute_cov_mmd_1nna(torch.from_numpy(gen), torch.from_numpy(ref), 4)
    assert set(got) == set(want)
    for k in want:
        if k in COUNT_KEYS:
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_block_schedule_skips_lower_blocks():
    sym = list(block_schedule(40, 40, 16, 16, True))
    assert (32, 0) not in sym and (32, 16) not in sym and (16, 16) in sym
    assert len(list(block_schedule(40, 40, 16, 16, False))) == 9 and len(sym) == 6
    # the 5000-scan protocol at (16, 512): 313 x 10 blocks, 3130 when not
    # symmetric
    assert len(list(block_schedule(5000, 5000, 16, 512, False))) == 3130
