"""dusty_gan_torch's EMD against the JAX package on the same numpy clouds.

* The dense plain auction (``approx_match`` + ``match_cost``) against
  ``earth_mover_distance_dense``: rtol 1e-4.  The port forms squared
  distances from coordinate differences, the JAX dense path as
  |x|^2 + |y|^2 - 2 x.y; the ten rounds at levels down to -16384 amplify
  that rounding to ~1.4e-5 relative at 2048 points.
* The plain block and pair versions against the Pallas kernels in
  interpret mode: costs rtol 5e-4 (the JAX package's own kernel-against-
  dense tolerance), residues R and C atol 1e-5, V and U atol 1e-4.
* Gradients of ``earth_mover_distance`` against ``jax.grad`` of the dense
  cost with the match held constant: atol 2e-4.
* The pairwise EMD matrices and COV/MMD/1-NNA over CD and EMD: values
  rtol 1e-4, counts equal.
* The auction is permutation-equivariant: the plain versions on clouds in
  another point order give the same costs (rtol 1e-5, only the float32
  sum order differs) and the residues permuted alike.
* Above the kernels' shared-memory path (3072 points a cloud) the plain
  versions against the JAX dense path: costs rtol 1e-4, residues per pair
  in relative L2 at 1e-3 (float32 moves single entries of a match between
  near columns at that level, as chip_smoke.py holds them on the card).
* The wrappers' choice between the shared-memory and the device-memory
  path and the size of the device-memory path's chunks, as pure functions.
* The build helpers of ``kernels.py`` that ``chip_smoke.py`` reads ptxas's
  report through.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_tpu.metrics import emd as jemd
from dusty_gan_tpu.metrics.cov_mmd_1nna import _pairwise_distance as jax_pairwise
from dusty_gan_tpu.metrics.cov_mmd_1nna import _pairwise_emd_rowwise as jax_pairwise_emd_dense
from dusty_gan_tpu.metrics.cov_mmd_1nna import compute_cov_mmd_1nna as jax_cov
from dusty_gan_tpu.metrics.emd_pallas import emd_block_pallas, emd_pair_pallas

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from dusty_gan_torch import kernels
from dusty_gan_torch.metrics import emd_cuda
from dusty_gan_torch.metrics.cov_mmd_1nna import compute_cov_mmd_1nna, pairwise_emd
from dusty_gan_torch.metrics.emd import (approx_match, compute_emd, earth_mover_distance,
                                         earth_mover_distance_dense, match_cost)
from dusty_gan_torch.metrics.emd_cuda import (SHARED_MAX_POINTS, WORKSPACE_CAP_BYTES,
                                              emd_block, emd_block_reference, emd_pair,
                                              emd_pair_reference, pairs_per_launch,
                                              state_floats, uses_device_memory)

COUNT_KEYS = tuple(f"{k}-{m}" for m in ("cd", "emd") for k in (
    "cov", "1-nn-tp", "1-nn-fp", "1-nn-fn", "1-nn-tn", "1-nn-accuracy"))


def _clouds(seed, b, n, scale=0.3):
    rng = np.random.RandomState(seed)
    return (scale * rng.randn(b, n, 3)).astype(np.float32)


def _lidar_like(seed, b, n):
    """Unit-space LiDAR-like clouds: uniform in [-0.8, 0.8]^3 with a fifth
    of the points at the origin (equal points)."""
    rng = np.random.RandomState(seed)
    p = (rng.rand(b, n, 3) * 1.6 - 0.8).astype(np.float32)
    p[rng.rand(b, n) < 0.2] = 0.0
    return p


CLOUD_KINDS = {"gaussian": _clouds, "lidar_like": _lidar_like}


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("n,m,scale", [(128, 128, 0.3), (512, 512, 0.3), (2048, 2048, 0.3),
                                       (256, 128, 1.0), (128, 384, 1.0), (300, 200, 1.0)])
def test_dense_cost_matches_jax(n, m, scale):
    """Equal and uneven masses (multi_r = N // M, multi_l = M // N) and a
    ragged pair whose integer mass split leaves row mass unmatched."""
    a, b = _clouds(n, 2, n, scale), _clouds(m + 1, 2, m, scale)
    want = np.asarray(jemd.earth_mover_distance_dense(jnp.asarray(a), jnp.asarray(b)))
    x, y = _t(a), _t(b)
    got = match_cost(x, y, approx_match(x, y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    # one pair a batch: the CPU matmuls block their float32 sums by batch
    np.testing.assert_allclose(earth_mover_distance_dense(x, y, max_batch=1).numpy(),
                               got.numpy(), rtol=1e-5)


def test_levels_are_exact_powers_of_four():
    assert emd_cuda.LEVELS == (-16384.0, -4096.0, -1024.0, -256.0, -64.0, -16.0, -4.0,
                               -1.0, -0.25, 0.0)


def test_match_masses():
    """Rows carry at most multi_l, columns at most multi_r (here 3 and 1)."""
    x, y = _t(_clouds(1, 1, 100)), _t(_clouds(2, 1, 300))
    match = approx_match(x, y)
    assert float(match.sum(2).max()) <= 3.0 + 1e-4
    assert float(match.sum(1).max()) <= 1.0 + 1e-4
    assert float(match.sum()) == pytest.approx(300.0, rel=1e-3)


def test_emd_block_reference_matches_pallas():
    a, b = _clouds(3, 2, 128, 1.0), _clouds(4, 3, 128, 1.0)
    want = np.asarray(emd_block_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = emd_block_reference(_t(a), _t(b))
    assert got.shape == (2, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4)


def test_emd_pair_reference_matches_pallas():
    a, b = _clouds(5, 2, 128, 1.0), _clouds(6, 2, 128, 1.0)
    want = emd_pair_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    got = emd_pair_reference(_t(a), _t(b))
    for name, g, w, tol in zip(("cost", "R", "C", "V", "U"), got, want,
                               (dict(rtol=5e-4), dict(atol=1e-5), dict(atol=1e-5),
                                dict(atol=1e-4), dict(atol=1e-4))):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **tol)


def test_block_and_pair_are_one_function():
    """The block's entries are the pair costs of every (row, col) pair."""
    a, b = _t(_clouds(7, 3, 200)), _t(_clouds(8, 2, 150))
    block = emd_block_reference(a, b)
    for i in range(3):
        cost = emd_pair_reference(a[i].expand(2, -1, -1), b)[0]
        np.testing.assert_allclose(block[i].numpy(), cost.numpy(), rtol=1e-5)


@pytest.mark.parametrize("n,m", [(128, 128), (300, 200)])
def test_gradients_match_jax_dense(n, m):
    """The analytic backward 2g(Rx - V), 2g(Cy - U) against autodiff of the
    JAX dense cost with stop_gradient(match), for a weighted sum."""
    a, b = _clouds(9, 2, n, 1.0), _clouds(10, 2, m, 1.0)
    wts = np.array([0.7, -1.3], np.float32)

    def jax_loss(x, y):
        match = jax.lax.stop_gradient(jemd.approx_match(x, y))
        return jnp.sum(jemd.match_cost(x, y, match) * wts)

    gx_w, gy_w = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    x, y = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    (earth_mover_distance(x, y) * _t(wts)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx_w), atol=2e-4)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(gy_w), atol=2e-4)
    # the dense path through autograd gives the same gradients
    x2, y2 = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    (earth_mover_distance_dense(x2, y2) * _t(wts)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), x2.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(y.grad.numpy(), y2.grad.numpy(), atol=1e-5)


def test_compute_emd_divides_by_n_and_needs_equal_counts():
    x, y = _t(_clouds(11, 2, 96)), _t(_clouds(12, 2, 96))
    np.testing.assert_allclose(compute_emd(x, y).numpy(),
                               (earth_mover_distance(x, y) / 96.0).numpy(), rtol=0)
    want = np.asarray(jemd.compute_emd(jnp.asarray(x.numpy()), jnp.asarray(y.numpy())))
    np.testing.assert_allclose(compute_emd(x, y).numpy(), want, rtol=1e-4)
    with pytest.raises(ValueError, match="equal point counts"):
        compute_emd(x, y[:, :95])


def test_wrappers_on_cpu_use_plain_versions():
    a, b = _t(_clouds(13, 2, 60)), _t(_clouds(14, 3, 50))
    blocks, pairs = emd_block.launches, emd_pair.launches
    np.testing.assert_array_equal(emd_block(a, b).numpy(), emd_block_reference(a, b).numpy())
    for g, w in zip(emd_pair(a, b[:2]), emd_pair_reference(a, b[:2])):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert (emd_block.launches, emd_pair.launches) == (blocks, pairs)  # no kernel launch


def test_reference_chunks_pairs(monkeypatch):
    """The plain versions bound their (pairs, N, M) tensors; chunked results
    equal unchunked ones up to the CPU matmuls' float32 blocking by batch."""
    a, b = _t(_clouds(15, 3, 40)), _t(_clouds(16, 4, 30))
    block, pair = emd_block_reference(a, b), emd_pair_reference(a, b[:3])
    monkeypatch.setattr(emd_cuda, "_REFERENCE_BUDGET", 40 * 30 * 2)
    np.testing.assert_allclose(emd_block_reference(a, b).numpy(), block.numpy(), rtol=1e-5)
    for g, w in zip(emd_pair_reference(a, b[:3]), pair):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn", [emd_block, emd_pair])
@pytest.mark.parametrize("bad", [
    lambda a, b: (a.double(), b.double()),
    lambda a, b: (a[..., :2], b[..., :2]),
    lambda a, b: (a[0], b),
    lambda a, b: (a[:, :0], b),
])
def test_rejects_bad_inputs(fn, bad):
    a, b = _t(_clouds(17, 2, 8)), _t(_clouds(18, 2, 8))
    with pytest.raises((ValueError, TypeError)):
        fn(*bad(a, b))


def test_pair_needs_matched_batches():
    with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
        emd_pair(_t(_clouds(19, 2, 8)), _t(_clouds(20, 3, 8)))


@pytest.mark.parametrize("fn", [emd_block, emd_pair])
def test_off_cpu_shape_limit_raises_before_launch(fn):
    """Off the CPU, clouds of any size reach the kernels (there is no
    point limit since the device-memory path), so a device that is not
    CUDA raises for both paths' sizes; more pairs than one launch takes
    raise before any launch, on any device."""
    big = torch.empty((1, SHARED_MAX_POINTS + 1, 3), device="meta")
    ok = torch.empty((1, 64, 3), device="meta")
    for a, b in ((big, ok), (ok, big), (ok, ok)):
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn(a, b)
    many = torch.empty((46341, 1, 3), device="meta")
    if fn is emd_block:  # 46341^2 pairs
        with pytest.raises(ValueError, match="pairs"):
            fn(many, many)


# (N, M, residues, pairs) -> device-memory path?, pairs a launch
PATH_CASES = [
    ((2048, 2048, False, 8192), (False, 8192)),   # the protocol's block
    ((3072, 3072, True, 512), (False, 512)),      # the shared path's largest
    ((3073, 100, False, 40), (True, 40)),         # one cloud above it
    ((100, 3073, True, 40), (True, 40)),
    ((4096, 4096, True, 8192), (True, 3640)),     # 2.4 GB at once, chunked
    ((4096, 4096, False, 8192), (True, 5957)),
    ((16384, 16384, True, 10_000), (True, 910)),
    ((30_000_000, 30_000_000, True, 3), (True, 1)),  # one pair above the cap
]


@pytest.mark.parametrize("shape,want", PATH_CASES)
def test_path_choice_and_workspace_chunks(shape, want):
    n, m, residues, pairs = shape
    device_memory, chunk = want
    assert uses_device_memory(n, m) == device_memory
    assert pairs_per_launch(n, m, residues, pairs) == chunk
    if device_memory and chunk > 1:
        assert chunk * 4 * state_floats(n, m, residues) <= WORKSPACE_CAP_BYTES
        assert (chunk + 1) * 4 * state_floats(n, m, residues) > WORKSPACE_CAP_BYTES \
            or chunk == pairs


def test_state_floats_match_the_kernels_state():
    """csrc/emd.cu's State: two float4 clouds, remain_l and remain_r, and E
    (K4) or R, V0-2 (N) and C, U0-2 (M) (K5), padded to whole float4s;
    the launch functions refuse a smaller workspace."""
    assert state_floats(4096, 4096, True) == 18 * 4096
    assert state_floats(4097, 4096, False) == (6 * 4097 + 5 * 4096 + 3) // 4 * 4
    assert all(state_floats(n, m, r) % 4 == 0 for n in (1, 2, 3) for m in (1, 5) for r in (0, 1))
    src = (kernels.CSRC / "emd.cu").read_text()
    assert "(residues ? 9LL : 6LL) * N + (residues ? 9LL : 5LL) * M" in src
    assert f"kSharedMaxPoints = {SHARED_MAX_POINTS};" in src
    assert "work_floats / pairs >= state_floats(N, M, residues)" in src


def test_pair_reference_above_shared_limit_matches_jax():
    """(1, 3200) x (1, 3100): the dense auction of the kernels' device-memory
    path against JAX's approx_match and match_cost."""
    a, b = _clouds(30, 1, 3200), _clouds(31, 1, 3100)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    match = jemd.approx_match(ja, jb)
    want = (jemd.match_cost(ja, jb, match), match.sum(2), match.sum(1),
            jnp.einsum("bnm,bmc->bnc", match, jb), jnp.einsum("bnm,bnc->bmc", match, ja))
    got = emd_pair_reference(_t(a), _t(b))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4)
    for name, g, w in zip("RCVU", got[1:], want[1:]):
        w = np.asarray(w, np.float64)
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert rel <= 1e-3, (name, rel)


def test_block_reference_above_shared_limit_matches_jax():
    """A (2, 3200)^2 block of per-point costs against the JAX package's
    dense row loop, _pairwise_emd_rowwise, which scores any shape its
    Pallas kernels do not take."""
    a, b = _clouds(32, 2, 3200), _clouds(33, 2, 3200)
    want = jax_pairwise_emd_dense(jnp.asarray(a), jnp.asarray(b), 2, False)
    got = emd_block_reference(_t(a), _t(b)) / 3200.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


def test_zero_padding_clouds_stay_finite():
    """blocked_matrix pads with all-zero clouds: w = 1 everywhere."""
    z, x = torch.zeros((2, 64, 3)), _t(_clouds(21, 2, 64))
    block = emd_block_reference(torch.cat([x, z]), torch.cat([x, z]))
    assert bool(torch.isfinite(block).all())
    assert float(block[2:, 2:].abs().max()) == 0.0
    # a zero cloud against a cloud costs sum |y|^2 C with C = 1
    np.testing.assert_allclose(block[2, :2].numpy(), (x * x).sum((1, 2)).numpy(), rtol=1e-5)


@pytest.mark.parametrize("symmetric", [True, False])
def test_pairwise_emd_matches_jax(symmetric):
    a, b = _clouds(22, 7, 64, 0.5), _clouds(23, 5, 64, 0.5)
    if symmetric:
        t = _t(a)
        got = pairwise_emd(t, t, 3)
        np.testing.assert_array_equal(got, got.T)  # mirrored exactly
        # EMD is not symmetric: the mirror keeps emd(row, col) of the upper
        # triangle, the full matrix holds both
        full = pairwise_emd(t, t.clone(), 3)
        upper = np.triu_indices(7, 1)
        np.testing.assert_allclose(got[upper], full[upper], rtol=1e-5)
        assert not np.allclose(full, full.T, rtol=1e-6, atol=0)
        ja = jnp.asarray(a)
        want = jax_pairwise(ja, ja, 3, ("emd",))["emd"]
    else:
        got = pairwise_emd(_t(a), _t(b), 3)
        want = jax_pairwise(jnp.asarray(a), jnp.asarray(b), 3, ("emd",))["emd"]
    assert got.shape == want.shape
    # a self pair's cost is ~0 as the difference of sum |x|^2 R + sum |y|^2 C
    # and 2 sum x.V, each ~the cloud's spread: float32 leaves ~1e-6 of it
    diag = np.eye(*got.shape, dtype=bool) if symmetric else np.zeros(got.shape, bool)
    np.testing.assert_allclose(got[~diag], want[~diag], rtol=1e-4)
    np.testing.assert_allclose(got[diag], want[diag], atol=1e-5)
    with pytest.raises(ValueError, match="equal point counts"):
        pairwise_emd(_t(a), _t(b[:, :63]), 3)


def test_cov_mmd_1nna_cd_and_emd_key_by_key():
    gen, ref = _clouds(24, 9, 64, 0.5), _clouds(25, 7, 64, 0.5)
    want = jax_cov(jnp.asarray(gen), jnp.asarray(ref), 4, ("cd", "emd"))
    timings = {}
    got = compute_cov_mmd_1nna(_t(gen), _t(ref), 4, ("cd", "emd"), timings=timings)
    assert list(got) == list(want) and set(timings) == {"pairwise_cd", "pairwise_emd"}
    for k in want:
        if k in COUNT_KEYS:
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    emd_only = compute_cov_mmd_1nna(_t(gen), _t(ref), 4, ("emd",))
    assert emd_only == {k: v for k, v in got.items() if k.endswith("-emd")}


@pytest.mark.parametrize("metrics", [("cd", "chamfer"), ("l2",), ()])
def test_unknown_metric_raises(metrics):
    t = torch.zeros(2, 4, 3)
    with pytest.raises(ValueError, match="metrics"):
        compute_cov_mmd_1nna(t, t, 2, metrics)


@pytest.mark.parametrize("kind", list(CLOUD_KINDS))
def test_block_reference_is_permutation_equivariant(kind):
    """The costs do not depend on the order of either cloud's points."""
    rows, cols = _t(CLOUD_KINDS[kind](26, 2, 128)), _t(CLOUD_KINDS[kind](27, 3, 96))
    g = torch.Generator().manual_seed(0)
    pr, pc = torch.randperm(128, generator=g), torch.randperm(96, generator=g)
    np.testing.assert_allclose(emd_block_reference(rows[:, pr], cols[:, pc]).numpy(),
                               emd_block_reference(rows, cols).numpy(), rtol=1e-5)


@pytest.mark.parametrize("kind", list(CLOUD_KINDS))
def test_pair_reference_residues_follow_a_permutation(kind):
    """Permuting the points permutes R and V with the rows, C and U with the
    columns, and leaves the cost."""
    x, y = _t(CLOUD_KINDS[kind](28, 2, 96)), _t(CLOUD_KINDS[kind](29, 2, 96))
    g = torch.Generator().manual_seed(1)
    pr, pc = torch.randperm(96, generator=g), torch.randperm(96, generator=g)
    want = emd_pair_reference(x, y)
    got = emd_pair_reference(x[:, pr], y[:, pc])
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5)
    for name, g_, w, perm in zip("RCVU", got[1:], want[1:], (pr, pc, pr, pc)):
        np.testing.assert_allclose(g_.numpy(), w[:, perm].numpy(), atol=1e-5, err_msg=name)


def test_library_path_tags_source_and_flags(monkeypatch):
    path = kernels.library_path("emd")
    assert path.parent == kernels.BUILD_DIR and path.name.startswith("libemd-")
    assert path.suffix == ".so" and kernels.library_path("emd") == path
    assert ("-Xptxas", "-v") == kernels.NVCC_FLAGS[-2:]  # ptxas reports every build
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-lineinfo",))
    assert kernels.library_path("emd") != path


def test_ptxas_info_keeps_register_and_spill_lines(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    kernels.library_path("emd").with_suffix(".log").write_text(
        "ptxas info    : Compiling entry function 'k' for 'sm_90a'\n"
        "ptxas info    : Function properties for k\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers\n"
        "some other line\n")
    info = kernels.ptxas_info("emd").splitlines()
    assert len(info) == 4 and "spill stores" in info[2] and "64 registers" in info[3]
