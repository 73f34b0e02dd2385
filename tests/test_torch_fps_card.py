"""The furthest point sampling kernel (``dusty_gan_torch/csrc/fps.cu``)
against the plain loop, both on the card: the indices bit for bit.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports neither JAX nor the repository's test helpers, so that it runs
on a machine with the card and no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_fps_card.py
"""

import numpy as np
import pytest
import torch

from dusty_gan_torch.metrics import fps
from dusty_gan_torch.metrics.fps import (furthest_point_sampling,
                                         furthest_point_sampling_reference)
from dusty_gan_torch.utils import profiling

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def _lidar_like(seed: int, b: int, n: int, dropped: float = 0.2) -> torch.Tensor:
    """Unit-space clouds: uniform in a ball of radius 0.8, a share of the
    points dropped to the origin, as the synthesis protocol's clouds."""
    g = torch.Generator().manual_seed(seed)
    p = torch.rand((b, n, 3), generator=g) * 1.6 - 0.8
    p[torch.rand((b, n), generator=g) < dropped] = 0.0
    return p


def _hold(xyz: torch.Tensor, k: int, device) -> torch.Tensor:
    """The kernel's indices on the card, equal to the plain loop's there and
    to a second launch's."""
    x = xyz.to(device)
    before = furthest_point_sampling.launches
    got = furthest_point_sampling(x, k)
    again = furthest_point_sampling(x, k)
    torch.cuda.synchronize()
    assert furthest_point_sampling.launches == before + 2
    want = furthest_point_sampling_reference(x, k)
    assert got.dtype == torch.int64 and got.shape == (xyz.shape[0], k)
    mismatch = (got != want).any(dim=1)
    assert not bool(mismatch.any()), (
        f"{int(mismatch.sum())} of {xyz.shape[0]} clouds differ; first row at "
        f"step {int((got != want).int().argmax(dim=1)[mismatch][0])}")
    assert torch.equal(got, again)
    return got.cpu()


def _threshold_points():
    """float32 (x, y, 0) whose squared magnitude (x*x + y*y) rounds to
    exactly 1e-3f, and the nearest such points whose sum rounds below and
    above it."""
    t = np.float32(1e-3)
    x = np.float32(0.03)
    x2 = np.float32(x * x)
    y = np.float32(np.sqrt(np.float64(t) - np.float64(x2)))
    for _ in range(64):
        s = np.float32(x2 + np.float32(y * y))
        if s == t:
            break
        y = np.nextafter(y, np.float32(0 if s > t else 1))
    assert np.float32(x2 + np.float32(y * y)) == t

    def step(v, to):  # the nearest y whose sum leaves t
        while np.float32(x2 + np.float32(v * v)) == t:
            v = np.nextafter(v, np.float32(to))
        return v

    below, above = step(y, 0), step(y, 1)
    assert np.float32(x2 + np.float32(below * below)) < t
    assert np.float32(x2 + np.float32(above * above)) > t
    return [(x, v, np.float32(0)) for v in (y, below, above)]


def test_the_validity_threshold_rounds_as_the_loop(cuda_device):
    """Points whose squared magnitude is exactly 1e-3f (not valid), just
    below (not valid) and just above (valid), among far points that leave
    them the furthest once taken."""
    (eq, below, above) = _threshold_points()
    g = torch.Generator().manual_seed(3)
    b, n = 4, 3000
    p = 0.5 + 0.01 * torch.randn((b, n, 3), generator=g)
    rows = torch.arange(b)
    for i, pt in enumerate((eq, below, above) * 40):
        p[:, 7 + 23 * i] = torch.tensor(pt)
    p[rows, rows] = 0.0  # index 0 dropped in cloud 0
    got = _hold(p, 400, cuda_device)
    eq_idx = [7 + 23 * i for i in range(0, 120, 3)]
    above_idx = [7 + 23 * i for i in range(2, 120, 3)]
    assert not np.isin(got[:, 1:].numpy(), eq_idx).any()
    assert np.isin(got.numpy(), above_idx).any()


def test_exact_ties_go_to_the_first_index(cuda_device):
    """A duplicated grid: many equal distances, a point and its copy."""
    grid = torch.stack(torch.meshgrid(*[torch.arange(12.0)] * 3, indexing="ij"),
                       -1).reshape(-1, 3) / 11.0
    p = torch.cat([grid, grid, grid[:500]])[None].repeat(3, 1, 1)
    p[1] = p[1].flip(0)
    _hold(p, 2048, cuda_device)


def test_a_cloud_with_no_valid_point_gives_zeros(cuda_device):
    p = _lidar_like(5, 3, 5000)
    p[1] = 0.0
    p[2] = 1e-3 * torch.rand((5000, 3))  # all inside the threshold
    got = _hold(p, 300, cuda_device)
    assert not bool(got[1:].any())


def test_k_above_the_valid_points(cuda_device):
    p = _lidar_like(7, 4, 5000, dropped=0.98)
    valid = int(((p * p).sum(-1) > 1e-3).sum(-1).max())
    assert valid < 200
    _hold(p, 500, cuda_device)


@pytest.mark.parametrize("b,n,k", [
    (1, 16384, 2048),    # one cloud of the protocol
    (32, 16384, 512),    # training's validation
    (256, 16384, 2048),  # the synthesis protocol's call
    (4, 8192, 2048),     # 32x256 scans
    (3, 5000, 700),      # N not a multiple of 1024
    (2, 1000, 1500),     # under one point a thread, k above N
    (5, 3, 4),
    (2, 16385, 300),     # past the staged path: device memory
    (2, 40000, 300),
])
def test_the_kernel_equals_the_loop(cuda_device, b, n, k):
    _hold(_lidar_like(b * 1000 + n, b, n), k, cuda_device)


def test_the_kernel_counts_its_clouds(cuda_device):
    p = _lidar_like(11, 6, 700).to(cuda_device)
    profiling.enable()
    try:
        fps.downsample_point_clouds(p, 64)
        fps.downsample_point_clouds(p[:2], 32)
    finally:
        profiling.disable()
    rec = profiling.drain()
    assert rec["counters"] == {"fps.steps": 63 + 31, "fps.kernel_clouds": 6 + 2}
