"""Furthest point sampling + gather (``dusty_gan_tpu/metrics/fps.py``).

CUDA tensors go through the hand-written kernel ``csrc/fps.cu``, all k - 1
dependent steps of a batch of clouds in one launch, or the call raises;
CPU tensors go through the plain PyTorch loop,
``furthest_point_sampling_reference``.  The two give the same indices bit
for bit on clouds of finite coordinates.

The call is the tracer's span ``fps``; its k - 1 steps are added to the
counter ``fps.steps`` once a call, and on the kernel's path the clouds it
sampled to ``fps.kernel_clouds`` (``utils/profiling.py``).
"""

from __future__ import annotations

import torch

from dusty_gan_torch import kernels
from dusty_gan_torch.utils import profiling


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]


def _check(xyz: torch.Tensor, k: int) -> None:
    if xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"expected (B, N, 3) clouds, got {tuple(xyz.shape)}")
    if xyz.dtype != torch.float32:
        raise TypeError(f"furthest point sampling takes float32 clouds, got {xyz.dtype}")
    if xyz.shape[1] == 0:
        raise ValueError("furthest point sampling needs non-empty clouds")
    if k < 1:
        raise ValueError(f"furthest point sampling takes k >= 1 points, got {k}")


@torch.no_grad()
def furthest_point_sampling_reference(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, 3) -> (B, k) int64 indices: a plain PyTorch loop of k - 1
    dependent steps over a running min-distance vector.

    Kept exactly:
    * the first selected index is always 0, even for a dropped origin point;
    * points with squared magnitude <= 1e-3 never update the running
      distances and are never selected (dropped pixels back-project to the
      origin);
    * running distances start at 1e10;
    * ties go to the first index (``argmax``).
    """
    _check(xyz, k)
    b, n, _ = xyz.shape
    valid = _sq_norm(xyz) > 1e-3
    idxs = torch.zeros((b, k), dtype=torch.int64, device=xyz.device)
    temp = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    neg = torch.full((), -1.0, dtype=torch.float32, device=xyz.device)
    old = torch.zeros((b,), dtype=torch.int64, device=xyz.device)
    batch = torch.arange(b, device=xyz.device)
    for j in range(1, k):
        last = xyz[batch, old]  # (B, 3)
        d = _sq_norm(xyz - last[:, None, :])
        temp = torch.where(valid, torch.minimum(temp, d), temp)
        old = torch.where(valid, temp, neg).argmax(dim=-1)
        idxs[:, j] = old
    return idxs


def _launch(xyz: torch.Tensor, k: int) -> torch.Tensor:
    b, n, _ = xyz.shape
    out = torch.empty((b, k), dtype=torch.int64, device=xyz.device)
    if b == 0:
        return out
    lib = kernels.load("fps")
    with torch.cuda.device(xyz.device):
        # clouds too large for the block's shared memory keep their running
        # distances in device memory
        work = (torch.empty((b, n), dtype=torch.float32, device=xyz.device)
                if n > lib.fps_staged_points() else None)
        stream = torch.cuda.current_stream(xyz.device).cuda_stream
        err = lib.fps_launch(xyz.data_ptr(), out.data_ptr(),
                             None if work is None else work.data_ptr(), b, n, int(k), stream)
    if err != 0:
        raise RuntimeError(f"fps kernel launch failed: CUDA error {err} "
                           f"({lib.fps_error_string(err).decode()})")
    furthest_point_sampling.launches += 1
    profiling.count("fps.kernel_clouds", b)
    return out


@torch.no_grad()
def furthest_point_sampling(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, k) int64 indices: the kernel on CUDA tensors,
    the plain loop on CPU tensors."""
    _check(xyz, k)
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"furthest point sampling runs on cpu or cuda, got {xyz.device}")
    profiling.count("fps.steps", k - 1)
    with profiling.span("fps"):
        if xyz.device.type == "cpu":
            return furthest_point_sampling_reference(xyz, k)
        return _launch(xyz.contiguous(), k)


furthest_point_sampling.launches = 0


def gather_points(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, k) -> (B, k, C)."""
    return torch.gather(xyz, 1, idx[..., None].expand(-1, -1, xyz.shape[-1]))


def downsample_point_clouds(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, 3) -> (B, k, 3) FPS subset."""
    if xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"expected (B, N, 3) clouds, got {tuple(xyz.shape)}")
    return gather_points(xyz, furthest_point_sampling(xyz, k))
