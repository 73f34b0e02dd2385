"""Pairwise symmetric Chamfer blocks: the hand-written CUDA kernel
``csrc/cd_block.cu`` and its plain PyTorch version.

``cd_block(rows, cols)`` takes (R, N, 3) and (C, M, 3) float32 clouds and
returns the (R, C) block ``mean_n min_m d + mean_m min_n d`` of squared
distances, the function of ``dusty_gan_tpu/metrics/chamfer_pallas.py::
cd_block_pallas``.  CPU tensors go through ``cd_block_reference``; CUDA
tensors go through the kernel or the call raises.
"""

from __future__ import annotations

import torch

from dusty_gan_torch import kernels

# distances materialised at once by the plain version (elements)
_REFERENCE_BUDGET = 1 << 24


def _check(rows: torch.Tensor, cols: torch.Tensor):
    if rows.dim() != 3 or rows.shape[2] != 3 or cols.dim() != 3 or cols.shape[2] != 3:
        raise ValueError(f"expected (R, N, 3) and (C, M, 3) clouds, got "
                         f"{tuple(rows.shape)} and {tuple(cols.shape)}")
    if rows.dtype != torch.float32 or cols.dtype != torch.float32:
        raise TypeError(f"cd_block takes float32 clouds, got {rows.dtype} "
                        f"and {cols.dtype}")
    if rows.device != cols.device:
        raise ValueError(f"clouds on different devices: {rows.device} and "
                         f"{cols.device}")
    if min(rows.shape[:2]) == 0 or min(cols.shape[:2]) == 0:
        raise ValueError("cd_block needs non-empty clouds")


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3), (..., M, 3) -> (..., N, M) squared distances from
    explicit coordinate differences."""
    d = (a[..., :, None, 0] - b[..., None, :, 0]) ** 2
    d = d + (a[..., :, None, 1] - b[..., None, :, 1]) ** 2
    return d + (a[..., :, None, 2] - b[..., None, :, 2]) ** 2


def cd_block_reference(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one row cloud at a time against
    as many column clouds as fit the distance budget."""
    _check(rows, cols)
    r, n, _ = rows.shape
    c, m, _ = cols.shape
    step = max(1, _REFERENCE_BUDGET // (n * m))
    out = torch.empty((r, c), dtype=torch.float32, device=rows.device)
    for i in range(r):
        for j in range(0, c, step):
            d = _sq_dist(rows[i][None], cols[j:j + step])  # (c', N, M)
            out[i, j:j + step] = d.amin(dim=2).mean(dim=1) + d.amin(dim=1).mean(dim=1)
    return out


def cd_block(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(R, N, 3), (C, M, 3) float32 -> (R, C) float32 symmetric Chamfer."""
    _check(rows, cols)
    if rows.device.type == "cpu":
        return cd_block_reference(rows, cols)
    if rows.device.type != "cuda":
        raise ValueError(f"cd_block runs on cpu or cuda, got {rows.device}")
    if not (rows.is_contiguous() and cols.is_contiguous()):
        raise ValueError("cd_block takes contiguous clouds")
    r, n, _ = rows.shape
    c, m, _ = cols.shape
    if r > 65535:
        raise ValueError(f"cd_block takes at most 65535 row clouds, got {r}")
    lib = kernels.load("cd_block")
    out = torch.empty((r, c), dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.cd_block_launch(rows.data_ptr(), cols.data_ptr(), out.data_ptr(),
                                  r, c, n, m, stream)
    if err != 0:
        raise RuntimeError(f"cd_block kernel launch failed: CUDA error {err} "
                           f"({lib.cd_block_error_string(err).decode()})")
    cd_block.launches += 1
    return out


cd_block.launches = 0
