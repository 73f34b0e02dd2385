"""Chamfer kernels: the hand-written CUDA kernels ``csrc/cd_block.cu`` and
``csrc/nn.cu`` and their plain PyTorch versions.

* ``cd_block(rows, cols)`` takes (R, N, 3) and (C, M, 3) float32 clouds and
  returns the (R, C) block ``mean_n min_m d + mean_m min_n d`` of squared
  distances, the function of ``dusty_gan_tpu/metrics/chamfer_pallas.py::
  cd_block_pallas``.
* ``nn_dist(x, y)`` and ``nn_argmin(x, y)`` take (B, N, 3) and (B, M, 3)
  float32 clouds matched 1:1 by batch index and return the (B, N) minimum
  squared distance from each x point to its cloud in y, and for
  ``nn_argmin`` also the (B, N) int32 first index of that minimum: the
  function of ``nn_pallas(need_idx=False)`` and ``nn_pallas(need_idx=True)``.

CPU tensors go through the plain versions (``cd_block_reference``,
``nn_reference``); CUDA tensors go through the kernel or the call raises.
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


def _check_nn(x: torch.Tensor, y: torch.Tensor):
    if x.dim() != 3 or x.shape[2] != 3 or y.dim() != 3 or y.shape[2] != 3 \
            or x.shape[0] != y.shape[0]:
        raise ValueError(f"expected (B, N, 3) and (B, M, 3) clouds, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"nearest-neighbour kernels take float32 clouds, got "
                        f"{x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"clouds on different devices: {x.device} and {y.device}")
    if min(x.shape[:2]) == 0 or y.shape[1] == 0:
        raise ValueError("nearest-neighbour kernels need non-empty clouds")


def nn_reference(x: torch.Tensor, y: torch.Tensor, need_idx: bool = True):
    """Plain PyTorch version of ``nn_dist`` / ``nn_argmin``: as many clouds
    and partner points at once as fit the distance budget, ``torch.argmin``
    (the first occurrence) within a chunk of M and a strict ``<`` across
    chunks.  Returns (dist, idx or None)."""
    _check_nn(x, y)
    b, n, _ = x.shape
    m = y.shape[1]
    mc = max(1, min(m, _REFERENCE_BUDGET // n))
    bs = max(1, _REFERENCE_BUDGET // (n * mc))
    dist = torch.empty((b, n), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=x.device) if need_idx else None
    for i in range(0, b, bs):
        xi, best, bidx = x[i:i + bs], None, None
        for j in range(0, m, mc):
            d = _sq_dist(xi, y[i:i + bs, j:j + mc])  # (b', N, m')
            if need_idx:
                carg = d.argmin(dim=2)
                cmin = d.gather(2, carg[..., None])[..., 0]
                if best is None:
                    best, bidx = cmin, carg + j
                else:
                    take = cmin < best
                    best = torch.where(take, cmin, best)
                    bidx = torch.where(take, carg + j, bidx)
            else:
                cmin = d.amin(dim=2)
                best = cmin if best is None else torch.minimum(best, cmin)
        dist[i:i + bs] = best.clamp_min(0.0)
        if need_idx:
            idx[i:i + bs] = bidx.to(torch.int32)
    return dist, idx


def _nn_launch(x: torch.Tensor, y: torch.Tensor, need_idx: bool):
    if x.device.type != "cuda":
        raise ValueError(f"nearest-neighbour kernels run on cpu or cuda, got {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("nearest-neighbour kernels take contiguous clouds")
    b, n, _ = x.shape
    m = y.shape[1]
    if b > 65535:
        raise ValueError(f"nearest-neighbour kernels take at most 65535 clouds, got {b}")
    lib = kernels.load("nn")
    dist = torch.empty((b, n), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=x.device) if need_idx else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if need_idx:
            err = lib.nn_argmin_launch(x.data_ptr(), y.data_ptr(), dist.data_ptr(),
                                       idx.data_ptr(), b, n, m, stream)
        else:
            err = lib.nn_dist_launch(x.data_ptr(), y.data_ptr(), dist.data_ptr(),
                                     b, n, m, stream)
    if err != 0:
        raise RuntimeError(f"nearest-neighbour kernel launch failed: CUDA error "
                           f"{err} ({lib.nn_error_string(err).decode()})")
    return dist, idx


def nn_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) float32 -> (B, N) float32 min squared distance
    (kernel K2)."""
    _check_nn(x, y)
    if x.device.type == "cpu":
        return nn_reference(x, y, need_idx=False)[0]
    dist, _ = _nn_launch(x, y, need_idx=False)
    nn_dist.launches += 1
    return dist


def nn_argmin(x: torch.Tensor, y: torch.Tensor):
    """(B, N, 3), (B, M, 3) float32 -> ((B, N) float32 min squared distance,
    (B, N) int32 first index of the minimum) (kernel K3)."""
    _check_nn(x, y)
    if x.device.type == "cpu":
        return nn_reference(x, y, need_idx=True)
    out = _nn_launch(x, y, need_idx=True)
    nn_argmin.launches += 1
    return out


nn_dist.launches = 0
nn_argmin.launches = 0
