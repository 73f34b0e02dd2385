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
  The squared distance is ``fma(dz, dz, fma(dy, dy, dx * dx))`` of the
  coordinate differences, each step rounded once, in the kernel and in its
  plain version.  Before the kernel runs, ``nn_layout`` orders both clouds
  along a Morton curve and boxes the partners in groups of 32, so that the
  kernel can skip the groups that cannot hold a nearest neighbour.

CPU tensors go through the plain versions (``cd_block_reference``,
``nn_reference``); CUDA tensors go through the kernel or the call raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

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


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) of float32 tensors, rounded once as on the card: the
    product is exact in float64, and where the float64 sum's own rounding
    left it exactly halfway between two floats, the sign of that
    rounding's error (TwoSum) decides."""
    p, cd = a.double() * b.double(), c.double()
    s = p + cd
    z = s - p
    err = (p - (s - z)) + (cd - z)
    r = s.float()
    other = torch.nextafter(r, torch.where(s > r.double(), r.new_tensor(float("inf")),
                                           r.new_tensor(float("-inf"))))
    halfway = (err != 0) & ((r.double() + other.double()) * 0.5 == s)
    up = torch.where(err > 0, torch.maximum(r, other), torch.minimum(r, other))
    return torch.where(halfway, up, r)


def _sq_dist_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3), (..., M, 3) -> (..., N, M) squared distances by the nn
    kernels' sequence: fma(dz, dz, fma(dy, dy, dx * dx))."""
    diff = lambda i: a[..., :, None, i] - b[..., None, :, i]  # noqa: E731
    dx = diff(0)
    d = _fma(diff(1), diff(1), dx * dx)
    return _fma(diff(2), diff(2), d)


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
    and partner points at once as fit the distance budget, the kernels'
    distance sequence (``_sq_dist_fma``), ``torch.argmin`` (the first
    occurrence) within a chunk of M and a strict ``<`` across chunks.
    Returns (dist, idx or None)."""
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
            d = _sq_dist_fma(xi, y[i:i + bs, j:j + mc])  # (b', N, m')
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


# partner points a group of the nn kernels (csrc/nn.cu kGroup)
GROUP = 32
# bits a coordinate of the Morton code: 32 cells an axis, a 15-bit code that
# sorts as int16 (half the radix passes of int32).  A 16,384-point scan has
# about one point a cell, so finer cells would not make groups of 32 tighter.
_MORTON_BITS = 5


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    """The low 5 bits of each integer moved to every third bit."""
    v = v & 0x1F
    v = (v | (v << 8)) & 0x100F
    v = (v | (v << 4)) & 0x10C3
    return (v | (v << 2)) & 0x1249


@functools.lru_cache(maxsize=None)
def _spread_table(device: torch.device) -> torch.Tensor:
    return _spread_bits(torch.arange(1 << _MORTON_BITS, dtype=torch.int16, device=device))


def morton_codes(p: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) -> (B, N) int16 15-bit Morton codes, each cloud quantised
    to 32 cells an axis in its own bounding box."""
    lo, hi = torch.aminmax(p, dim=1, keepdim=True)
    cells = 1 << _MORTON_BITS
    extent = hi - lo
    # a flat axis is one cell; a huge scale only saturates the clamp
    scale = torch.where(extent > 0, (cells / extent).clamp_max(torch.finfo(p.dtype).max), 0.0)
    # non-negative after the clamp, so the conversion's truncation floors
    q = torch.addcmul(-lo * scale, p, scale).clamp_(0, cells - 1).to(torch.int32)
    spread = torch.index_select(_spread_table(p.device), 0, q.view(-1)).view(q.shape)
    return spread[..., 0] | (spread[..., 1] << 1) | (spread[..., 2] << 2)


def morton_order(*clouds: torch.Tensor):
    """For each (B, N_i, 3) cloud batch, the (B, N_i) int64 permutation
    that sorts each cloud by its Morton code, stable (equal codes keep
    their original order); batches of one size share one sort."""
    codes = [morton_codes(c) for c in clouds]
    if len({c.shape for c in codes}) == 1:
        order = torch.argsort(torch.cat(codes), dim=1, stable=True)
        return order.split([c.shape[0] for c in codes])
    return tuple(torch.argsort(c, dim=1, stable=True) for c in codes)


class NNLayout(NamedTuple):
    """The nn kernels' inputs (csrc/nn.cu): queries and partners in Morton
    order, the partners padded to whole groups of GROUP with copies of the
    last, each group's box and smallest original index."""
    xs: torch.Tensor     # (B, N, 3) float32 queries, sorted
    xpos: torch.Tensor   # (B, N) int32 their original positions
    ys: torch.Tensor     # (B, G * GROUP, 3) float32 partners, sorted and padded
    yidx: torch.Tensor   # (B, G * GROUP) int32 their original indices
    boxes: torch.Tensor  # (B, G, 6) float32 each group's lo and hi corners
    gmin: torch.Tensor   # (B, G) int32 each group's smallest original index


def nn_layout(x: torch.Tensor, y: torch.Tensor) -> NNLayout:
    """Order queries and partners along the Morton curve and box the
    partners in groups: the layout step of ``nn_dist`` and ``nn_argmin``."""
    b, n, _ = x.shape
    m = y.shape[1]
    groups = -(-m // GROUP)
    px, py = morton_order(x, y)
    if groups * GROUP != m:
        py = py[:, torch.arange(groups * GROUP, device=y.device).clamp_max(m - 1)]
    gather = lambda p, i: torch.gather(p, 1, i[..., None].expand(-1, -1, 3))  # noqa: E731
    ys = gather(y, py)
    boxes = torch.cat(torch.aminmax(ys.view(b, groups, GROUP, 3), dim=2), dim=2)
    yidx = py.to(torch.int32)
    return NNLayout(gather(x, px), px.to(torch.int32), ys, yidx, boxes,
                    yidx.view(b, groups, GROUP).amin(2))


def nn_layout_reference(lay: NNLayout, need_idx: bool = True):
    """Plain PyTorch version of the kernels on their layout: per sorted
    query the least distance and, among the partners that reach it, the
    smallest original index, written at the query's original position.
    On the same clouds it equals ``nn_reference`` bit for bit."""
    best, bidx = None, None
    b, n, _ = lay.xs.shape
    mc = max(1, _REFERENCE_BUDGET // (b * n))
    for j in range(0, lay.ys.shape[1], mc):
        d = _sq_dist_fma(lay.xs, lay.ys[:, j:j + mc])  # (B, N, m')
        cmin = d.amin(dim=2)
        cidx = torch.where(d == cmin[..., None], lay.yidx[:, None, j:j + mc],
                           torch.iinfo(torch.int32).max).amin(dim=2)
        if best is None:
            best, bidx = cmin, cidx
        else:
            bidx = torch.where(cmin < best, cidx,
                               torch.where(cmin == best, torch.minimum(bidx, cidx), bidx))
            best = torch.minimum(best, cmin)
    dist = torch.empty_like(best).scatter_(1, lay.xpos.long(), best.clamp_min(0.0))
    idx = torch.empty_like(bidx).scatter_(1, lay.xpos.long(), bidx) if need_idx else None
    return dist, idx


def box_lower_bound(alo: torch.Tensor, ahi: torch.Tensor, blo: torch.Tensor,
                    bhi: torch.Tensor) -> torch.Tensor:
    """The nn kernels' culling bound, (..., 3) corners -> (...): the squared
    gap between boxes [alo, ahi] and [blo, bhi] by the distance's sequence
    of roundings (csrc/nn.cu box_lb); never above the squared distance of
    a point of one box to a point of the other."""
    g = torch.clamp_min(torch.maximum(alo - bhi, blo - ahi), 0.0)
    return _fma(g[..., 2], g[..., 2], _fma(g[..., 1], g[..., 1], g[..., 0] * g[..., 0]))


def nn_on_layout(lay: NNLayout, need_idx: bool, count: Optional[torch.Tensor] = None):
    """Launch K2 (``need_idx`` False) or K3 on ``nn_layout``'s layout of
    CUDA clouds; with ``count`` (two int64 zeros), the counting
    instantiation.  Returns (dist, idx or None)."""
    b, n, _ = lay.xs.shape
    groups = lay.boxes.shape[1]
    lib = kernels.load("nn")
    dist = torch.empty((b, n), dtype=torch.float32, device=lay.xs.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=lay.xs.device) if need_idx else None
    with torch.cuda.device(lay.xs.device):
        stream = torch.cuda.current_stream(lay.xs.device).cuda_stream
        args = (lay.xs.data_ptr(), lay.xpos.data_ptr(), lay.ys.data_ptr())
        if count is not None:
            err = lib.nn_count_launch(*args, lay.yidx.data_ptr(), lay.boxes.data_ptr(),
                                      lay.gmin.data_ptr(), dist.data_ptr(),
                                      0 if idx is None else idx.data_ptr(), count.data_ptr(),
                                      int(need_idx), b, n, groups, stream)
        elif need_idx:
            err = lib.nn_argmin_launch(*args, lay.yidx.data_ptr(), lay.boxes.data_ptr(),
                                       lay.gmin.data_ptr(), dist.data_ptr(), idx.data_ptr(),
                                       b, n, groups, stream)
        else:
            err = lib.nn_dist_launch(*args, lay.boxes.data_ptr(), dist.data_ptr(), b, n,
                                     groups, stream)
    if err != 0:
        raise RuntimeError(f"nearest-neighbour kernel launch failed: CUDA error "
                           f"{err} ({lib.nn_error_string(err).decode()})")
    return dist, idx


def _nn_launch(x: torch.Tensor, y: torch.Tensor, need_idx: bool,
               count: Optional[torch.Tensor] = None):
    if x.device.type != "cuda":
        raise ValueError(f"nearest-neighbour kernels run on cpu or cuda, got {x.device}")
    if x.shape[0] > 65535:
        raise ValueError(f"nearest-neighbour kernels take at most 65535 clouds, "
                         f"got {x.shape[0]}")
    return nn_on_layout(nn_layout(x, y), need_idx, count)


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


def nn_evaluated(x: torch.Tensor, y: torch.Tensor, need_idx: bool):
    """The work of one kernel launch on CUDA clouds: its (dist, idx) and the
    distances it formed in pass 1 (the minima) and pass 2 (K3's index), by
    the kernels' counting instantiation.  A measurement, not a path of the
    port: it adds to neither launch count."""
    _check_nn(x, y)
    count = torch.zeros(2, dtype=torch.int64, device=x.device)
    dist, idx = _nn_launch(x, y, need_idx, count)
    pass1, pass2 = (int(v) for v in count.cpu())
    return dist, idx, pass1, pass2


nn_dist.launches = 0
nn_argmin.launches = 0
