"""Approximate-EMD kernels: the hand-written CUDA kernels of ``csrc/emd.cu``
and their plain PyTorch versions.

* ``emd_block(rows, cols)`` takes (R, N, 3) and (C, M, 3) float32 clouds and
  returns the (R, C) block of auction costs ``sum_nm d * match`` (divide by
  N for ``compute_emd``'s per-point score): the function of
  ``dusty_gan_tpu/metrics/emd_pallas.py::emd_block_pallas`` (kernel K4).
* ``emd_pair(x, y)`` takes (B, N, 3) and (B, M, 3) clouds matched 1:1 and
  returns ``(cost (B,), R (B, N), C (B, M), V (B, N, 3), U (B, M, 3))``:
  the match's row and column masses and ``V = match @ y``, ``U = match^T @
  x``, from which the cost and both gradients are elementwise: the function
  of ``emd_pair_pallas`` (kernel K5).

The plain versions run the dense annealed auction of
``dusty_gan_tpu/metrics/emd.py`` (``approx_match``, ``match_cost``) on
materialised (pairs, N, M) tensors, as many pairs at once as fit an element
budget.  CPU tensors go through them; CUDA tensors go through the kernel or
the call raises.  The kernels take any N and M: up to ``SHARED_MAX_POINTS``
a cloud the auction state sits in shared memory; above it the wrapper
passes a workspace in device memory and launches in chunks of pairs
(``pairs_per_launch``).
"""

from __future__ import annotations

import torch

from dusty_gan_torch import kernels
from dusty_gan_torch.metrics.chamfer_cuda import _sq_dist

# the largest N and M of the shared-memory path (csrc/emd.cu
# kSharedMaxPoints: K5's state fits one block's shared memory); larger clouds
# keep the state in a device-memory workspace
SHARED_MAX_POINTS = 3072
# the device-memory path's workspace, at most this many bytes a launch:
# 8192 pairs of 4096-point clouds would need 2.4 GB for K5 at once; 1 GiB
# still holds 900 pairs of 16,384-point clouds (K5), nearly 7 waves of one
# block an SM on an H100.  A single pair above the cap gets a launch of
# its own.
WORKSPACE_CAP_BYTES = 1 << 30
# CUDA's limit on a one-dimensional grid: one block per pair
MAX_PAIRS = 2 ** 31 - 1
# (pairs, N, M) elements materialised at once by the plain versions
_REFERENCE_BUDGET = 1 << 24
# annealing levels of the 10 rounds: -4^7 .. -4^-1, then 0
LEVELS = tuple(-(4.0 ** j) for j in range(7, -2, -1)) + (0.0,)


def approx_match(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> match (B, N, M) of the 10-round annealed
    auction, row sums ~multi_l and column sums ~multi_r (multi_l = 1 and
    multi_r = N // M when N >= M, else mirrored; integer division).

    Squared distances come from explicit coordinate differences, as in the
    kernels (the JAX dense path forms |x|^2 + |y|^2 - 2 x.y; the costs agree
    within 1.4e-5 relative at 2048 points).  Where N != M some row mass
    stays unmatched, and which rows keep it moves with the distances'
    float32 rounding: the costs stay within ~1e-4 relative, single
    entries of R and V move by a few 1e-3."""
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    multi_l, multi_r = (1.0, float(n // m)) if n >= m else (float(m // n), 1.0)
    d = _sq_dist(xyz1, xyz2)
    match = torch.zeros_like(d)
    remain_l = torch.full((b, n), multi_l, dtype=d.dtype, device=d.device)
    remain_r = torch.full((b, m), multi_r, dtype=d.dtype, device=d.device)
    for level in LEVELS:
        w = torch.exp(level * d)
        suml = 1e-9 + torch.bmm(w, remain_r[:, :, None])[:, :, 0]
        ratio_l = remain_l / suml
        sumr = torch.bmm(ratio_l[:, None, :], w)[:, 0, :] * remain_r
        consumption = torch.clamp(remain_r / (sumr + 1e-9), max=1.0)
        ratio_r = consumption * remain_r
        remain_r = torch.clamp(remain_r - sumr, min=0.0)
        delta = w * ratio_l[:, :, None] * ratio_r[:, None, :]
        match = match + delta
        remain_l = torch.clamp(remain_l - delta.sum(2), min=0.0)
    return match


def match_cost(xyz1: torch.Tensor, xyz2: torch.Tensor,
               match: torch.Tensor) -> torch.Tensor:
    """sum_nm |x_n - y_m|^2 match[n, m] per pair, (B,), as three
    contractions: sum |x|^2 R + sum |y|^2 C - 2 sum x . (match @ y)."""
    row, col = match.sum(2), match.sum(1)
    t1 = ((xyz1 * xyz1).sum(-1) * row).sum(1)
    t2 = ((xyz2 * xyz2).sum(-1) * col).sum(1)
    t3 = (torch.bmm(match, xyz2) * xyz1).sum((1, 2))
    return t1 + t2 - 2.0 * t3


def _check(a: torch.Tensor, b: torch.Tensor, paired: bool):
    if a.dim() != 3 or a.shape[2] != 3 or b.dim() != 3 or b.shape[2] != 3 \
            or (paired and a.shape[0] != b.shape[0]):
        want = "(B, N, 3) and (B, M, 3)" if paired else "(R, N, 3) and (C, M, 3)"
        raise ValueError(f"expected {want} clouds, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"EMD kernels take float32 clouds, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"clouds on different devices: {a.device} and {b.device}")
    if min(a.shape[:2]) == 0 or min(b.shape[:2]) == 0:
        raise ValueError("EMD kernels need non-empty clouds")


def _pairs_per_chunk(n: int, m: int) -> int:
    return max(1, _REFERENCE_BUDGET // (n * m))


def emd_block_reference(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``emd_block``: the dense auction and cost over
    the R*C pairs, as many at once as fit the element budget."""
    _check(rows, cols, paired=False)
    r, n, _ = rows.shape
    c, m, _ = cols.shape
    out = torch.empty(r * c, dtype=torch.float32, device=rows.device)
    step = _pairs_per_chunk(n, m)
    for p in range(0, r * c, step):
        idx = torch.arange(p, min(p + step, r * c), device=rows.device)
        x, y = rows[idx // c], cols[idx % c]
        out[p:p + step] = match_cost(x, y, approx_match(x, y))
    return out.view(r, c)


def emd_pair_reference(x: torch.Tensor, y: torch.Tensor):
    """Plain PyTorch version of ``emd_pair``: (cost, R, C, V, U) from the
    dense match, R = match.sum(2), C = match.sum(1), V = match @ y,
    U = match^T @ x."""
    _check(x, y, paired=True)
    b, n, _ = x.shape
    m = y.shape[1]
    step = _pairs_per_chunk(n, m)
    parts = []
    for i in range(0, b, step):
        xi, yi = x[i:i + step], y[i:i + step]
        match = approx_match(xi, yi)
        parts.append((match_cost(xi, yi, match), match.sum(2), match.sum(1),
                      torch.bmm(match, yi), torch.bmm(match.transpose(1, 2), xi)))
    return tuple(torch.cat(t) for t in zip(*parts))


def uses_device_memory(n: int, m: int) -> bool:
    """Whether N- and M-point clouds take the kernels' device-memory path."""
    return max(n, m) > SHARED_MAX_POINTS


def state_floats(n: int, m: int, residues: bool) -> int:
    """Floats of one pair's auction state in the workspace (csrc/emd.cu
    state_floats): the clouds as float4, remain_l and remain_r, and E
    (K4) or R, V, C and U (K5), rounded up to whole float4s."""
    f = 9 * (n + m) if residues else 6 * n + 5 * m
    return (f + 3) // 4 * 4


def pairs_per_launch(n: int, m: int, residues: bool, pairs: int) -> int:
    """Pairs of one launch: all of them on the shared-memory path, else as
    many as keep the workspace within WORKSPACE_CAP_BYTES (at least one)."""
    if not uses_device_memory(n, m):
        return pairs
    return max(1, min(pairs, WORKSPACE_CAP_BYTES // (4 * state_floats(n, m, residues))))


def _lib(a: torch.Tensor, b: torch.Tensor, pairs: int):
    """The kernels' library, after the checks of what they take."""
    if pairs > MAX_PAIRS:
        raise ValueError(f"EMD kernels take at most {MAX_PAIRS} pairs a launch "
                         f"(one block each), got {pairs}")
    if a.device.type != "cuda":
        raise ValueError(f"EMD kernels run on cpu or cuda, got {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("EMD kernels take contiguous clouds")
    return kernels.load("emd")


def _workspace(device, n: int, m: int, residues: bool, pairs: int):
    """(tensor, pointer, floats) of a workspace for ``pairs`` pairs on the
    device-memory path; (None, 0, 0) on the shared-memory path."""
    if not uses_device_memory(n, m):
        return None, 0, 0
    floats = pairs * state_floats(n, m, residues)
    work = torch.empty(floats, dtype=torch.float32, device=device)
    return work, work.data_ptr(), floats


def _raise_on(lib, err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.emd_error_string(err).decode()})")


def emd_block(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(R, N, 3), (C, M, 3) float32 -> (R, C) float32 auction costs
    (kernel K4).  On the device-memory path the block is launched in tiles
    of rows and columns of at most ``pairs_per_launch`` pairs."""
    _check(rows, cols, paired=False)
    if rows.device.type == "cpu":
        return emd_block_reference(rows, cols)
    r, n, _ = rows.shape
    c, m, _ = cols.shape
    chunk = pairs_per_launch(n, m, False, r * c)
    lib = _lib(rows, cols, chunk)
    tile_c = min(c, chunk)
    tile_r = max(1, chunk // tile_c)
    out = torch.empty((r, c), dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        work, ptr, floats = _workspace(rows.device, n, m, False, tile_r * tile_c)
        for r0 in range(0, r, tile_r):
            for c0 in range(0, c, tile_c):
                rs, cs = min(tile_r, r - r0), min(tile_c, c - c0)
                tile = out if (rs, cs) == (r, c) else torch.empty(
                    (rs, cs), dtype=torch.float32, device=rows.device)
                err = lib.emd_block_launch(rows[r0].data_ptr(), cols[c0].data_ptr(),
                                           tile.data_ptr(), rs, cs, n, m, ptr, floats, stream)
                _raise_on(lib, err, "emd_block")
                emd_block.launches += 1
                if tile is not out:
                    out[r0:r0 + rs, c0:c0 + cs] = tile
    return out


def emd_pair(x: torch.Tensor, y: torch.Tensor):
    """(B, N, 3), (B, M, 3) float32 -> (cost (B,), R (B, N), C (B, M),
    V (B, N, 3), U (B, M, 3)) (kernel K5).  On the device-memory path the
    pairs are launched in chunks of ``pairs_per_launch``."""
    _check(x, y, paired=True)
    if x.device.type == "cpu":
        return emd_pair_reference(x, y)
    b, n, _ = x.shape
    m = y.shape[1]
    chunk = pairs_per_launch(n, m, True, b)
    lib = _lib(x, y, chunk)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=x.device)  # noqa: E731
    cost, r, c, v, u = new(b), new(b, n), new(b, m), new(b, n, 3), new(b, m, 3)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        work, ptr, floats = _workspace(x.device, n, m, True, chunk)
        for b0 in range(0, b, chunk):
            bs = min(chunk, b - b0)
            err = lib.emd_pair_launch(x[b0].data_ptr(), y[b0].data_ptr(), cost[b0:].data_ptr(),
                                      r[b0].data_ptr(), c[b0].data_ptr(), v[b0].data_ptr(),
                                      u[b0].data_ptr(), bs, n, m, ptr, floats, stream)
            _raise_on(lib, err, "emd_pair")
            emd_pair.launches += 1
    return cost, r, c, v, u


emd_block.launches = 0
emd_pair.launches = 0
