"""COV / MMD / 1-NNA over pairwise Chamfer and EMD matrices
(``dusty_gan_tpu/metrics/cov_mmd_1nna.py``).

The (B1, B2) matrix is filled in (R, C) blocks, one kernel launch per block
(``cd_block`` for CD, ``emd_block`` divided by the point count for EMD), on
the clouds' device.  A symmetric matrix (the same tensor on both
sides) computes only the blocks that touch the upper triangle and mirrors
the strict upper triangle onto the lower one, so the lower entries of a
diagonal block are overwritten exactly as in the JAX package.  COV, MMD and
1-NNA are then computed on the host with numpy.

``process_shard`` stripes the block-rows over the ranks of a process group
(``parallel/mesh.py``): block-row ``i // R`` is computed by rank
``(i // R) % W``, the others leave zeros there, and one gather of the host
partials, summed, merges them.  Each entry comes from one rank, so the
merged matrix is the single-process one bit for bit wherever the kernel is
deterministic.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from dusty_gan_torch.metrics.chamfer_cuda import cd_block
from dusty_gan_torch.metrics.emd_cuda import emd_block
from dusty_gan_torch.parallel import mesh
from dusty_gan_torch.utils import profiling

METRICS = ("cd", "emd")

# row clouds per launch; a (16, 512) block is 8192 thread blocks on the card
ROW_BLOCK = 16


def block_dims(b1: int, b2: int, col_chunk: int) -> Tuple[int, int]:
    """(R, C) per launch, clamped to the matrix so small inputs do not pad
    up to protocol scale."""
    return max(1, min(ROW_BLOCK, b1)), max(1, min(int(col_chunk), b2))


def block_schedule(b1: int, b2: int, R: int, C: int,
                   symmetric: bool) -> Iterator[Tuple[int, int]]:
    """Top-left corners of the blocks that are computed."""
    b1p, b2p = -(-b1 // R) * R, -(-b2 // C) * C
    for i in range(0, b1p, R):
        for j in range(0, b2p, C):
            if symmetric and j + C <= i:
                continue  # entirely below the diagonal: mirrored later
            yield i, j


def _pad_rows(p: torch.Tensor, target: int) -> torch.Tensor:
    b = p.shape[0]
    p = p.float().contiguous()
    if b == target:
        return p
    pad = torch.zeros((target - b,) + tuple(p.shape[1:]), dtype=p.dtype,
                      device=p.device)
    return torch.cat([p, pad], dim=0)


def blocked_matrix(pcs_1: torch.Tensor, pcs_2: torch.Tensor, R: int, C: int,
                   symmetric: bool, block: Callable, label: str,
                   verbose: bool = False, process_shard: bool = False) -> np.ndarray:
    """Fill the (B1, B2) matrix block by block through ``block(rows, cols)
    -> (R, C)``; with ``process_shard``, this rank's block-rows, merged
    with the other ranks'."""
    b1, b2 = pcs_1.shape[0], pcs_2.shape[0]
    b1p, b2p = -(-b1 // R) * R, -(-b2 // C) * C
    rows_all = _pad_rows(pcs_1, b1p)
    cols_all = _pad_rows(pcs_2, b2p)
    rank, ranks = (mesh.rank(), mesh.world_size()) if process_shard else (0, 1)
    out = torch.zeros((b1p, b2p), dtype=torch.float32, device=pcs_1.device)
    last_i = -1
    for i, j in block_schedule(b1, b2, R, C, symmetric):
        if (i // R) % ranks != rank:
            continue  # another rank's block-row
        out[i:i + R, j:j + C] = block(rows_all[i:i + R], cols_all[j:j + C])
        if verbose and i != last_i:
            print(f"pairwise {label}: dispatched {min(i + R, b1)}/{b1}")
            last_i = i
    out = out.cpu().numpy()
    if ranks > 1:
        out = mesh.pod_allgather(out).sum(axis=0)
    out = out[:b1, :b2]
    if symmetric:
        lower = np.tril_indices(b1, -1)
        out[lower] = out.T[lower]
    return out


def pairwise_cd(pcs_1: torch.Tensor, pcs_2: torch.Tensor, col_chunk: int,
                verbose: bool = False, process_shard: bool = False) -> np.ndarray:
    """(B1, N, 3), (B2, M, 3) -> (B1, B2) symmetric-CD matrix; symmetric
    when both arguments are the same tensor."""
    R, C = block_dims(pcs_1.shape[0], pcs_2.shape[0], col_chunk)
    return blocked_matrix(pcs_1, pcs_2, R, C, pcs_1 is pcs_2, cd_block, "cd", verbose,
                          process_shard)


def pairwise_emd(pcs_1: torch.Tensor, pcs_2: torch.Tensor, col_chunk: int,
                 verbose: bool = False, process_shard: bool = False) -> np.ndarray:
    """(B1, N, 3), (B2, N, 3) -> (B1, B2) per-point EMD matrix
    (``compute_emd``: the auction cost over N); symmetric when both
    arguments are the same tensor.  EMD is not symmetric in its two clouds,
    so a symmetric matrix keeps the upper triangle's emd(row, col)."""
    n, m = pcs_1.shape[1], pcs_2.shape[1]
    if n != m:
        raise ValueError(f"pairwise EMD needs equal point counts, got {n} != {m}")
    R, C = block_dims(pcs_1.shape[0], pcs_2.shape[0], col_chunk)
    return blocked_matrix(pcs_1, pcs_2, R, C, pcs_1 is pcs_2,
                          lambda rows, cols: emd_block(rows, cols) / float(n),
                          "emd", verbose, process_shard)


PAIRWISE = {"cd": pairwise_cd, "emd": pairwise_emd}


def _compute_cov_mmd(m_rg: np.ndarray) -> Dict[str, float]:
    """Rows = reference, cols = generated."""
    mmd_gen = m_rg.min(axis=0)
    min_idx_gen = m_rg.argmin(axis=0)
    mmd_ref = m_rg.min(axis=1)
    return {
        "mmd": float(mmd_ref.mean()),
        "mmd-sample": float(mmd_gen.mean()),
        "cov": float(len(np.unique(min_idx_gen))) / float(m_rg.shape[0]),
    }


def _compute_nna(m_rr, m_rg, m_gg, k: int = 1,
                 sqrt: bool = False) -> Dict[str, float]:
    """Leave-one-out 1-NN two-sample classification."""
    n_ref, n_gen = m_rg.shape
    label = np.concatenate([np.ones(n_ref), np.zeros(n_gen)])
    m = np.concatenate(
        [
            np.concatenate([m_rr, m_rg], axis=1),
            np.concatenate([m_rg.T, m_gg], axis=1),
        ],
        axis=0,
    )
    if sqrt:
        m = np.sqrt(np.abs(m))
    np.fill_diagonal(m, np.inf)
    idx = np.argsort(m, axis=0)[:k]  # k smallest per column
    count = label[idx].sum(axis=0)
    pred = (count / k >= 0.5).astype(np.float64)

    s = {
        "tp": float((pred * label).sum()),
        "fp": float((pred * (1 - label)).sum()),
        "fn": float(((1 - pred) * label).sum()),
        "tn": float(((1 - pred) * (1 - label)).sum()),
    }
    s.update(
        {
            "precision": s["tp"] / (s["tp"] + s["fp"] + 1e-10),
            "recall": s["tp"] / (s["tp"] + s["fn"] + 1e-10),
            "accuracy_t": s["tp"] / (s["tp"] + s["fn"] + 1e-10),
            "accuracy_f": s["tn"] / (s["tn"] + s["fp"] + 1e-10),
            "accuracy": float((pred == label).mean()),
        }
    )
    return s


def check_metrics(metrics: Tuple[str, ...]) -> None:
    unknown = [m for m in metrics if m not in METRICS]
    if unknown or not metrics:
        raise ValueError(f"metrics {tuple(metrics)}: each must be one of {METRICS}")


def compute_cov_mmd_1nna(pcs_gen: torch.Tensor, pcs_ref: torch.Tensor,
                         batch_size: int, metrics: Tuple[str, ...] = ("cd",),
                         verbose: bool = False,
                         timings: Optional[Dict[str, float]] = None,
                         process_shard: bool = False) -> Dict[str, float]:
    """{cov,mmd,mmd-sample}-<metric> and 1-nn-*-<metric> scores of generated
    clouds against reference clouds, both (B, N, 3) on one device, for each
    metric of ``metrics`` ("cd", "emd").  ``timings``, when given, receives
    the wall seconds of each metric's three matrices and its scores as
    ``pairwise_<metric>``; the scores on the host are the tracer's span
    ``<metric>.scores`` (``utils/profiling.py``).  ``process_shard``: every
    rank of the process group calls this with the same clouds, and the
    matrices' block-rows are striped over the ranks."""
    check_metrics(tuple(metrics))
    results: Dict[str, float] = {}
    for metric in metrics:
        pairwise = PAIRWISE[metric]
        t = time.perf_counter()
        m_rr = pairwise(pcs_ref, pcs_ref, batch_size, verbose, process_shard)
        m_rg = pairwise(pcs_ref, pcs_gen, batch_size, verbose, process_shard)
        m_gg = pairwise(pcs_gen, pcs_gen, batch_size, verbose, process_shard)
        with profiling.span(f"{metric}.scores"):
            for k, v in _compute_cov_mmd(m_rg).items():
                results[f"{k}-{metric}"] = v
            for k, v in _compute_nna(m_rr, m_rg, m_gg).items():
                results[f"1-nn-{k}-{metric}"] = v
        if timings is not None:  # each matrix ends in a copy to the host
            timings[f"pairwise_{metric}"] = time.perf_counter() - t
    return results
