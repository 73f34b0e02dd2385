"""Peaks of one NVIDIA H100 SXM and the least time of the work a cell
needs.

Peaks are NVIDIA's data sheet's dense rates at the card's full 700 W
(a card set to a lower power limit runs below them; every result line
carries the limit it ran at): 989 TFLOP/s bf16 in the tensor cores, 67
TFLOP/s float32 outside them, 3.35 TB/s of HBM3.

K1 (``cd_block``) forms, for a pair of clouds of N and M points, the N*M
squared distances, each 3 subtractions, 3 multiplications and 2
additions (the minimum is not counted): 8 FP32 operations a distance.
It reads each cloud once and writes one number a pair.  A protocol round
of n generated and n reference clouds needs M_rg whole and the strict
upper triangles of M_rr and M_gg (their diagonals and lower halves are
not used by COV, MMD or 1-NNA): n^2 + n(n - 1) pairs.  That is the work
counted, whatever blocks, padding or mirroring the program computes.

FPS over a (B, N, 3) batch to k points needs k - 1 passes over the
running distances: per pass and point a squared distance (8 operations)
and a minimum; bytes: each input point read once and each output point
written once.
"""

from __future__ import annotations

PEAK_BF16_FLOP_PER_S = 989e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12

FLOP_PER_DISTANCE = 8


def protocol_pairs(n_gen: int, n_ref: int) -> int:
    """Cloud pairs COV, MMD and 1-NNA need: M_rg, and M_rr's and M_gg's
    strict upper triangles."""
    return n_gen * n_ref + n_ref * (n_ref - 1) // 2 + n_gen * (n_gen - 1) // 2


def k1_least_s(pairs: int, points: int, clouds: int) -> float:
    """Least seconds of K1 over ``pairs`` pairs of ``points``-point clouds,
    ``clouds`` distinct clouds read: the larger of the FP32 operation
    bound and the byte bound."""
    ops = FLOP_PER_DISTANCE * points * points * pairs
    nbytes = 4 * (3 * points * clouds + pairs)
    return max(ops / PEAK_FP32_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S)


def fps_least_s(b: int, n: int, k: int) -> float:
    """Least seconds of furthest point sampling of (b, n, 3) to k points."""
    ops = (FLOP_PER_DISTANCE + 1) * b * n * (k - 1)
    nbytes = 4 * 3 * b * (n + k)
    return max(ops / PEAK_FP32_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S)


def bf16_least_s(flop: float) -> float:
    return flop / PEAK_BF16_FLOP_PER_S
