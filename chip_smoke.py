"""Smoke run of dusty_gan_torch on one CUDA GPU.

    python3 chip_smoke.py [--num-test 512] [--num-step 1000] [--emd-num-test 256]

1. Prints the card's name and power limit and the torch version, and
   builds every CUDA kernel of the port from ``dusty_gan_torch/csrc``
   (one nvcc per source, all started together); prints ptxas's registers
   and spills for ``cd_block.cu`` and ``emd.cu`` and fails if their
   kernels spill; counts ``cd_block``'s issued SASS instructions a
   distance in its inner loop (``cuobjdump``).
2. Holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes and at ragged ones, and times both: ``cd_block``
   (K1, also at the edges of its tiling, on both of its branches, and bit
   for bit across two launches), ``nn_dist`` (K2) and ``nn_argmin`` (K3),
   the latter two in every instantiation the launcher can pick,
   ``emd_block`` (K4, also bit for bit across two launches) and
   ``emd_pair`` (K5); and the gradients of ``chamfer_distance`` and
   ``earth_mover_distance`` against autograd through the dense plain
   versions.
3. Drives the synthesis path, ``dusty_gan_torch.cli.evaluate_synthesis``,
   for the full-width DUSty-II generator (configs/model/dusty2_dcgan_eqlr.yaml,
   64x256 KITTI) with seeded random weights on a synthetic KITTI tree:
   512 test scans (``--num-test``; 5000 is the paper's protocol),
   2048-point clouds, and again with --compute-gt; then the EMD path,
   ``--metrics cd,emd`` on 256 generated scans (``--emd-num-test``), from
   whose us a pair it projects the 5000-scan protocol's EMD time, and
   one ``--calibrate-drop-rate`` run (CD only) on 256.
4. Drives the reconstruction path,
   ``dusty_gan_torch.cli.evaluate_reconstruction``, on the same generator
   and tree: one batch of 512 test scans, ``--num-step`` inversion steps,
   Chamfer distance on the full 16,384-point clouds; checks the CSV, that
   the masked loss fell, and profiles a few inversion steps.
   Each path's kernel launch counts are set to 0 just before it and read
   just after.
5. Checks the scores (every key, finite) and, on small inputs, the card's
   scores, pairwise EMD matrices, generator output and inversion against
   the CPU, and one
   inversion step's bf16 gradient for z against float32 on the card.
6. Prints a JSON line of per-kernel numbers, the card line, and as the
   last line ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when there is no GPU or any phase
fails.
"""

from __future__ import annotations

import argparse
import copy
import csv
import glob
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from dusty_gan_torch import kernels  # noqa: E402
from dusty_gan_torch.cli import evaluate_reconstruction as er  # noqa: E402
from dusty_gan_torch.cli import evaluate_synthesis as es  # noqa: E402
from dusty_gan_torch.config import compose, save_config  # noqa: E402
from dusty_gan_torch.data.synthetic import build_synthetic_kitti  # noqa: E402
from dusty_gan_torch.metrics import chamfer_cuda, emd_cuda  # noqa: E402
from dusty_gan_torch.metrics.chamfer import chamfer_distance  # noqa: E402
from dusty_gan_torch.metrics.emd import (  # noqa: E402
    earth_mover_distance, earth_mover_distance_dense)
from dusty_gan_torch.metrics.cov_mmd_1nna import (  # noqa: E402
    ROW_BLOCK, block_schedule, compute_cov_mmd_1nna, pairwise_emd)
from dusty_gan_torch.models.factory import define_G  # noqa: E402
from dusty_gan_torch.models.losses import masked_loss  # noqa: E402
from dusty_gan_torch.utils.inversion import (  # noqa: E402
    latent_noise_strength, make_inversion_loop, project_sphere)
from dusty_gan_torch.utils.calibration import (  # noqa: E402
    calibrate_mask_threshold, drop_rate_2d)
from dusty_gan_torch.utils.setup import make_eval_generator, make_fixed_noise  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet): HBM3, FP32 outside the
# tensor cores, dense bf16 in them
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
# 3 subtractions, 3 multiplies and 2 additions per squared distance (the
# min is not counted); a pair needs at least N*M distances
FLOP_PER_DISTANCE = 8
# K1's explicit form issues at least 8 instructions a distance (3 FADD, 1
# FMUL, 2 FFMA, and 2 FMNMX for its row's and its column's minimum); an SM
# issues 4 warp instructions a clock (one per scheduler) at the 1.98 GHz
# boost clock
CD_INSTR_PER_DISTANCE = 8
PEAK_THREAD_INSTR_PER_S = 132 * 4 * 32 * 1.98e9
CD_RTOL, CD_ATOL = 1e-5, 1e-6  # as tests/test_chamfer_pallas.py
NUM_TEST, NUM_POINTS, CD_BATCH = 512, 2048, 512
NUM_STEP, REC_BATCH, SCAN_POINTS = 1000, 512, 64 * 256
# the JAX CLI's CSV header (dusty_gan_tpu/cli/evaluate_reconstruction.py)
REC_CSV_HEADER = ["", "cd", "accuracy_1", "accuracy_2", "accuracy_3", "rmse",
                  "rmse_log", "abs_rel", "sq_rel", "tol", "drop_gen", "drop_ref"]
Z_ATOL = 1e-4  # card vs CPU z* after 5 float32 L2 inversion steps (z has unit RMS)
# one step's bf16 gradient for z vs float32 at full width: relative L2 error
# (0.082 measured on an H100) and cosine; a wrong gradient is off by ~1
BF16_GRAD_RTOL, BF16_GRAD_MIN_COS = 0.15, 0.99
EXPECTED_KEYS = {
    "swd-16", "swd-32", "swd-64", "swd-mean", "jsd", "mmd-cd", "mmd-sample-cd",
    "cov-cd", "1-nn-tp-cd", "1-nn-fp-cd", "1-nn-fn-cd", "1-nn-tn-cd",
    "1-nn-precision-cd", "1-nn-recall-cd", "1-nn-accuracy_t-cd",
    "1-nn-accuracy_f-cd", "1-nn-accuracy-cd", "#test", "#points",
}
EMD_KEYS = {k[:-2] + "emd" for k in EXPECTED_KEYS if k.endswith("-cd")}
CALIB_KEYS = {"mask_threshold", "drop_rate/target", "drop_rate/calibrated", "drop_rate/fake"}
EMD_NUM_TEST = 256  # scans of the --metrics cd,emd run (the protocol's 5000 cut)
# calibrated against target drop rate: 24 bisection steps close the threshold
# to 6e-8, but float32 keep probabilities tie, so the last step can move a
# few hundred of the 8.4M calibration pixels (the JAX package's own test
# allows 5e-3)
CALIB_ATOL = 1e-4
# EMD: the kernels against the dense plain version (explicit differences on
# both sides, sums in other orders).  Costs rtol 5e-4, the JAX package's
# kernel-against-dense tolerance (tests/test_emd_pallas.py), with a 1e-6
# guard for exact zeros.  A self pair's cost (~1e-3 at 2048 points, scale
# 0.3) is the difference of sum |x|^2 R + sum |y|^2 C ~ 550 and 2 sum x.V:
# float32 leaves a few ulps of 550 (~6e-5 each), so the diagonal is held
# at atol 5e-3.
EMD_RTOL, EMD_ATOL, EMD_DIAG_ATOL = 5e-4, 1e-6, 5e-3
# K5's residues R, C, V and U against the plain version, per pair in
# relative L2 norm: 1e-3.  Single entries are conditioned at the 1e-3
# level at 2048 points: float32 rounding moves a row's mass between near
# columns.  On an H100, over the timed 512 pairs, the float32 plain version
# itself lands up to 9.6e-4 from a float64 auction in single entries of V
# (5.1e-5 per pair in relative L2; printed beside the hold), the kernel
# 1.4e-3 (7.9e-5), and the two differ by at most 1.4e-3 (7.8e-5).  A
# kernel whose R is off by a few tenths of a percent, or whose V is off by
# 0.1 in one row of 2048, fails.
PAIR_REL_L2 = 1e-3
# earth_mover_distance's gradient: at (2, 128)^2, uniform in [-1, 1] as
# tests/test_emd_pallas.py, atol 2e-4 against autograd through the float32
# dense cost.  At 2048 points float32 itself moves single entries by up to
# ~4e-3 (the dense float32 gradient against float64, 8 draws on the CPU), so
# there the gradient is held against the float64 dense gradient in relative
# L2 norm: float32 reaches up to 3.5e-4 on those draws; a wrong gradient
# is off by ~1.
EMD_GRAD_ATOL, EMD_GRAD_REL_L2 = 2e-4, 2e-3
# What the auction needs per distance and annealing round (rounds 0-8;
# round 9 is O(N + M)): 8 FLOP for d, 2 row sum, 2 column sum, 2 match mass,
# and for K4 2 for d * match, for K5 6 for V and 6 for U; and one exp2 on
# the special function units (SFU)
EMD_K4_FLOP_PER_DISTANCE_ROUND, EMD_K5_FLOP_PER_DISTANCE_ROUND, EMD_ROUNDS = 16, 26, 9
EMD_FLOP_PER_POINT = 20  # round 9 and the cost, per point of either cloud
# SFU exp2 rate: 16 a clock per SM (CUDA programming guide's throughput
# table, compute capability 9.0), 132 SMs, the 1.98 GHz boost clock that
# the 67 TFLOP/s FP32 peak assumes
PEAK_SFU_EXP2_PER_S = 16 * 132 * 1.98e9


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def clouds(gen: torch.Generator, b: int, n: int, dev) -> torch.Tensor:
    """Unit-space LiDAR-like clouds: uniform in a ball of radius 0.8 with a
    fifth of the points dropped to the origin, as FPS input would carry."""
    p = torch.rand((b, n, 3), generator=gen) * 1.6 - 0.8
    p[torch.rand((b, n), generator=gen) < 0.2] = 0.0
    return p.to(dev)


def check_cd_block(dev) -> dict:
    """Kernel against the plain version at the main path's block shape, at
    ragged ones and at the edges of the kernel's tiling (2048 query points a
    tile, 1024 partner points a chunk, groups of 32), on both of its
    branches; bit for bit across two launches; times both at the main
    path's shape."""
    g = torch.Generator().manual_seed(0)
    shapes = [("main path", (ROW_BLOCK, NUM_POINTS), (CD_BATCH, NUM_POINTS)),
              ("ragged N and M", (4, 100), (3, 77)),
              ("N != M", (5, 300), (7, 1000)),
              ("more than one chunk", (3, 3000), (2, 5000)),
              ("1-point row clouds", (3, 1), (4, NUM_POINTS)),
              ("1-point column clouds", (4, NUM_POINTS), (3, 1)),
              ("1-point clouds", (2, 1), (3, 1)),
              ("tile - 1 x tile + 1", (2, 2047), (3, 2049)),
              ("tile + 1 x chunk + 1", (3, 2049), (2, 1025)),
              ("chunk - 1 x group - 1", (2, 1023), (2, 31)),
              ("N >> M", (2, 6000), (3, 7)),
              ("M >> N", (3, 9), (2, 6000)),
              ("self pair", (4, NUM_POINTS), None),
              ("columns past the chunk, buffer > 48 KB", (2, 20000), (2, 16384)),
              # one pass keeps the smaller cloud's minima in shared memory, at
              # most 49,888 points (227 KB a block); past that, two one-way
              # passes
              ("two one-way passes", (1, 49889), (1, 49889))]
    max_abs = max_rel = 0.0
    for name, (r, n), cm in shapes:
        rows = clouds(g, r, n, dev)
        cols = rows if cm is None else clouds(g, *cm, dev)
        c, m = cols.shape[:2]
        got = chamfer_cuda.cd_block(rows, cols)
        torch.cuda.synchronize()
        want = chamfer_cuda.cd_block_reference(rows, cols)
        diag = None if cm is not None else float(got.diagonal().abs().max())
        err = (got - want).abs()
        bad = err > CD_ATOL + CD_RTOL * want.abs()
        ma, mr = float(err.max()), float((err / want.abs().clamp_min(1e-30)).max())
        print(f"cd_block ({r},{n})x({c},{m}) {name}: max_abs_err {ma:.3e} "
              f"max_rel_err {mr:.3e} (rtol {CD_RTOL}, atol {CD_ATOL})"
              + (f"; diagonal max {diag:.3e}" if diag is not None else ""))
        if bool(bad.any()):
            raise AssertionError(f"cd_block disagrees with its plain version at "
                                 f"({r},{n})x({c},{m}): {int(bad.sum())} entries")
        max_abs, max_rel = max(max_abs, ma), max(max_rel, mr)
        del rows, cols, got, want, err, bad
        torch.cuda.empty_cache()  # the last plain version holds ~40 GB of distances

    _, (r, n), (c, m) = shapes[0]
    rows, cols = clouds(g, r, n, dev), clouds(g, c, m, dev)
    if not torch.equal(chamfer_cuda.cd_block(rows, cols), chamfer_cuda.cd_block(rows, cols)):
        raise AssertionError("cd_block gives other bits on a second launch")
    print("cd_block: two launches on the timed block are equal bit for bit")
    got, want = {}, {}
    ms = cuda_ms(lambda: got.__setitem__(0, chamfer_cuda.cd_block(rows, cols)), iters=10)
    plain_ms = cuda_ms(lambda: want.__setitem__(0, chamfer_cuda.cd_block_reference(rows, cols)),
                       iters=2)
    err = (got[0] - want[0]).abs()
    if bool((err > CD_ATOL + CD_RTOL * want[0].abs()).any()):
        raise AssertionError(f"cd_block's timed output disagrees with its plain version: "
                             f"max abs err {float(err.max())}")
    max_abs = max(max_abs, float(err.max()))
    nbytes = 4 * (rows.numel() + cols.numel() + r * c)
    distances = n * m * r * c
    flops = FLOP_PER_DISTANCE * distances
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOP_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    issue_ms = CD_INSTR_PER_DISTANCE * distances / PEAK_THREAD_INSTR_PER_S * 1e3
    print(f"cd_block ({r},{n})x({c},{m}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms ({flops / 1e9:.1f} GFLOP fp32, {nbytes / 1e6:.2f} MB), "
          f"issue floor of the explicit form {issue_ms:.3f} ms ({CD_INSTR_PER_DISTANCE} "
          f"instructions a distance, 4 warp instructions a clock per SM); "
          f"{r * c / ms * 1e3:.0f} pairs/s")
    return {"name": "cd_block", "route": "cuda",
            "source": "dusty_gan_torch/csrc/cd_block.cu",
            "replaces": "dusty_gan_tpu/metrics/chamfer_pallas.py:265",
            "launches": None, "max_abs_err": max_abs, "max_rel_err": max_rel,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def sass_loops(sass: str, function: str) -> list:
    """Innermost loops of one kernel in ``cuobjdump -sass`` output: a list
    of each loop's instructions (opcode and operands), from its backward
    branch's target to the branch."""
    lines = sass.splitlines()
    start = next(i for i, line in enumerate(lines)
                 if "Function :" in line and function in line)
    insts, labels = [], {}
    for line in lines[start + 1:]:
        if "Function :" in line:
            break
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            labels[label.group(1)] = len(insts)
        found = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if found:
            insts.append((int(found.group(1), 16), found.group(2)))
    index_of = {addr: k for k, (addr, _) in enumerate(insts)}
    # code after the first unpredicated EXIT is out of line (the divergent
    # paths of warp shuffles), and its branches back are not loops
    end = next((k for k, (_, text) in enumerate(insts) if text.startswith("EXIT")),
               len(insts))
    loops = []
    for k, (_, text) in enumerate(insts[:end]):
        if not re.search(r"\bBRA\b", text):
            continue
        target = re.search(r"\(?(\.L_x_\d+)\)?", text)
        if target and target.group(1) in labels:
            t = labels[target.group(1)]
        else:
            addr = re.search(r"0x([0-9a-f]+)", text)
            t = index_of.get(int(addr.group(1), 16)) if addr else None
        if t is not None and t <= k:
            loops.append((t, k))
    inner = [(a, b) for a, b in loops
             if not any((a, b) != (c, d) and a <= c and d <= b for c, d in loops)]
    return [[text for _, text in insts[a:b + 1]] for a, b in inner]


def cd_sass_per_distance() -> dict:
    """Issued SASS instructions a distance in the inner loop of the one-pass
    K1 kernel, from ``cuobjdump -sass`` of the built library: the innermost
    loop with the most FMULs (one a distance: dx*dx) and its instructions
    over them; opcodes counted.  "not measured" without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {"instructions_per_distance": "not measured (no cuobjdump)"}
    sass = subprocess.run([tool, "-sass", str(kernels.library_path("cd_block"))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    opcode = lambda t: re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]  # noqa: E731
    loop = max(sass_loops(sass, "cd_block_kernelILb1E"),
               key=lambda body: sum(opcode(t) == "FMUL" for t in body))
    counts = {}
    for t in loop:
        counts[opcode(t)] = counts.get(opcode(t), 0) + 1
    distances = counts.get("FMUL", 0)
    return {"loop_instructions": len(loop), "distances": distances,
            "instructions_per_distance": len(loop) / distances if distances else
            "not measured (no FMUL in the loop)",
            "opcodes": dict(sorted(counts.items(), key=lambda kv: -kv[1]))}


def protocol_launches(n: int = 5000) -> int:
    """cd_block launches of one scoring run of the n-scan protocol
    (real-real and fake-fake symmetric, real-fake full)."""
    R, C = min(ROW_BLOCK, n), min(CD_BATCH, n)
    sym = len(list(block_schedule(n, n, R, C, True)))
    return 2 * sym + len(list(block_schedule(n, n, R, C, False)))


def nn_bound(b: int, n: int, m: int):
    """(bound ms, bound_by) of one nearest-neighbour launch: the larger of
    its bytes (both clouds read, distances and indices written) over the
    memory rate and its B*N*M distances over the FP32 rate."""
    nbytes = 4 * (b * n * 3 + b * m * 3 + 2 * b * n)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = FLOP_PER_DISTANCE * b * n * m / PEAK_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def hold_nn(x, y, got_d, want_d, got_i=None, want_i=None) -> tuple:
    """One K2 or K3 result against ``nn_reference``'s: distances within
    rtol 1e-5 / atol 1e-6; indices equal, or, where they differ (the kernel
    contracts to fused multiply-adds, so a near-tie can round the other
    way), the two candidates' distances agree within the same tolerance.
    Returns (max abs error, index mismatches)."""
    e = (got_d - want_d).abs()
    if bool((e > CD_ATOL + CD_RTOL * want_d.abs()).any()):
        raise AssertionError(f"distances disagree with nn_reference at {tuple(x.shape)}"
                             f"x{tuple(y.shape)}: max abs err {float(e.max())}")
    if got_i is None:
        return float(e.max()), 0
    diff = got_i != want_i
    if bool(diff.any()):
        def dist_at(idx):
            near = torch.gather(y, 1, idx.long()[..., None].expand(-1, -1, 3))
            return ((x - near) ** 2).sum(-1)[diff]
        da, db = dist_at(got_i), dist_at(want_i)
        if bool(((da - db).abs() > CD_ATOL + CD_RTOL * db.abs()).any()):
            raise AssertionError(f"nn_argmin picks a farther point than nn_reference "
                                 f"at {tuple(x.shape)}x{tuple(y.shape)}")
    return float(e.max()), int(diff.sum())


def check_nn(dev) -> list:
    """K2 (``nn_dist``) and K3 (``nn_argmin``) against ``nn_reference`` on
    the card (``hold_nn``), at the reconstruction shape (512, 16,384)², whose
    timed outputs are held too, and at shapes that take each of the
    kernel's four instantiations (8, 4, 2 and 1 query points a thread):
    small batches come from a small ``--batch-size`` and from the demo's
    few scans.  Times both and their plain versions at the reconstruction
    shape."""
    lib = kernels.load("nn")
    g = torch.Generator().manual_seed(2)
    shapes = [(5, SCAN_POINTS, SCAN_POINTS),  # a batch of 5 scans
              (4, SCAN_POINTS, SCAN_POINTS),  # a fifth of the points at the origin
              (3, 300, 5000),                 # ragged
              (5, 1000, 300),                 # N != M
              (2, 3000, 5000)]                # M above one shared-memory chunk
    err = {"nn_dist": 0.0, "nn_argmin": 0.0}
    mismatches = compared = 0
    taken = {}

    def hold(x, y, d2, d3, i3, want_d, want_i):
        nonlocal mismatches, compared
        b, n, m = x.shape[0], x.shape[1], y.shape[1]
        e2, _ = hold_nn(x, y, d2, want_d)
        e3, mis = hold_nn(x, y, d3, want_d, i3, want_i)
        err["nn_dist"], err["nn_argmin"] = max(err["nn_dist"], e2), max(err["nn_argmin"], e3)
        mismatches, compared = mismatches + mis, compared + i3.numel()
        qpt = lib.nn_points_per_thread(b, n)
        taken[qpt] = taken.get(qpt, []) + [(b, n, m)]
        print(f"nn ({b},{n})x({b},{m}), {qpt} query points a thread: nn_dist "
              f"max_abs_err {e2:.3e}, nn_argmin max_abs_err {e3:.3e}, index "
              f"mismatches {mis} of {i3.numel()}")

    for b, n, m in shapes:
        x, y = clouds(g, b, n, dev), clouds(g, b, m, dev)
        d2 = chamfer_cuda.nn_dist(x, y)
        d3, i3 = chamfer_cuda.nn_argmin(x, y)
        torch.cuda.synchronize()
        hold(x, y, d2, d3, i3, *chamfer_cuda.nn_reference(x, y, need_idx=True))

    b, n = REC_BATCH, SCAN_POINTS
    x, y = clouds(g, b, n, dev), clouds(g, b, n, dev)
    bound_ms, bound_by = nn_bound(b, n, n)
    got, want, entries = {}, {}, []
    for name, fn, need_idx, line in (("nn_dist", chamfer_cuda.nn_dist, False, 355),
                                     ("nn_argmin", chamfer_cuda.nn_argmin, True, 346)):
        ms = cuda_ms(lambda: got.__setitem__(name, fn(x, y)), iters=5)
        plain_ms = cuda_ms(lambda: want.__setitem__(
            name, chamfer_cuda.nn_reference(x, y, need_idx=need_idx)), iters=1, warmup=0)
        print(f"{name} ({b},{n})x({b},{n}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.3f} ms ({bound_by})")
        entries.append({"name": name, "route": "cuda",
                        "source": "dusty_gan_torch/csrc/nn.cu",
                        "replaces": f"dusty_gan_tpu/metrics/chamfer_pallas.py:{line}",
                        "launches": None, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
    if not torch.equal(want["nn_dist"][0], want["nn_argmin"][0]):
        raise AssertionError("nn_reference's distances differ with and without the index")
    hold(x, y, got["nn_dist"], *got["nn_argmin"], *want["nn_argmin"])
    if set(taken) != {8, 4, 2, 1}:
        raise AssertionError(f"the checks took the instantiations {sorted(taken)}, "
                             "not all of 8, 4, 2 and 1 query points a thread")
    for e in entries:
        e["max_abs_err"] = err[e["name"]]
    entries[1]["index_mismatches"] = f"{mismatches} of {compared}"
    print("nn instantiations checked:", json.dumps({str(k): v for k, v in taken.items()}))
    entries[1]["note"] = ("no ported CLI path runs nn_argmin yet (its caller is the "
                          "demo's chamfer inversion); launches are those of the "
                          "reconstruction path, 0")
    return entries


def check_chamfer_grad(dev) -> None:
    """``chamfer_distance``'s forward (K3 both ways) and analytic backward on
    the card against autograd through the dense distance matrix on the
    card, on clouds without ties (autograd splits a tied minimum's gradient
    evenly, the analytic backward gives it to the first index).  rtol 1e-5 /
    atol 1e-6: the cross terms are summed with atomics in no fixed order."""
    g = torch.Generator().manual_seed(3)
    x = (torch.rand((4, 3000, 3), generator=g) * 1.6 - 0.8).to(dev)
    y = (torch.rand((4, 2000, 3), generator=g) * 1.6 - 0.8).to(dev)
    w1 = torch.rand((4, 3000), generator=g).to(dev)
    w2 = torch.rand((4, 2000), generator=g).to(dev)
    grads = []
    for analytic in (True, False):
        tx, ty = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        if analytic:
            d1, d2 = chamfer_distance(tx, ty)
        else:
            d = ((tx[:, :, None] - ty[:, None]) ** 2).sum(-1)
            d1, d2 = d.amin(dim=2), d.amin(dim=1)
        ((d1 * w1).sum() + (d2 * w2).sum()).backward()
        grads.append((d1.detach(), d2.detach(), tx.grad, ty.grad))
    torch.cuda.synchronize()
    for name, got, want in zip(("dist1", "dist2", "grad x", "grad y"), *grads):
        e = (got - want).abs()
        print(f"chamfer_distance {name}: max_abs_err {float(e.max()):.3e} "
              f"(rtol {CD_RTOL}, atol {CD_ATOL})")
        if bool((e > CD_ATOL + CD_RTOL * want.abs()).any()):
            raise AssertionError(f"chamfer_distance {name} on the card disagrees "
                                 f"with dense autograd: {float(e.max())}")


def gaussian(gen: torch.Generator, b: int, n: int, dev, scale: float = 0.3) -> torch.Tensor:
    """Gaussian clouds of standard deviation 0.3, bench.py's EMD clouds."""
    return (torch.randn((b, n, 3), generator=gen) * scale).to(dev)


def emd_bound(pairs: int, n: int, m: int, nbytes: int, with_u: bool):
    """(bound ms, bound_by) of an auction over ``pairs`` pairs: the largest
    of ``nbytes`` (each input read once, each output written once) over the
    memory rate, the FP32 operations over the FP32 rate and the exp2s over
    the SFU rate."""
    flop_d = EMD_K5_FLOP_PER_DISTANCE_ROUND if with_u else EMD_K4_FLOP_PER_DISTANCE_ROUND
    flops = pairs * (EMD_ROUNDS * flop_d * n * m + EMD_FLOP_PER_POINT * (n + m))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    exp2s = pairs * EMD_ROUNDS * n * m
    t_ops = max(flops / PEAK_FP32_FLOP_PER_S, exp2s / PEAK_SFU_EXP2_PER_S) * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def check_ptxas(name: str, count: int) -> None:
    """Print ptxas's registers and spills for the ``count`` kernels of
    ``csrc/<name>.cu`` and fail if any spills."""
    info = kernels.ptxas_info(name)
    print(f"ptxas, {name}.cu:\n" + info)
    spills = [line for line in info.splitlines() if "spill" in line]
    if len(spills) != count or any(not line.strip().startswith(
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
            for line in spills):
        raise AssertionError(f"{name}.cu's kernels spill or ptxas said otherwise: {spills}")


def hold_emd(name: str, got, want, atol: float, rtol: float, diag=None) -> float:
    """|got - want| <= atol + rtol |want| (``diag``: a mask of entries held at
    EMD_DIAG_ATOL instead); returns the largest absolute error."""
    err = (got - want).abs()
    lim = atol + rtol * want.abs()
    if diag is not None:
        lim = torch.where(diag, torch.full_like(lim, EMD_DIAG_ATOL), lim)
    print(f"{name}: max_abs_err {float(err.max()):.3e} (rtol {rtol}, atol {atol}"
          + (f", diagonal atol {EMD_DIAG_ATOL}" if diag is not None else "") + ")")
    if bool((err > lim).any()):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{int((err > lim).sum())} entries, max abs err {float(err.max())}")
    return float(err.max())


def pair_rel_l2(got, want) -> torch.Tensor:
    """Per pair, the L2 norm of got - want over want's (both (B, ...))."""
    d, w = (got - want).flatten(1).double(), want.flatten(1).double()
    return d.norm(dim=1) / w.norm(dim=1).clamp_min(1e-30)


def hold_pair(name: str, got, want) -> float:
    """One K5 result (cost, R, C, V, U) against ``emd_pair_reference``'s:
    the cost at EMD_RTOL, each residue per pair in relative L2 norm at
    PAIR_REL_L2; returns the largest absolute error."""
    errs = [hold_emd(f"emd_pair {name} cost", got[0], want[0], EMD_ATOL, EMD_RTOL)]
    for part, gt, wt in zip(("R", "C", "V", "U"), got[1:], want[1:]):
        rel = float(pair_rel_l2(gt, wt).max())
        errs.append(float((gt - wt).abs().max()))
        print(f"emd_pair {name} {part}: relative L2 error {rel:.3e} in the worst pair "
              f"(held at {PAIR_REL_L2}), max abs err {errs[-1]:.3e}")
        if rel > PAIR_REL_L2:
            raise AssertionError(f"emd_pair {name} {part} disagrees with its plain version: "
                                 f"relative L2 error {rel}")
    return max(errs)


def float64_residues(x, y, chunk: int = 16):
    """R, C, V and U of the dense auction in float64, ``chunk`` pairs at a
    time: how far float32 itself lands from the auction."""
    parts = []
    for i in range(0, x.shape[0], chunk):
        xd, yd = x[i:i + chunk].double(), y[i:i + chunk].double()
        match = emd_cuda.approx_match(xd, yd)
        parts.append((match.sum(2), match.sum(1), torch.bmm(match, yd),
                      torch.bmm(match.transpose(1, 2), xd)))
    return [torch.cat(t) for t in zip(*parts)]


def check_emd_block(dev) -> dict:
    """K4 against ``emd_block_reference`` on the card: (3, 4) x 2048^2 at
    bench.py's scale, a self block, N != M with the integer mass split, a
    ragged pair and a block with all-zero rows (blocked_matrix's padding);
    bit for bit across two launches; then a (16, 512) x 2048^2 block, the
    protocol's, on which both are timed and the kernel's output is held."""
    g = torch.Generator().manual_seed(7)
    x = gaussian(g, 4, NUM_POINTS, dev)
    zero_rows = torch.cat([torch.zeros((2, 512, 3), device=dev), gaussian(g, 2, 512, dev)])
    cases = [("(3,2048)x(4,2048)", gaussian(g, 3, NUM_POINTS, dev), x, None),
             ("self (4,2048)", x, x, torch.eye(4, dtype=torch.bool, device=dev)),
             ("(2,256)x(3,128)", gaussian(g, 2, 256, dev), gaussian(g, 3, 128, dev), None),
             ("(2,128)x(2,384)", gaussian(g, 2, 128, dev), gaussian(g, 2, 384, dev), None),
             ("(2,300)x(2,200)", gaussian(g, 2, 300, dev), gaussian(g, 2, 200, dev), None),
             ("zero rows (4,512)x(3,512)", zero_rows, gaussian(g, 3, 512, dev), None)]
    max_abs = 0.0
    for name, rows, cols, diag in cases:
        got = emd_cuda.emd_block(rows, cols)
        torch.cuda.synchronize()
        want = emd_cuda.emd_block_reference(rows, cols)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"emd_block {name}: non-finite costs")
        max_abs = max(max_abs, hold_emd(f"emd_block {name}", got, want, EMD_ATOL,
                                        EMD_RTOL, diag))
    rows, cols = cases[0][1], cases[0][2]
    if not torch.equal(emd_cuda.emd_block(rows, cols), emd_cuda.emd_block(rows, cols)):
        raise AssertionError("emd_block gives other bits on a second launch")
    print("emd_block: two launches on one input are equal bit for bit")

    r, c, n = ROW_BLOCK, CD_BATCH, NUM_POINTS
    rows, cols = gaussian(g, r, n, dev), gaussian(g, c, n, dev)
    got, want = {}, {}
    ms = cuda_ms(lambda: got.__setitem__(0, emd_cuda.emd_block(rows, cols)), iters=2)
    plain_ms = cuda_ms(lambda: want.__setitem__(0, emd_cuda.emd_block_reference(rows, cols)),
                       iters=1, warmup=0)
    max_abs = max(max_abs, hold_emd(f"emd_block ({r},{n})x({c},{n}), the timed block",
                                    got[0], want[0], EMD_ATOL, EMD_RTOL))
    bound_ms, bound_by = emd_bound(r * c, n, n, 4 * (rows.numel() + cols.numel() + r * c),
                                   with_u=False)
    print(f"emd_block ({r},{n})x({c},{n}): kernel {ms:.3f} ms ({ms / (r * c) * 1e3:.3f} us "
          f"a pair), plain {plain_ms:.3f} ms ({plain_ms / (r * c):.3f} ms a pair), bound "
          f"{bound_ms:.3f} ms ({bound_by}); {r * c / ms * 1e3:.0f} pairs/s")
    return {"name": "emd_block", "route": "cuda", "source": "dusty_gan_torch/csrc/emd.cu",
            "replaces": "dusty_gan_tpu/metrics/emd_pallas.py:307",
            "launches": None, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "shape": f"({r},{n})x({c},{n}) block",
            "plain_ms_per_pair": plain_ms / (r * c)}


def check_emd_pair(dev) -> dict:
    """K5 against ``emd_pair_reference`` on the card at (4, 2048)^2 and a
    ragged (2, 300) x (2, 200): cost, R, C, V and U; the gradient of
    ``earth_mover_distance`` against autograd through the dense plain cost
    with the match detached, at (2, 128)^2 and, against float64, at
    (2, 2048)^2; then a (512, 2048)^2 launch, on which both are timed and
    the kernel's output is held."""
    g = torch.Generator().manual_seed(8)
    max_abs = 0.0
    for name, b, n, m in (("(4,2048)^2", 4, NUM_POINTS, NUM_POINTS),
                          ("(2,300)x(2,200)", 2, 300, 200)):
        x, y = gaussian(g, b, n, dev), gaussian(g, b, m, dev)
        got = emd_cuda.emd_pair(x, y)
        torch.cuda.synchronize()
        max_abs = max(max_abs, hold_pair(name, got, emd_cuda.emd_pair_reference(x, y)))

    def weighted_grads(fn, x, y):
        wts = torch.tensor([0.7, -1.3], dtype=x.dtype, device=dev)
        tx, ty = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        (fn(tx, ty) * wts).sum().backward()
        return tx.grad, ty.grad

    x = (torch.rand((2, 128, 3), generator=g) * 2 - 1).to(dev)
    y = (torch.rand((2, 128, 3), generator=g) * 2 - 1).to(dev)
    for part, gt, wt in zip(("grad x", "grad y"), weighted_grads(earth_mover_distance, x, y),
                            weighted_grads(earth_mover_distance_dense, x, y)):
        hold_emd(f"earth_mover_distance {part} (2,128)^2", gt, wt, EMD_GRAD_ATOL, 0.0)
    x, y = gaussian(g, 2, NUM_POINTS, dev), gaussian(g, 2, NUM_POINTS, dev)
    kernel = weighted_grads(earth_mover_distance, x, y)
    plain = weighted_grads(earth_mover_distance_dense, x, y)
    exact = weighted_grads(earth_mover_distance_dense, x.double(), y.double())
    for i, part in enumerate(("grad x", "grad y")):
        rel = lambda a: float((a.double() - exact[i]).norm() / exact[i].norm())  # noqa: E731
        worst = lambda a: float((a.double() - exact[i]).abs().max())  # noqa: E731
        print(f"earth_mover_distance {part} (2,2048)^2 against float64: relative L2 error "
              f"{rel(kernel[i]):.3e} (held at {EMD_GRAD_REL_L2}; the float32 plain version's "
              f"{rel(plain[i]):.3e}), max abs err {worst(kernel[i]):.3e} (plain "
              f"{worst(plain[i]):.3e})")
        if rel(kernel[i]) > EMD_GRAD_REL_L2:
            raise AssertionError(f"earth_mover_distance {part} at (2,2048)^2: relative L2 "
                                 f"error {rel(kernel[i])} against float64")

    b, n = REC_BATCH, NUM_POINTS
    x, y = gaussian(g, b, n, dev), gaussian(g, b, n, dev)
    got, want = {}, {}
    ms = cuda_ms(lambda: got.__setitem__(0, emd_cuda.emd_pair(x, y)), iters=3)
    plain_ms = cuda_ms(lambda: want.__setitem__(0, emd_cuda.emd_pair_reference(x, y)),
                       iters=1, warmup=0)
    max_abs = max(max_abs, hold_pair(f"({b},{n})^2, the timed launch", got[0], want[0]))
    for part, k, p, e in zip(("R", "C", "V", "U"), got[0][1:], want[0][1:],
                             float64_residues(x, y)):
        worst = lambda a: float(pair_rel_l2(a, e).max())  # noqa: E731
        print(f"emd_pair ({b},{n})^2 {part} against float64 (not held): relative L2 error "
              f"in the worst pair {worst(k):.3e} (plain {worst(p):.3e}), max abs err "
              f"{float((k - e).abs().max()):.3e} (plain {float((p - e).abs().max()):.3e})")
    out_floats = b * (1 + 4 * n + 4 * n)  # cost, R, C, V, U
    bound_ms, bound_by = emd_bound(b, n, n, 4 * (x.numel() + y.numel() + out_floats),
                                   with_u=True)
    print(f"emd_pair ({b},{n})^2: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"({plain_ms / b:.3f} ms a pair), bound {bound_ms:.3f} ms ({bound_by})")
    return {"name": "emd_pair", "route": "cuda", "source": "dusty_gan_torch/csrc/emd.cu",
            "replaces": "dusty_gan_tpu/metrics/emd_pallas.py:346",
            "launches": None, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "shape": f"({b},{n})^2 launch",
            "plain_ms_per_pair": plain_ms / b,
            "note": "no ported CLI path runs emd_pair (its callers are the public "
                    "earth_mover_distance / compute_emd), launches are those of the "
                    "EMD path, 0"}


def prepare(work: str, num_test: int) -> dict:
    """Synthetic KITTI tree, the full-width DUSty-II config and a
    reference-format .pth of seeded random weights."""
    root = build_synthetic_kitti(os.path.join(work, "data"), n_scans_per_seq=num_test,
                                 w0=512, sequences=(0, 11))
    cfg = compose(os.path.join(REPO, "configs"),
                  ["model=dusty2_dcgan_eqlr", "dataset=kitti_odometry",
                   f"dataset.root={root}"])
    cfg.model.gen.shape = list(cfg.dataset.shape)
    gen = cfg.model.gen
    if (gen.in_ch, gen.ch_base, gen.ch_max) != (512, 64, 512) or \
            list(cfg.dataset.shape) != [64, 256]:
        raise AssertionError(f"not the full-width configuration: {gen}")
    torch.manual_seed(0)
    G = define_G(cfg)
    sd = G.state_dict()
    pth = os.path.join(work, "checkpoint.pth")
    torch.save({"step": 0, "G": sd, "G_ema": sd}, pth)
    cfg_path = save_config(cfg, os.path.join(work, "run"))
    return {"G": G, "cfg": cfg, "pth": pth, "cfg_path": cfg_path}


WRAPPERS = (chamfer_cuda.cd_block, chamfer_cuda.nn_dist, chamfer_cuda.nn_argmin,
            emd_cuda.emd_block, emd_cuda.emd_pair)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def synthesis_args(work: str, run: dict, num_test: int) -> list:
    return ["--model-path", run["pth"], "--config-path", run["cfg_path"],
            "--save-dir-path", os.path.join(work, "out"),
            "--num-test", str(num_test), "--num-points", str(NUM_POINTS),
            "--cd-batch", str(CD_BATCH), "--device", "cuda"]


def check_scores(name: str, s: dict, keys: set) -> None:
    if set(s) != keys:
        raise AssertionError(f"{name} score keys {sorted(s)}, expected {sorted(keys)}")
    bad = {k: v for k, v in s.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"{name} scores not finite: {bad}")


def synthesis_path(work: str, run: dict, num_test: int) -> int:
    """evaluate_synthesis (generated and --compute-gt); returns the
    cd_block launches of the two runs."""
    args = synthesis_args(work, run, num_test)
    cwd = os.getcwd()
    os.chdir(work)  # --compute-gt writes outputs/ under the working directory
    try:
        reset_launches()
        t_fake, t_gt = {}, {}
        t0 = time.perf_counter()
        fake = es.main(args, timings=t_fake)
        t1 = time.perf_counter()
        gt = es.main(args + ["--compute-gt"], timings=t_gt)
        t2 = time.perf_counter()
        launches = chamfer_cuda.cd_block.launches
    finally:
        os.chdir(cwd)
    for name, s in (("fake", fake), ("gt", gt)):
        check_scores(name, s, EXPECTED_KEYS)
    if launches <= 0:
        raise AssertionError("the synthesis path launched cd_block no time")
    print("scores (generated vs test):", json.dumps(fake, sort_keys=True))
    print("scores (train vs test):", json.dumps(gt, sort_keys=True))
    print("stages:", json.dumps({"generated_run_s": t1 - t0, "gt_run_s": t2 - t1,
                                 "generated": t_fake, "gt": t_gt}))
    return launches


def emd_path(work: str, run: dict, num_test: int) -> dict:
    """evaluate_synthesis --metrics cd,emd on ``num_test`` generated scans
    against the test split (the protocol's 5000 cut in depth); checks every
    key and that emd_block ran; projects the 5000-scan protocol's pairwise
    EMD time from the run's us a pair; returns the run's launch counts."""
    t = {}
    reset_launches()
    t0 = time.perf_counter()
    s = es.main(synthesis_args(work, run, num_test) + ["--metrics", "cd,emd"], timings=t)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    check_scores("emd run", s, EXPECTED_KEYS | EMD_KEYS)
    if launches["emd_block"] <= 0 or launches["cd_block"] <= 0:
        raise AssertionError(f"the EMD path's launches: {launches}")
    R, C = min(ROW_BLOCK, num_test), min(CD_BATCH, num_test)
    pairs = sum(R * C for _ in block_schedule(num_test, num_test, R, C, True)) * 2 + \
        sum(R * C for _ in block_schedule(num_test, num_test, R, C, False))
    protocol_pairs = protocol_launches() * ROW_BLOCK * CD_BATCH
    us_per_pair = t["pairwise_emd"] / pairs * 1e6
    print("scores (generated vs test, cd,emd):", json.dumps(s, sort_keys=True))
    print("stages:", json.dumps({"emd_run_s": wall, "num_test": num_test, "emd_pairs": pairs,
                                 "emd_block_launches": launches["emd_block"],
                                 "emd_us_per_pair": us_per_pair, "generated": t}))
    print(f"emd_block in one 5000-scan run: {protocol_launches()} (16,512) blocks, "
          f"{protocol_pairs} pairs; projected pairwise EMD time "
          f"{protocol_pairs * us_per_pair / 1e6:.0f} s at this run's {us_per_pair:.2f} us a pair")
    return launches


def calibration_path(work: str, run: dict, num_test: int, dev) -> None:
    """evaluate_synthesis --calibrate-drop-rate (CD only) on ``num_test``
    generated scans: the calibrated drop rate is within CALIB_ATOL of the
    target, or the threshold sits at an end of its interval (the target is
    out of the generator's reach, as the real rate may be for random
    weights).  Then the bisection on the card toward a target the generator
    reaches: its own drop rate at threshold 0.3 on 64 calibration latents."""
    t = {}
    reset_launches()
    t0 = time.perf_counter()
    s = es.main(synthesis_args(work, run, num_test) + ["--calibrate-drop-rate"], timings=t)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    check_scores("calibration run", s, EXPECTED_KEYS | CALIB_KEYS)
    if launches["cd_block"] <= 0:
        raise AssertionError(f"the calibration path's launches: {launches}")
    gap = abs(s["drop_rate/calibrated"] - s["drop_rate/target"])
    at_end = s["mask_threshold"] in (1e-3, 1.0 - 1e-3)
    print("calibration:", json.dumps({
        k: s[k] for k in sorted(CALIB_KEYS)} | {"gap": gap, "at_interval_end": at_end,
                                               "calibration_run_s": wall, "stages": t}))
    if not (at_end or gap <= CALIB_ATOL):
        raise AssertionError(f"calibrated drop rate {s['drop_rate/calibrated']} is not the "
                             f"target {s['drop_rate/target']}")

    cfg = run["cfg"]
    drop = float(cfg.model.gen.drop_const)
    G = copy.deepcopy(run["G"]).to(dev).requires_grad_(False)
    gen = make_eval_generator(G, make_fixed_noise(G, tuple(cfg.dataset.shape), device=dev))
    z = es.latents(0, 64, int(cfg.model.gen.in_ch), es.CALIB_SEED).to(dev)
    with torch.no_grad():
        target = float(drop_rate_2d(gen(z, threshold=0.3)["depth"], drop))
    thr, achieved = calibrate_mask_threshold(gen, z, target, drop, batch=32)
    print(f"calibration toward the rate at threshold 0.3 ({target:.6f}): threshold "
          f"{thr:.6f}, rate {achieved:.6f} (held at atol {CALIB_ATOL})")
    if abs(achieved - target) > CALIB_ATOL:
        raise AssertionError(f"calibration reached {achieved}, not {target}")


def reconstruction_path(work: str, run: dict, num_step: int) -> dict:
    """evaluate_reconstruction on one batch of 512 test scans; returns the
    nn kernels' launches of the run."""
    out_dir = os.path.join(work, "rec")
    args = ["--model-path", run["pth"], "--config-path", run["cfg_path"],
            "--save-dir-path", out_dir, "--batch-size", str(REC_BATCH),
            "--num-step", str(num_step), "--max-batches", "1", "--device", "cuda"]
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    er.main(args, stats=stats)
    wall = time.perf_counter() - t0
    launches = {"nn_dist": chamfer_cuda.nn_dist.launches,
                "nn_argmin": chamfer_cuda.nn_argmin.launches}

    (path,) = glob.glob(os.path.join(out_dir, "*.csv"))
    with open(path) as f:
        rows = list(csv.reader(f))
    if rows[0] != REC_CSV_HEADER:
        raise AssertionError(f"CSV header {rows[0]} is not the JAX CLI's")
    if len(rows) - 1 != REC_BATCH:
        raise AssertionError(f"CSV has {len(rows) - 1} rows, expected {REC_BATCH}")
    bad = [r for r in rows[1:] if not all(math.isfinite(float(v)) for v in r[1:])]
    if bad:
        raise AssertionError(f"{len(bad)} CSV rows hold non-finite values: {bad[0]}")
    if launches["nn_dist"] != 2:
        raise AssertionError(f"the reconstruction path launched nn_dist "
                             f"{launches['nn_dist']} times, expected 2")
    if not stats["loss_zstar"] < stats["loss_z0"]:
        raise AssertionError(f"the masked loss did not fall: z0 {stats['loss_z0']} "
                             f"-> z* {stats['loss_zstar']}")
    cols = list(zip(*[[float(v) for v in r[1:]] for r in rows[1:]]))
    means = {k: sum(c) / len(c) for k, c in zip(REC_CSV_HEADER[1:], cols)}
    print("reconstruction means:", json.dumps(means, sort_keys=True))
    print("stages:", json.dumps({
        "reconstruction_run_s": wall, "inversion_s": stats["inversion_s"],
        "ms_per_step": stats["inversion_s"] / num_step * 1e3,
        "cd_ms": stats["cd_s"] * 1e3, "rest_s": stats["rest_s"],
        "loss_z0": stats["loss_z0"], "loss_zstar": stats["loss_zstar"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "num_step": num_step, "batch": REC_BATCH}))
    return launches


def profile_inversion(dev, run: dict, steps: int = 10) -> None:
    """Kernel time by name and the device's busy share over ``steps``
    inversion steps of the full-width generator at batch 512 in bf16 (the
    reconstruction path's setting), from torch.profiler; per-step numbers
    include 1/steps of the loop's final forward.  Also the FLOP of one step
    (forward and the gradient for z) from torch's FLOP counter, and the
    least time the bf16 tensor cores need for them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    G = copy.deepcopy(run["G"]).to(dev).requires_grad_(False)
    gen = make_eval_generator(G, make_fixed_noise(G, (64, 256), device=dev))
    g = torch.Generator(device=dev).manual_seed(4)
    ref = torch.rand((REC_BATCH, 64, 256, 1), generator=g, device=dev)
    mask = (torch.rand((REC_BATCH, 64, 256, 1), generator=g, device=dev) > 0.2).float()
    z0 = torch.randn((REC_BATCH, 512), generator=g, device=dev)
    noise = lambda i, shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
    loss = lambda z: masked_loss(ref, (gen(z)["depth_orig"] + 1.0) / 2.0, mask)  # noqa: E731
    loop = make_inversion_loop(loss, num_steps=steps)
    loop(z0, noise)  # warm-up
    with FlopCounterMode(display=False) as fc:
        make_inversion_loop(loss, num_steps=1)(z0, noise)
    one_step_and_forward = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            loss(z0)
    flop_step = one_step_and_forward - fc.get_total_flops()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop(z0, noise)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for e in prof.events():  # device-side events: kernels, copies, sets
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    rows = sorted(per_kernel.items(), key=lambda r: -r[1])
    busy_ms = sum(t for _, t in rows)
    print("inversion_profile:", json.dumps({
        "steps": steps, "batch": REC_BATCH, "wall_ms_per_step": wall_ms / steps,
        "flop_per_step": flop_step,
        "bf16_bound_ms_per_step": flop_step / PEAK_BF16_FLOP_PER_S * 1e3,
        "device_busy_ms_per_step": busy_ms / steps if rows else "not measured",
        "device_idle_share": 1.0 - busy_ms / wall_ms if rows else "not measured",
        "top_kernels_ms_per_step": [[k[:90], t / steps] for k, t in rows[:12]]}))


def inversion_card_vs_cpu(dev, run: dict, steps: int = 5) -> None:
    """5 inversion steps of the full-width generator in float32 at batch 2,
    from the same z0, noise and target, on the card and on the CPU.  Under
    the L2 loss z* must agree within atol Z_ATOL.  Under the L1 loss (the
    CLI's default) the difference is printed, not held: a pixel whose error
    crosses 0 flips the sign of its gradient, so two float32 trajectories
    part once one crosses at a different step."""
    g = torch.Generator().manual_seed(5)
    ref = torch.rand((2, 64, 256, 1), generator=g)
    mask = (torch.rand((2, 64, 256, 1), generator=g) > 0.2).float()
    z0 = torch.randn((2, 512), generator=g)
    draws = [torch.randn((2, 512), generator=g) for _ in range(steps)]
    fixed = make_fixed_noise(run["G"], (64, 256))
    for distance in ("l2", "l1"):
        z = {}
        for where in ("cuda", "cpu"):
            d = dev if where == "cuda" else torch.device("cpu")
            G = copy.deepcopy(run["G"]).to(d).requires_grad_(False)
            fn = {k: v.to(d) for k, v in fixed.items()}
            gen = make_eval_generator(G, fn, compute_dtype=None)
            r, m = ref.to(d), mask.to(d)
            loop = make_inversion_loop(
                lambda zz: masked_loss(r, (gen(zz)["depth_orig"] + 1.0) / 2.0, m, distance),
                num_steps=steps)
            z[where] = loop(z0.to(d), lambda i, shape: draws[i].to(d))[0].cpu()
        err = float((z["cuda"] - z["cpu"]).abs().max())
        held = f"atol {Z_ATOL}" if distance == "l2" else "not held"
        print(f"inversion card vs cpu ({steps} float32 steps, batch 2, {distance}): "
              f"z* max_abs_err {err:.3e} ({held})")
        if distance == "l2" and err > Z_ATOL:
            raise AssertionError(f"z* on the card vs the CPU: {err}")


def inversion_grad_bf16(dev, run, b: int = 8) -> None:
    """The gradient for z of one inversion step (the masked L1 at step 0's
    noise-perturbed latent) through the full-width generator with bf16
    convolutions, as the reconstruction path runs it, against the same
    gradient with float32 convolutions, both on the card.  Held per sample:
    the L2 norm of the difference within BF16_GRAD_RTOL of the float32
    gradient's, and their cosine at least BF16_GRAD_MIN_COS; bf16 keeps 8
    significant bits, so each layer, forward and back, adds relative errors
    of a few 1e-3."""
    g = torch.Generator(device=dev).manual_seed(6)
    ref = torch.rand((b, 64, 256, 1), generator=g, device=dev)
    mask = (torch.rand((b, 64, 256, 1), generator=g, device=dev) > 0.2).float()
    z = project_sphere(torch.randn((b, 512), generator=g, device=dev))
    shift = latent_noise_strength(0, NUM_STEP) * torch.randn((b, 512), generator=g, device=dev)
    G = copy.deepcopy(run["G"]).to(dev).requires_grad_(False)
    fixed = make_fixed_noise(G, (64, 256), device=dev)
    grads = []
    for dtype in (torch.bfloat16, None):
        gen = make_eval_generator(G, fixed, compute_dtype=dtype)
        latent = z.clone().requires_grad_(True)
        inv = (gen(latent + shift)["depth_orig"] + 1.0) / 2.0
        (grad,) = torch.autograd.grad(masked_loss(ref, inv, mask, "l1").sum(), latent)
        grads.append(grad)
    bf16, f32 = grads
    rel = (bf16 - f32).norm(dim=1) / f32.norm(dim=1)
    cos = torch.nn.functional.cosine_similarity(bf16, f32, dim=1)
    print(f"inversion gradient bf16 vs float32 on the card (batch {b}, l1): relative "
          f"L2 error max {float(rel.max()):.3e} (held at {BF16_GRAD_RTOL}), cosine "
          f"min {float(cos.min()):.6f} (held at {BF16_GRAD_MIN_COS})")
    if float(rel.max()) > BF16_GRAD_RTOL or float(cos.min()) < BF16_GRAD_MIN_COS:
        raise AssertionError(f"bf16 gradient for z vs float32: relative error "
                             f"{float(rel.max())}, cosine {float(cos.min())}")


def small_input_agreement(dev, G) -> None:
    """The card's scores and generator output on a small input agree with
    the CPU's (plain Chamfer version, CPU convolutions); so do the card's
    pairwise EMD matrices, symmetric and full, with padded blocks, and the
    CPU's (plain auction), at EMD_RTOL and, on the diagonal, EMD_DIAG_ATOL."""
    g = torch.Generator().manual_seed(1)
    gen, ref = clouds(g, 24, 300, "cpu"), clouds(g, 20, 300, "cpu")
    on_card = compute_cov_mmd_1nna(gen.to(dev), ref.to(dev), 7)
    on_cpu = compute_cov_mmd_1nna(gen, ref, 7)
    for k, v in on_cpu.items():
        if not math.isclose(on_card[k], v, rel_tol=1e-5, abs_tol=1e-7):
            raise AssertionError(f"{k}: card {on_card[k]} vs cpu {v}")
    gen_card, ref_card = gen.to(dev), ref.to(dev)
    for name, card, cpu, diag in (
            ("gen x gen", pairwise_emd(gen_card, gen_card, 7), pairwise_emd(gen, gen, 7),
             torch.eye(24, dtype=torch.bool)),
            ("ref x gen", pairwise_emd(ref_card, gen_card, 7), pairwise_emd(ref, gen, 7),
             None)):
        hold_emd(f"pairwise_emd {name} card vs cpu", torch.from_numpy(card),
                 torch.from_numpy(cpu), EMD_ATOL, EMD_RTOL, diag)
    z = torch.randn((4, 512), generator=g)
    with torch.no_grad():
        # depth before the Gumbel mask: no noise draw involved
        out_card = G.to(dev)(z.to(dev), train=False)["depth_orig"].cpu()
        out_cpu = G.cpu()(z, train=False)["depth_orig"]
    err = float((out_card - out_cpu).abs().max())
    print(f"small input: card vs cpu scores agree; G depth max_abs_err {err:.3e}")
    if err > 1e-3:
        raise AssertionError(f"full-width G on the card vs the CPU: {err}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num-test", type=int, default=NUM_TEST,
                        help="scans per split of the synthetic tree and scored "
                             "samples of the synthesis run")
    parser.add_argument("--num-step", type=int, default=NUM_STEP,
                        help="inversion steps of the reconstruction run")
    parser.add_argument("--emd-num-test", type=int, default=EMD_NUM_TEST,
                        help="scored samples of the --metrics cd,emd run and of the "
                             "calibration run")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if args.num_test < REC_BATCH:
        raise SystemExit(f"--num-test must be at least {REC_BATCH}: the "
                         "reconstruction run inverts one batch of that many scans")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print("card:", card)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0))
    t = time.perf_counter()
    kernels.build()
    print(f"kernel build: {time.perf_counter() - t:.1f} s")
    check_ptxas("cd_block", 2)  # the one-pass and the two-pass instantiation
    check_ptxas("emd", 2)
    print("cd_block SASS, inner loop:", json.dumps(cd_sass_per_distance()))

    entries = [check_cd_block(dev)] + check_nn(dev)
    check_chamfer_grad(dev)
    entries += [check_emd_block(dev), check_emd_pair(dev)]
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(REPO, "build"))
    try:
        run = prepare(work, args.num_test)
        cd_launches = synthesis_path(work, run, args.num_test)
        emd_launches = emd_path(work, run, args.emd_num_test)
        calibration_path(work, run, args.emd_num_test, dev)
        nn_launches = reconstruction_path(work, run, args.num_step)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    entries[0]["launches"] = cd_launches
    entries[1]["launches"] = nn_launches["nn_dist"]
    entries[2]["launches"] = nn_launches["nn_argmin"]
    entries[3]["launches"] = emd_launches["emd_block"]
    entries[4]["launches"] = emd_launches["emd_pair"]
    print(f"cd_block launches in one {args.num_test}-scan run: "
          f"{cd_launches // 2}; in one 5000-scan run: {protocol_launches()}")
    profile_inversion(dev, run)
    inversion_card_vs_cpu(dev, run)
    inversion_grad_bf16(dev, run)
    small_input_agreement(dev, run["G"])

    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
