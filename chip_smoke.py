"""Smoke run of dusty_gan_torch on one CUDA GPU.

    python3 chip_smoke.py [--num-test 512] [--num-step 1000] [--emd-num-test 256]

1. Prints the card's name and power limit and the torch version, and
   builds every CUDA kernel of the port from ``dusty_gan_torch/csrc``
   (one nvcc per source, all started together); prints ptxas's registers
   and spills for ``cd_block.cu``, ``emd.cu`` and ``nn.cu`` and fails if
   their kernels spill; counts ``cd_block``'s issued SASS instructions a
   distance in its inner loop (``cuobjdump``).
2. Holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes and at ragged ones, and times both: ``cd_block``
   (K1, also at the edges of its tiling, on both of its branches, and bit
   for bit across two launches), ``nn_dist`` (K2) and ``nn_argmin`` (K3)
   (at the edges of their culled design; equal distances bit for bit,
   indices equal the plain version's; the distances each pass formed, by
   the counting instantiation, on uniform clouds, on clouds where nothing
   can be culled, where K2 is held to 1.2x the brute-force kernel's time,
   and on the reconstruction path's own clouds), ``emd_block`` (K4, also
   bit for bit across two launches) and ``emd_pair`` (K5), both also above
   3072 points on their device-memory path, with a full-scan (1, 16384)^2
   K5 launch against a float64 auction; and the gradients of
   ``chamfer_distance`` and ``earth_mover_distance`` against autograd
   through the dense plain versions.
3. Drives the synthesis path, ``dusty_gan_torch.cli.evaluate_synthesis``,
   for the full-width DUSty-II generator (configs/model/dusty2_dcgan_eqlr.yaml,
   64x256 KITTI) with seeded random weights on a synthetic KITTI tree:
   512 test scans (``--num-test``; 5000 is the paper's protocol),
   2048-point clouds, and again with --compute-gt; then the EMD path,
   ``--metrics cd,emd`` on 256 generated scans (``--emd-num-test``), from
   whose us a pair it projects the 5000-scan protocol's EMD time, again
   at 4096 points a cloud on 32 scans (the EMD kernels' device-memory
   path), and one ``--calibrate-drop-rate`` run (CD only) on 256.
4. Drives the reconstruction path,
   ``dusty_gan_torch.cli.evaluate_reconstruction``, on the same generator
   and tree: one batch of 512 test scans, ``--num-step`` inversion steps,
   Chamfer distance on the full 16,384-point clouds; checks the CSV, that
   the masked loss fell, counts the distances K2 formed on the path's own
   clouds, and profiles a few inversion steps.
5. Drives the training path, ``dusty_gan_torch.cli.train``, for the same
   full-width DUSty-II (and its discriminator, ch_base 64, ch_max 512) at
   batch 32 under bf16 with R1 and DiffAugment, on the tree's train split
   with the val split (sequence 08, 256 scans) scored once in training on
   K1: run 1 logs stats, validates and checkpoints; run 2 resumes from run
   1's mid-run checkpoint and is held to run 1 (its first step's losses,
   its final G_ema); K1 is held against its plain version on the blocks the
   validation gave it.  Then it times the train step (CUDA events, scans/s,
   peak memory, FLOP against the bf16 rate, device idle share and top
   device ops from torch.profiler), holds one float32 step at a small width
   on the card against the CPU, prints one full-width step's bf16 against
   float32 scalars, and checks that D's bf16 logit sees a far-field-only
   change.
   Each path's kernel launch counts are set to 0 just before it and read
   just after.
   Around the training phase: (a) the data path: the native library
   against the numpy pipeline on this host, bit for bit; the resized
   cache's build seconds for the train split, with and without the flip
   cache; the host's ms to collate a batch of 32 from raw scans, from the
   cache and from the flip cache.  Training run 1 reads the resized cache
   (``cache_dataset``).  (b) the device cache: its first batches against
   the host path's bit for bit (flips included), its bytes, upload
   seconds and per-step gather time beside the KITTI-size projection; a
   CLI run with ``cache_device=true`` resumed from run 1's checkpoint and
   held as run 2 is, and a CLI run with ``transfer_dtype=float16``.  (c)
   ``dusty_gan_torch.cli.tune_tolerance`` on run 1's final G_ema (full
   width), the 256-scan val split at 512 points, 8 TPE trials; K1 is held
   against its plain version on the blocks the trials gave it.  (d)
   ``dusty_gan_torch.cli.process_kitti`` on 32 raw 64x2048 scans that the
   script writes, native against numpy bit for bit, scans a second.  (e)
   ``Lidar.points_to_depth`` at 64x2048 on 16,384 points of a processed
   scan, card against CPU, image and gradient.
6. Trains through CUDA-graph chunks (``steps_per_call``): (a) graph
   against eager at full width (DUSty-II, batch 32, R1, DiffAugment, the
   device cache), under bf16 and under float32: three eager trainers and
   one in chunks of 4 from one seed for 17 iterations (a chunk of 1, then
   the CLI's schedule from iteration 2: 3, 4, 4, 4, 1), eager against
   eager, then graph against its nearest eager run after iterations 1 and
   4 (the JAX package's state envelope) and on the scalars at the end,
   each bound the larger of the JAX one and twice the eager runs' spread;
   the replays must cover every chunked iteration; (b) ms a step for K = 1 (eager), 2, 4, 8, 16
   by CUDA events over 64 iterations, capture seconds, peak memory, the
   host's launches a step outside the graphs, and device busy time and
   idle share from torch.profiler; (c) ``cli.train ... cache_device=true
   steps_per_call=4`` at full width for 48 iterations with one validation
   on K1 (its blocks held against the plain version), and a chunk run
   resumed from a per-step checkpoint at iteration 21 (first chunk 3),
   held to the uninterrupted chunk run at iteration 24 and on its final
   G_ema.  (d) Training run 2 passes ``profile_dir=``: its Chrome trace
   and summary, with the step's device kernels by name.
7. Checks the scores (every key, finite) and, on small inputs, the card's
   scores, pairwise EMD matrices, generator output and inversion against
   the CPU, and one
   inversion step's bf16 gradient for z against float32 on the card.
8. Prints a JSON line of per-kernel numbers (K1's with its training-path
   launches under ``training``, its chunk-mode CLI's under
   ``training_chunks`` and its tolerance-tuning launches under
   ``tune_tolerance``), the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when there is no GPU or any phase
fails.
"""

from __future__ import annotations

import argparse
import copy
import csv
import gc
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

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from dusty_gan_torch import kernels  # noqa: E402
from dusty_gan_torch.cli import evaluate_reconstruction as er  # noqa: E402
from dusty_gan_torch.cli import evaluate_synthesis as es  # noqa: E402
from dusty_gan_torch.cli import process_kitti  # noqa: E402
from dusty_gan_torch.cli import train as train_cli  # noqa: E402
from dusty_gan_torch.cli import tune_tolerance  # noqa: E402
from dusty_gan_torch.config import compose, save_config  # noqa: E402
from dusty_gan_torch.data import preprocess  # noqa: E402
from dusty_gan_torch.data.datasets import define_dataset  # noqa: E402
from dusty_gan_torch.data.loader import Loader  # noqa: E402
from dusty_gan_torch.data.synthetic import (  # noqa: E402
    build_synthetic_kitti, synthetic_scene_depth)
from dusty_gan_torch.geometry.lidar import Lidar  # noqa: E402
from dusty_gan_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY  # noqa: E402
from dusty_gan_torch.metrics import chamfer, chamfer_cuda, cov_mmd_1nna, emd_cuda  # noqa: E402
from dusty_gan_torch.metrics.chamfer import chamfer_distance  # noqa: E402
from dusty_gan_torch.metrics.emd import (  # noqa: E402
    earth_mover_distance, earth_mover_distance_dense)
from dusty_gan_torch.metrics.cov_mmd_1nna import (  # noqa: E402
    ROW_BLOCK, block_schedule, compute_cov_mmd_1nna, pairwise_emd)
from dusty_gan_torch.models.factory import define_D, define_G  # noqa: E402
from dusty_gan_torch.models.losses import masked_loss  # noqa: E402
from dusty_gan_torch.utils.inversion import (  # noqa: E402
    latent_noise_strength, make_inversion_loop, project_sphere)
from dusty_gan_torch.utils.calibration import (  # noqa: E402
    calibrate_mask_threshold, drop_rate_2d)
from dusty_gan_torch.train.state import create_train_state  # noqa: E402
from dusty_gan_torch.train.step import TrainStep, sample_draws  # noqa: E402
from dusty_gan_torch.train.trainer import Trainer  # noqa: E402
from dusty_gan_torch.utils import profiling  # noqa: E402
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
# the --metrics cd,emd run above the EMD kernels' shared-memory path
EMD_LARGE_POINTS, EMD_LARGE_NUM_TEST = 4096, 32
# K2 on clouds where no partner group can be culled: within 1.2x of the
# brute-force kernel's 34.46 ms a (512, 16384)^2 launch (NVIDIA H100 80GB
# HBM3, 700 W, the slowest of its runs in PERF.md)
NN_ADVERSARIAL_MS = 1.2 * 34.46
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
# training: full-width DUSty-II at batch 32 under bf16, run 1 for
# TRAIN_ITERS iterations with stats every TRAIN_STATS (so iteration 21, the
# resumed run's first, is logged by both runs), one validation at
# TRAIN_TEST on VAL_SCANS val scans (sequence 08, built apart with its own
# seed), checkpoints every TRAIN_SAVE; run 2 resumes from iteration
# TRAIN_SAVE
TRAIN_BATCH, TRAIN_ITERS, TRAIN_STATS, TRAIN_TEST, TRAIN_SAVE = 32, 42, 7, 30, 20
VAL_SCANS = 256
# run 2's first step and final G_ema against run 1's: the checkpoint and
# the draws are the same, so only the card's unordered reductions (cuDNN's
# backward algorithms, atomics) part them; a wrong resume (another batch,
# other draws, a lost optimizer or EMA state) moves losses by ~0.1 and
# G_ema by ~1e-2 in relative L2
RESUME_SCALAR_RTOL, RESUME_SCALAR_ATOL, RESUME_EMA_REL_L2 = 1e-3, 1e-4, 1e-3
# one float32 step at a small width, card against CPU, in relative L2 over
# each model: the Adam moments (the gradients, which float32 sums in other
# orders on the two devices) within 1e-4; the weights within 1e-3, since
# Adam's first update lr * g / (|g| + 1e-8) takes either sign where g is
# below the gradients' float32 noise (a flip moves a weight by 2 lr = 4e-3)
STEP_MOMENT_REL_L2, STEP_WEIGHT_REL_L2, STEP_SCALAR_RTOL = 1e-4, 1e-3, 1e-4

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


def nn_bound(b: int, n: int, m: int, distances: int):
    """(bound ms, bound_by) of one nearest-neighbour launch: the larger of
    its bytes (both clouds read, distances and indices written) over the
    memory rate and ``distances`` (B*N*M for brute force, or the
    distances a culled launch formed) over the FP32 rate."""
    nbytes = 4 * (b * n * 3 + b * m * 3 + 2 * b * n)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = FLOP_PER_DISTANCE * distances / PEAK_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def hold_nn(x, y, got_d, want_d, got_i=None, want_i=None) -> dict:
    """One K2 or K3 result against ``nn_reference``'s, which forms the same
    distance expression: distances within rtol 1e-5 / atol 1e-6 (and
    counted where their bits differ); indices equal wherever the distances
    are, and where the distances differ, the kernel's index must reach its
    own distance.  Returns the max abs error and the counts."""
    e = (got_d - want_d).abs()
    if bool((e > CD_ATOL + CD_RTOL * want_d.abs()).any()):
        raise AssertionError(f"distances disagree with nn_reference at {tuple(x.shape)}"
                             f"x{tuple(y.shape)}: max abs err {float(e.max())}")
    same = got_d == want_d
    out = {"max_abs_err": float(e.max()), "distances_not_bit_equal": int((~same).sum())}
    if got_i is None:
        return out
    diff = got_i != want_i
    if bool((diff & same).any()):
        raise AssertionError(f"nn_argmin's index differs from nn_reference's where the "
                             f"distances are equal at {tuple(x.shape)}x{tuple(y.shape)}: "
                             f"{int((diff & same).sum())} queries")
    if bool(diff.any()):
        near = torch.gather(y, 1, got_i.long()[..., None].expand(-1, -1, 3))
        if bool((chamfer_cuda._sq_dist_fma(x[..., None, :], near[..., None, :])[..., 0, 0]
                 != got_d)[diff].any()):
            raise AssertionError("nn_argmin's index does not reach its distance")
    out["index_mismatches"] = int(diff.sum())
    return out


def adversarial(gen: torch.Generator, b: int, n: int, dev):
    """Clouds where no partner group can be culled: queries in a ball of
    radius 1e-3 at the origin, partners on the sphere of radius 0.8, so
    every group's box is about as near the queries as their minima."""
    q = torch.randn((b, n, 3), generator=gen) * 1e-3
    p = torch.randn((b, n, 3), generator=gen)
    return q.to(dev), (0.8 * p / p.norm(dim=2, keepdim=True)).to(dev)


def nn_work(entries: list, name: str, x, y) -> tuple:
    """The distances K2's and K3's counting instantiation formed in each
    pass on (x, y): prints them, records each kernel's evaluated share
    under ``evaluated_share_<name>`` and returns {kernel: (pass 1, pass 2,
    brute force)} and K2's distances."""
    total = x.shape[0] * x.shape[1] * y.shape[1]
    out, dist2 = {}, None
    for e, need_idx in zip(entries, (False, True)):
        dist, _, p1, p2 = chamfer_cuda.nn_evaluated(x, y, need_idx)
        dist2 = dist if dist2 is None else dist2
        if not torch.equal(dist, dist2):
            raise AssertionError("the counting instantiations' distances differ")
        out[e["name"]] = (p1, p2, total)
        e[f"evaluated_share_{name}"] = (p1 + p2) / total
        print(f"{e['name']} {name} ({x.shape[0]},{x.shape[1]})x({y.shape[0]},{y.shape[1]}): "
              f"distances formed in pass 1 {p1} ({p1 / total:.4%}), pass 2 {p2} "
              f"({p2 / total:.4%}) of {total}")
    return out, dist2


def check_nn(dev) -> list:
    """K2 (``nn_dist``) and K3 (``nn_argmin``) against ``nn_reference`` on
    the card (``hold_nn``) at the edges of the culled design: ragged N and
    M, partner groups of 32 +- 1, a batch of 1 (the demo's), N >> M and
    M >> N, all points at the origin, a fifth at the origin, and the
    reconstruction shape (512, 16,384)^2 whose timed outputs are held too;
    K2's and K3's distances bit for bit equal, and each kernel's outputs
    across two launches.  The distances each pass formed (``nn_work``) on
    the timed clouds (uniform, a fifth at the origin) and on clouds where
    no group can be culled, on which K2 is held to 1.2x the brute-force
    kernel's 34.46 ms (PERF.md); the reconstruction path's own clouds get
    theirs after that path has run."""
    lib = kernels.load("nn")
    g = torch.Generator().manual_seed(2)
    zeros = lambda b, n: torch.zeros((b, n, 3), device=dev)  # noqa: E731
    shapes = [("a batch of 5 scans", clouds(g, 5, SCAN_POINTS, dev), clouds(g, 5, SCAN_POINTS, dev)),
              ("a batch of 1 scan", clouds(g, 1, SCAN_POINTS, dev), clouds(g, 1, SCAN_POINTS, dev)),
              ("ragged N and M", clouds(g, 3, 300, dev), clouds(g, 3, 5001, dev)),
              ("group - 1", clouds(g, 2, 1000, dev), clouds(g, 2, 31, dev)),
              ("group + 1", clouds(g, 2, 33, dev), clouds(g, 2, 33, dev)),
              ("1-point clouds", clouds(g, 3, 1, dev), clouds(g, 3, 1, dev)),
              ("N >> M", clouds(g, 2, 20000, dev), clouds(g, 2, 7, dev)),
              ("M >> N", clouds(g, 2, 9, dev), clouds(g, 2, 20000, dev)),
              ("all points at the origin", zeros(2, 3000), zeros(2, 2000)),
              ("queries at the origin", zeros(2, 500), clouds(g, 2, 4000, dev))]
    err = {"nn_dist": 0.0, "nn_argmin": 0.0}
    totals = {"mismatches": 0, "compared": 0, "not_bit_equal": 0}
    taken = {}

    def hold(name, x, y, d2, d3, i3, want_d, want_i):
        b, n, m = x.shape[0], x.shape[1], y.shape[1]
        if not torch.equal(d2, d3):
            raise AssertionError(f"nn_dist's and nn_argmin's distances differ ({name})")
        h2 = hold_nn(x, y, d2, want_d)
        h3 = hold_nn(x, y, d3, want_d, i3, want_i)
        err["nn_dist"] = max(err["nn_dist"], h2["max_abs_err"])
        err["nn_argmin"] = max(err["nn_argmin"], h3["max_abs_err"])
        totals["mismatches"] += h3["index_mismatches"]
        totals["compared"] += i3.numel()
        totals["not_bit_equal"] += h3["distances_not_bit_equal"]
        qpt = lib.nn_points_per_thread(b, n)
        taken[qpt] = taken.get(qpt, []) + [(b, n, m)]
        print(f"nn ({b},{n})x({b},{m}) {name}, {qpt} query points a thread: max_abs_err "
              f"{h3['max_abs_err']:.3e}, distances not bit-equal to nn_reference "
              f"{h3['distances_not_bit_equal']}, index mismatches {h3['index_mismatches']} "
              f"of {i3.numel()}")

    for name, x, y in shapes:
        d2 = chamfer_cuda.nn_dist(x, y)
        d3, i3 = chamfer_cuda.nn_argmin(x, y)
        torch.cuda.synchronize()
        hold(name, x, y, d2, d3, i3, *chamfer_cuda.nn_reference(x, y, need_idx=True))
        if not (torch.equal(d2, chamfer_cuda.nn_dist(x, y))
                and all(map(torch.equal, (d3, i3), chamfer_cuda.nn_argmin(x, y)))):
            raise AssertionError(f"nn kernels give other bits on a second launch ({name})")
    print("nn instantiations taken (query points a thread):",
          json.dumps({str(k): v for k, v in taken.items()}))

    b, n = REC_BATCH, SCAN_POINTS
    x, y = clouds(g, b, n, dev), clouds(g, b, n, dev)
    brute_ms, _ = nn_bound(b, n, n, b * n * n)
    got, want, entries = {}, {}, []
    for name, fn, need_idx, line in (("nn_dist", chamfer_cuda.nn_dist, False, 355),
                                     ("nn_argmin", chamfer_cuda.nn_argmin, True, 346)):
        ms = cuda_ms(lambda: got.__setitem__(name, fn(x, y)), iters=5)
        plain_ms = cuda_ms(lambda: want.__setitem__(
            name, chamfer_cuda.nn_reference(x, y, need_idx=need_idx)), iters=1, warmup=0)
        entries.append({"name": name, "route": "cuda",
                        "source": "dusty_gan_torch/csrc/nn.cu",
                        "replaces": f"dusty_gan_tpu/metrics/chamfer_pallas.py:{line}",
                        "launches": None, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": None, "bound_brute_force_ms": brute_ms,
                        "shape": f"({b},{n})^2 launch"})
    if not torch.equal(want["nn_dist"][0], want["nn_argmin"][0]):
        raise AssertionError("nn_reference's distances differ with and without the index")
    hold("the timed launch", x, y, got["nn_dist"], *got["nn_argmin"], *want["nn_argmin"])
    del want
    if not torch.equal(got["nn_dist"], chamfer_cuda.nn_dist(x, y)):
        raise AssertionError("nn_dist gives other bits on a second launch (timed shape)")

    # the work each pass did on the timed clouds and on clouds where no
    # group can be culled (the reconstruction path's own: nn_work after it)
    work, dist2 = nn_work(entries, "uniform", x, y)
    if not torch.equal(dist2, got["nn_dist"]):
        raise AssertionError("the counting instantiation's distances differ from nn_dist's")
    qa, pa = adversarial(g, b, n, dev)
    nn_work(entries, "adversarial", qa, pa)
    # no group can be culled: K2 against the brute-force kernel's time
    sub = slice(0, 8)
    hold("adversarial, 8 clouds", qa[sub], pa[sub], chamfer_cuda.nn_dist(qa[sub], pa[sub]),
         *chamfer_cuda.nn_argmin(qa[sub], pa[sub]),
         *chamfer_cuda.nn_reference(qa[sub], pa[sub], need_idx=True))
    adv_ms = cuda_ms(lambda: chamfer_cuda.nn_dist(qa, pa), iters=5)
    adv_argmin_ms = cuda_ms(lambda: chamfer_cuda.nn_argmin(qa, pa), iters=3)
    layout_ms = cuda_ms(lambda: chamfer_cuda.nn_layout(x, y), iters=5)
    lay = chamfer_cuda.nn_layout(x, y)
    kernel_ms = [cuda_ms(lambda: chamfer_cuda.nn_on_layout(lay, need_idx), iters=5)
                 for need_idx in (False, True)]
    del lay
    print(f"nn_dist adversarial ({b},{n})^2: {adv_ms:.3f} ms (held at {NN_ADVERSARIAL_MS:.3f} "
          f"ms, 1.2x the brute-force kernel's 34.46 ms), nn_argmin {adv_argmin_ms:.3f} ms; "
          f"the layout step alone (Morton order, gathers, boxes) {layout_ms:.3f} ms; the "
          f"kernels alone on the timed clouds' layout {kernel_ms[0]:.3f} / {kernel_ms[1]:.3f} ms")

    for e, k_ms in zip(entries, kernel_ms):
        p1, p2, total = work[e["name"]]
        e["bound_ms"], e["bound_by"] = nn_bound(b, n, n, p1 + p2)
        e["max_abs_err"] = err[e["name"]]
        e["layout_ms"], e["kernel_only_ms"] = layout_ms, k_ms
        print(f"{e['name']} ({b},{n})^2: kernel {e['ms']:.3f} ms (layout included), plain "
              f"{e['plain_ms']:.3f} ms, bound on the distances formed {e['bound_ms']:.3f} ms "
              f"({e['bound_by']}; {(p1 + p2) / total:.4%} of brute force), brute-force "
              f"bound {brute_ms:.3f} ms")
    entries[0]["adversarial_ms"] = adv_ms
    entries[1]["adversarial_ms"] = adv_argmin_ms
    entries[1]["index_mismatches"] = f"{totals['mismatches']} of {totals['compared']}"
    entries[1]["distances_not_bit_equal_to_plain"] = totals["not_bit_equal"]
    entries[1]["note"] = ("no ported CLI path runs nn_argmin yet (its caller is the "
                          "demo's chamfer inversion); launches are those of the "
                          "reconstruction path, 0")
    if adv_ms > NN_ADVERSARIAL_MS:
        raise AssertionError(f"nn_dist on clouds no group of which can be culled takes "
                             f"{adv_ms:.3f} ms, over {NN_ADVERSARIAL_MS:.3f} ms")
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

    wts = torch.tensor([0.7, -1.3], device=dev)
    x = (torch.rand((2, 128, 3), generator=g) * 2 - 1).to(dev)
    y = (torch.rand((2, 128, 3), generator=g) * 2 - 1).to(dev)
    for part, gt, wt in zip(("grad x", "grad y"), weighted_grads(earth_mover_distance, x, y, wts),
                            weighted_grads(earth_mover_distance_dense, x, y, wts)):
        hold_emd(f"earth_mover_distance {part} (2,128)^2", gt, wt, EMD_GRAD_ATOL, 0.0)
    x, y = gaussian(g, 2, NUM_POINTS, dev), gaussian(g, 2, NUM_POINTS, dev)
    kernel = weighted_grads(earth_mover_distance, x, y, wts)
    plain = weighted_grads(earth_mover_distance_dense, x, y, wts)
    exact = weighted_grads(earth_mover_distance_dense, x.double(), y.double(), wts.double())
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


def weighted_grads(fn, x, y, wts):
    """Gradients of sum_b wts[b] * fn(x, y)[b] for both clouds."""
    tx, ty = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    (fn(tx, ty) * wts).sum().backward()
    return tx.grad, ty.grad


def check_emd_device_path(dev) -> dict:
    """K4 and K5 above 3072 points a cloud, where the auction state sits in
    a device-memory workspace: K4 against ``emd_block_reference`` at
    (2,4096)^2 and a mixed (1,5000)x(2,3500), bit for bit across two
    launches; K5 against ``emd_pair_reference`` at (2,4096)^2 and a ragged
    (2,3100)x(2,4500); one timed (1,16384)^2 full-scan K5 launch against a
    float64 auction; ``earth_mover_distance``'s gradient at (1,4096)^2
    against float64; K4 timed on an (8,33) block of 4096-point clouds.
    Returns each kernel's device-path numbers for the ``kernels`` line."""
    g = torch.Generator().manual_seed(9)
    out = {"emd_block": {}, "emd_pair": {}}
    max_abs, block_abs = 0.0, 0.0
    big = EMD_LARGE_POINTS
    for name, (r, n), (c, m) in ((f"(2,{big})^2", (2, big), (2, big)),
                                 ("(1,5000)x(2,3500)", (1, 5000), (2, 3500))):
        rows, cols = gaussian(g, r, n, dev), gaussian(g, c, m, dev)
        got = emd_cuda.emd_block(rows, cols)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"emd_block {name}: non-finite costs")
        block_abs = max(block_abs, hold_emd(f"emd_block device path {name}", got,
                                            emd_cuda.emd_block_reference(rows, cols),
                                            EMD_ATOL, EMD_RTOL))
        if not torch.equal(got, emd_cuda.emd_block(rows, cols)):
            raise AssertionError(f"emd_block device path {name}: other bits on a second launch")
    print("emd_block device path: two launches equal bit for bit at both shapes")
    for name, b, n, m in ((f"(2,{big})^2", 2, big, big), ("(2,3100)x(2,4500)", 2, 3100, 4500)):
        x, y = gaussian(g, b, n, dev), gaussian(g, b, m, dev)
        got = emd_cuda.emd_pair(x, y)
        torch.cuda.synchronize()
        max_abs = max(max_abs, hold_pair(f"device path {name}", got,
                                         emd_cuda.emd_pair_reference(x, y)))
    out["emd_pair"]["max_abs_err"] = max_abs

    x, y = gaussian(g, 1, big, dev), gaussian(g, 1, big, dev)
    wts = torch.tensor([0.7], device=dev)
    kernel = weighted_grads(earth_mover_distance, x, y, wts)
    exact = weighted_grads(earth_mover_distance_dense, x.double(), y.double(), wts.double())
    for part, k, e in zip(("grad x", "grad y"), kernel, exact):
        rel = float((k.double() - e).norm() / e.norm())
        print(f"earth_mover_distance {part} (1,{big})^2 against float64: relative L2 error "
              f"{rel:.3e} (held at {EMD_GRAD_REL_L2})")
        if rel > EMD_GRAD_REL_L2:
            raise AssertionError(f"earth_mover_distance {part} at (1,{big})^2: relative L2 "
                                 f"error {rel} against float64")

    # one full scan a cloud: a single block, so a single SM, runs the pair
    x, y = clouds(g, 1, SCAN_POINTS, dev), clouds(g, 1, SCAN_POINTS, dev)
    got = {}
    ms = cuda_ms(lambda: got.__setitem__(0, emd_cuda.emd_pair(x, y)), iters=1)
    plain = emd_cuda.emd_pair_reference(x, y)
    xd, yd = x.double(), y.double()
    match = emd_cuda.approx_match(xd, yd)
    exact = (emd_cuda.match_cost(xd, yd, match), match.sum(2), match.sum(1),
             torch.bmm(match, yd), torch.bmm(match.transpose(1, 2), xd))
    del match
    rel_cost = lambda c: float((c.double() - exact[0]).abs().max() / exact[0].abs().max())  # noqa: E731
    print(f"emd_pair (1,{SCAN_POINTS})^2 cost against float64: relative error "
          f"{rel_cost(got[0][0]):.3e} (the float32 plain version's {rel_cost(plain[0]):.3e}); "
          f"against the float32 plain version {float((got[0][0] - plain[0]).abs().max() / plain[0].abs().max()):.3e}")
    for part, k, p32, e in zip("RCVU", got[0][1:], plain[1:], exact[1:]):
        print(f"emd_pair (1,{SCAN_POINTS})^2 {part} against float64: relative L2 error "
              f"{float(pair_rel_l2(k, e).max()):.3e} (the float32 plain version's "
              f"{float(pair_rel_l2(p32, e).max()):.3e}); against the float32 plain version "
              f"{float(pair_rel_l2(k, p32).max()):.3e}")
    cost_rel = rel_cost(got[0][0])
    if cost_rel > EMD_RTOL:
        raise AssertionError(f"emd_pair (1,{SCAN_POINTS})^2 cost: {cost_rel} from float64")
    for part, k, e in zip("RCVU", got[0][1:], exact[1:]):
        rel = float(pair_rel_l2(k, e).max())
        if rel > PAIR_REL_L2:
            raise AssertionError(f"emd_pair (1,{SCAN_POINTS})^2 {part}: relative L2 error "
                                 f"{rel} against float64")
    del exact, xd, yd, plain
    torch.cuda.empty_cache()
    bound_ms, bound_by = emd_bound(1, SCAN_POINTS, SCAN_POINTS,
                                   4 * (x.numel() + y.numel() + 1 + 8 * SCAN_POINTS), True)
    out["emd_pair"].update({"shape": f"(1,{SCAN_POINTS})^2 launch", "ms": ms,
                            "bound_ms": bound_ms, "bound_by": bound_by,
                            "workspace_pairs_a_launch": emd_cuda.pairs_per_launch(
                                SCAN_POINTS, SCAN_POINTS, True, 10 ** 9)})
    print(f"emd_pair device path (1,{SCAN_POINTS})^2: kernel {ms:.3f} ms (one block, one SM), "
          f"bound {bound_ms:.3f} ms ({bound_by}) on the whole card")

    r, c, n = 8, 33, big
    rows, cols = gaussian(g, r, n, dev), gaussian(g, c, n, dev)
    ms = cuda_ms(lambda: emd_cuda.emd_block(rows, cols), iters=2)
    bound_ms, bound_by = emd_bound(r * c, n, n, 4 * (rows.numel() + cols.numel() + r * c), False)
    out["emd_block"] = {"shape": f"({r},{n})x({c},{n}) block", "ms": ms,
                        "us_per_pair": ms / (r * c) * 1e3, "bound_ms": bound_ms,
                        "bound_by": bound_by, "max_abs_err": block_abs,
                        "workspace_pairs_a_launch": emd_cuda.pairs_per_launch(n, n, False, 10 ** 9)}
    print(f"emd_block device path ({r},{n})x({c},{n}): kernel {ms:.3f} ms "
          f"({ms / (r * c) * 1e3:.1f} us a pair), bound {bound_ms:.3f} ms ({bound_by})")
    return out


def prepare(work: str, num_test: int) -> dict:
    """Synthetic KITTI tree (train 00, test 11, and the val split 08 with a
    seed of its own, so that 00 and 11 stay as before), the full-width
    DUSty-II config and a reference-format .pth of seeded random weights."""
    root = build_synthetic_kitti(os.path.join(work, "data"), n_scans_per_seq=num_test,
                                 w0=512, sequences=(0, 11))
    build_synthetic_kitti(root, n_scans_per_seq=VAL_SCANS, w0=512, sequences=(8,), seed=1)
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
    return {"G": G, "cfg": cfg, "pth": pth, "cfg_path": cfg_path, "root": root}


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


def emd_large_path(work: str, run: dict) -> dict:
    """evaluate_synthesis --metrics cd,emd at 4096 points a cloud on 32
    scans: every EMD pair takes the kernels' device-memory path.  Checks
    every key and that emd_block ran; returns the run's launch counts."""
    t = {}
    args = synthesis_args(work, run, EMD_LARGE_NUM_TEST) + ["--metrics", "cd,emd"]
    args[args.index("--num-points") + 1] = str(EMD_LARGE_POINTS)
    reset_launches()
    t0 = time.perf_counter()
    s = es.main(args, timings=t)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    check_scores("emd run at 4096 points", s, EXPECTED_KEYS | EMD_KEYS)
    if s["#points"] != EMD_LARGE_POINTS or launches["emd_block"] <= 0 \
            or not emd_cuda.uses_device_memory(EMD_LARGE_POINTS, EMD_LARGE_POINTS):
        raise AssertionError(f"the 4096-point EMD path: #points {s['#points']}, "
                             f"launches {launches}")
    print(f"scores (generated vs test, cd,emd, {EMD_LARGE_POINTS} points):",
          json.dumps(s, sort_keys=True))
    print("stages:", json.dumps({"emd_large_run_s": wall, "num_test": EMD_LARGE_NUM_TEST,
                                 "num_points": EMD_LARGE_POINTS, "launches": launches,
                                 "generated": t}))
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


def reconstruction_path(work: str, run: dict, num_step: int):
    """evaluate_reconstruction on one batch of 512 test scans; returns the
    nn kernels' launches of the run and the clouds its Chamfer score gave
    K2 (recorded on the way to the kernel, for ``nn_work``)."""
    out_dir = os.path.join(work, "rec")
    args = ["--model-path", run["pth"], "--config-path", run["cfg_path"],
            "--save-dir-path", out_dir, "--batch-size", str(REC_BATCH),
            "--num-step", str(num_step), "--max-batches", "1", "--device", "cuda"]
    stats, seen = {}, []

    def recording_nn_dist(x, y):
        seen.append((x, y))
        return chamfer_cuda.nn_dist(x, y)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    chamfer.nn_dist = recording_nn_dist
    try:
        t0 = time.perf_counter()
        er.main(args, stats=stats)
        wall = time.perf_counter() - t0
    finally:
        chamfer.nn_dist = chamfer_cuda.nn_dist
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
    return launches, seen


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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_overrides(root: str, run_dir: str, iters: int, *extra) -> list:
    return ["model=dusty2_dcgan_eqlr", "dataset=kitti_odometry", f"dataset.root={root}",
            "enable_amp=true", f"solver.batch_size={TRAIN_BATCH}",
            f"total_iterations={iters}", f"run_dir={run_dir}",
            f"validate_samples={VAL_SCANS}", f"solver.checkpoint.save_stats={TRAIN_STATS}",
            f"solver.checkpoint.test={TRAIN_TEST}",
            f"solver.checkpoint.save_model={TRAIN_SAVE}", "device=cuda", *extra]


def logged(run_dir: str) -> dict:
    """scalars.jsonl as {image step: {tag: value}}."""
    out = {}
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            step = row.pop("step")
            row.pop("t")
            out.setdefault(step, {}).update(row)
    return out


def rel_l2(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over every tensor of two state dicts."""
    num = sum(float((got[k].float() - want[k].float()).pow(2).sum()) for k in want)
    den = sum(float(want[k].float().pow(2).sum()) for k in want)
    return math.sqrt(num / den)


def training_path(work: str, run: dict) -> dict:
    """dusty_gan_torch.cli.train at full width (DUSty-II, batch 32, bf16),
    reading the resized cache (``cache_dataset``, the default): run 1 with
    stats, one validation (pairwise CD on K1) and checkpoints;
    run 2 resumed from run 1's mid-run checkpoint, its first step's scalars
    and its final G_ema held against run 1's.  Returns the run's K1
    launches, the blocks K1 was given, the stage times, run 1's directory
    and its CLI scans/s."""
    root = run["root"]
    dir1, dir2 = os.path.join(work, "train1"), os.path.join(work, "train2")
    blocks = []

    def recording_cd_block(rows, cols):
        blocks.append((rows.clone(), cols.clone()))
        return chamfer_cuda.cd_block(rows, cols)

    reset_launches()
    cov_mmd_1nna.cd_block = recording_cd_block
    t1 = {}
    try:
        t0 = time.perf_counter()
        train_cli.main(train_overrides(root, dir1, TRAIN_ITERS), timings=t1)
        wall1 = time.perf_counter() - t0
    finally:
        cov_mmd_1nna.cd_block = chamfer_cuda.cd_block
    launches = launch_counts()
    if launches["cd_block"] <= 0 or not blocks:
        raise AssertionError(f"the training path's validation launched cd_block "
                             f"{launches['cd_block']} times")

    mid = os.path.join(dir1, "models", f"checkpoint_{TRAIN_SAVE * TRAIN_BATCH:010d}.pth")
    t2 = {}
    prof_dir = os.path.join(work, "profile")
    t0 = time.perf_counter()
    train_cli.main(train_overrides(root, dir2, TRAIN_ITERS, f"resume={mid}",
                                   f"solver.checkpoint.test={10 * TRAIN_ITERS}",
                                   f"profile_dir={prof_dir}"), timings=t2)
    wall2 = time.perf_counter() - t0

    hold_resume(dir1, dir2, "resumed")
    profile_dir_check(prof_dir)
    rows1 = logged(dir1)
    scores = {k: v for r in rows1.values() for k, v in r.items() if k.startswith("score/")}
    if not scores:
        raise AssertionError("run 1 logged no validation scores")
    sps = {step // TRAIN_BATCH: r["perf/scans_per_sec"] for step, r in rows1.items()
           if "perf/scans_per_sec" in r}
    print("validation scores (random weights, iteration 30):", json.dumps(scores, sort_keys=True))
    print("stages:", json.dumps({
        "train_run1_s": wall1, "train_run1_loop_s": t1["train_s"],
        "validation_s": t1["validation_s"], "validation_cd_block_launches": launches["cd_block"],
        "train_run2_s": wall2, "cli_scans_per_sec_by_iteration": sps}))
    return {"launches": launches["cd_block"], "blocks": blocks,
            "validation_s": t1["validation_s"], "dir": dir1, "sps": sps}


def hold_resume(dir1: str, dir2: str, name: str, resumed_at: int = TRAIN_SAVE,
                first_logged: int = TRAIN_SAVE + 1, final_iteration: int = TRAIN_ITERS,
                rtol: float = RESUME_SCALAR_RTOL, atol: float = RESUME_SCALAR_ATOL) -> None:
    """Run 2 (``dir2``), resumed at iteration ``resumed_at`` from a
    checkpoint of run 1's, held to run 1: the losses of the first iteration
    both logged after it (within ``rtol``, ``atol``) and its final G_ema."""
    rows1, rows2 = logged(dir1), logged(dir2)
    first = first_logged * TRAIN_BATCH
    a, b = rows1[first], rows2[first]
    if set(a) != set(b) or not all(math.isfinite(v) for r in (rows1, rows2)
                                   for row in r.values() for v in row.values()):
        raise AssertionError(f"{name}: logged scalars {sorted(a)} vs {sorted(b)}")
    worst = max(abs(a[k] - b[k]) / (atol + rtol * abs(a[k])) for k in a if k.startswith("loss/"))
    final = f"checkpoint_{final_iteration * TRAIN_BATCH:010d}.pth"
    ema1 = torch.load(os.path.join(dir1, "models", final), weights_only=True)["G_ema"]
    ema2 = torch.load(os.path.join(dir2, "models", final), weights_only=True)["G_ema"]
    ema_err = rel_l2(ema2, ema1)
    print(f"training, {name} at iteration {resumed_at}: iteration {first_logged}'s "
          f"losses within {worst:.3f} of their hold (rtol {rtol}, atol {atol}); final "
          f"G_ema relative L2 {ema_err:.3e} (held at "
          f"{RESUME_EMA_REL_L2})")
    print(f"training iteration {first_logged} run 1:", json.dumps(a, sort_keys=True))
    print(f"training iteration {first_logged} {name}:", json.dumps(b, sort_keys=True))
    if worst > 1.0 or ema_err > RESUME_EMA_REL_L2:
        raise AssertionError(f"the {name} run left run 1: losses {worst}x their hold, "
                             f"G_ema {ema_err}")


def profile_dir_check(prof_dir: str) -> None:
    """``profile_dir=`` on a per-step CLI run: one Chrome trace, and its
    summary (``utils/profiling.py``) with the step's device kernels by
    name."""
    traces = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    summary = profiling.summarize_trace(prof_dir, steps=4)
    if len(traces) != 1 or summary is None:
        raise AssertionError(f"profile_dir: traces {traces}, summary {summary}")
    cats = {r["category"]: r for r in summary["by_category"]}
    if "kernel" not in cats or not summary["top_ops"]:
        raise AssertionError(f"profile_dir: no device kernel in the summary: {cats}")
    print("profile_dir:", json.dumps({
        "trace": os.path.basename(traces[0]), "trace_mb": os.path.getsize(traces[0]) / 1e6,
        "total_ms_per_step": summary["total_ms_per_step"],
        "num_op_events": summary["num_op_events"], "by_category": summary["by_category"],
        "top_ops": summary["top_ops"][:8]}))


def hold_blocks(blocks: list, path: str) -> dict:
    """K1 on a path's own (rows, cols) blocks against the plain version;
    times both on the first block."""
    max_abs = 0.0
    for rows, cols in blocks:
        got = chamfer_cuda.cd_block(rows, cols)
        want = chamfer_cuda.cd_block_reference(rows, cols)
        err = (got - want).abs()
        if bool((err > CD_ATOL + CD_RTOL * want.abs()).any()):
            raise AssertionError(f"cd_block on a {path} block {tuple(rows.shape)}x"
                                 f"{tuple(cols.shape)}: max abs err {float(err.max())}")
        max_abs = max(max_abs, float(err.max()))
    rows, cols = blocks[0]
    ms = cuda_ms(lambda: chamfer_cuda.cd_block(rows, cols), iters=20)
    plain_ms = cuda_ms(lambda: chamfer_cuda.cd_block_reference(rows, cols), iters=2)
    (r, n, _), (c, m, _) = rows.shape, cols.shape
    shape = f"({r},{n})x({c},{m})"
    print(f"cd_block on the {path} path's {len(blocks)} blocks: max_abs_err {max_abs:.3e} "
          f"(rtol {CD_RTOL}, atol {CD_ATOL}); {shape}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms")
    return {"shape": shape, "blocks": len(blocks), "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms}


# ---------------------------------------------------------------------------
# the data path, the device cache, tolerance tuning, KITTI preprocessing and
# points_to_depth
# ---------------------------------------------------------------------------

COLLATE_BATCHES = 5  # batches timed per host collate variant
NATIVE_CHECK_STRIDE = 8  # every 8th train scan: native against numpy, both flips
DEVICE_CACHE_BATCHES = 6  # first batches of the device cache held to the host path
F16_ITERS = 14  # the transfer_dtype=float16 CLI run
TUNE_TRIALS, TUNE_POINTS = 8, 512
# raw KITTI-format scans the preprocessing phase writes: 24 in train seq 00, 8
# in val seq 08, 64 rings of 2048 returns at most (~115k points a scan)
KITTI_SEQ_SCANS, KITTI_H, KITTI_W = {0: 24, 8: 8}, 64, 2048
P2D_POINTS = 16384
# points_to_depth card vs CPU: CUDA's and the CPU's float32 atan2 differ by an
# ulp on some points, which moves a point whose two nearest grid angles are
# that close to the other one: at most this share of points may change
# pixel, of pixels may change value, and the gradient may move by this
# relative L2
P2D_MOVED_SHARE, P2D_GRAD_REL_L2, P2D_ATOL = 1e-3, 1e-2, 1e-5
KITTI_TRAIN_SCANS = 19130  # KITTI odometry's train split, sequences 00-07, 09, 10


def collate_ms(ds) -> float:
    """The trainer's host collate (batch 32, depth only, one thread): ms a
    batch over COLLATE_BATCHES batches of epoch 1."""
    batches = Loader(ds, TRAIN_BATCH, shuffle=True, drop_last=True, seed=0,
                     keys=("depth",)).epoch(1)
    next(batches)
    t0 = time.perf_counter()
    for _ in range(COLLATE_BATCHES):
        next(batches)
    return (time.perf_counter() - t0) / COLLATE_BATCHES * 1e3


def data_path(work: str, run: dict) -> None:
    """Native library against numpy on this host, bit for bit (every 8th
    train scan, both flips); the resized cache's build seconds for the
    train split, without and with the flip cache; the host's ms to collate
    a batch from raw scans, from the cache and from the flip cache."""
    dcfg = copy.deepcopy(run["cfg"].dataset)
    raw = define_dataset(dcfg, "train")
    items = 0
    for i in range(0, len(raw), NATIVE_CHECK_STRIDE):
        scan = raw._load_raw(i)
        for flip in (False, True):
            a, b = raw._process(scan, flip), raw._process(scan, flip, native=False)
            for k in a:
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"native and numpy items differ: scan {i}, "
                                         f"flip {flip}, {k}")
            items += 1
    cache_dir = os.path.join(work, "cache_probe")
    t0 = time.perf_counter()
    cached = define_dataset(dcfg, "train", cache_dir=cache_dir)
    build_s = time.perf_counter() - t0
    dcfg.flip = True
    t0 = time.perf_counter()
    cached_flip = define_dataset(dcfg, "train", cache_dir=cache_dir)
    build_flip_s = time.perf_counter() - t0
    out = {"native_equals_numpy_items": items, "train_scans": len(raw),
           "cache_build_s": build_s, "cache_build_with_flip_s": build_flip_s,
           "host_collate_ms_per_batch": {"raw": collate_ms(raw), "cached": collate_ms(cached),
                                         "cached_flip": collate_ms(cached_flip)},
           "batch": TRAIN_BATCH, "threads": 1}
    print("data_path:", json.dumps(out))


def device_cache_path(dev, work: str, run: dict, dir1: str) -> dict:
    """The device cache: its first batches against the host path's bit for
    bit (with flips), its bytes, upload seconds and per-step gather time,
    the host path's per-batch copy; then the CLI with ``cache_device=true``
    resumed from run 1's mid-run checkpoint (run 1 read host batches), held
    as run 2 is; and a short CLI run with ``transfer_dtype=float16``.
    Returns the CLI scans/s of both runs."""
    root = run["root"]
    host = Trainer(train_cfg(root, "dataset.flip=true"), dev, verbose=False)
    cached = Trainer(train_cfg(root, "dataset.flip=true", "cache_device=true"), dev,
                     verbose=False)
    a, b = host.device_iter(), cached.device_iter()
    for i in range(DEVICE_CACHE_BATCHES):
        if not torch.equal(next(a)["depth"], next(b)["depth"]):
            raise AssertionError(f"device cache batch {i} differs from the host path's")
    a.close()
    cache = cached.device_cache
    epoch, idx = next(cached.loader.index_stream(0))
    gather_ms = cuda_ms(lambda: cache.batch(epoch, idx), iters=50)
    host_batch = next(host.loader.epoch(0))
    copy_ms = {}
    for name, dt in (("float32", None), ("float16", torch.float16)):
        host.transfer_dtype = dt
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            host.to_device(host_batch)
        torch.cuda.synchronize()
        copy_ms[name] = (time.perf_counter() - t0) / 20 * 1e3
    stats = {"scans": cache.n, "flip": cache.flip, "nbytes": cache.nbytes,
             "upload_s": cache.upload_s, "gather_ms_per_step": gather_ms,
             "batches_equal_to_host_path": DEVICE_CACHE_BATCHES,
             "host_to_device_ms_per_batch": copy_ms,
             "kitti_projection_gb": {"train_scans": KITTI_TRAIN_SCANS,
                                     "depth": KITTI_TRAIN_SCANS * 64 * 256 * 4 / 1e9,
                                     "depth_with_flip": 2 * KITTI_TRAIN_SCANS * 64 * 256 * 4 / 1e9}}
    del host, cached, a, b, cache
    torch.cuda.empty_cache()

    mid = os.path.join(dir1, "models", f"checkpoint_{TRAIN_SAVE * TRAIN_BATCH:010d}.pth")
    dir3, dir4 = os.path.join(work, "train3"), os.path.join(work, "train4")
    t0 = time.perf_counter()
    train_cli.main(train_overrides(root, dir3, TRAIN_ITERS, f"resume={mid}", "cache_device=true",
                                   f"solver.checkpoint.test={10 * TRAIN_ITERS}"))
    stats["train_run3_cache_device_s"] = time.perf_counter() - t0
    hold_resume(dir1, dir3, "resumed with cache_device=true")
    t0 = time.perf_counter()
    train_cli.main(train_overrides(root, dir4, F16_ITERS, "transfer_dtype=float16",
                                   f"solver.checkpoint.test={10 * TRAIN_ITERS}"))
    stats["train_run4_float16_s"] = time.perf_counter() - t0
    rows4 = logged(dir4)
    if not all(math.isfinite(v) for r in rows4.values() for v in r.values()):
        raise AssertionError(f"transfer_dtype=float16 logged non-finite scalars: {rows4}")
    for name, d in (("cache_device", dir3), ("float16", dir4)):
        stats[f"cli_scans_per_sec_by_iteration_{name}"] = {
            step // TRAIN_BATCH: r["perf/scans_per_sec"] for step, r in logged(d).items()
            if "perf/scans_per_sec" in r}
    print("device_cache:", json.dumps(stats))
    return stats


def tune_path(work: str, dir1: str) -> dict:
    """dusty_gan_torch.cli.tune_tolerance on run 1's final G_ema (full
    width), the 256-scan val split at 512 points, TUNE_TRIALS TPE trials;
    returns K1's launches, the blocks it was given and the stage times."""
    blocks = []

    def recording_cd_block(rows, cols):
        blocks.append((rows.clone(), cols.clone()))
        return chamfer_cuda.cd_block(rows, cols)

    ckpt = os.path.join(dir1, "models", f"checkpoint_{TRAIN_ITERS * TRAIN_BATCH:010d}.pth")
    args = ["--model-path", ckpt, "--config-path", os.path.join(dir1, ".hydra", "config.yaml"),
            "--save-dir-path", os.path.join(work, "tune"), "--num-samples", str(TUNE_TRIALS),
            "--num-points", str(TUNE_POINTS), "--device", "cuda"]
    t = {}
    reset_launches()
    cov_mmd_1nna.cd_block = recording_cd_block
    try:
        t0 = time.perf_counter()
        best = tune_tolerance.main(args, timings=t)
        wall = time.perf_counter() - t0
    finally:
        cov_mmd_1nna.cd_block = chamfer_cuda.cd_block
    launches = launch_counts()
    if launches["cd_block"] <= 0 or not blocks:
        raise AssertionError(f"tune_tolerance launched cd_block {launches['cd_block']} times")
    (out,) = glob.glob(os.path.join(work, "tune", "tune_*.json"))
    with open(out) as f:
        trials = json.load(f)["trials"]
    if len(trials) != TUNE_TRIALS or not all(math.isfinite(v) for r in trials
                                             for v in r.values()):
        raise AssertionError(f"tune_tolerance trials: {trials}")
    print("tune_tolerance best:", json.dumps(best, sort_keys=True))
    print("stages:", json.dumps({"tune_run_s": wall, **t, "trials": TUNE_TRIALS,
                                 "s_per_trial": t["trials_s"] / TUNE_TRIALS,
                                 "cd_block_launches": launches["cd_block"]}))
    return {"launches": launches["cd_block"], "blocks": blocks}


def write_velodyne_tree(root: str) -> None:
    """Raw KITTI-format .bin scans: per scan 64 rings, each a counterclockwise
    sweep of 2048 azimuths from yaw 0 (jittered), depth from the synthetic
    scene, no return where it drops out; reflectance uniform."""
    rng = np.random.RandomState(8)
    pitch = np.radians(np.linspace(2.0, -24.8, KITTI_H))[:, None]
    for seq, n in KITTI_SEQ_SCANS.items():
        d = os.path.join(root, "dataset", "sequences", f"{seq:02d}", "velodyne")
        os.makedirs(d)
        for i in range(n):
            depth, _, _ = synthetic_scene_depth(rng, KITTI_H, KITTI_W)
            yaw = (np.arange(KITTI_W) + rng.uniform(0.05, 0.95, (KITTI_H, KITTI_W))) \
                * (2 * np.pi / KITTI_W)
            pts = np.stack([depth * np.cos(pitch) * np.cos(yaw),
                            depth * np.cos(pitch) * np.sin(yaw), depth * np.sin(pitch),
                            rng.uniform(size=depth.shape)], -1)[depth > 0]
            pts.astype(np.float32).tofile(os.path.join(d, f"{i:06d}.bin"))


def kitti_path(work: str) -> str:
    """``python -m dusty_gan_torch.cli.process_kitti`` as a user runs it, on a
    pool of every core and inline (``--n-jobs 1``), and the numpy projection
    inline, each on its own copy of the tree: every range image equal bit
    for bit, the angle grid too inline and within 1e-7 rad on the pool
    (float64 shard sums); scans a second of each (the CLI's wall includes
    its interpreter's and its spawned workers' start), and ms a scan of one
    projection in this process.  Returns the pooled tree's root."""
    native_root = os.path.join(work, "kitti")
    serial_root, numpy_root = native_root + "_serial", native_root + "_numpy"
    write_velodyne_tree(native_root)
    shutil.copytree(native_root, numpy_root)
    shutil.copytree(native_root, serial_root)
    n = sum(KITTI_SEQ_SCANS.values())
    jobs = os.cpu_count() or 1
    wall = {}
    for name, root, n_jobs in (("pool", native_root, jobs), ("inline", serial_root, 1)):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "dusty_gan_torch.cli.process_kitti",
                        "--root-dir", root, "--n-jobs", str(n_jobs)], cwd=REPO, check=True,
                       timeout=600)
        wall[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    angles_np = preprocess.process_kitti_root(numpy_root, verbose=False, n_jobs=1, native=False)
    wall["numpy_inline"] = time.perf_counter() - t0
    angles = np.load(os.path.join(native_root, "angles.npy"))
    if not np.array_equal(np.load(os.path.join(serial_root, "angles.npy")), angles_np):
        raise AssertionError("the angle grids of the native and the numpy builds differ")
    if not np.allclose(angles, angles_np, rtol=0, atol=1e-7):
        raise AssertionError("the pooled angle grid left the inline one by > 1e-7 rad")
    outs = sorted(glob.glob(os.path.join(native_root, "dusty-gan", "sequences", "*",
                                         "velodyne", "*.npy")))
    if len(outs) != n:
        raise AssertionError(f"process_kitti wrote {len(outs)} range images of {n}")
    for path in outs:
        a = np.load(path)
        if a.shape != (KITTI_H, KITTI_W, 4) or not all(
                np.array_equal(a, np.load(path.replace(native_root, other)))
                for other in (numpy_root, serial_root)):
            raise AssertionError(f"native, serial and numpy range images differ: {path}")
    pts = np.fromfile(glob.glob(os.path.join(native_root, "dataset", "sequences", "00",
                                             "velodyne", "*.bin"))[0],
                      np.float32).reshape(-1, 4)
    per_scan = {}
    for native in (True, False):
        t0 = time.perf_counter()
        for _ in range(5):
            preprocess.project_scan(pts, KITTI_H, KITTI_W, native=native)
        per_scan["native" if native else "numpy"] = (time.perf_counter() - t0) / 5 * 1e3
    print("process_kitti:", json.dumps({
        "scans": n, "points_per_scan": len(pts), "workers": jobs,
        "wall_s": wall, "scans_per_s": {k: n / v for k, v in wall.items()},
        "ms_per_scan_one_process": per_scan,
        "native_equals_numpy": True}))
    return native_root


def points_to_depth_check(dev, kitti_root: str) -> None:
    """Lidar.points_to_depth at 64x2048 (the processed tree's angle grid) on
    P2D_POINTS points of a processed scan, card against CPU: the image,
    validity and the gradient of a weighted sum for the points."""
    angles = np.load(os.path.join(kitti_root, "angles.npy"))
    scan = np.load(sorted(glob.glob(os.path.join(kitti_root, "dusty-gan", "sequences", "00",
                                                 "velodyne", "*.npy")))[0])
    xyz = scan[..., :3].reshape(-1, 3)
    r = np.linalg.norm(xyz, axis=1)
    xyz = xyz[(r > 0.9) & (r < 120.0)]
    pick = np.random.RandomState(0).choice(len(xyz), P2D_POINTS, replace=False)
    pts = torch.from_numpy((xyz[pick] / 120.0).astype(np.float32))[None]
    wts = torch.from_numpy(np.random.RandomState(1).randn(1, KITTI_H, KITTI_W, 1)
                           .astype(np.float32))
    out = {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        lidar = Lidar.from_angle_array(angles, (KITTI_H, KITTI_W), 0.9, 120.0, device=d)
        x = pts.to(d).requires_grad_()
        t0 = time.perf_counter()
        depth, valid = lidar.points_to_depth(x)
        (depth * wts.to(d)).sum().backward()
        if where == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            px, py, pz = x[..., 0], x[..., 1], x[..., 2]
            ids = lidar.nearest_angle(torch.atan2(pz, torch.sqrt(px ** 2 + py ** 2 + 1e-24)),
                                      torch.atan2(py, px))
        out[where] = (depth.detach().cpu(), valid.cpu(), x.grad.cpu(), ids.cpu(), ms)
    (dc, vc, gc, ic, ms_card), (d0, v0, g0, i0, ms_cpu) = out["cuda"], out["cpu"]
    moved = float((ic != i0).float().mean())
    changed = float(((dc - d0).abs() > P2D_ATOL).float().mean())
    grad_err = float((gc - g0).norm() / g0.norm())
    print("points_to_depth card vs cpu:", json.dumps({
        "shape": [KITTI_H, KITTI_W], "points": P2D_POINTS, "valid_pixels": int(v0.sum()),
        "points_on_another_pixel": int((ic != i0).sum()), "pixels_changed_share": changed,
        "valid_equal": bool(torch.equal(vc, v0)), "grad_rel_l2": grad_err,
        "ms_forward_backward": {"cuda_first_call": ms_card, "cpu": ms_cpu},
        "holds": {"moved_share": P2D_MOVED_SHARE, "atol": P2D_ATOL,
                  "grad_rel_l2": P2D_GRAD_REL_L2}}))
    if moved > P2D_MOVED_SHARE or changed > P2D_MOVED_SHARE or grad_err > P2D_GRAD_REL_L2:
        raise AssertionError(f"points_to_depth card vs CPU: {moved} of the points moved, "
                             f"{changed} of the pixels changed, gradient {grad_err}")
    if not int(v0.sum()) > P2D_POINTS // 4:
        raise AssertionError("points_to_depth filled too few pixels")


def train_cfg(root: str, *extra):
    cfg = compose(os.path.join(REPO, "configs"),
                  ["model=dusty2_dcgan_eqlr", "dataset=kitti_odometry", f"dataset.root={root}",
                   f"solver.batch_size={TRAIN_BATCH}", *extra])
    return cfg


class FlopCount(TorchDispatchMode):
    """FLOP of the ops run inside, by torch's FLOP formulas (convolutions
    and matmuls, forward and backward).  torch's FlopCounterMode tracks
    modules with hooks that ``autograd.grad`` (R1) refuses."""

    def __init__(self):
        super().__init__()
        self.flop = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flop += count(*args, **kwargs, out_val=out)
        return out


def profile_train_step(dev, root: str, steps: int = 20, profiled: int = 5) -> None:
    """Full-width DUSty-II train step at batch 32 under bf16 through
    ``Trainer.step`` on one device-resident batch: ms a step by CUDA events
    around each of ``steps`` steps (the draws included; median, min and
    max) and scans/s at the median, peak device memory, the FLOP of one
    step (torch's formulas) against the bf16 tensor cores' rate, from
    torch.profiler the device's busy time, its idle share of the profiled
    wall time (which the host tracing slows) and of the unprofiled median,
    the top device ops over ``profiled`` steps and the convolutions by
    input shape over one; and the host's ms to collate one train batch (the
    CLI's data path, one thread)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer = Trainer(train_cfg(root, "enable_amp=true"), dev, verbose=False)
    batch = trainer.to_device(next(trainer.loader.epoch(0)))
    for i in range(1, 4):  # warm-up: cuDNN's heuristics, allocator
        trainer.step(i, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    events[0].record()
    for i in range(steps):
        trainer.step(4 + i, batch)
        events[i + 1].record()
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    median = ms[len(ms) // 2]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with FlopCount() as fc:
        trainer.step(100, batch)
    flop = fc.flop
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(200, 200 + profiled):
            trainer.step(i, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # which convolutions the device time goes to: aten ops with their input
    # shapes (a second, host-traced profile: its wall time is not reported)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as shapes_prof:
        trainer.step(300, batch)
        torch.cuda.synchronize()
    convs = [(getattr(e, "device_time_total", 0.0) / 1e3, e.key, e.input_shapes)
             for e in shapes_prof.key_averages(group_by_input_shape=True)
             if "conv" in e.key and e.key.startswith("aten::cudnn")
             or e.key == "aten::convolution_backward"]
    convs.sort(key=lambda r: -r[0])
    print("train_step convolutions by device time (one step):", json.dumps(
        [[round(t, 3), k, str(shapes)[:160]] for t, k, shapes in convs[:12]]))
    batches, n = trainer.loader.epoch(1), min(5, len(trainer.loader))
    t0 = time.perf_counter()
    for _ in range(n):
        next(batches)
    host_batch_ms = (time.perf_counter() - t0) / n * 1e3
    per_kernel, launches = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            launches += 1
    top = sorted(per_kernel.items(), key=lambda r: -r[1])
    busy_ms = sum(t for _, t in top)
    print("train_step:", json.dumps({
        "batch": TRAIN_BATCH, "policy": "bf16", "steps": steps, "ms_per_step_median": median,
        "ms_per_step_min": ms[0], "ms_per_step_max": ms[-1],
        "scans_per_sec_at_median": TRAIN_BATCH / median * 1e3, "peak_memory_gb": peak_gb,
        "flop_per_step": flop, "bf16_bound_ms_per_step": flop / PEAK_BF16_FLOP_PER_S * 1e3,
        "profiled_steps": profiled, "profiled_wall_ms_per_step": wall_ms / profiled,
        "device_busy_ms_per_step": busy_ms / profiled if top else "not measured",
        "device_idle_share": 1.0 - busy_ms / wall_ms if top else "not measured",
        "device_idle_share_of_unprofiled_median": (1.0 - busy_ms / profiled / median
                                                   if top else "not measured"),
        "device_ops_per_step": launches / profiled,
        "host_collate_ms_per_batch": host_batch_ms,
        "top_device_ops_ms_per_step": [[k[:90], t / profiled] for k, t in top[:15]]}))


def _to(obj, dev):
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, dev) for v in obj)
    if hasattr(obj, "__dataclass_fields__"):
        return type(obj)(**{k: _to(getattr(obj, k), dev) for k in obj.__dataclass_fields__})
    return obj


def one_step(cfg, dev, batch_np, draws, policy, seed: int = 0):
    """One train step from weights initialised from ``seed`` on ``dev``;
    returns (state, scalars)."""
    cfg.model.gen.shape = list(cfg.dataset.shape)
    cfg.model.dis.shape = list(cfg.dataset.shape)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        G, D = define_G(cfg), define_D(cfg)
    state = create_train_state(G.to(dev), D.to(dev), lr_G=2e-3, lr_D=2e-3, beta1=0.0,
                               beta2=0.99)
    lidar = Lidar.from_angle_file(os.path.join(cfg.dataset.root, "angles.npy"),
                                  tuple(cfg.dataset.shape), cfg.dataset.min_depth,
                                  cfg.dataset.max_depth, device=dev)
    step = TrainStep(lidar, batch_size=batch_np["depth"].shape[0], policy=policy,
                     ema_decay=0.5 ** (batch_np["depth"].shape[0] / 10000.0))
    depth = torch.from_numpy(batch_np["depth"]).permute(0, 3, 1, 2).contiguous().to(dev)
    scalars = step(state, {"depth": depth}, _to(draws, dev))
    return state, {k: float(v) for k, v in scalars.items()}


def moments(opt, module) -> dict:
    return {n: opt.state[p]["exp_avg"] for n, p in module.named_parameters()}


def train_step_card_vs_cpu(dev, root: str) -> None:
    """One float32 step at a small width (ch 8/16, in_ch 32, 64x256, batch
    8) on the card and on the CPU from the same weights, batch and draws
    (drawn on the CPU): G, D, G_ema and the Adam moments in relative L2."""
    cfg = train_cfg(root, "enable_amp=false", "model.gen.in_ch=32", "model.gen.ch_base=8",
                    "model.gen.ch_max=16", "model.dis.ch_base=8", "model.dis.ch_max=16",
                    "solver.batch_size=8")
    trainer_ds = Trainer(cfg, torch.device("cpu"), verbose=False)
    batch = next(trainer_ds.loader.epoch(0))
    draws = trainer_ds.draws(1)  # CPU generator
    out = {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        out[where] = one_step(copy.deepcopy(cfg), d, batch, draws, FP32_POLICY)
    (sc, sc_cpu), errs = (out["cuda"][1], out["cpu"][1]), {}
    card, cpu = out["cuda"][0], out["cpu"][0]
    for name in ("G", "D", "G_ema"):
        errs[name] = rel_l2({k: v.cpu() for k, v in getattr(card, name).state_dict().items()},
                            getattr(cpu, name).state_dict())
    for name, opt in (("mu_G", "opt_G"), ("mu_D", "opt_D")):
        net = name[-1]
        errs[name] = rel_l2({k: v.cpu() for k, v in moments(getattr(card, opt),
                                                             getattr(card, net)).items()},
                            moments(getattr(cpu, opt), getattr(cpu, net)))
    worst = max(abs(sc[k] - sc_cpu[k]) / (1e-6 + STEP_SCALAR_RTOL * abs(sc_cpu[k]))
                for k in sc_cpu)
    print("train step card vs cpu (float32, small width, batch 8): relative L2",
          json.dumps(errs), f"(weights held at {STEP_WEIGHT_REL_L2}, moments at "
          f"{STEP_MOMENT_REL_L2}); scalars within {worst:.3f} of their hold (rtol "
          f"{STEP_SCALAR_RTOL})")
    if (max(errs[k] for k in ("G", "D", "G_ema")) > STEP_WEIGHT_REL_L2
            or max(errs["mu_G"], errs["mu_D"]) > STEP_MOMENT_REL_L2 or worst > 1.0):
        raise AssertionError(f"one train step on the card vs the CPU: {errs}, scalars {worst}")


def train_step_bf16(dev, root: str) -> None:
    """One full-width step under bf16 and under float32 from the same
    weights, batch and draws (printed, not held: bf16 keeps 8 bits); and
    D's logit under the bf16 policy moves when only far-field pixels move
    (a ~110 m return, -0.9985, against dropped pixels, -1)."""
    cfg = train_cfg(root, "enable_amp=true")
    trainer = Trainer(cfg, torch.device("cpu"), verbose=False)
    batch = next(trainer.loader.epoch(0))
    draws = trainer.draws(1)
    res = {name: one_step(copy.deepcopy(cfg), dev, batch, draws, policy)
           for name, policy in (("bf16", DEFAULT_POLICY), ("float32", FP32_POLICY))}
    b, f = res["bf16"][1], res["float32"][1]
    if not all(math.isfinite(v) for v in list(b.values()) + list(f.values())):
        raise AssertionError(f"non-finite scalars: bf16 {b}, float32 {f}")
    print("train step bf16 vs float32 (full width, batch 32):", json.dumps(
        {k: {"bf16": b[k], "float32": f[k], "delta": b[k] - f[k]} for k in sorted(f)}))
    D = res["bf16"][0].D
    x0 = torch.full((1, 1, 64, 256), -1.0, device=dev)
    x1 = x0.clone()
    x1[0, 0, 10:20, 50:200] = -0.9985
    with torch.no_grad():
        delta = float((D(x1, torch.bfloat16) - D(x0, torch.bfloat16)).abs().max())
    print(f"D far-field logit change under bf16 (full width, trained one step): {delta:.3e}")
    if not delta > 0.0:
        raise AssertionError("D's bf16 logit does not see the far field")


# ---------------------------------------------------------------------------
# steps_per_call: CUDA-graph chunks of the train step
# ---------------------------------------------------------------------------

# (a) graph against eager: iteration 1 as a chunk of 1, then the CLI's
# schedule from iteration 2 at K = 4: chunks of 3, 4, 4, 4, 1; three eager
# runs measure the card's own run-to-run spread
GRAPH_K, GRAPH_ITERS, GRAPH_EAGER_RUNS = 4, 17, 3
# the JAX package's chunk-against-step envelopes (tests/test_device_cache.py):
# after one iteration, in every float leaf of >= 10,000 elements at most
# 0.1% of the elements beyond 1e-4 + 2e-3 |b|, and every element within
# 2.2 lr (Adam's first update is +-lr wherever a gradient's sign sits
# below the two programs' rounding); the scalars after the run within
# rtol 5e-2 / atol 5e-3.  Those bounds were set on the CPU, whose
# reductions repeat; the card's eager step does not (cuDNN's and the
# reflection pad's backward reduce with atomics), and two eager runs part
# by as much (measured on an H100: 0.19-0.23% of a leaf's elements after
# one bf16 step, up to 8.4x the scalar hold after 17).  So the graph is
# held against its nearest eager run, each bound the larger of the JAX one
# and twice the largest spread between the eager runs.
GRAPH_ATOL, GRAPH_RTOL, GRAPH_LOOSE_SHARE, GRAPH_LR_BOUND = 1e-4, 2e-3, 1e-3, 2.2 * 2e-3
GRAPH_SCALAR_RTOL, GRAPH_SCALAR_ATOL, GRAPH_SPREAD_FACTOR = 5e-2, 5e-3, 2.0
# (b) ms a step for each K (1: the eager per-step path), over CHUNK_TIMED
# iterations after a warm-up that captures; the profiler over CHUNK_PROFILED
CHUNK_KS, CHUNK_TIMED, CHUNK_PROFILED = (1, 2, 4, 8, 16), 64, 16
# (c) the CLI in chunk mode: K = 4, 48 iterations, stats every 8, one
# validation at 40, checkpoints every 20; a per-step run from its
# iteration-20 checkpoint to 21, and a chunk run resumed there (first
# chunk: 3 iterations), held to the uninterrupted chunk run at iteration 24
CLI_K, CLI_ITERS, CLI_STATS, CLI_TEST, CLI_SAVE, CLI_RESUME = 4, 48, 8, 40, 20, 21
RUNTIME_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def chunk_schedule(start: int, total: int, k_max: int) -> list:
    """The CLI's chunks from iteration ``start``: the first realigns to the
    K-grid."""
    out, i = [], start
    while i < total:
        k = min(k_max - i % k_max, total - i)
        out.append(list(range(i + 1, i + k + 1)))
        i += k
    return out


def run_chunk(trainer, ix, iters):
    rows = np.stack([trainer.device_cache.rows(*next(ix)) for _ in iters])
    return trainer.step_chunk(iters, rows)


def state_tensors(trainer) -> dict:
    st = trainer.state
    out = {f"{net}.{k}": v for net in ("G", "D", "G_ema")
           for k, v in getattr(st, net).state_dict().items()}
    for name, opt, module in (("opt_G", st.opt_G, st.G), ("opt_D", st.opt_D, st.D)):
        for n, p in module.named_parameters():
            for k in ("exp_avg", "exp_avg_sq", "step"):
                out[f"{name}.{n}.{k}"] = opt.state[p][k]
    out["pl_ema"] = st.pl_ema
    return out


def envelope(got: dict, want: dict) -> dict:
    """The JAX chunk-against-step envelope of ``got`` against ``want``:
    the largest share of loose elements in a leaf of >= 10,000, the largest
    difference, and whether both hold at the JAX bounds."""
    worst_share, worst_diff, equal = 0.0, 0.0, True
    for k, b in want.items():
        a, b = got[k].float().to(b.device), b.float()
        diff = (a - b).abs()
        equal &= bool(torch.equal(a, b))
        if b.numel() >= 10_000:
            worst_share = max(worst_share,
                              float((diff > GRAPH_ATOL + GRAPH_RTOL * b.abs()).float().mean()))
        worst_diff = max(worst_diff, float(diff.max()))
    return {"bit_equal": equal, "largest_loose_share": worst_share,
            "largest_abs_diff": worst_diff,
            "jax_envelope_holds": worst_share < GRAPH_LOOSE_SHARE and worst_diff <= GRAPH_LR_BOUND}


def graph_against_eager(dev, root: str, amp: bool) -> dict:
    """Phase (a): full-width DUSty-II, batch 32, R1, DiffAugment, the
    device cache, under bf16 (``amp``) or float32; GRAPH_EAGER_RUNS eager
    trainers and one in chunks of K = 4 from one seed, GRAPH_ITERS
    iterations each.  Eager against eager, then graph against its nearest
    eager run: the JAX package's state envelope after iteration 1 and
    after the first chunk of 3 (iteration 4), the scalars against the JAX
    hold at the end; each held to the larger of the JAX bound and twice the
    eager runs' spread.  The replays must have run every chunked
    iteration."""
    cfg = lambda *e: train_cfg(root, f"enable_amp={str(amp).lower()}",  # noqa: E731
                               "cache_device=true", *e)
    eager = [Trainer(cfg(), dev, verbose=False) for _ in range(GRAPH_EAGER_RUNS)]
    graphed = Trainer(cfg(f"steps_per_call={GRAPH_K}"), dev, verbose=False)
    its = [t.device_iter() for t in eager]
    ix = graphed.loader.index_stream(0)
    chunks = [[1]] + chunk_schedule(1, GRAPH_ITERS, GRAPH_K)
    pairs = [(a, b) for a in range(GRAPH_EAGER_RUNS) for b in range(a + 1, GRAPH_EAGER_RUNS)]
    out = {"policy": "bf16" if amp else "float32", "chunks": [len(c) for c in chunks]}
    failures = []

    def hold_state(name: str, bound_diff: bool) -> None:
        """The envelope of each eager pair and of the graph against each
        eager run; the graph's nearest run held to the larger of the JAX
        bounds and twice the eager spread."""
        torch.cuda.synchronize()
        states = [state_tensors(t) for t in eager]
        graph = state_tensors(graphed)
        eager_pairs = [envelope(states[b], states[a]) for a, b in pairs]
        to_eager = [envelope(graph, st) for st in states]
        share = min(e["largest_loose_share"] for e in to_eager)
        bound = max(GRAPH_LOOSE_SHARE, GRAPH_SPREAD_FACTOR * max(
            e["largest_loose_share"] for e in eager_pairs))
        diff = min(e["largest_abs_diff"] for e in to_eager)
        out[name] = {"eager_vs_eager": eager_pairs, "graph_vs_eager": to_eager,
                     "graph_loose_share": share, "loose_share_bound": bound,
                     "graph_largest_abs_diff": diff}
        if share > bound or (bound_diff and diff > GRAPH_LR_BOUND):
            failures.append(f"{name}: {out[name]}")

    for n, iters in enumerate(chunks):
        sc_graph = run_chunk(graphed, ix, iters)
        for i in iters:
            sc_eager = [t.step(i, next(it)) for t, it in zip(eager, its)]
        if n < 2:
            hold_state(f"iteration_{iters[-1]}", bound_diff=n == 0)
    sc = [{k: float(v) for k, v in s.items()} for s in sc_eager]
    a = {k: float(v) for k, v in sc_graph.items()}
    ratio = lambda x, y: max(abs(x[k] - y[k]) / (GRAPH_SCALAR_ATOL  # noqa: E731
                                                 + GRAPH_SCALAR_RTOL * abs(y[k])) for k in y)
    eager_ratio = max(ratio(sc[b], sc[a]) for a, b in pairs)
    graph_ratio = min(ratio(a, e) for e in sc)
    scalar_bound = max(1.0, GRAPH_SPREAD_FACTOR * eager_ratio)
    runner = graphed.chunks
    out.update({"scalars_eager_vs_eager_within_hold": eager_ratio,
                "scalars_graph_vs_nearest_eager_within_hold": graph_ratio,
                "scalars_bound_in_holds": scalar_bound, "scalars_graph": a,
                "scalars_eager": sc, "replays": runner.replays,
                "replayed_iterations": runner.replayed_iterations,
                "chunked_iterations": sum(len(ch) for ch in chunks),
                "capture_s": runner.capture_s})
    print("graph against eager:", json.dumps(out))
    if (set(a) != set(sc[0]) or not all(math.isfinite(v) for v in a.values())
            or graph_ratio > scalar_bound):
        failures.append(f"scalars {graph_ratio}x the hold (bound {scalar_bound})")
    if failures:
        raise AssertionError(f"graph against eager ({out['policy']}): " + "; ".join(failures))
    if (runner.replays != len(chunks) or runner.replayed_iterations != GRAPH_ITERS
            or sorted(runner.graphs) != [1, 3, 4]):
        raise AssertionError(f"{runner.replays} replays of {runner.replayed_iterations} "
                             f"iterations, graphs {sorted(runner.graphs)}, for {GRAPH_ITERS} "
                             "chunked iterations")
    return out


def device_profile(prof, iterations: int, wall_ms: float) -> dict:
    """Device busy time, idle share and op counts a step from a torch.profiler
    run over ``iterations`` iterations, and the host's launches a step
    (kernels, copies and memsets the host issued itself, outside any
    graph)."""
    from torch.autograd import DeviceType

    busy_us, device_ops, host_launches, graph_launches = 0.0, 0, 0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy_us += e.time_range.elapsed_us()
            device_ops += 1
        elif e.name in RUNTIME_LAUNCHES:
            host_launches += 1
        elif e.name == "cudaGraphLaunch":
            graph_launches += 1
    return {"device_busy_ms_per_step": busy_us / 1e3 / iterations,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "device_ops_per_step": device_ops / iterations,
            "host_launches_per_step": host_launches / iterations,
            "graph_launches": graph_launches, "profiled_wall_ms_per_step": wall_ms / iterations}


def time_chunk_size(dev, root: str, K: int, eager_ops) -> dict:
    """ms a step and the rest of phase (b) at one K."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(train_cfg(root, "enable_amp=true", "cache_device=true",
                                f"steps_per_call={K if K > 1 else 0}"), dev, verbose=False)
    if K == 1:
        it = trainer.device_iter()
        run = lambda iters: [trainer.step(i, next(it)) for i in iters]  # noqa: E731
    else:
        ix = trainer.loader.index_stream(0)
        run = lambda iters: run_chunk(trainer, ix, iters)  # noqa: E731
    i = 0

    def chunks(n: int) -> None:
        nonlocal i
        for _ in range(n):
            run(list(range(i + 1, i + K + 1)))
            i += K

    chunks(max(1, 4 // K))  # warm-up: the capture, or 4 eager steps
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    chunks(CHUNK_TIMED // K)
    stop.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / CHUNK_TIMED
    ms = start.elapsed_time(stop) / CHUNK_TIMED
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunks(CHUNK_PROFILED // K)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    p = device_profile(prof, CHUNK_PROFILED, wall_ms)
    row = {"K": K, "iterations": CHUNK_TIMED, "ms_per_step": ms,
           "host_clock_ms_per_step": host_ms, "scans_per_sec": TRAIN_BATCH / ms * 1e3,
           "peak_memory_gb": peak_gb, **p,
           "device_idle_share_of_unprofiled_step": 1.0 - p["device_busy_ms_per_step"] / ms}
    # the graphs' kernels are in the trace when it holds about as many
    # device ops a step as the eager step launches
    if eager_ops is not None and p["device_ops_per_step"] < 0.5 * eager_ops:
        row["device_busy_ms_per_step"] = row["device_idle_share"] = row[
            "device_idle_share_of_unprofiled_step"] = (
            f"not measured: the trace holds {p['device_ops_per_step']:.0f} device ops a "
            f"step against the eager step's {eager_ops:.0f}; it misses the graphs' kernels")
    if K > 1:
        runner = trainer.chunks
        row.update({"capture_s": runner.capture_s, "replays": runner.replays,
                    "replayed_iterations": runner.replayed_iterations})
        if runner.replayed_iterations != i:
            raise AssertionError(f"K={K}: {runner.replayed_iterations} replayed iterations "
                                 f"of {i}")
    print("steps_per_call:", json.dumps(row))
    return row


def time_chunks(dev, root: str) -> list:
    """Phase (b): ms a step for each K in CHUNK_KS (K = 1: the eager
    per-step path), by CUDA events over CHUNK_TIMED iterations on the
    device cache after a warm-up (the capture for K > 1); capture seconds,
    peak memory, the host's launches a step outside the graphs, and device
    busy time and idle share from torch.profiler where the trace shows the
    graphs' kernels."""
    rows = []
    for K in CHUNK_KS:
        rows.append(time_chunk_size(dev, root, K, rows[0]["device_ops_per_step"]
                                    if rows else None))
        gc.collect()  # a trainer and its chunk runner refer to each other
        torch.cuda.empty_cache()
    return rows


def chunk_cli_path(work: str, run: dict) -> dict:
    """Phase (c): ``cli.train ... cache_device=true steps_per_call=4`` at
    full width for CLI_ITERS iterations, one validation on K1 (its blocks
    held against the plain version), then a per-step run from its
    checkpoint at CLI_SAVE to CLI_RESUME and a chunk run resumed from that
    per-step checkpoint (first chunk 3), held to the uninterrupted chunk
    run.  Returns K1's launches and blocks."""
    root = run["root"]
    d5, d6, d7 = (os.path.join(work, n) for n in ("chunks5", "per_step6", "chunks7"))
    cadence = [f"solver.checkpoint.save_stats={CLI_STATS}", f"solver.checkpoint.test={CLI_TEST}",
               f"solver.checkpoint.save_model={CLI_SAVE}", "cache_device=true"]
    chunked = [*cadence, f"steps_per_call={CLI_K}"]
    blocks = []

    def recording_cd_block(rows, cols):
        blocks.append((rows.clone(), cols.clone()))
        return chamfer_cuda.cd_block(rows, cols)

    reset_launches()
    cov_mmd_1nna.cd_block = recording_cd_block
    try:
        t0 = time.perf_counter()
        train_cli.main(train_overrides(root, d5, CLI_ITERS, *chunked))
        wall5 = time.perf_counter() - t0
    finally:
        cov_mmd_1nna.cd_block = chamfer_cuda.cd_block
    launches = launch_counts()
    if launches["cd_block"] <= 0 or not blocks:
        raise AssertionError(f"the chunk CLI's validation launched cd_block "
                             f"{launches['cd_block']} times")
    mid = os.path.join(d5, "models", f"checkpoint_{CLI_SAVE * TRAIN_BATCH:010d}.pth")
    train_cli.main(train_overrides(root, d6, CLI_RESUME, *cadence, f"resume={mid}",
                                   f"solver.checkpoint.test={10 * CLI_ITERS}"))
    per_step = os.path.join(d6, "models", f"checkpoint_{CLI_RESUME * TRAIN_BATCH:010d}.pth")
    t0 = time.perf_counter()
    train_cli.main(train_overrides(root, d7, CLI_ITERS, *chunked, f"resume={per_step}",
                                   f"solver.checkpoint.test={10 * CLI_ITERS}"))
    wall7 = time.perf_counter() - t0
    first = CLI_RESUME + CLI_K - CLI_RESUME % CLI_K
    rows7 = logged(d7)
    if min(rows7) != first * TRAIN_BATCH:
        raise AssertionError(f"the chunk run resumed at {CLI_RESUME} first logged image step "
                             f"{min(rows7)}, not iteration {first}'s")
    # iteration 21 of run 7 ran eagerly and 22-24 in a graph, where run 5
    # graphed all four: a chunk-against-step trajectory, held as the JAX
    # package holds one (tests/test_device_cache.py), at its first log
    hold_resume(d5, d7, "chunks resumed from a per-step checkpoint", CLI_RESUME, first,
                CLI_ITERS, GRAPH_SCALAR_RTOL, GRAPH_SCALAR_ATOL)
    sps = {step // TRAIN_BATCH: r["perf/scans_per_sec"] for step, r in logged(d5).items()
           if "perf/scans_per_sec" in r}
    print("chunk CLI:", json.dumps({"K": CLI_K, "iterations": CLI_ITERS, "run5_s": wall5,
                                    "run7_s": wall7, "validation_cd_block_launches":
                                    launches["cd_block"],
                                    "cli_scans_per_sec_by_iteration": sps}))
    return {"launches": launches["cd_block"], "blocks": blocks}


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
    check_ptxas("emd", 4)  # K4 and K5, each on both paths
    check_ptxas("nn", 12)  # 4/2/1 query points a thread, K2 and K3, counting or not
    print("cd_block SASS, inner loop:", json.dumps(cd_sass_per_distance()))

    entries = [check_cd_block(dev)] + check_nn(dev)
    check_chamfer_grad(dev)
    entries += [check_emd_block(dev), check_emd_pair(dev)]
    device_path = check_emd_device_path(dev)
    entries[3]["device_path"], entries[4]["device_path"] = (device_path["emd_block"],
                                                            device_path["emd_pair"])
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(REPO, "build"))
    try:
        run = prepare(work, args.num_test)
        cd_launches = synthesis_path(work, run, args.num_test)
        emd_launches = emd_path(work, run, args.emd_num_test)
        emd_large_launches = emd_large_path(work, run)
        calibration_path(work, run, args.emd_num_test, dev)
        nn_launches, rec_clouds = reconstruction_path(work, run, args.num_step)
        data_path(work, run)
        training = training_path(work, run)
        device_cache_path(dev, work, run, training["dir"])
        tune = tune_path(work, training["dir"])
        kitti_root = kitti_path(work)
        points_to_depth_check(dev, kitti_root)
        profile_train_step(dev, run["root"])
        train_step_card_vs_cpu(dev, run["root"])
        train_step_bf16(dev, run["root"])
        for amp in (True, False):
            graph_against_eager(dev, run["root"], amp)
            gc.collect()  # the phase's trainers, and their graphs' memory pools
            torch.cuda.empty_cache()
        time_chunks(dev, run["root"])
        chunk_training = chunk_cli_path(work, run)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for i, (x, y) in enumerate(rec_clouds):
        nn_work(entries[1:3], f"reconstruction_{i}", x, y)
    del rec_clouds
    entries[0]["launches"] = cd_launches
    entries[1]["launches"] = nn_launches["nn_dist"]
    entries[2]["launches"] = nn_launches["nn_argmin"]
    entries[3]["launches"] = emd_launches["emd_block"]
    entries[4]["launches"] = emd_launches["emd_pair"]
    entries[3]["device_path"]["launches"] = emd_large_launches["emd_block"]
    entries[0]["training"] = {"launches": training["launches"],
                              **hold_blocks(training["blocks"], "training validation")}
    entries[0]["tune_tolerance"] = {"launches": tune["launches"],
                                    **hold_blocks(tune["blocks"], "tune_tolerance")}
    entries[0]["training_chunks"] = {"launches": chunk_training["launches"],
                                     **hold_blocks(chunk_training["blocks"],
                                                   "chunk-mode training validation")}
    del training["blocks"], tune["blocks"], chunk_training["blocks"]
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
