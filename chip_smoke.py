"""Smoke run of dusty_gan_torch on one CUDA GPU.

    python3 chip_smoke.py [--num-test 512]

1. Prints the card's name and power limit and the torch version, and
   builds every CUDA kernel of the port from ``dusty_gan_torch/csrc``.
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes and at ragged ones, and times both.
3. Drives the main path, ``dusty_gan_torch.cli.evaluate_synthesis``, for the
   full-width DUSty-II generator (configs/model/dusty2_dcgan_eqlr.yaml,
   64x256 KITTI) with seeded random weights on a synthetic KITTI tree:
   512 test scans (``--num-test``; 5000 is the paper's protocol),
   2048-point clouds, and again with --compute-gt.  Kernel
   launch counts are set to 0 just before and read just after.
4. Checks the scores (every key, finite) and, on a small input, the card's
   scores and generator output against the CPU.
5. Prints a JSON line of per-kernel numbers, the card line, and as the
   last line ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when there is no GPU or any phase
fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from dusty_gan_torch import kernels  # noqa: E402
from dusty_gan_torch.cli import evaluate_synthesis as es  # noqa: E402
from dusty_gan_torch.config import compose, save_config  # noqa: E402
from dusty_gan_torch.data.synthetic import build_synthetic_kitti  # noqa: E402
from dusty_gan_torch.metrics import chamfer_cuda  # noqa: E402
from dusty_gan_torch.metrics.cov_mmd_1nna import (  # noqa: E402
    ROW_BLOCK, block_schedule, compute_cov_mmd_1nna)
from dusty_gan_torch.models.factory import define_G  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet): HBM3 and FP32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
# 3 subtractions, 3 multiplies and 2 additions per squared distance (the
# min is not counted); a pair needs at least N*M distances
FLOP_PER_DISTANCE = 8
CD_RTOL, CD_ATOL = 1e-5, 1e-6  # as tests/test_chamfer_pallas.py
NUM_TEST, NUM_POINTS, CD_BATCH = 512, 2048, 512
EXPECTED_KEYS = {
    "swd-16", "swd-32", "swd-64", "swd-mean", "jsd", "mmd-cd", "mmd-sample-cd",
    "cov-cd", "1-nn-tp-cd", "1-nn-fp-cd", "1-nn-fn-cd", "1-nn-tn-cd",
    "1-nn-precision-cd", "1-nn-recall-cd", "1-nn-accuracy_t-cd",
    "1-nn-accuracy_f-cd", "1-nn-accuracy-cd", "#test", "#points",
}


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
    """Kernel against the plain version at the main path's block shape and
    at ragged ones; times both at the main path's shape."""
    g = torch.Generator().manual_seed(0)
    shapes = [((ROW_BLOCK, NUM_POINTS), (CD_BATCH, NUM_POINTS)),  # main path
              ((4, 100), (3, 77)),        # ragged N and M
              ((5, 300), (7, 1000)),      # N != M
              ((3, 3000), (2, 5000))]     # more than one shared-memory chunk
    max_abs = max_rel = 0.0
    for (r, n), (c, m) in shapes:
        rows, cols = clouds(g, r, n, dev), clouds(g, c, m, dev)
        got = chamfer_cuda.cd_block(rows, cols)
        torch.cuda.synchronize()
        want = chamfer_cuda.cd_block_reference(rows, cols)
        err = (got - want).abs()
        bad = err > CD_ATOL + CD_RTOL * want.abs()
        ma, mr = float(err.max()), float((err / want.abs().clamp_min(1e-30)).max())
        print(f"cd_block ({r},{n})x({c},{m}): max_abs_err {ma:.3e} "
              f"max_rel_err {mr:.3e} (rtol {CD_RTOL}, atol {CD_ATOL})")
        if bool(bad.any()):
            raise AssertionError(f"cd_block disagrees with its plain version at "
                                 f"({r},{n})x({c},{m}): {int(bad.sum())} entries")
        max_abs, max_rel = max(max_abs, ma), max(max_rel, mr)

    (r, n), (c, m) = shapes[0]
    rows, cols = clouds(g, r, n, dev), clouds(g, c, m, dev)
    ms = cuda_ms(lambda: chamfer_cuda.cd_block(rows, cols), iters=10)
    plain_ms = cuda_ms(lambda: chamfer_cuda.cd_block_reference(rows, cols), iters=2)
    nbytes = 4 * (rows.numel() + cols.numel() + r * c)
    flops = FLOP_PER_DISTANCE * n * m * r * c
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOP_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"cd_block ({r},{n})x({c},{m}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms ({flops / 1e9:.1f} GFLOP fp32, {nbytes / 1e6:.2f} MB); "
          f"{r * c / ms * 1e3:.0f} pairs/s")
    return {"name": "cd_block", "route": "cuda",
            "source": "dusty_gan_torch/csrc/cd_block.cu",
            "replaces": "dusty_gan_tpu/metrics/chamfer_pallas.py:265",
            "launches": None, "max_abs_err": max_abs, "max_rel_err": max_rel,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def protocol_launches(n: int = 5000) -> int:
    """cd_block launches of one scoring run of the n-scan protocol
    (real-real and fake-fake symmetric, real-fake full)."""
    R, C = min(ROW_BLOCK, n), min(CD_BATCH, n)
    sym = len(list(block_schedule(n, n, R, C, True)))
    return 2 * sym + len(list(block_schedule(n, n, R, C, False)))


def main_path(dev, work: str, num_test: int) -> dict:
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
    args = ["--model-path", pth, "--config-path", cfg_path,
            "--save-dir-path", os.path.join(work, "out"),
            "--num-test", str(num_test), "--num-points", str(NUM_POINTS),
            "--cd-batch", str(CD_BATCH), "--device", "cuda"]

    cwd = os.getcwd()
    os.chdir(work)  # --compute-gt writes outputs/ under the working directory
    try:
        chamfer_cuda.cd_block.launches = 0
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
        if set(s) != EXPECTED_KEYS:
            raise AssertionError(f"{name} score keys {sorted(s)}")
        bad = {k: v for k, v in s.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"{name} scores not finite: {bad}")
    if launches <= 0:
        raise AssertionError("the main path launched cd_block no time")
    print("scores (generated vs test):", json.dumps(fake, sort_keys=True))
    print("scores (train vs test):", json.dumps(gt, sort_keys=True))
    print("stages:", json.dumps({"generated_run_s": t1 - t0, "gt_run_s": t2 - t1,
                                 "generated": t_fake, "gt": t_gt}))
    return {"launches": launches, "G": G, "cfg": cfg}


def small_input_agreement(dev, G) -> None:
    """The card's scores and generator output on a small input agree with
    the CPU's (plain Chamfer version, CPU convolutions)."""
    g = torch.Generator().manual_seed(1)
    gen, ref = clouds(g, 24, 300, "cpu"), clouds(g, 20, 300, "cpu")
    on_card = compute_cov_mmd_1nna(gen.to(dev), ref.to(dev), 7)
    on_cpu = compute_cov_mmd_1nna(gen, ref, 7)
    for k, v in on_cpu.items():
        if not math.isclose(on_card[k], v, rel_tol=1e-5, abs_tol=1e-7):
            raise AssertionError(f"{k}: card {on_card[k]} vs cpu {v}")
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
                             "samples of the main-path run")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
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

    entry = check_cd_block(dev)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(REPO, "build"))
    try:
        run = main_path(dev, work, args.num_test)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    entry["launches"] = run["launches"]
    print(f"cd_block launches in one {args.num_test}-scan run: "
          f"{run['launches'] // 2}; in one 5000-scan run: {protocol_launches()}")
    small_input_agreement(dev, run["G"])

    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
