"""Synthesis evaluation on the GPU (``dusty_gan_tpu/cli/evaluate_synthesis.py``):

    python -m dusty_gan_torch.cli.evaluate_synthesis \\
        --model-path <checkpoint.pth> --config-path <run>/.hydra/config.yaml \\
        [--num-test 5000] [--num-points 2048] [--tol 0] [--compute-gt] \\
        [--metrics cd[,emd]] [--calibrate-drop-rate] [--device cuda]

EMA generator with frozen Gumbel noise; real train/test tensors cached under
the dataset root with a content signature; uniform-stride subsample to
``--num-test``; SWD on the 2D inverse depth, JSD on points / 2 and
COV/MMD/1-NNA over pairwise Chamfer matrices (the CUDA ``cd_block``
kernel) and, with ``--metrics cd,emd``, EMD matrices (the CUDA
``emd_block`` kernel); the scores are printed and dumped as JSON.
``--compute-gt`` scores the real train set against the test set instead.
One latent is drawn per global sample index, so scores do not depend on the
batch size.

``--calibrate-drop-rate`` first bisects the Gumbel keep threshold so that
the generated drop rate matches the real train set's
(``utils/calibration.py``).  Its latents are drawn like the evaluation
latents, one per index i, from generators seeded ``CALIB_SEED + i`` with
``CALIB_SEED = 0xCA1 << 20``.  A CPU generator keeps the low 32 bits of
its seed and evaluation sample i takes seed i, so the calibration seeds sit
above every evaluation seed of a run with fewer than 3.39e9 samples (0xCA1
itself is evaluation sample 3233's).  They are not the JAX CLI's
``PRNGKey(0xCA1)`` draws, so the calibrated threshold differs from the JAX
CLI's by the sampling noise of ``--calib-samples`` latents.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import os.path as osp
import pprint
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dusty_gan_torch import resolve_device, synchronize
from dusty_gan_torch.data.datasets import define_dataset
from dusty_gan_torch.data.loader import Loader
from dusty_gan_torch.geometry.lidar import sigmoid_to_tanh, tanh_to_sigmoid
from dusty_gan_torch.metrics.cov_mmd_1nna import check_metrics, compute_cov_mmd_1nna
from dusty_gan_torch.metrics.fps import downsample_point_clouds
from dusty_gan_torch.metrics.jsd import compute_jsd
from dusty_gan_torch.metrics.swd import compute_swd
from dusty_gan_torch.utils.calibration import (calibrate_mask_threshold, drop_rate_2d,
                                               real_drop_rate)
from dusty_gan_torch.utils.setup import make_eval_generator, setup

REAL_TOL = 1e-8
LATENT_SEED = 0  # sample i's latent is drawn from seed LATENT_SEED + i
CALIB_SEED = 0xCA1 << 20  # calibration latent i: seed CALIB_SEED + i
FPS_BATCH = 256  # clouds per furthest-point-sampling call


def real_cache_path(ds, name: str, subset: str, num_points: int, tol: float) -> str:
    """Content-signed cache file under ``<dataset root>/cache/``; the
    ``torch_`` prefix keeps it apart from the JAX package's caches."""
    sig = "|".join([
        ds.__class__.__name__, subset, str(tuple(ds.shape)),
        str(ds.min_depth), str(ds.max_depth), str(len(ds.datalist)),
        str(num_points), repr(tol),
    ])
    h = hashlib.sha1(sig.encode()).hexdigest()[:16]
    return osp.join(ds.root, "cache",
                    f"torch_eval_{name}_{subset}_{num_points}_{h}.npz")


def latents(start: int, stop: int, in_ch: int, seed: int = LATENT_SEED) -> torch.Tensor:
    """(stop - start, in_ch) standard normal latents, row i drawn from a CPU
    generator seeded ``seed + i`` by its global sample index i."""
    g = torch.Generator()
    rows = []
    for i in range(start, stop):
        g.manual_seed(seed + i)
        rows.append(torch.randn(in_ch, generator=g))
    return torch.stack(rows)


def to_points(lidar, inv: torch.Tensor, tol: float, num_points: int) -> torch.Tensor:
    """(B, H, W, 1) inverse depth in [-1, 1] -> (B, num_points, 3) FPS clouds."""
    out = []
    for i in range(0, inv.shape[0], FPS_BATCH):
        inv01 = torch.clamp(tanh_to_sigmoid(inv[i:i + FPS_BATCH]), 0.0, 1.0)
        xyz = lidar.inv_to_xyz(inv01, tol)
        out.append(downsample_point_clouds(xyz.reshape(xyz.shape[0], -1, 3), num_points))
    return torch.cat(out)


def score(gen_2d, gen_3d, ref_2d, ref_3d, cd_batch: int, draws=None,
          timings: Optional[Dict[str, float]] = None,
          metrics: Tuple[str, ...] = ("cd",)) -> Dict[str, float]:
    """SWD, JSD and COV/MMD/1-NNA (over each of ``metrics``: "cd", "emd")
    of generated against reference images (B, H, W, 1) and clouds
    (B, N, 3)."""
    timings = {} if timings is None else timings
    device = gen_2d.device
    scores: Dict[str, float] = {}
    t = time.perf_counter()
    scores.update(compute_swd(gen_2d, ref_2d, draws))
    synchronize(device)
    timings["swd"] = time.perf_counter() - t
    t = time.perf_counter()
    scores["jsd"] = compute_jsd(gen_3d / 2.0, ref_3d / 2.0)
    timings["jsd"] = time.perf_counter() - t
    scores.update(compute_cov_mmd_1nna(gen_3d, ref_3d, cd_batch, metrics, verbose=True,
                                       timings=timings))
    return scores


def _subsample(arr: np.ndarray, num_test: int) -> np.ndarray:
    """Uniform-stride subsample to ``num_test`` items."""
    if num_test != -1 and len(arr) > num_test:
        skip = len(arr) // num_test
        limit = skip * num_test + 1
        arr = arr[skip:limit:skip]
    return arr


def _not_ported(flag: str):
    raise NotImplementedError(
        f"{flag} is not yet ported to dusty_gan_torch; use "
        "dusty_gan_tpu.cli.evaluate_synthesis for it")


def main(argv=None, timings: Optional[Dict[str, float]] = None):
    """Returns the score dict.  ``timings``, when given, receives the wall
    seconds of each stage (reals, calibration, generation, fps, swd, jsd,
    pairwise_cd, pairwise_emd)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--config-path", type=str, required=True)
    parser.add_argument("--save-dir-path", type=str, default=".")
    parser.add_argument("--num-test", type=int, default=5000)
    parser.add_argument("--num-points", type=int, default=2048)
    parser.add_argument("--tol", type=float, default=0)
    parser.add_argument("--compute-gt", action="store_true")
    parser.add_argument("--cd-batch", type=int, default=512)
    parser.add_argument("--metrics", type=str, default="cd",
                        help="comma list: cd[,emd] (reference protocol: cd)")
    parser.add_argument("--mask-threshold", type=float, default=0.5,
                        help="Gumbel keep threshold for the DUSty pixel mask "
                             "(reference: 0.5)")
    parser.add_argument("--calibrate-drop-rate", action="store_true",
                        help="bisect --mask-threshold so the generated drop "
                             "rate matches the real train set (post hoc; see "
                             "utils/calibration.py)")
    parser.add_argument("--calib-samples", type=int, default=512,
                        help="latents used to measure the generated drop rate "
                             "during calibration")
    parser.add_argument("--multihost", action="store_true",
                        help="not yet ported")
    parser.add_argument("--prepare-only", action="store_true",
                        help="build the content-signed real-tensor caches, "
                             "then exit without scoring")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    metrics = tuple(m.strip() for m in args.metrics.split(",") if m.strip())
    check_metrics(metrics)
    if args.multihost:
        _not_ported("--multihost")
    device = resolve_device(args.device)
    timings = {} if timings is None else timings

    cfg, G, lidar, fixed_noise = setup(args.model_path, args.config_path, device)
    gen = make_eval_generator(G, fixed_noise)
    drop_const = float(cfg.model.gen.drop_const)
    batch_size = int(cfg.solver.batch_size)

    # ------------------------------------------------------------- reals
    # reals_load: the host's part (scans through the native pipeline,
    # collated, or the cache file); reals_project: the device's (inverse
    # depth, projection to points, FPS)
    timings["reals_load"] = timings["reals_project"] = 0.0
    reals = {}
    for subset in ("train", "test"):
        t = time.perf_counter()
        ds = define_dataset(cfg.dataset, phase=subset)
        cache_path = real_cache_path(ds, cfg.dataset.name, subset,
                                     args.num_points, REAL_TOL)
        if osp.exists(cache_path):
            with np.load(cache_path) as z:
                reals[subset] = {"2d": z["d2"], "3d": z["d3"]}
            timings["reals_load"] += time.perf_counter() - t
            print("loaded:", cache_path)
            continue
        batches = [(b["depth"], b["mask"]) for b in Loader(ds, batch_size).epoch()]
        timings["reals_load"] += time.perf_counter() - t
        t = time.perf_counter()
        d2 = []
        for depth, mask in batches:
            depth = torch.from_numpy(depth).to(device)
            mask = torch.from_numpy(mask).to(device)
            inv = sigmoid_to_tanh(lidar.invert_depth(depth))
            d2.append(mask * inv + (1 - mask) * drop_const)
        d2 = torch.cat(d2)
        d3 = to_points(lidar, d2, REAL_TOL, args.num_points)
        reals[subset] = {"2d": d2.cpu().numpy(), "3d": d3.cpu().numpy()}
        timings["reals_project"] += time.perf_counter() - t
        t = time.perf_counter()
        os.makedirs(osp.dirname(cache_path), exist_ok=True)
        tmp = cache_path + f".tmp.{os.getpid()}.npz"
        np.savez(tmp, d2=reals[subset]["2d"], d3=reals[subset]["3d"])
        os.replace(tmp, cache_path)
        timings["reals_load"] += time.perf_counter() - t
        print("cached:", cache_path)

    if args.prepare_only:
        print("prepare-only: real-tensor caches ready; exiting")
        return {"prepared": True}

    for subset in ("train", "test"):
        for mode in ("2d", "3d"):
            arr = _subsample(reals[subset][mode], args.num_test)
            reals[subset][mode] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
            print("real", subset, mode, tuple(reals[subset][mode].shape))

    timestamp = datetime.datetime.now().isoformat()
    if args.compute_gt:
        scores = score(reals["train"]["2d"], reals["train"]["3d"],
                       reals["test"]["2d"], reals["test"]["3d"], args.cd_batch,
                       timings=timings, metrics=metrics)
        scores["#test"] = args.num_test
        scores["#points"] = args.num_points
        pprint.pprint(scores)
        gt_dir = f"outputs/logs/dataset={cfg.dataset.name}/gt/evaluation/tol=0"
        os.makedirs(gt_dir, exist_ok=True)
        with open(osp.join(gt_dir, f"{timestamp}.json"), "w") as f:
            json.dump(scores, f, ensure_ascii=False, indent=4, sort_keys=True)
        return scores

    # ------------------------------------------------------------- fakes
    n_test = len(reals["test"]["2d"])
    in_ch = int(cfg.model.gen.in_ch)
    mask_threshold = float(args.mask_threshold)
    calib_info = {}
    if args.calibrate_drop_rate:
        # target: the real train set's drop rate
        t = time.perf_counter()
        target = real_drop_rate(reals["train"]["2d"], drop_const)
        z_cal = latents(0, int(args.calib_samples), in_ch, CALIB_SEED).to(device)
        mask_threshold, achieved = calibrate_mask_threshold(
            gen, z_cal, target, drop_const, batch=batch_size)
        calib_info = {"mask_threshold": mask_threshold, "drop_rate/target": target,
                      "drop_rate/calibrated": achieved}
        timings["calibration"] = time.perf_counter() - t
        print(f"calibrated mask threshold: {mask_threshold:.6f} "
              f"(drop rate {achieved:.4f} vs real {target:.4f})")
    t = time.perf_counter()
    fake_2d = []
    for i in range(0, n_test, batch_size):
        z = latents(i, min(i + batch_size, n_test), in_ch).to(device)
        fake_2d.append(gen(z, threshold=mask_threshold)["depth"])
    fake_2d = torch.cat(fake_2d).contiguous()
    synchronize(device)
    timings["generation"] = time.perf_counter() - t
    t = time.perf_counter()
    fake_3d = to_points(lidar, fake_2d, args.tol, args.num_points)
    synchronize(device)
    timings["fps"] = time.perf_counter() - t

    scores = score(fake_2d, fake_3d, reals["test"]["2d"], reals["test"]["3d"],
                   args.cd_batch, timings=timings, metrics=metrics)
    scores["#test"] = args.num_test
    scores["#points"] = args.num_points
    if mask_threshold != 0.5 or calib_info:
        scores["drop_rate/fake"] = float(drop_rate_2d(fake_2d, drop_const))
        scores["mask_threshold"] = mask_threshold
        scores.update(calib_info)
    pprint.pprint(scores)
    os.makedirs(args.save_dir_path, exist_ok=True)
    save_path = osp.join(args.save_dir_path, f"{timestamp}.json")
    with open(save_path, "w") as f:
        json.dump(scores, f, ensure_ascii=False, indent=4, sort_keys=True)
    print("Saved:", save_path)
    return scores


if __name__ == "__main__":
    main()
