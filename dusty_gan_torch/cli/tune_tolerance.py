"""Drop-tolerance tuning on one GPU (``dusty_gan_tpu/cli/tune_tolerance.py``):

    python -m dusty_gan_torch.cli.tune_tolerance --model-path <.pth> \\
        --config-path <config.yaml> [--num-samples 100] [--device cuda]

Searches tol in [--tol-min, --tol-max] (log-uniform) for the projection
of generated inverse depth to points, minimising on the val split

    1 * 1-NNA-CD + 100 * MMD-CD - 1 * COV-CD + 10 * JSD

by TPE (``utils/tpe.py``) or ``--algo random`` (log-uniform exploration,
then refinement around the incumbent).  The real val clouds (tol 1e-8,
FPS to ``--num-points``) and their real-real Chamfer matrix are computed
once; G_ema generates the fakes once in 2D with fixed Gumbel noise, since
tol only changes their projection; each trial projects them, computes the
real-fake and fake-fake matrices (``pairwise_cd``: kernel K1, ``cd_block``,
on the card) and JSD.  Single-process.  Writes
``<save-dir>/tune_<timestamp>.json`` with the best trial and every trial,
as the JAX CLI does.  Latent i of the fakes is drawn from a CPU generator
seeded ``(0x70E << 20) + (seed << 16) + i``: JAX's ``fold_in`` streams and
torch's generators never match, so ``tolerance_scores`` takes the fakes.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import os.path as osp
import time
from typing import Dict, Optional

import numpy as np
import torch

from dusty_gan_torch import resolve_device, synchronize
from dusty_gan_torch.cli.evaluate_synthesis import latents, to_points
from dusty_gan_torch.data.datasets import define_dataset
from dusty_gan_torch.data.loader import Loader
from dusty_gan_torch.geometry.lidar import sigmoid_to_tanh
from dusty_gan_torch.metrics.cov_mmd_1nna import _compute_cov_mmd, _compute_nna, pairwise_cd
from dusty_gan_torch.metrics.jsd import compute_jsd
from dusty_gan_torch.utils.setup import make_eval_generator, setup
from dusty_gan_torch.utils.tpe import tpe_minimize_batched

REAL_TOL = 1e-8
TUNE_SEED = 0x70E << 20


def real_clouds(cfg, lidar, num_points: int, batch_size: int, device) -> torch.Tensor:
    """The val split's clouds at tol 1e-8, FPS to ``num_points``."""
    drop_const = float(cfg.model.gen.drop_const)
    ds = define_dataset(cfg.dataset, phase="val")
    out = []
    for batch in Loader(ds, batch_size).epoch(0):
        depth = torch.from_numpy(batch["depth"]).to(device)
        mask = torch.from_numpy(batch["mask"]).to(device)
        inv = mask * sigmoid_to_tanh(lidar.invert_depth(depth)) + (1 - mask) * drop_const
        out.append(to_points(lidar, inv, REAL_TOL, num_points))
    return torch.cat(out)


def tolerance_scores(fake_2d: torch.Tensor, real_3d: torch.Tensor, m_rr: np.ndarray,
                     tol: float, lidar, num_points: int, cd_batch: int) -> Dict[str, float]:
    """The objective at ``tol`` for generated inverse depth (B, H, W, 1) in
    [-1, 1] against real clouds (B', N, 3) and their real-real matrix:
    ``score`` and its terms (``jsd``, ``{cov,mmd,mmd-sample}-cd``,
    ``1-nn-*-cd``)."""
    fake_3d = to_points(lidar, fake_2d, tol, num_points)
    scores = {"jsd": compute_jsd(fake_3d / 2.0, real_3d / 2.0)}
    m_rg = pairwise_cd(real_3d, fake_3d, cd_batch)
    m_gg = pairwise_cd(fake_3d, fake_3d, cd_batch)
    for k, v in _compute_cov_mmd(m_rg).items():
        scores[f"{k}-cd"] = v
    for k, v in _compute_nna(m_rr, m_rg, m_gg).items():
        scores[f"1-nn-{k}-cd"] = v
    score = (1.0 * scores["1-nn-accuracy-cd"] + 100.0 * scores["mmd-cd"]
             - 1.0 * scores["cov-cd"] + 10.0 * scores["jsd"])
    return {"score": float(score), **{k: float(v) for k, v in scores.items()}}


def main(argv=None, timings: Optional[Dict[str, float]] = None):
    """Returns the best trial.  ``timings``, when given, receives the wall
    seconds of the real side (``reals_s``), the fakes (``generation_s``),
    the real-real matrix (``m_rr_s``) and the trials (``trials_s``)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--config-path", type=str, required=True)
    parser.add_argument("--save-dir-path", type=str, default=".")
    parser.add_argument("--num-samples", type=int, default=100)
    parser.add_argument("--num-points", type=int, default=512)
    parser.add_argument("--num-test", type=int, default=-1)
    parser.add_argument("--tol-min", type=float, default=1e-3)
    parser.add_argument("--tol-max", type=float, default=1e-1)
    parser.add_argument("--cd-batch", type=int, default=512)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--algo", choices=["tpe", "random"], default="tpe")
    parser.add_argument("--trial-batch", type=int, default=0,
                        help="tolerances proposed per round (0 = 1, the one device)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    timings = {} if timings is None else timings
    trial_batch = args.trial_batch if args.trial_batch > 0 else 1

    cfg, G, lidar, fixed_noise = setup(args.model_path, args.config_path, device)
    gen = make_eval_generator(G, fixed_noise)
    batch_size = int(cfg.solver.batch_size)

    t = time.perf_counter()
    real_3d = real_clouds(cfg, lidar, args.num_points, batch_size, device)
    if args.num_test > 0:
        real_3d = real_3d[:args.num_test]
    n_test = real_3d.shape[0]
    synchronize(device)
    timings["reals_s"] = time.perf_counter() - t
    print("val clouds:", tuple(real_3d.shape))

    t = time.perf_counter()
    in_ch = int(cfg.model.gen.in_ch)
    seed0 = TUNE_SEED + (args.seed << 16)
    with torch.no_grad():
        fake_2d = torch.cat([
            gen(latents(i, min(i + batch_size, n_test), in_ch, seed0).to(device))["depth"]
            for i in range(0, n_test, batch_size)]).contiguous()
    synchronize(device)
    timings["generation_s"] = time.perf_counter() - t
    t = time.perf_counter()
    m_rr = pairwise_cd(real_3d, real_3d, args.cd_batch)
    timings["m_rr_s"] = time.perf_counter() - t

    trials, best = [], None
    timings["trials_s"] = 0.0

    def record_batch(tols) -> list:
        nonlocal best
        ys = []
        for tol in tols:
            t0 = time.perf_counter()
            r = {"tol": float(tol), **tolerance_scores(fake_2d, real_3d, m_rr, float(tol),
                                                       lidar, args.num_points, args.cd_batch)}
            timings["trials_s"] += time.perf_counter() - t0
            trials.append(r)
            if best is None or r["score"] < best["score"]:
                best = r
            print(f"trial {len(trials)}/{args.num_samples}: tol={tol:.5f} "
                  f"score={r['score']:.4f} (best {best['tol']:.5f} @ {best['score']:.4f})")
            ys.append(r["score"])
        return ys

    if args.algo == "tpe":
        tpe_minimize_batched(record_batch, args.tol_min, args.tol_max,
                             num_samples=args.num_samples, seed=args.seed,
                             n_startup=max(5, args.num_samples // 5), log_space=True,
                             batch=trial_batch)
    else:
        rng = np.random.RandomState(args.seed)
        lo, hi = np.log(args.tol_min), np.log(args.tol_max)
        n_explore = max(1, args.num_samples * 3 // 4)
        explore = [float(t) for t in np.exp(rng.uniform(lo, hi, n_explore))]
        for i in range(0, n_explore, trial_batch):
            record_batch(explore[i:i + trial_batch])
        while len(trials) < args.num_samples:  # refinement around the incumbent
            q = min(trial_batch, args.num_samples - len(trials))
            record_batch([float(np.clip(np.exp(rng.normal(np.log(best["tol"]), 0.15)),
                                        args.tol_min, args.tol_max)) for _ in range(q)])

    print("best:", best)
    os.makedirs(args.save_dir_path, exist_ok=True)
    out_path = osp.join(args.save_dir_path,
                        f"tune_{datetime.datetime.now().isoformat()}.json")
    with open(out_path, "w") as f:
        json.dump({"best": best, "trials": trials}, f, indent=2, sort_keys=True)
    print("Saved:", out_path)
    return best


if __name__ == "__main__":
    main()
