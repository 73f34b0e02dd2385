"""Reconstruction (GAN inversion) evaluation on the GPU
(``dusty_gan_tpu/cli/evaluate_reconstruction.py``):

    python -m dusty_gan_torch.cli.evaluate_reconstruction \\
        --model-path <checkpoint.pth> --config-path <run>/.hydra/config.yaml \\
        [--tol 0] [--batch-size 512] [--distance l1|l2] [--num-step 1000] \\
        [--max-batches -1] [--device cuda] [--multihost]
    torchrun --nproc-per-node N -m dusty_gan_torch.cli.evaluate_reconstruction ... --multihost

For each test batch: the EMA generator with frozen Gumbel noise inverts a
spherical latent (Adam lr 0.1, StyleGAN2 cosine-ramp schedule, decaying
latent noise, ``--num-step`` steps) against the masked L1/L2 on the
normalised inverse depth, ``depth_orig`` for DUSty models and ``depth``
for the baseline.  The reconstruction at z* is then scored against the
scan: Chamfer distance on the full 64x256-point clouds (the CUDA ``nn``
kernel, K2), depth errors and accuracies over the measured pixels, and the
drop rates of both.  One CSV row per test scan, with the JAX CLI's columns.

The initial latent and the per-step latent noise of batch ``bi`` come from
generators seeded by ``bi`` on the device (``initial_latent``,
``step_noise``), so a batch's result does not depend on which other batches
run.  The generator's convolutions run in bf16 (``make_eval_generator``'s
default), as the JAX CLI's do.

``--multihost`` joins the process group that torchrun's environment
describes (``parallel/mesh.py``): batch ``bi`` is inverted by rank
``bi % W``, and the per-sample rows are merged as the JAX CLI merges them
(``merge_process_results``: one gather of the counts, one of the rows
padded to the largest count, sorted by global sample index) over gloo, so
ranks may share a card.  Rank 0 writes the CSV; every rank returns the
merged columns.  A group of more than one rank without ``--multihost``
raises, since each rank would repeat every batch.
"""

from __future__ import annotations

import argparse
import csv
import datetime
import os
import os.path as osp
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from dusty_gan_torch import resolve_device, synchronize
from dusty_gan_torch.data.datasets import define_dataset
from dusty_gan_torch.data.loader import Loader
from dusty_gan_torch.geometry.lidar import tanh_to_sigmoid
from dusty_gan_torch.metrics.chamfer import compute_cd
from dusty_gan_torch.metrics.depth import compute_depth_accuracy, compute_depth_error
from dusty_gan_torch.models.losses import masked_loss
from dusty_gan_torch.parallel import mesh
from dusty_gan_torch.utils.inversion import NoiseFn, make_inversion_loop, project_sphere
from dusty_gan_torch.utils.postprocess import postprocess
from dusty_gan_torch.utils.setup import make_eval_generator, setup

# CSV column order of the JAX CLI ("index" is dropped before writing)
RESULT_KEYS = ("cd", "accuracy_1", "accuracy_2", "accuracy_3", "rmse",
               "rmse_log", "abs_rel", "sq_rel", "tol", "drop_gen",
               "drop_ref", "index")
# batch bi seeds its z0 generator Z0_SEED + bi and its noise generator
# NOISE_SEED + bi; a CPU generator keeps only the low 32 bits of a seed, so
# the two ranges differ there
Z0_SEED, NOISE_SEED = 1 << 20, 2 << 20


def initial_latent(bi: int, b: int, in_ch: int, device) -> torch.Tensor:
    """(b, in_ch) standard normal z0 of test batch ``bi``."""
    g = torch.Generator(device=device).manual_seed(Z0_SEED + bi)
    return torch.randn((b, in_ch), generator=g, device=device)


def step_noise(bi: int, device) -> NoiseFn:
    """The per-step latent noise of test batch ``bi``: standard normal
    draws taken one after another from a generator seeded by ``bi``."""
    g = torch.Generator(device=device).manual_seed(NOISE_SEED + bi)
    return lambda step, shape: torch.randn(shape, generator=g, device=device)


def reconstruct_batch(gen, lidar, batch: Dict[str, np.ndarray], z0: torch.Tensor,
                      noise: NoiseFn, is_dusty: bool, distance: str = "l1",
                      num_step: int = 1000, tol: float = 0.0,
                      stats: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
    """Invert one test batch and score the reconstruction.  ``gen`` is an
    eval generator over a frozen G; ``batch`` holds the dataset's (B, H, W, 1)
    depth and mask and (B, H, W, 3) xyz.  Returns the per-sample (B,)
    columns of ``RESULT_KEYS`` except ``tol`` and ``index``.  ``stats``,
    when given, accumulates the mean loss at z0 and at z* and the seconds
    of the inversion, the Chamfer distance and the rest; only then are the
    loss at z0 computed and the device synchronised between stages."""
    device = z0.device

    def clock() -> float:
        if stats is not None:
            synchronize(device)
        return time.perf_counter()

    t0 = clock()
    mask_ref = torch.from_numpy(batch["mask"]).to(device)
    inv_ref = lidar.invert_depth(torch.from_numpy(batch["depth"]).to(device)) * mask_ref
    xyz_ref = torch.from_numpy(batch["xyz"]).to(device)
    b = z0.shape[0]
    key = "depth_orig" if is_dusty else "depth"

    def loss_fn(latent):
        inv_gen = tanh_to_sigmoid(gen(latent)[key])
        return masked_loss(inv_ref, inv_gen, mask_ref, distance)

    if stats is not None:
        with torch.no_grad():
            loss0 = loss_fn(project_sphere(z0.float()))
    t1 = clock()
    z_star, loss = make_inversion_loop(loss_fn, num_steps=num_step, lr=0.1)(z0, noise)
    t2 = clock()

    with torch.no_grad():
        raw = gen(z_star)
        out = postprocess(raw, lidar, tol=tol)
        points_gen = out["points"].reshape(b, -1, 3)
        points_ref = xyz_ref.reshape(b, -1, 3)
        t3 = clock()
        res = {"cd": compute_cd(points_ref, points_gen)}
        t4 = clock()
        depth_gen = lidar.revert_depth(tanh_to_sigmoid(raw[key]), norm=False)
        depth_ref = lidar.revert_depth(inv_ref, norm=False)
        res.update(compute_depth_accuracy(depth_ref, depth_gen, mask_ref))
        res.update(compute_depth_error(depth_ref, depth_gen, mask_ref))
        h, w = out["depth"].shape[1:3]
        if is_dusty:
            # DUSty-II's mask holds [pixel, image]: both channels are
            # counted, as the JAX CLI counts them
            drop = (1 - out["mask"]).sum(dim=(1, 2, 3)) / (h * w)
        else:
            m = ((out["depth"] - 0.0).abs() > tol).float()
            drop = (1 - m).sum(dim=(1, 2, 3)) / (h * w)
        res["drop_gen"] = drop
        res["drop_ref"] = (1 - mask_ref).sum(dim=(1, 2, 3)) / (h * w)
    t5 = clock()
    if stats is not None:
        for k, v in (("loss_z0", float(loss0.mean())), ("loss_zstar", float(loss.mean())),
                     ("inversion_s", t2 - t1), ("cd_s", t4 - t3),
                     ("rest_s", (t1 - t0) + (t3 - t2) + (t5 - t4))):
            stats[k] = stats.get(k, 0.0) + v
    return res


def merge_process_results(results: Dict[str, list]) -> Dict[str, list]:
    """The per-sample columns of every rank (``RESULT_KEYS``, ``index``
    included), merged in order of global sample index, without ``index``.
    Every rank calls it in lockstep, also one that inverted no batch."""
    vals = np.asarray([results[k] for k in RESULT_KEYS], np.float64).T
    vals = vals.reshape(-1, len(RESULT_KEYS))
    counts = mesh.pod_allgather(np.asarray([vals.shape[0]], np.int64))[:, 0]
    pad = np.zeros((int(counts.max()) - vals.shape[0], len(RESULT_KEYS)))
    gathered = mesh.pod_allgather(np.concatenate([vals, pad]))
    rows = np.concatenate([gathered[p, :n] for p, n in enumerate(counts)])
    rows = rows[np.argsort(rows[:, RESULT_KEYS.index("index")], kind="stable")]
    return {k: rows[:, i].tolist() for i, k in enumerate(RESULT_KEYS) if k != "index"}


def main(argv=None, stats: Optional[Dict[str, float]] = None):
    """Returns the per-sample result columns (without ``index``).
    ``stats``, when given, accumulates what ``reconstruct_batch`` records
    over every batch, and the number of batches."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--config-path", type=str, required=True)
    parser.add_argument("--save-dir-path", type=str, default=".")
    parser.add_argument("--tol", type=float, default=0)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--distance", default="l1", choices=["l1", "l2"])
    parser.add_argument("--num-step", type=int, default=1000)
    parser.add_argument("--max-batches", type=int, default=-1)
    parser.add_argument("--multihost", action="store_true",
                        help="join torchrun's process group and stripe the test "
                             "batches over its ranks")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    with mesh.process_group(device, join=args.multihost) as device:
        return _evaluate(args, device, stats)


def _evaluate(args, device, stats: Optional[Dict[str, float]]) -> Dict[str, list]:
    ranks, rank = mesh.world_size(), mesh.rank()
    if ranks > 1 and not args.multihost:
        raise SystemExit("evaluate_reconstruction in a process group of more than one "
                         "rank needs --multihost, which stripes the batches over the "
                         "ranks (without it every rank repeats every batch)")

    cfg, G, lidar, fixed_noise = setup(args.model_path, args.config_path, device)
    gen = make_eval_generator(G, fixed_noise)
    is_dusty = "dusty" in str(cfg.model.gen.arch)
    in_ch = int(cfg.model.gen.in_ch)
    loader = Loader(define_dataset(cfg.dataset, phase="test"), args.batch_size)

    results = defaultdict(list)
    for bi, batch in enumerate(loader.epoch()):
        if 0 <= args.max_batches <= bi:
            break
        if bi % ranks != rank:
            continue  # another rank inverts this batch
        b = len(batch["depth"])
        res = reconstruct_batch(
            gen, lidar, batch, initial_latent(bi, b, in_ch, device),
            step_noise(bi, device), is_dusty, args.distance, args.num_step,
            args.tol, stats)
        if stats is not None:
            stats["batches"] = stats.get("batches", 0) + 1
        for k in RESULT_KEYS:
            if k == "tol":
                results[k] += [args.tol] * b
            elif k == "index":
                results[k] += list(range(bi * args.batch_size, bi * args.batch_size + b))
            else:
                results[k] += res[k].float().cpu().tolist()
        print(f"batch {bi}: cd={np.mean(results['cd']):.5f}")

    if ranks > 1:
        results = merge_process_results(results)
        if rank != 0:
            return results
    results.pop("index", None)
    os.makedirs(args.save_dir_path, exist_ok=True)
    timestamp = datetime.datetime.now().isoformat()
    save_path = osp.join(args.save_dir_path, f"{timestamp}.csv")
    keys = list(results.keys())
    with open(save_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow([""] + keys)
        for i in range(len(results["cd"])):
            writer.writerow([i] + [results[k][i] for k in keys])
    print(f"Saved: {save_path}")
    return dict(results)


if __name__ == "__main__":
    main()
