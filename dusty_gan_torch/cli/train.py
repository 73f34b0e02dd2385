"""Training on one or more GPUs (``dusty_gan_tpu/cli/train.py``):

    python -m dusty_gan_torch.cli.train dataset=kitti_odometry \\
        model=dusty2_dcgan_eqlr solver=nsgan_eqlr [key=value ...] [device=cuda]
    torchrun --nproc-per-node N -m dusty_gan_torch.cli.train ... multihost=1

The reference's ``key=value`` overrides, plus the CLI-only keys
``total_iterations=N`` (cap the run), ``run_dir=…`` (fix the output
directory; default ``outputs/logs/dataset=…/model=…/solver=…/<date>/
<time>``), ``config_dir=…``, ``validate_samples=N`` (val scans scored per
validation; default all), ``profile_dir=…``, ``device=`` (default
``cuda``; a run without a visible GPU raises unless ``device=cpu``),
``multihost=1`` and ``preempt_sync=N``.

Ranks (``parallel/mesh.py``): ``num_devices`` (config; null means every
visible GPU, and one process on the CPU) above 1 starts that many local
processes, rank r on ``cuda:r`` (or on the CPU over gloo with
``device=cpu``); more GPUs than are visible raise.  ``multihost=1`` joins
the process group that torchrun's environment describes instead (then
``num_devices`` must be null or the world size).  ``solver.batch_size`` is
the global batch; each rank trains on its slice and the step averages the
gradients.  Rank 0 alone logs, prints, validates, logs images and writes
the config and the checkpoints; every rank holds the same state.  A
SIGTERM to any rank stops every rank at the same iteration: each step's
scalar all-reduce carries the ranks' stop flags, and every rank reads the
vote every ``preempt_sync`` iterations (default ``max(1, min(save_stats,
100))``), so no collective runs at a point the ranks do not share; rank 0
checkpoints and every rank returns.  In chunk mode the vote rides each
chunk's last step and is read at the chunk end where the chunk crossed a
multiple of ``preempt_sync`` (so the cadence rounds up to chunk ends).

Writes ``.hydra/config.yaml``, ``scalars.jsonl`` (every
``solver.checkpoint.save_stats`` iterations and, in the per-step loop, at
iteration 1, with ``perf/scans_per_sec`` over the iterations since the
last log; ``score/*`` at every ``test``), and
``models/checkpoint_<images>.pth`` at every ``save_model`` and at the end.
SIGTERM checkpoints at the next iteration boundary (chunk boundary in
chunk mode) and returns.  The per-step loop takes its batches from
``Trainer.device_iter`` (host batches copied ahead, or with
``cache_device=true`` index gathers from the device-resident train split;
``transfer_dtype`` narrows the host copy; ``cache_dataset`` builds the
resized cache).

``steps_per_call=K`` (K > 1, with ``cache_device=true``) runs the chunk
loop: k iterations a call through ``Trainer.step_chunk`` (on CUDA one
captured CUDA graph per chunk length), the first chunk ``min(K - i % K,
total - i)`` long so that a resume off the K-grid realigns, and the
boundary actions at chunk ends; so K must divide ``save_stats``,
``test``, ``save_image`` and ``save_model``.  In a process group every
rank captures the run's chunk lengths (the realigning first chunk, K, the
tail) before the first chunk and then waits at one host barrier, as the
JAX CLI compiles every length and then meets at a barrier; each rank
passes its stop flag into each chunk and reads the previous chunk's
``stop/agreed``.

``profile_dir=DIR`` traces iterations start+4 to start+8 of the per-step
loop with torch.profiler (CPU and CUDA), writes the Chrome trace into DIR
and prints its summary (``utils/profiling.py``), per step over four steps
as the JAX CLI reckons it (the window holds five).  The chunk loop does
not profile, as in the JAX CLI.

Image logging (``log_images``), with the JAX CLI's tags, to TensorBoard
and wandb (``RunLogger.image``): the first batch of epoch 0 as ``real/*``
at the start (the loader's stream is a function of the position, so the
batch stream does not move), and G's samples of ``Trainer.fixed_latent``
as ``synth/*`` every ``save_image`` iterations, in the per-step loop and,
in chunk mode, between chunks, never inside a capture or a replay.
"""

from __future__ import annotations

import os
import os.path as osp
import signal
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from dusty_gan_torch import resolve_device, synchronize
from dusty_gan_torch.config import compose, run_dir_for, save_config
from dusty_gan_torch.geometry.render import render_point_clouds
from dusty_gan_torch.parallel import mesh
from dusty_gan_torch.train.logging import RunLogger
from dusty_gan_torch.train.step import fetch_reals
from dusty_gan_torch.train.trainer import Trainer
from dusty_gan_torch.utils import profiling
from dusty_gan_torch.utils.postprocess import colorize, postprocess

CLI_KEYS = ("total_iterations", "run_dir", "config_dir", "validate_samples", "device",
            "profile_dir", "multihost", "preempt_sync")
CHUNK_CADENCES = ("save_stats", "test", "save_image", "save_model")
INV_SCALE = 1 / 0.4  # the logged inverse depth's visibility scale


def log_images(logger: RunLogger, tag_prefix: str, out: Dict[str, torch.Tensor],
               step: int) -> None:
    """Image grids of a postprocessed output dict (B, H, W, C): the
    coloured inverse depth, the normal map, the top-down BEV render, and
    where present the depth before the drops, the confidence and the mask
    (DUSty-II's channels as ``/pix`` and ``/img``)."""
    def grid(tag: str, images: torch.Tensor) -> None:
        logger.image_grid(f"{tag_prefix}/{tag}", images.cpu().numpy(), step)

    grid("inv", colorize(out["depth"] * INV_SCALE))
    grid("normal", out["normals"])
    pts = out["points"].reshape(out["points"].shape[0], -1, 3)
    grid("bev", render_point_clouds(pts, out["normals"].reshape(pts.shape),
                                    t=torch.tensor([0.0, 0.0, 0.5])))
    if "depth_orig" in out:
        grid("inv/orig", colorize(out["depth_orig"] * INV_SCALE))
    if "confidence" in out:
        conf = out["confidence"]
        if conf.shape[-1] == 2:
            grid("confidence/pix", colorize(conf[..., :1]))
            grid("confidence/img", colorize(conf[..., 1:]))
        else:
            grid("confidence", colorize(conf))
    if "mask" in out:
        mask = out["mask"]
        for c in range(mask.shape[-1]):
            sub = ("/pix" if c == 0 else "/img") if mask.shape[-1] == 2 else ""
            grid(f"mask{sub}", mask[..., c:c + 1].expand(-1, -1, -1, 3))


def log_real_images(trainer: Trainer, logger: RunLogger) -> None:
    """The first batch of epoch 0, in float32 whatever ``transfer_dtype``,
    as ``real/*`` at image step 1; the loader's batches are a function of
    their position, so this does not move the training stream."""
    depth = torch.from_numpy(next(trainer.loader.epoch(0))["depth"]).to(trainer.device)
    inv, mask = fetch_reals({"depth": depth.permute(0, 3, 1, 2)}, trainer.lidar,
                            float(trainer.cfg.model.gen.drop_const))
    real = postprocess({"depth": inv.permute(0, 2, 3, 1), "mask": mask.permute(0, 2, 3, 1)},
                       trainer.lidar)
    log_images(logger, "real", real, 1)


def chunk_lengths(start: int, total: int, K: int) -> list:
    """The distinct chunk lengths of a chunk run from iteration ``start``
    to ``total``: the first chunk realigns to the K-grid, then chunks of
    K, then the tail."""
    if start >= total:
        return []
    first = min(K - start % K, total - start)
    rest = total - start - first
    return sorted({first} | ({K} if rest >= K else set()) | ({rest % K} - {0}))


def main(argv=None, timings: Optional[Dict[str, float]] = None) -> str:
    """Returns the run directory.  ``timings``, when given, receives the
    wall seconds of the training loop (``train_s``, validation and saves
    included) and of the validations (``validation_s``) of this process."""
    argv = list(sys.argv[1:] if argv is None else argv)
    extras, overrides = {}, []
    for ov in argv:
        key = ov.split("=", 1)[0]
        if key in CLI_KEYS:
            extras[key] = ov.split("=", 1)[1]
        else:
            overrides.append(ov)
    device = resolve_device(extras.get("device"))

    config_dir = extras.get("config_dir", osp.join(osp.dirname(__file__), "../../configs"))
    cfg = compose(osp.abspath(config_dir), overrides)
    if cfg.get("resume") and not osp.isabs(cfg.resume):
        cfg.resume = osp.abspath(cfg.resume)
    requested = cfg.get("num_devices")
    if extras.get("multihost") in ("1", "true", "True"):
        with mesh.process_group(device) as device:
            if requested is not None and int(requested) != mesh.world_size():
                raise ValueError(f"num_devices={requested} but the process group has "
                                 f"{mesh.world_size()} ranks")
            return _train(cfg, extras, device, timings)
    n = mesh.num_processes(device, requested)
    if n == 1:
        return _train(cfg, extras, device, timings)
    run_dir = extras.get("run_dir") or run_dir_for(cfg)
    mesh.spawn(main, n, [ov for ov in argv if not ov.startswith("run_dir=")]
               + [f"run_dir={run_dir}", "multihost=1"])
    return run_dir


def _train(cfg, extras: Dict[str, str], device, timings: Optional[Dict[str, float]]) -> str:
    """The training run of this process (rank 0 alone writes)."""
    is_main, rank = mesh.is_main(), mesh.rank()
    voting = mesh.distributed()
    run_dir = extras.get("run_dir") or run_dir_for(cfg)
    models_dir = osp.join(run_dir, "models")
    if is_main:
        os.makedirs(models_dir, exist_ok=True)
        save_config(cfg, run_dir)

    ckpt = cfg.solver.checkpoint
    K = int(cfg.get("steps_per_call") or 0)
    if K > 1:
        for name in CHUNK_CADENCES:
            c = int(ckpt[name])
            if c % K:
                raise ValueError(
                    f"steps_per_call={K} must divide solver.checkpoint.{name}={c} "
                    "(boundary actions fire only at chunk ends)")

    trainer = Trainer(cfg, device, verbose=is_main)
    logger = None
    if is_main:
        logger = RunLogger(run_dir, use_wandb=bool(cfg.get("publish_wandb")),
                           wandb_config=cfg.to_plain())
        print("run dir:", run_dir)
        log_real_images(trainer, logger)
    total_iteration = int(int(cfg.solver.total_kimg) * 1000 / cfg.solver.batch_size)
    if "total_iterations" in extras:
        total_iteration = min(total_iteration, int(extras["total_iterations"]))
    val_samples = int(extras.get("validate_samples", 0)) or None
    profile_dir = extras.get("profile_dir") if is_main else None
    preempt_sync = int(extras.get("preempt_sync") or 0) or max(1, min(int(ckpt.save_stats),
                                                                     100))
    timings = {} if timings is None else timings
    timings.setdefault("validation_s", 0.0)
    imgs_per_iter = trainer.batch_size
    start = trainer.start_iteration
    last_log = [time.perf_counter(), start]

    def boundary_actions(i: int, scalars) -> None:
        """Stats, validation and checkpoint due at iteration ``i`` (rank 0)."""
        if not is_main:
            return
        step_imgs = i * imgs_per_iter
        if i % int(ckpt.save_stats) == 0 or i == 1:
            values = {k: float(v) for k, v in scalars.items()}  # waits for the step
            now = time.perf_counter()
            t_last, i_last = last_log
            # over the iterations since the last log (a resumed run's
            # first window is shorter than save_stats)
            sps = imgs_per_iter * (i - i_last) / (now - t_last) if i > 1 else 0.0
            last_log[:] = [now, i]
            logger.scalars(values, step_imgs)
            if sps:
                logger.scalar("perf/scans_per_sec", sps, step_imgs)
            print(f"iter {i}/{total_iteration} "
                  + " ".join(f"{k.split('/')[-1]}={v:.4f}" for k, v in sorted(values.items()))
                  + (f" [{sps:.0f} scans/s]" if sps else ""))
        if i % int(ckpt.save_image) == 0:
            log_images(logger, "synth", trainer.generate(ema=False), step_imgs)
        if i % int(ckpt.test) == 0:
            t = time.perf_counter()
            scores = trainer.validation(max_samples=val_samples)
            timings["validation_s"] += time.perf_counter() - t
            logger.scalars({f"score/{k}": v for k, v in scores.items()}, step_imgs)
            print("validation:", {k: round(v, 4) for k, v in scores.items()
                                  if not k.startswith("1-nn-t")})
        if i % int(ckpt.save_model) == 0:
            print("saved:", trainer.save(models_dir, step_imgs))

    def stopped(i: int, agreed=None, due: bool = True) -> bool:
        """Whether to stop after iteration ``i``: on SIGTERM, or in a group
        on the vote that iteration ``i``'s step returned (``agreed``), read
        on every rank where ``due`` (every ``preempt_sync`` iterations)."""
        if voting:
            stop = agreed is not None and due and float(agreed) > 0.0
        else:
            stop = bool(stop_requested)
        if stop and is_main:
            path = trainer.save(models_dir, i * imgs_per_iter)
            print(f"SIGTERM: checkpointed at iteration {i}: {path}")
        elif stop:
            print(f"SIGTERM vote: rank {rank} stopped at iteration {i}")
        return stop

    stop_requested = []
    prev_handler = signal.signal(signal.SIGTERM, lambda signum, frame: stop_requested.append(signum))
    t_start = time.perf_counter()
    it = None
    try:
        if K > 1:
            ix = trainer.loader.index_stream(start)
            if voting:
                trainer.chunks.prepare(chunk_lengths(start, total_iteration, K))
                mesh.host_barrier()
            i, k, agreed = start, 0, None
            while i < total_iteration:
                # the vote is read where the last chunk crossed a multiple
                # of preempt_sync
                if stopped(i, agreed, i // preempt_sync > (i - k) // preempt_sync):
                    return run_dir
                k = min(K - i % K, total_iteration - i)
                rows = np.stack([trainer.device_cache.rows(*next(ix)) for _ in range(k)])
                scalars = trainer.step_chunk(range(i + 1, i + k + 1), rows,
                                             stop=bool(stop_requested))
                agreed = scalars.pop("stop/agreed", None)
                i += k
                boundary_actions(i, scalars)
        else:
            it = trainer.device_iter()
            prof, agreed = None, None
            for i in range(start + 1, total_iteration + 1):
                if stopped(i - 1, agreed, (i - 1) % preempt_sync == 0):
                    return run_dir
                if profile_dir and i == start + 4:
                    prof = profiling.start_trace(device)
                scalars = trainer.step(i, next(it), stop=bool(stop_requested))
                agreed = scalars.pop("stop/agreed", None)
                if prof is not None and i == start + 8:
                    synchronize(device)
                    path = profiling.stop_trace(prof, profile_dir, f"train_{start + 4}-{i}")
                    prof = None
                    print("profile trace written to", path)
                    summary = profiling.summarize_trace(profile_dir, steps=4)
                    if summary is not None:
                        print(profiling.format_summary(summary))
                boundary_actions(i, scalars)
        if is_main:
            print("saved final:", trainer.save(models_dir, total_iteration * imgs_per_iter))
        timings["train_s"] = time.perf_counter() - t_start
        return run_dir
    finally:
        if it is not None:
            it.close()
        if logger is not None:
            logger.close()
        signal.signal(signal.SIGTERM, prev_handler)


if __name__ == "__main__":
    main()
