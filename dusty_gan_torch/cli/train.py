"""Training on one GPU (``dusty_gan_tpu/cli/train.py``):

    python -m dusty_gan_torch.cli.train dataset=kitti_odometry \\
        model=dusty2_dcgan_eqlr solver=nsgan_eqlr [key=value ...] [device=cuda]

The reference's ``key=value`` overrides, plus the CLI-only keys
``total_iterations=N`` (cap the run), ``run_dir=…`` (fix the output
directory; default ``outputs/logs/dataset=…/model=…/solver=…/<date>/
<time>``), ``config_dir=…``, ``validate_samples=N`` (val scans scored per
validation; default all), ``profile_dir=…`` and ``device=`` (default
``cuda``; a run without a visible GPU raises unless ``device=cpu``).

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
``test``, ``save_image`` and ``save_model``.

``profile_dir=DIR`` traces iterations start+4 to start+8 of the per-step
loop with torch.profiler (CPU and CUDA), writes the Chrome trace into DIR
and prints its summary (``utils/profiling.py``), per step over four steps
as the JAX CLI reckons it (the window holds five).  The chunk loop does
not profile, as in the JAX CLI.

Not yet ported, each raising: ``multihost``, ``preempt_sync``; image
logging (``save_image``) writes nothing.
"""

from __future__ import annotations

import os
import os.path as osp
import signal
import sys
import time
from typing import Dict, Optional

import numpy as np

from dusty_gan_torch import resolve_device, synchronize
from dusty_gan_torch.config import compose, run_dir_for, save_config
from dusty_gan_torch.train.logging import RunLogger
from dusty_gan_torch.train.trainer import Trainer
from dusty_gan_torch.utils import profiling

CLI_KEYS = ("total_iterations", "run_dir", "config_dir", "validate_samples", "device",
            "profile_dir")
NOT_PORTED = ("multihost", "preempt_sync")
CHUNK_CADENCES = ("save_stats", "test", "save_image", "save_model")


def main(argv=None, timings: Optional[Dict[str, float]] = None) -> str:
    """Returns the run directory.  ``timings``, when given, receives the
    wall seconds of the training loop (``train_s``, validation and saves
    included) and of the validations (``validation_s``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    extras, overrides = {}, []
    for ov in argv:
        key = ov.split("=", 1)[0]
        if key in NOT_PORTED:
            raise NotImplementedError(f"{key}= is not yet ported to dusty_gan_torch; "
                                      "use dusty_gan_tpu.cli.train for it")
        if key in CLI_KEYS:
            extras[key] = ov.split("=", 1)[1]
        else:
            overrides.append(ov)
    device = resolve_device(extras.get("device"))

    config_dir = extras.get("config_dir", osp.join(osp.dirname(__file__), "../../configs"))
    cfg = compose(osp.abspath(config_dir), overrides)
    if cfg.get("resume") and not osp.isabs(cfg.resume):
        cfg.resume = osp.abspath(cfg.resume)
    run_dir = extras.get("run_dir") or run_dir_for(cfg)
    models_dir = osp.join(run_dir, "models")
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

    trainer = Trainer(cfg, device)
    logger = RunLogger(run_dir, use_wandb=bool(cfg.get("publish_wandb")),
                       wandb_config=cfg.to_plain())
    print("run dir:", run_dir)
    total_iteration = int(int(cfg.solver.total_kimg) * 1000 / cfg.solver.batch_size)
    if "total_iterations" in extras:
        total_iteration = min(total_iteration, int(extras["total_iterations"]))
    val_samples = int(extras.get("validate_samples", 0)) or None
    profile_dir = extras.get("profile_dir")
    timings = {} if timings is None else timings
    timings.setdefault("validation_s", 0.0)
    imgs_per_iter = trainer.batch_size
    start = trainer.start_iteration
    last_log = [time.perf_counter(), start]

    def boundary_actions(i: int, scalars) -> None:
        """Stats, validation and checkpoint due at iteration ``i``."""
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
        if i % int(ckpt.test) == 0:
            t = time.perf_counter()
            scores = trainer.validation(max_samples=val_samples)
            timings["validation_s"] += time.perf_counter() - t
            logger.scalars({f"score/{k}": v for k, v in scores.items()}, step_imgs)
            print("validation:", {k: round(v, 4) for k, v in scores.items()
                                  if not k.startswith("1-nn-t")})
        if i % int(ckpt.save_model) == 0:
            print("saved:", trainer.save(models_dir, step_imgs))

    def stopped(i: int) -> bool:
        if stop_requested:
            path = trainer.save(models_dir, i * imgs_per_iter)
            print(f"SIGTERM: checkpointed at iteration {i}: {path}")
        return bool(stop_requested)

    stop_requested = []
    prev_handler = signal.signal(signal.SIGTERM, lambda signum, frame: stop_requested.append(signum))
    t_start = time.perf_counter()
    it = None
    try:
        if K > 1:
            ix = trainer.loader.index_stream(start)
            i = start
            while i < total_iteration:
                if stopped(i):
                    return run_dir
                k = min(K - i % K, total_iteration - i)
                rows = np.stack([trainer.device_cache.rows(*next(ix)) for _ in range(k)])
                scalars = trainer.step_chunk(range(i + 1, i + k + 1), rows)
                i += k
                boundary_actions(i, scalars)
        else:
            it = trainer.device_iter()
            prof = None
            for i in range(start + 1, total_iteration + 1):
                if stopped(i - 1):
                    return run_dir
                if profile_dir and i == start + 4:
                    prof = profiling.start_trace(device)
                scalars = trainer.step(i, next(it))
                if prof is not None and i == start + 8:
                    synchronize(device)
                    path = profiling.stop_trace(prof, profile_dir, f"train_{start + 4}-{i}")
                    prof = None
                    print("profile trace written to", path)
                    summary = profiling.summarize_trace(profile_dir, steps=4)
                    if summary is not None:
                        print(profiling.format_summary(summary))
                boundary_actions(i, scalars)
        print("saved final:", trainer.save(models_dir, total_iteration * imgs_per_iter))
        timings["train_s"] = time.perf_counter() - t_start
        return run_dir
    finally:
        if it is not None:
            it.close()
        logger.close()
        signal.signal(signal.SIGTERM, prev_handler)


if __name__ == "__main__":
    main()
