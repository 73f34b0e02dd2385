"""Training on one GPU (``dusty_gan_tpu/cli/train.py``):

    python -m dusty_gan_torch.cli.train dataset=kitti_odometry \\
        model=dusty2_dcgan_eqlr solver=nsgan_eqlr [key=value ...] [device=cuda]

The reference's ``key=value`` overrides, plus the CLI-only keys
``total_iterations=N`` (cap the run), ``run_dir=…`` (fix the output
directory; default ``outputs/logs/dataset=…/model=…/solver=…/<date>/
<time>``), ``config_dir=…``, ``validate_samples=N`` (val scans scored per
validation; default all) and ``device=`` (default ``cuda``; a run without a
visible GPU raises unless ``device=cpu``).

Writes ``.hydra/config.yaml``, ``scalars.jsonl`` (every
``solver.checkpoint.save_stats`` iterations and at iteration 1, with
``perf/scans_per_sec``; ``score/*`` at every ``test``), and
``models/checkpoint_<images>.pth`` at every ``save_model`` and at the end.
SIGTERM checkpoints at the next iteration boundary and returns.  Not yet
ported, each raising: ``multihost``, ``preempt_sync``, ``profile_dir``,
``cache_device=true``, ``steps_per_call>1``, ``transfer_dtype``; image
logging (``save_image``) writes nothing.
"""

from __future__ import annotations

import os
import os.path as osp
import signal
import sys
import time
from typing import Dict, Optional

from dusty_gan_torch import resolve_device
from dusty_gan_torch.config import compose, run_dir_for, save_config
from dusty_gan_torch.train.logging import RunLogger
from dusty_gan_torch.train.trainer import Trainer

CLI_KEYS = ("total_iterations", "run_dir", "config_dir", "validate_samples", "device")
NOT_PORTED = ("multihost", "preempt_sync", "profile_dir")


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

    trainer = Trainer(cfg, device)
    logger = RunLogger(run_dir, use_wandb=bool(cfg.get("publish_wandb")),
                       wandb_config=cfg.to_plain())
    print("run dir:", run_dir)
    total_iteration = int(int(cfg.solver.total_kimg) * 1000 / cfg.solver.batch_size)
    if "total_iterations" in extras:
        total_iteration = min(total_iteration, int(extras["total_iterations"]))
    val_samples = int(extras.get("validate_samples", 0)) or None
    ckpt = cfg.solver.checkpoint
    timings = {} if timings is None else timings
    timings.setdefault("validation_s", 0.0)
    imgs_per_iter = trainer.batch_size

    stop_requested = []
    prev_handler = signal.signal(signal.SIGTERM, lambda signum, frame: stop_requested.append(signum))
    t_last = t_start = time.perf_counter()
    it = trainer.loader.iter_from(trainer.start_iteration)
    try:
        for i in range(trainer.start_iteration + 1, total_iteration + 1):
            if stop_requested:
                path = trainer.save(models_dir, (i - 1) * imgs_per_iter)
                print(f"SIGTERM: checkpointed at iteration {i - 1}: {path}")
                return run_dir
            scalars = trainer.step(i, next(it))
            step_imgs = i * imgs_per_iter
            if i % int(ckpt.save_stats) == 0 or i == 1:
                values = {k: float(v) for k, v in scalars.items()}  # waits for the step
                now = time.perf_counter()
                sps = imgs_per_iter * int(ckpt.save_stats) / (now - t_last) if i > 1 else 0.0
                t_last = now
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
        print("saved final:", trainer.save(models_dir, total_iteration * imgs_per_iter))
        timings["train_s"] = time.perf_counter() - t_start
        return run_dir
    finally:
        it.close()
        logger.close()
        signal.signal(signal.SIGTERM, prev_handler)


if __name__ == "__main__":
    main()
