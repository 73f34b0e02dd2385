"""Scalar and image logging (``dusty_gan_tpu/train/logging.py``): scalars
always to a ``scalars.jsonl`` in the run directory; scalars and images to
TensorBoard events when ``torch.utils.tensorboard`` imports, and to wandb
when asked for and it imports.  Images go to those two sinks only, as in
the JAX package: without either, ``image`` writes nothing."""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Optional

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 4, pad: int = 2) -> np.ndarray:
    """(B, H, W, C) -> one (H', W', C) image, ``nrow`` images a row with
    ``pad`` zero pixels around each."""
    b, h, w, c = images.shape
    rows = (b + nrow - 1) // nrow
    grid = np.zeros((rows * (h + pad) + pad, nrow * (w + pad) + pad, c), images.dtype)
    for i in range(b):
        r, col = divmod(i, nrow)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = images[i]
    return grid


class RunLogger:
    def __init__(self, run_dir: str, use_wandb: bool = False,
                 wandb_config: Optional[dict] = None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(osp.join(run_dir, "scalars.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                print("publish_wandb: wandb is not installed; logging to "
                      "scalars.jsonl only")
            else:
                wandb.init(project="dusty-gan-torch", config=wandb_config or {})
                self._wandb = wandb
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is not installed
            pass
        else:
            self._tb = SummaryWriter(log_dir=run_dir)

    def scalar(self, tag: str, value: float, step: int):
        value = float(value)
        self._jsonl.write(json.dumps({"t": time.time(), "step": step, tag: value}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._wandb is not None:
            self._wandb.log({tag: value}, step=step)

    def scalars(self, mapping: dict, step: int):
        for k, v in mapping.items():
            self.scalar(k, v, step)
        self._jsonl.flush()

    def image(self, tag: str, img_hwc: np.ndarray, step: int):
        """(H, W, C) values in [0, 1]."""
        img = np.clip(np.asarray(img_hwc, np.float32), 0, 1)
        if self._tb is not None:
            self._tb.add_image(tag, np.transpose(img, (2, 0, 1)), step)
        if self._wandb is not None:
            self._wandb.log({tag: self._wandb.Image(img)}, step=step)

    def image_grid(self, tag: str, batch_nhwc: np.ndarray, step: int, nrow: int = 4):
        self.image(tag, make_grid(np.asarray(batch_nhwc), nrow), step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
