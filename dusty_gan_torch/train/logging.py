"""Scalar logging (``dusty_gan_tpu/train/logging.py``): always a
``scalars.jsonl`` in the run directory; TensorBoard events too when
``torch.utils.tensorboard`` imports, and wandb when asked for and it
imports.  Image logging is not ported."""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Optional


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

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
