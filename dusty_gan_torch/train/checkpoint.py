"""Checkpoints in the reference's ``.pth`` format
(``dusty_gan_tpu/train/checkpoint.py``, ``utils/torch_export.py``).

``{step, G, D, G_ema, optim_G, optim_D, pl_ema}`` as the reference trainer
saves it: state dicts with the reference keys, ``torch.optim.Adam`` state
dicts whose parameter indices follow ``named_parameters()`` (the
reference's order), the image-step counter; plus the run's ``seed``, from
which every draw of an iteration derives, so a resume replays the
uninterrupted run.  The JAX package imports the file
(``train_state_from_torch``) and writes it
(``save_reference_checkpoint``); the port resumes from either.  Writes go
to a temporary file renamed into place.

A run trained in CUDA-graph chunks keeps Adam in its capturable mode
(``train/state.py::make_capturable``); its file is written as a per-step
run's (``capturable`` off, the step counts on the CPU), so that either
mode, and the JAX package, resumes from it.  Loading is in place, before
any capture.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import torch

from dusty_gan_torch.train.state import TrainState


def checkpoint_name(images_seen: int) -> str:
    """The reference's name: checkpoint_0025000000.pth."""
    return f"checkpoint_{images_seen:010d}.pth"


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_cpu(v) for v in obj]
    return obj


def _optimizer_state_dict(optimizer: torch.optim.Optimizer) -> dict:
    sd = optimizer.state_dict()
    sd["param_groups"] = [{**g, "capturable": False} for g in sd["param_groups"]]
    return sd


def save_checkpoint(path: str, state: TrainState, seed: int) -> str:
    payload = _cpu({
        "step": int(state.step),
        "G": state.G.state_dict(),
        "D": state.D.state_dict(),
        "G_ema": state.G_ema.state_dict(),
        "optim_G": _optimizer_state_dict(state.opt_G),
        "optim_D": _optimizer_state_dict(state.opt_D),
        "pl_ema": state.pl_ema,
        "seed": int(seed),
    })
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, state: TrainState) -> Optional[int]:
    """Load a reference-format ``.pth`` into ``state`` (strictly); returns
    the run seed it carries, None for a file without one (the JAX
    package's export, a reference run)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.G.load_state_dict(ckpt["G"], strict=True)
    state.D.load_state_dict(ckpt["D"], strict=True)
    state.G_ema.load_state_dict(ckpt["G_ema"], strict=True)
    state.opt_G.load_state_dict(ckpt["optim_G"])
    state.opt_D.load_state_dict(ckpt["optim_D"])
    pl = ckpt.get("pl_ema")
    state.pl_ema.copy_(torch.as_tensor(0.0 if pl is None else pl,
                                       dtype=torch.float32).reshape(()))
    state.step = int(ckpt["step"])
    seed = ckpt.get("seed")
    return None if seed is None else int(seed)
