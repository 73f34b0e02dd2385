"""Checkpoint + config -> (cfg, G, lidar, fixed noise) for evaluation
(``dusty_gan_tpu/utils/setup.py``).

Weights come from a reference-format ``.pth`` (its ``G_ema``) or from the
JAX package's native ``.ckpt`` (its ``params_G_ema``, read without JAX by
``utils/jax_checkpoint.py``).  The fixed Gumbel noise, one frozen
logistic field per Gumbel module shared by every evaluated sample, is
drawn on the CPU from a seeded generator so every device sees the same
field.
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, Optional, Tuple

import torch

from dusty_gan_torch.config import Config, load_config
from dusty_gan_torch.geometry.lidar import Lidar
from dusty_gan_torch.models.dusty import DUSty1, DUSty2
from dusty_gan_torch.models.factory import define_G
from dusty_gan_torch.ops.gumbel import logistic_noise
from dusty_gan_torch.utils.jax_checkpoint import read_jax_checkpoint
from dusty_gan_torch.utils.weights import generator_state_dict, load_reference_checkpoint

FIXED_NOISE_SEED = 0x501


def make_fixed_noise(G, shape, seed: int = FIXED_NOISE_SEED, device="cpu"):
    """None, a (1, 1, H, W) field (DUSty-I) or {"pixel": (1, 1, H, W),
    "image": (1, 1, 1, 1)} (DUSty-II)."""
    g = torch.Generator().manual_seed(seed)
    if isinstance(G, DUSty1):
        return logistic_noise(g, 1, shape, pixelwise=True).to(device)
    if isinstance(G, DUSty2):
        return {
            "pixel": logistic_noise(g, 1, shape, pixelwise=True).to(device),
            "image": logistic_noise(g, 1, shape, pixelwise=False).to(device),
        }
    return None


def setup(model_path: str, config_path: str,
          device) -> Tuple[Config, torch.nn.Module, Lidar, Optional[object]]:
    """Returns (cfg, the EMA generator on ``device`` in eval mode with its
    parameters frozen, lidar, fixed_noise).  Frozen parameters build no
    graph for G's weights: the generator's output carries a gradient only
    for a latent that asks for one (GAN inversion), as the reference's
    ``set_requires_grad(G, False)``."""
    if not osp.exists(model_path):
        raise FileNotFoundError(f"model checkpoint not found: {model_path}")
    if not osp.exists(config_path):
        raise FileNotFoundError(f"config not found: {config_path}")
    if not model_path.endswith((".pth", ".ckpt")):
        raise ValueError(
            f"{model_path}: dusty_gan_torch loads a reference-format .pth or the "
            "JAX package's native .ckpt")
    cfg = load_config(config_path)
    cfg.model.gen.shape = list(cfg.dataset.shape)
    cfg.model.dis.shape = list(cfg.dataset.shape)

    G = define_G(cfg)
    if model_path.endswith(".ckpt"):
        state = read_jax_checkpoint(model_path)["state"]
        sd = generator_state_dict(state["params_G_ema"], str(cfg.model.gen.arch),
                                  float(cfg.model.gen.drop_const))
        step, kind = int(state["step"]), "JAX .ckpt"
    else:
        (sd, step), kind = load_reference_checkpoint(model_path, "G_ema"), "reference .pth"
    G.load_state_dict(sd, strict=True)
    G = G.to(device).eval().requires_grad_(False)
    print(f"#images: {step} ({kind})")

    angle_file = None
    for cand in ("angles.npy", "angles.pt"):
        p = osp.join(str(cfg.dataset.root), cand)
        if osp.exists(p):
            angle_file = p
            break
    if angle_file is None:
        raise FileNotFoundError(f"angles file missing under {cfg.dataset.root}")
    lidar = Lidar.from_angle_file(angle_file, tuple(cfg.dataset.shape),
                                  cfg.dataset.min_depth, cfg.dataset.max_depth,
                                  device=device)
    fixed_noise = make_fixed_noise(G, tuple(cfg.dataset.shape), device=device)
    return cfg, G, lidar, fixed_noise


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def make_eval_generator(G, fixed_noise, compute_dtype=torch.bfloat16):
    """latent (B, I) -> output dict in (B, H, W, C) layout, deterministic:
    fixed noise, eval thresholds.  The convolutions run in
    ``compute_dtype`` (None = float32); tanh, the Gumbel masks and the
    composite run in float32.  ``threshold`` is the Gumbel keep threshold
    (reference default 0.5).  Autograd is left as the caller has it: with
    G frozen (``setup``) the output carries a gradient for the latent
    alone, and only when the latent asks for one."""
    masked = isinstance(G, (DUSty1, DUSty2))

    def gen(z, threshold: float = 0.5) -> Dict[str, torch.Tensor]:
        if masked:
            out = G(z, compute_dtype=compute_dtype, train=False,
                    threshold=threshold, fixed_noise=fixed_noise)
        else:
            out = G(z, compute_dtype=compute_dtype)
        return {k: _nhwc(v) for k, v in out.items()}

    return gen
