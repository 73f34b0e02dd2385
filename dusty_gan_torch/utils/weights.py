"""Carry weights and optimizer state into the port.

The port's modules use the reference ``.pth`` state-dict keys, so weights
arrive either as a reference-format ``.pth`` (``{"G", "G_ema", "step",
...}``, as the port's trainer, the reference trainer and the JAX package's
``export_pth`` write it) or as a JAX parameter tree (a nested dict of
arrays: a native JAX ``.ckpt`` read by ``utils/jax_checkpoint.py``, which
``python -m dusty_gan_torch.cli.export_pth`` turns into a ``.pth``), which
``generator_state_dict`` maps to the same keys and layouts:

  proj/kernel (h0,w0,I,O)                    -> 0.0.module.weight (I,O,h0,w0)
  proj_act/bias                              -> 0.1.bias
  up{0,1,2}/EqualLRConvTranspose_0/kernel    -> {1,2,3}.1.module.weight
  up{0,1,2}/FusedLeakyReLU_0/bias            -> {1,2,3}.2.bias
  head/head_<k>/{kernel,bias}                -> 4.heads.<k>.1.module.{weight,bias}

DUSty models prefix the backbone with ``backbone.``, add the ``drop_const``
buffer and, with a learnable temperature, ``gumbel*.weight``.
``discriminator_state_dict`` maps a JAX discriminator tree the same way:

  down{0..3}/EqualLRConv_0/kernel (4,4,I,O)  -> {1..4}.1.module.weight (O,I,4,4)
  down{0..3}/FusedLeakyReLU_0/bias           -> {1..4}.2.bias
  final/{kernel,bias}                        -> 5.module.{weight,bias}

plus the BlurVH filter buffers.  ``adam_state_dict`` turns Adam moments
(optax's mu, nu and count, mapped to state dicts by the same functions)
into a ``torch.optim.Adam`` state dict.  With ``train/checkpoint.py`` this
module is the port's counterpart of the JAX package's
``utils/torch_import.py`` and of ``utils/torch_export.py``'s writing half.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _convt(w) -> torch.Tensor:  # (kh, kw, I, O) -> torch ConvT (I, O, kh, kw)
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w, np.float32), (2, 3, 0, 1))))


def _conv(w) -> torch.Tensor:  # HWIO -> torch conv (O, I, kh, kw)
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))))


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def backbone_state_dict(params: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    p = prefix
    sd = {
        f"{p}0.0.module.weight": _convt(params["proj"]["kernel"]),
        f"{p}0.1.bias": _f32(params["proj_act"]["bias"]),
    }
    for i in range(3):
        up = params[f"up{i}"]
        sd[f"{p}{i + 1}.1.module.weight"] = _convt(up["EqualLRConvTranspose_0"]["kernel"])
        sd[f"{p}{i + 1}.2.bias"] = _f32(up["FusedLeakyReLU_0"]["bias"])
    # heads in the reference's out_ch order: depth, confidence, then others
    known = [n for n in ("depth", "confidence") if f"head_{n}" in params["head"]]
    extra = sorted(k[len("head_"):] for k in params["head"]
                   if k[len("head_"):] not in known)
    for name in known + extra:
        head = params["head"][f"head_{name}"]
        sd[f"{p}4.heads.{name}.1.module.weight"] = _convt(head["kernel"])
        sd[f"{p}4.heads.{name}.1.module.bias"] = _f32(head["bias"])
    return sd


def generator_state_dict(params: Dict, arch: str,
                         drop_const: float = -1.0) -> Dict[str, torch.Tensor]:
    """JAX generator parameter tree -> the port's (and the reference's)
    generator state dict, for ``load_state_dict(strict=True)``."""
    masker = arch.split("/")[0]
    p = params["params"] if "params" in params else params
    if masker == "none":
        return backbone_state_dict(p)
    sd = {"drop_const": _f32(drop_const).reshape(())}
    sd.update(backbone_state_dict(p["backbone"], prefix="backbone."))
    mods = {"dusty1": ("gumbel",), "dusty2": ("gumbel_pixel", "gumbel_image")}
    for mod in mods.get(masker, ()):
        if mod in p:
            sd[f"{mod}.weight"] = _f32(p[mod]["weight"]).reshape(())
    return sd


def discriminator_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX discriminator parameter tree -> the port's (and the reference's)
    discriminator state dict, with the [1,2,1]/4 blur buffers."""
    p = params["params"] if "params" in params else params
    taps = torch.tensor([0.25, 0.5, 0.25])
    sd = {"0.blur_v.kernel": taps.reshape(1, 1, 3, 1).clone(),
          "0.blur_h.kernel": taps.reshape(1, 1, 1, 3).clone()}
    for i in range(4):
        down = p[f"down{i}"]
        sd[f"{i + 1}.1.module.weight"] = _conv(down["EqualLRConv_0"]["kernel"])
        sd[f"{i + 1}.2.bias"] = _f32(down["FusedLeakyReLU_0"]["bias"])
    sd["5.module.weight"] = _conv(p["final"]["kernel"])
    sd["5.module.bias"] = _f32(p["final"]["bias"])
    return sd


def adam_state_dict(names, mu_sd: Dict, nu_sd: Dict, count: int,
                    lr: float, betas: Tuple[float, float], eps: float = 1e-8) -> Dict:
    """A ``torch.optim.Adam`` state dict over the parameters ``names`` (in
    ``named_parameters()`` order, which the indices follow), as the JAX
    package's ``torch_export.adam_state_dict`` writes it: ``mu_sd`` / ``nu_sd``
    hold the first and second moments keyed like the module's state dict (a
    moment tree mapped by the same function as the weights), ``count`` the
    updates made, stored as each parameter's int ``step``."""
    state = {i: {"step": int(count),
                 "exp_avg": torch.as_tensor(mu_sd[n], dtype=torch.float32).clone(),
                 "exp_avg_sq": torch.as_tensor(nu_sd[n], dtype=torch.float32).clone()}
             for i, n in enumerate(names)}
    group = {"lr": float(lr), "betas": tuple(float(b) for b in betas), "eps": float(eps),
             "weight_decay": 0.0, "amsgrad": False, "maximize": False, "foreach": None,
             "capturable": False, "differentiable": False, "fused": None,
             "params": list(range(len(names)))}
    return {"state": state, "param_groups": [group]}


def load_reference_checkpoint(path: str, which: str = "G_ema") -> Tuple[Dict, int]:
    """(state dict ``which`` of a reference-format .pth, its image step)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if which not in ckpt:
        raise KeyError(f"{path} has no '{which}' entry (keys: {sorted(ckpt)})")
    return ckpt[which], int(ckpt.get("step", 0))
