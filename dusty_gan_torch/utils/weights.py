"""Carry generator weights into the port.

The port's modules use the reference ``.pth`` state-dict keys, so weights
arrive either as a reference-format ``.pth`` (``{"G", "G_ema", "step",
...}``; ``python -m dusty_gan_tpu.cli.export_pth`` writes one from a native
JAX ``.ckpt``) or as a JAX parameter tree (a nested dict of arrays), which
``generator_state_dict`` maps to the same keys and layouts:

  proj/kernel (h0,w0,I,O)                    -> 0.0.module.weight (I,O,h0,w0)
  proj_act/bias                              -> 0.1.bias
  up{0,1,2}/EqualLRConvTranspose_0/kernel    -> {1,2,3}.1.module.weight
  up{0,1,2}/FusedLeakyReLU_0/bias            -> {1,2,3}.2.bias
  head/head_<k>/{kernel,bias}                -> 4.heads.<k>.1.module.{weight,bias}

DUSty models prefix the backbone with ``backbone.``, add the ``drop_const``
buffer and, with a learnable temperature, ``gumbel*.weight``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _convt(w) -> torch.Tensor:  # (kh, kw, I, O) -> torch ConvT (I, O, kh, kw)
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w, np.float32), (2, 3, 0, 1))))


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


def load_reference_checkpoint(path: str, which: str = "G_ema") -> Tuple[Dict, int]:
    """(state dict ``which`` of a reference-format .pth, its image step)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if which not in ckpt:
        raise KeyError(f"{path} has no '{which}' entry (keys: {sorted(ckpt)})")
    return ckpt[which], int(ckpt.get("step", 0))
