"""DUSty generator and discriminator over the equalized-learning-rate DCGAN
backbone, as functions of a parameter dict (NCHW, float32).

Parameters are keyed as in the published checkpoints (``backbone.0.0.
module.weight``, ...), so one dict of seeded weights serves the reference
and the program alike.  The layer equations:

* equalized LR: weights are N(0, 1) and multiplied at run time by
  ``1 / sqrt(weight[0].numel())`` (for a transposed convolution, whose
  weight is (in, out, kh, kw), that is out * kh * kw: the published code's
  fan-in);
* activation: ``leaky_relu(x + bias, 0.2) * sqrt(2)``;
* ring padding: circular along the azimuth (W), reflect along the rings (H),
  W first;
* G: z as a (B, I, 1, 1) map through a transposed convolution of kernel
  (H/16, W/16), then three (ring pad 1, transposed conv k4 s2 p3) blocks
  halving the channels from ``ch_max``, then one such head per output
  (``depth`` through tanh, ``confidence``);
* DUSty maskers: a hard Gumbel-sigmoid (threshold 0.5 after
  ``sigmoid((logit + noise) / tau)``, straight through) per pixel; DUSty-II
  multiplies a second mask whose noise is drawn per image, and at
  evaluation takes ``logit > 0`` for it; dropped pixels take ``drop_const``;
* D: [1, 2, 1] / 4 blurs along H (reflect) and W (circular), concatenated;
  four (ring pad 1, conv k4 s2) blocks; a logit conv of kernel (H/16, W/16)
  with a bias.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from gpubench.reference.precision import FLOAT32, Precision

SQRT2 = math.sqrt(2.0)
Params = Dict[str, torch.Tensor]


def _ch(i: int, base: int, cmax: int) -> int:
    return min(base << i, cmax)


def _masker(model: dict) -> str:
    return str(model["gen"]["arch"]).split("/")[0]


def generator_spec(model: dict, shape) -> List[Tuple[str, tuple]]:
    """(key, shape) of every parameter of G."""
    gen = model["gen"]
    b, m, i_ch = int(gen["ch_base"]), int(gen["ch_max"]), int(gen["in_ch"])
    pre = "backbone." if _masker(model) != "none" else ""
    h0, w0 = shape[0] >> 4, shape[1] >> 4
    spec = [(f"{pre}0.0.module.weight", (i_ch, _ch(3, b, m), h0, w0)),
            (f"{pre}0.1.bias", (_ch(3, b, m),))]
    for idx, i in enumerate((2, 1, 0)):
        spec += [(f"{pre}{idx + 1}.1.module.weight", (_ch(i + 1, b, m), _ch(i, b, m), 4, 4)),
                 (f"{pre}{idx + 1}.2.bias", (_ch(i, b, m),))]
    for name, out in gen["out_ch"].items():
        spec += [(f"{pre}4.heads.{name}.1.module.weight", (_ch(0, b, m), int(out), 4, 4)),
                 (f"{pre}4.heads.{name}.1.module.bias", (int(out),))]
    return spec


def discriminator_spec(model: dict, shape) -> List[Tuple[str, tuple]]:
    """(key, shape) of every parameter of D."""
    dis = model["dis"]
    b, m = int(dis["ch_base"]), int(dis["ch_max"])
    in_chs = (2 * int(dis["in_ch"]), _ch(0, b, m), _ch(1, b, m), _ch(2, b, m))
    spec = []
    for i in range(4):
        spec += [(f"{i + 1}.1.module.weight", (_ch(i, b, m), in_chs[i], 4, 4)),
                 (f"{i + 1}.2.bias", (_ch(i, b, m),))]
    spec += [("5.module.weight", (1, _ch(3, b, m), shape[0] >> 4, shape[1] >> 4)),
             ("5.module.bias", (1,))]
    return spec


def make_params(spec, generator: torch.Generator, device, bias_std: float = 0.1) -> Params:
    """Seeded weights for ``spec`` in one draw: weights N(0, 1), as the
    equalized-LR layers initialise them, and biases N(0, ``bias_std``), so
    that the bias paths carry work."""
    sizes = [math.prod(s) for _, s in spec]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    out, off = {}, 0
    for (key, s), n in zip(spec, sizes):
        t = flat[off:off + n].view(s)
        out[key] = t * bias_std if key.endswith("bias") else t
        off += n
    return out


def ring_pad(x: torch.Tensor, p: int = 1) -> torch.Tensor:
    x = F.pad(x, (p, p, 0, 0), mode="circular")
    return F.pad(x, (0, 0, p, p), mode="reflect")


def _act(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    y = x + bias.view(1, -1, 1, 1)
    return torch.where(y >= 0, y, 0.2 * y) * SQRT2


def _scaled(w: torch.Tensor) -> torch.Tensor:
    return w / math.sqrt(w[0].numel())


def _convt(x, w, prec: Precision):
    y = F.conv_transpose2d(prec.round(x), prec.round(_scaled(w)), None, 2, 3)
    return prec.round(y)


def _conv(x, w, prec: Precision, stride: int = 2):
    y = F.conv2d(prec.round(x), prec.round(_scaled(w)), None, stride)
    return prec.round(y)


def backbone(p: Params, z: torch.Tensor, model: dict, shape,
             prec: Precision = FLOAT32) -> Dict[str, torch.Tensor]:
    """(B, I) latents -> {"depth": tanh output, "confidence": logits}."""
    pre = "backbone." if _masker(model) != "none" else ""
    h0, w0 = shape[0] >> 4, shape[1] >> 4
    w = prec.round(_scaled(p[f"{pre}0.0.module.weight"]))
    h = prec.round(prec.round(z) @ w.reshape(w.shape[0], -1))
    h = prec.round(_act(h.reshape(z.shape[0], -1, h0, w0), p[f"{pre}0.1.bias"]))
    for idx in (1, 2, 3):
        h = _convt(ring_pad(h), p[f"{pre}{idx}.1.module.weight"], prec)
        h = prec.round(_act(h, p[f"{pre}{idx}.2.bias"]))
    out = {}
    for name in model["gen"]["out_ch"]:
        y = _convt(ring_pad(h), p[f"{pre}4.heads.{name}.1.module.weight"], prec)
        out[name] = prec.round(y + p[f"{pre}4.heads.{name}.1.module.bias"].view(1, -1, 1, 1))
    out["depth"] = torch.tanh(out["depth"])
    return out


def hard_gumbel_sigmoid(logits, noise, tau: float = 1.0) -> torch.Tensor:
    soft = torch.sigmoid((logits + noise) / tau)
    hard = (soft > 0.5).to(soft.dtype)
    return hard - soft.detach() + soft


def generator(p: Params, z: torch.Tensor, noise, model: dict, shape, train: bool = True,
              prec: Precision = FLOAT32) -> Dict[str, torch.Tensor]:
    """DUSty (or plain) G: {"depth", "depth_orig", "confidence", "mask"}.
    ``noise``: DUSty-I a (B, 1, H, W) logistic field, DUSty-II {"pixel":
    (B, 1, H, W), "image": (B, 1, 1, 1)}."""
    out = backbone(p, z, model, shape, prec)
    masker = _masker(model)
    if masker == "none":
        return out
    tau = float(model["gen"].get("tau", 1.0))
    drop = float(model["gen"]["drop_const"])
    conf = out["confidence"]
    if masker == "dusty1":
        mask = hard_gumbel_sigmoid(conf, noise, tau)
        masks = mask
    elif masker == "dusty2":
        pix = hard_gumbel_sigmoid(conf[:, :1], noise["pixel"], tau)
        img = (hard_gumbel_sigmoid(conf[:, 1:], noise["image"], tau) if train
               else (conf[:, 1:] > 0).to(conf.dtype))
        masks, mask = torch.cat([pix, img], dim=1), pix * img
    else:
        raise ValueError(f"unknown masker {masker!r}")
    out["depth_orig"] = out["depth"]
    out["mask"] = masks
    out["depth"] = mask * out["depth"] + (1.0 - mask) * drop
    return out


def _blur3(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim] - 2
    return (0.25 * x.narrow(dim, 0, n) + 0.5 * x.narrow(dim, 1, n)
            + 0.25 * x.narrow(dim, 2, n))


def discriminator(p: Params, x: torch.Tensor, prec: Precision = FLOAT32) -> torch.Tensor:
    """(B, 1, H, W) images -> (B,) float32 logits.  The blur, the first
    block and the logit stay in float32 in the program too."""
    x = x.float()
    v = _blur3(F.pad(x, (0, 0, 1, 1), mode="reflect"), 2)
    hz = _blur3(F.pad(x, (1, 1, 0, 0), mode="circular"), 3)
    h = torch.cat([v, hz], dim=1)
    h = _act(F.conv2d(ring_pad(h), _scaled(p["1.1.module.weight"]), None, 2), p["1.2.bias"])
    for i in (2, 3, 4):
        h = prec.round(_act(_conv(ring_pad(h), p[f"{i}.1.module.weight"], prec),
                            p[f"{i}.2.bias"]))
    y = F.conv2d(h, _scaled(p["5.module.weight"])) + p["5.module.bias"].view(1, -1, 1, 1)
    return y.reshape(-1)
