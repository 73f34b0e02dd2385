"""DUSty-II over a StyleGAN2 generator, and StyleGAN2's residual
discriminator, plain: functions of a parameter dict, NCHW, float32.

StyleGAN2 is Karras et al., "Analyzing and Improving the Image Quality of
StyleGAN" (CVPR 2020, arXiv:1912.04958), config-f; the layer equations
follow NVlabs' stylegan2-ada-pytorch (``training/networks.py``).  The
parameters are keyed as the program names them (``backbone.mapping.fc0.
weight``, ...), so one dict of seeded weights serves both sides.

* equalized LR: a weight W is used as ``W * lr_mul / sqrt(fan_in)``, a
  bias b as ``b * lr_mul`` (lr_mul 0.01 in the mapping, 1 elsewhere);
* mapping: ``z * rsqrt(mean(z^2) + 1e-8)``, then layers of ``lrelu(x W^T +
  b, 0.2) * sqrt(2)``;
* ws (B, num_ws, w_dim): ``ws[:, i] = w(z)`` for i below the cutoff,
  ``w(z_mix)`` from it on (no mixing: the cutoff is num_ws);
* modulated convolution, literally: per sample the weight ``W * s`` over
  its input channels, demodulated by ``rsqrt(sum_{in,kh,kw} (W s)^2 +
  1e-8)`` a (sample, output channel), applied as one grouped convolution
  (groups = batch); the up-sampling one as a grouped transposed
  convolution of stride 2 and the FIR blur below;
* FIR resampling as NVlabs' ``upfirdn2d_ref``: zero insertion, padding,
  each channel correlated with the flipped [1, 3, 3, 1] outer product
  (sum 1) times the gain, every ``down``-th pixel kept; the correlation is
  written out as 16 shifted, weighted copies, where NVlabs calls a
  depthwise ``conv2d``: on the card, torch's double backward of that conv
  (R1 and the path length) runs one convolution a channel, and cuDNN's
  one-channel kernels took a minute for one blur;
* synthesis: a learned constant, per level (a 3x3 modulated conv, up-
  sampling after the first level) x 2, each followed by ``+ strength *
  noise``, ``+ bias``, lrelu; per level a skip output (1x1 modulated conv
  without demodulation, styles over sqrt(fan_in), bias), summed as
  ``up2(out) + toout(x)``; ``depth = tanh(out[:, :1])``, ``confidence =
  out[:, 1:3]``; DUSty-II's masks as ``models.generator`` takes them;
* D: FromRGB (1x1, bias, lrelu); blocks of [3x3 conv, bias, lrelu; blur
  pad 2, 3x3 stride-2 conv, bias, lrelu] beside [FIR down, 1x1 conv],
  ``(x + skip) / sqrt(2)``; minibatch stddev (groups of min(4, B), one
  channel); 3x3 conv, bias, lrelu; linear with lrelu; linear to the logit.

Departures from the published model (the configuration file's
``assumed``): the image is 64x256, so the constant is 4x16 and each level
takes config-f's width of the square level with the same pixel count;
zero padding as StyleGAN2 has it (no ring padding); no ``w_avg`` and no
truncation; a 3-channel skip output (depth, two confidences) that feeds
DUSty-II's masker; regularisation every step (``train_step_sg2.py``).
Weights as StyleGAN2 draws them, with biases N(0, 0.1) where it sets 0,
style biases 1 + N(0, 0.1) and noise strengths N(0, 0.1) where it sets 0,
so that every path carries work.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from gpubench.reference.models import hard_gumbel_sigmoid
from gpubench.reference.precision import FLOAT32, Precision

SQRT2 = math.sqrt(2.0)
Params = Dict[str, torch.Tensor]
BIAS_STD = 0.1


def _masker(model: dict) -> str:
    return str(model["gen"]["arch"]).split("/")[0]


def levels(model: dict) -> int:
    return len(model["gen"]["channels"])


def num_ws(model: dict) -> int:
    return 2 * levels(model)


def noise_shapes(model: dict, shape) -> List[Tuple[int, int]]:
    """(H, W) of each noise layer, in layer order."""
    n = levels(model)
    h0, w0 = shape[0] >> (n - 1), shape[1] >> (n - 1)
    out = [(h0, w0)]
    for lvl in range(1, n):
        out += [(h0 << lvl, w0 << lvl)] * 2
    return out


def generator_spec(model: dict, shape) -> List[Tuple[str, tuple, float, float]]:
    """(key, shape, std, mean) of every parameter of G, drawn N(mean, std)."""
    gen = model["gen"]
    pre = "backbone." if _masker(model) != "none" else ""
    z_dim, w_dim = int(gen["in_ch"]), int(gen["w_dim"])
    lr_mul = float(gen["mapping_lr_mul"])
    ch = [int(c) for c in gen["channels"]]
    out_ch = sum(int(v) for v in gen["out_ch"].values())
    spec = []
    dims = [z_dim] + [w_dim] * int(gen["mapping_layers"])
    for i in range(int(gen["mapping_layers"])):
        spec += [(f"{pre}mapping.fc{i}.weight", (dims[i + 1], dims[i]), 1.0 / lr_mul, 0.0),
                 (f"{pre}mapping.fc{i}.bias", (dims[i + 1],), BIAS_STD / lr_mul, 0.0)]
    n = len(ch)
    spec.append((f"{pre}synthesis.const", (ch[0], shape[0] >> (n - 1), shape[1] >> (n - 1)),
                 1.0, 0.0))

    def layer(key, cin, cout):
        return [(f"{key}.weight", (cout, cin, 3, 3), 1.0, 0.0),
                (f"{key}.noise_strength", (), BIAS_STD, 0.0),
                (f"{key}.bias", (cout,), BIAS_STD, 0.0),
                (f"{key}.affine.weight", (cin, w_dim), 1.0, 0.0),
                (f"{key}.affine.bias", (cin,), BIAS_STD, 1.0)]

    for lvl in range(n):
        key = f"{pre}synthesis.l{lvl}"
        if lvl > 0:
            spec += layer(f"{key}.conv0", ch[lvl - 1], ch[lvl])
        spec += layer(f"{key}.conv1", ch[lvl], ch[lvl])
        spec += [(f"{key}.torgb.weight", (out_ch, ch[lvl], 1, 1), 1.0, 0.0),
                 (f"{key}.torgb.bias", (out_ch,), BIAS_STD, 0.0),
                 (f"{key}.torgb.affine.weight", (ch[lvl], w_dim), 1.0, 0.0),
                 (f"{key}.torgb.affine.bias", (ch[lvl],), BIAS_STD, 1.0)]
    return spec


def discriminator_spec(model: dict, shape) -> List[Tuple[str, tuple, float, float]]:
    dis = model["dis"]
    ch = [int(c) for c in dis["channels"]]
    n = len(ch) - 1
    h, w = shape[0] >> n, shape[1] >> n
    fc = int(dis["fc_dim"])
    spec = [("fromrgb.weight", (ch[0], int(dis["in_ch"]), 1, 1), 1.0, 0.0),
            ("fromrgb.bias", (ch[0],), BIAS_STD, 0.0)]
    for i in range(n):
        spec += [(f"b{i}.conv0.weight", (ch[i], ch[i], 3, 3), 1.0, 0.0),
                 (f"b{i}.conv0.bias", (ch[i],), BIAS_STD, 0.0),
                 (f"b{i}.conv1.weight", (ch[i + 1], ch[i], 3, 3), 1.0, 0.0),
                 (f"b{i}.conv1.bias", (ch[i + 1],), BIAS_STD, 0.0),
                 (f"b{i}.skip.weight", (ch[i + 1], ch[i], 1, 1), 1.0, 0.0)]
    c = ch[-1]
    spec += [("epilogue.conv.weight", (c, c + int(dis["mbstd_channels"]), 3, 3), 1.0, 0.0),
             ("epilogue.conv.bias", (c,), BIAS_STD, 0.0),
             ("epilogue.fc.weight", (fc, c * h * w), 1.0, 0.0),
             ("epilogue.fc.bias", (fc,), BIAS_STD, 0.0),
             ("epilogue.out.weight", (1, fc), 1.0, 0.0),
             ("epilogue.out.bias", (1,), BIAS_STD, 0.0)]
    return spec


def make_params(spec, generator: torch.Generator, device) -> Params:
    """Seeded parameters for ``spec`` in one draw."""
    sizes = [math.prod(s) for _, s, _, _ in spec]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    out, off = {}, 0
    for (key, s, std, mean), n in zip(spec, sizes):
        out[key] = flat[off:off + n].view(s) * std + mean
        off += n
    return out


def _lrelu(x: torch.Tensor, gain: float = SQRT2) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x) * gain


def _linear(x, w, b, lr_mul: float = 1.0):
    return x @ (w * (lr_mul / math.sqrt(w.shape[1]))).t() + b * lr_mul


def fir_filter(device) -> torch.Tensor:
    f = torch.tensor([1.0, 3.0, 3.0, 1.0], device=device)
    f = torch.outer(f, f)
    return f / f.sum()


def upfirdn2d(x: torch.Tensor, f: torch.Tensor, up: int = 1, down: int = 1,
              pad=(0, 0, 0, 0), gain: float = 1.0) -> torch.Tensor:
    """NVlabs' ``upfirdn2d_ref`` for non-negative padding (left, right,
    top, bottom), its filter applied as the sum of the 2-D filter's
    shifted, weighted copies of the padded image."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h, 1, w, 1)
    x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1])
    x = x.reshape(b, c, h * up, w * up)
    x = F.pad(x, list(pad))
    k = f.flip([0, 1]) * gain
    kh, kw = k.shape
    oh, ow = x.shape[2] - kh + 1, x.shape[3] - kw + 1
    y = sum(k[i, j] * x[:, :, i:i + oh, j:j + ow] for i in range(kh) for j in range(kw))
    return y[:, :, ::down, ::down]


def modulated_conv(x, weight, styles, *, demodulate=True, up=False,
                   prec: Precision = FLOAT32) -> torch.Tensor:
    """The grouped per-sample-weight form: x (B, I, H, W), weight (O, I,
    k, k) already scaled, styles (B, I)."""
    b, i, h, w = x.shape
    o, _, kh, kw = weight.shape
    wt = weight[None] * styles[:, None, :, None, None]  # (B, O, I, k, k)
    if demodulate:
        wt = wt * torch.rsqrt(wt.square().sum(dim=(2, 3, 4)) + 1e-8)[:, :, None, None, None]
    x = prec.round(x).reshape(1, b * i, h, w)
    if up:
        wt = wt.transpose(1, 2).reshape(b * i, o, kh, kw)
        y = F.conv_transpose2d(x, prec.round(wt), stride=2, groups=b)
        y = y.reshape(b, o, *y.shape[2:])
        y = upfirdn2d(prec.round(y), fir_filter(x.device), pad=(1, 1, 1, 1), gain=4.0)
    else:
        y = F.conv2d(x, prec.round(wt.reshape(b * o, i, kh, kw)), padding=kh // 2, groups=b)
        y = y.reshape(b, o, *y.shape[2:])
    return prec.round(y)


def mapping(p: Params, z: torch.Tensor, model: dict) -> torch.Tensor:
    pre = "backbone." if _masker(model) != "none" else ""
    lr_mul = float(model["gen"]["mapping_lr_mul"])
    x = z * torch.rsqrt(z.square().mean(dim=1, keepdim=True) + 1e-8)
    for i in range(int(model["gen"]["mapping_layers"])):
        x = _lrelu(_linear(x, p[f"{pre}mapping.fc{i}.weight"], p[f"{pre}mapping.fc{i}.bias"],
                           lr_mul))
    return x


def ws_of(p: Params, z: torch.Tensor, style: Optional[dict], model: dict) -> torch.Tensor:
    """(B, num_ws, w_dim): w(z), mixed with w(z_mix) from the cutoff on."""
    n = num_ws(model)
    ws = mapping(p, z, model)[:, None].repeat(1, n, 1)
    if style is not None and style.get("z_mix") is not None:
        c = int(style["cutoff"])
        ws2 = mapping(p, style["z_mix"], model)
        ws = torch.cat([ws[:, :c], ws2[:, None].repeat(1, n - c, 1)], dim=1)
    return ws


def synthesis(p: Params, ws: torch.Tensor, noise: List[torch.Tensor], model: dict,
              prec: Precision = FLOAT32) -> torch.Tensor:
    """(B, num_ws, w_dim) -> (B, out channels, H, W) skip image."""
    pre = "backbone." if _masker(model) != "none" else ""
    fields = iter(noise)
    f = fir_filter(ws.device)
    x = p[f"{pre}synthesis.const"][None].repeat(ws.shape[0], 1, 1, 1)
    img = None

    def layer(key, x, w, up):
        wt = p[f"{key}.weight"]
        s = _linear(w, p[f"{key}.affine.weight"], p[f"{key}.affine.bias"])
        y = modulated_conv(x, wt / math.sqrt(wt[0].numel()), s, up=up, prec=prec)
        y = prec.round(y + p[f"{key}.noise_strength"] * next(fields))
        return prec.round(_lrelu(y + p[f"{key}.bias"].view(1, -1, 1, 1)))

    for lvl in range(levels(model)):
        key = f"{pre}synthesis.l{lvl}"
        if lvl > 0:
            x = layer(f"{key}.conv0", x, ws[:, 2 * lvl - 1], True)
        x = layer(f"{key}.conv1", x, ws[:, 2 * lvl], False)
        wt = p[f"{key}.torgb.weight"]
        s = _linear(ws[:, 2 * lvl + 1], p[f"{key}.torgb.affine.weight"],
                    p[f"{key}.torgb.affine.bias"]) / math.sqrt(wt[0].numel())
        y = modulated_conv(x, wt, s, demodulate=False, prec=prec)
        y = y + p[f"{key}.torgb.bias"].view(1, -1, 1, 1)
        img = y if img is None else upfirdn2d(img, f, up=2, pad=(2, 1, 2, 1), gain=4.0) + y
    return img


def generator(p: Params, z: Optional[torch.Tensor], style: dict, gumbel, model: dict,
              train: bool = True, prec: Precision = FLOAT32,
              ws: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """{"depth", "depth_orig", "confidence", "mask"} of DUSty-II (or the
    bare backbone's {"depth", "confidence"}); ``style``: {"z_mix",
    "cutoff", "noise"}; ``ws`` in z's place."""
    if ws is None:
        ws = ws_of(p, z, style, model)
    img = synthesis(p, ws, style["noise"], model, prec)
    out = {"depth": torch.tanh(img[:, :1]), "confidence": img[:, 1:]}
    masker = _masker(model)
    if masker == "none":
        return out
    if masker != "dusty2":
        raise ValueError(f"the StyleGAN2 reference takes DUSty-II's masker, not {masker!r}")
    tau = float(model["gen"].get("tau", 1.0))
    drop = float(model["gen"]["drop_const"])
    conf = out["confidence"]
    pix = hard_gumbel_sigmoid(conf[:, :1], gumbel["pixel"], tau)
    img_mask = (hard_gumbel_sigmoid(conf[:, 1:], gumbel["image"], tau) if train
                else (conf[:, 1:] > 0).to(conf.dtype))
    mask = pix * img_mask
    out["depth_orig"] = out["depth"]
    out["mask"] = torch.cat([pix, img_mask], dim=1)
    out["depth"] = mask * out["depth"] + (1.0 - mask) * drop
    return out


def _conv(x, w, prec: Precision, stride: int = 1, padding: int = 0):
    y = F.conv2d(prec.round(x), prec.round(w / math.sqrt(w[0].numel())), None, stride, padding)
    return prec.round(y)


def minibatch_stddev(x: torch.Tensor, group: int = 4, channels: int = 1) -> torch.Tensor:
    n, c, h, w = x.shape
    g = min(group, n)
    y = x.reshape(g, -1, channels, c // channels, h, w)
    y = (y - y.mean(dim=0)).square().mean(dim=0)
    y = (y + 1e-8).sqrt().mean(dim=(2, 3, 4))
    y = y.reshape(-1, channels, 1, 1).repeat(g, 1, h, w)
    return torch.cat([x, y], dim=1)


def discriminator(p: Params, x: torch.Tensor, model: dict,
                  prec: Precision = FLOAT32) -> torch.Tensor:
    """(B, 1, H, W) images -> (B,) float32 logits.  FromRGB, the minibatch
    stddev and the two linear layers stay in float32 in the program too."""
    dis = model["dis"]
    f = fir_filter(x.device)
    w = p["fromrgb.weight"]
    h = _lrelu(F.conv2d(x.float(), w / math.sqrt(w[0].numel()))
               + p["fromrgb.bias"].view(1, -1, 1, 1))
    half = math.sqrt(0.5)
    for i in range(len(dis["channels"]) - 1):
        skip = _conv(upfirdn2d(prec.round(h), f, down=2, pad=(1, 1, 1, 1)),
                     p[f"b{i}.skip.weight"], prec) * half
        h = prec.round(_lrelu(_conv(h, p[f"b{i}.conv0.weight"], prec, padding=1)
                              + p[f"b{i}.conv0.bias"].view(1, -1, 1, 1)))
        hb = prec.round(upfirdn2d(h, f, pad=(2, 2, 2, 2)))
        h = prec.round(_lrelu(_conv(hb, p[f"b{i}.conv1.weight"], prec, stride=2)
                              + p[f"b{i}.conv1.bias"].view(1, -1, 1, 1), SQRT2 * half))
        h = prec.round(skip + h)
    h = minibatch_stddev(h.float(), int(dis["mbstd_group"]), int(dis["mbstd_channels"]))
    h = prec.round(_lrelu(_conv(h, p["epilogue.conv.weight"], prec, padding=1)
                          + p["epilogue.conv.bias"].view(1, -1, 1, 1)))
    h = _lrelu(_linear(h.float().flatten(1), p["epilogue.fc.weight"], p["epilogue.fc.bias"]))
    return _linear(h, p["epilogue.out.weight"], p["epilogue.out.bias"]).reshape(-1)
