"""StyleGAN2 (Karras et al., CVPR 2020, config-f) as a backbone for LiDAR
range images, NCHW, with its residual discriminator.  Training follows
NVlabs' PyTorch port (stylegan2-ada-pytorch ``training/networks.py``).

Equalized learning rate throughout: a weight is stored N(0, 1) / lr_mul
and scaled at run time by lr_mul / sqrt(fan_in); a bias is stored
init / lr_mul and scaled by lr_mul (lr_mul 0.01 in the mapping, 1
elsewhere).

Generator (``Generator``):

* mapping: z (B, z_dim) -> ``z * rsqrt(mean(z^2) + 1e-8)`` -> ``layers`` x
  [EqualLinear, lrelu(0.2) * sqrt(2)] -> w (B, w_dim), in float32;
* ws (B, num_ws, w_dim), num_ws = 2 * levels: w broadcast, or with style
  mixing (``StyleDraws``: a second latent and a cutoff c, a 0-d device
  tensor) ``ws[:, i] = w(z)`` for i < c and ``w(z_mix)`` after;
* synthesis over ``len(channels)`` levels, the first at (H, W) / 2^(levels
  - 1): a learned constant and one modulated 3x3 conv; each later level an
  up-sampling modulated conv (``ops/modulated.py``: transposed, stride 2,
  FIR [1, 3, 3, 1]) and a modulated 3x3 conv.  After each conv ``+
  strength * noise`` (noise (B, 1, H, W), one scalar strength a layer),
  ``+ bias``, lrelu(0.2) * sqrt(2).  Each level's skip output is a
  modulated 1x1 conv without demodulation (its styles times 1 /
  sqrt(fan_in)) plus a bias, summed as ``up2(out) + toout(x)`` in float32;
  ``depth = tanh(out[:, :1])``, the rest of the channels are the maskers'
  ``confidence`` (``out_ch``).  Style affines are EqualLinear w_dim -> C_in
  with their biases initialised to 1.  Layer ws: level 0 conv ws[0], skip
  ws[1]; level l > 0 conv0 ws[2l - 1], conv1 ws[2l], skip ws[2l + 1].

The noise of each layer is given (``StyleDraws.noise``, the train step's
draws) or, when absent, the layer's ``noise_const`` buffer (StyleGAN2's
``noise_mode="const"``), so evaluation is deterministic.

Discriminator (``Discriminator``), residual: FromRGB (1x1 conv, bias,
lrelu) to ``channels[0]``; per level a block [3x3 conv C_i -> C_i; FIR
blur + 3x3 stride-2 conv C_i -> C_(i+1)] beside a skip [FIR down + 1x1
conv, no bias], ``(x + skip) / sqrt(2)``; then minibatch stddev (groups
of min(``mbstd_group``, B), one channel), a 3x3 conv C + 1 -> C, a linear
layer C*h*w -> ``fc_dim`` with lrelu, and one to the logit.

Precision (``compute_dtype``): the convolutions (``ops/conv.py``'s, whose
double backward forms its weight terms on cuDNN's wgrad) run in it (bf16
under amp); the mapping, the styles, the demodulation coefficients, the skip
image, D's FromRGB, its minibatch stddev and its two linear layers run in
float32.

Tracer spans ``g.mapping`` and ``g.synthesis``; counters ``g.modconv`` (a
modulated conv call, 3 * levels - 1 a forward) and ``g.mixed_rows`` (rows
whose ws cross over; counted only while the tracer is on and no CUDA
graph captures, since it reads the cutoff on the host).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from dusty_gan_torch.ops import conv
from dusty_gan_torch.ops.activation import fused_leaky_relu
from dusty_gan_torch.ops.modulated import modulated_conv2d
from dusty_gan_torch.ops.upfirdn import downsample2d, setup_filter, upfirdn2d, upsample2d
from dusty_gan_torch.utils import profiling

SQRT2 = math.sqrt(2.0)


@dataclasses.dataclass
class StyleDraws:
    """The draws of a StyleGAN2 generator call for a batch of b: the mixing
    latent (b, z_dim) and cutoff (0-d int64; None without mixing) and each
    noise layer's field (b, 1, H_l, W_l), in layer order."""

    z_mix: Optional[torch.Tensor]
    cutoff: Optional[torch.Tensor]
    noise: List[torch.Tensor]


class EqualLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias_init: float = 0.0,
                 lr_mul: float = 1.0, activate: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_features, in_features) / lr_mul)
        self.bias = nn.Parameter(torch.full((out_features,), float(bias_init) / lr_mul))
        self.weight_gain = lr_mul / math.sqrt(in_features)
        self.lr_mul = lr_mul
        self.activate = activate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.addmm(self.bias * self.lr_mul, x.float(), (self.weight * self.weight_gain).t())
        return fused_leaky_relu(x) if self.activate else x


class EqualConv2d(nn.Module):
    """A zero-padded conv with a runtime-scaled weight; ``down``: FIR blur
    then stride 2 (3x3), or FIR down-sampling then the conv (1x1)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, bias: bool = True,
                 down: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.weight_gain = 1.0 / math.sqrt(in_ch * kernel * kernel)
        self.down = down
        self.resample_filter = setup_filter()

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype)
        w = (self.weight * self.weight_gain).to(dtype)
        k = self.weight.shape[-1]
        if self.down and k == 1:
            x = conv.conv2d(downsample2d(x, self.resample_filter), w)
        elif self.down:
            x = upfirdn2d(x, self.resample_filter, padding=(2, 2, 2, 2))
            x = conv.conv2d(x, w, stride=2)
        else:
            x = conv.conv2d(x, w, padding=k // 2)
        return x


class MappingNetwork(nn.Module):
    def __init__(self, z_dim: int = 512, w_dim: int = 512, layers: int = 8,
                 lr_mul: float = 0.01):
        super().__init__()
        dims = [z_dim] + [w_dim] * layers
        for i in range(layers):
            self.add_module(f"fc{i}", EqualLinear(dims[i], dims[i + 1], lr_mul=lr_mul,
                                                  activate=True))
        self.layers = layers

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z.float()
        x = x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + 1e-8)
        for i in range(self.layers):
            x = self._modules[f"fc{i}"](x)
        return x


class SynthesisLayer(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, w_dim: int, resolution, up: bool = False):
        super().__init__()
        self.affine = EqualLinear(w_dim, in_ch, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(out_ch, in_ch, 3, 3))
        self.noise_strength = nn.Parameter(torch.zeros(()))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.weight_gain = 1.0 / math.sqrt(in_ch * 9)
        self.up = up
        self.register_buffer("noise_const", torch.randn(tuple(resolution)))
        self.resample_filter = setup_filter()

    def forward(self, x, w, noise: Optional[torch.Tensor], dtype) -> torch.Tensor:
        styles = self.affine(w)
        x = modulated_conv2d(x, self.weight * self.weight_gain, styles, up=self.up,
                             resample_filter=self.resample_filter, compute_dtype=dtype)
        field = self.noise_const[None, None] if noise is None else noise
        x = x + (field.float() * self.noise_strength).to(dtype)
        return fused_leaky_relu(x, self.bias)


class ToOut(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, w_dim: int):
        super().__init__()
        self.affine = EqualLinear(w_dim, in_ch, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(out_ch, in_ch, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.weight_gain = 1.0 / math.sqrt(in_ch)

    def forward(self, x, w, dtype) -> torch.Tensor:
        styles = self.affine(w) * self.weight_gain
        y = modulated_conv2d(x, self.weight, styles, demodulate=False, compute_dtype=dtype)
        return y.float() + self.bias.view(1, -1, 1, 1)


class SynthesisNetwork(nn.Module):
    def __init__(self, w_dim: int, channels: Sequence[int], out_ch: int, shape):
        super().__init__()
        self.levels = len(channels)
        h0, w0 = shape[0] >> (self.levels - 1), shape[1] >> (self.levels - 1)
        self.const = nn.Parameter(torch.randn(channels[0], h0, w0))
        self.noise_shapes = []  # (H, W) of each layer's noise, in layer order
        for lvl, ch in enumerate(channels):
            res = (h0 << lvl, w0 << lvl)
            layers = {}
            if lvl > 0:
                layers["conv0"] = SynthesisLayer(channels[lvl - 1], ch, w_dim, res, up=True)
            layers["conv1"] = SynthesisLayer(ch, ch, w_dim, res)
            self.noise_shapes += [res] * len(layers)
            layers["torgb"] = ToOut(ch, out_ch, w_dim)
            self.add_module(f"l{lvl}", nn.ModuleDict(layers))
        self.num_ws = 2 * self.levels
        self.resample_filter = setup_filter()

    def forward(self, ws: torch.Tensor, noise: Optional[List[torch.Tensor]],
                dtype) -> torch.Tensor:
        """ws (B, num_ws, w_dim) -> (B, out_ch, H, W) float32."""
        fields = iter(noise if noise is not None else [None] * len(self.noise_shapes))
        x = self.const.to(dtype)[None].expand(ws.shape[0], -1, -1, -1)
        img = None
        for lvl in range(self.levels):
            level = self._modules[f"l{lvl}"]
            if lvl > 0:
                x = level["conv0"](x, ws[:, 2 * lvl - 1], next(fields), dtype)
            x = level["conv1"](x, ws[:, 2 * lvl], next(fields), dtype)
            y = level["torgb"](x, ws[:, 2 * lvl + 1], dtype)
            img = y if img is None else upsample2d(img, self.resample_filter) + y
        return img


class Generator(nn.Module):
    """The StyleGAN2 backbone: {"depth": tanh, <other out_ch keys>: the
    rest of the skip image's channels}."""

    def __init__(self, z_dim: int = 512, w_dim: int = 512, mapping_layers: int = 8,
                 mapping_lr_mul: float = 0.01, channels: Sequence[int] = (512,) * 4 + (256,),
                 out_ch: Optional[Dict[str, int]] = None, shape: Sequence[int] = (64, 256)):
        super().__init__()
        self.in_ch = int(z_dim)
        self.out_ch = dict(out_ch or {"depth": 1})
        if next(iter(self.out_ch)) != "depth" or self.out_ch["depth"] != 1:
            raise ValueError(f"out_ch must start with depth: 1, got {self.out_ch}")
        self.shape = tuple(shape)
        self.mapping = MappingNetwork(z_dim, w_dim, mapping_layers, mapping_lr_mul)
        self.synthesis = SynthesisNetwork(w_dim, list(channels), sum(self.out_ch.values()),
                                          self.shape)
        self.num_ws = self.synthesis.num_ws

    @property
    def noise_shapes(self):
        return list(self.synthesis.noise_shapes)

    def ws(self, z: torch.Tensor, style: Optional[StyleDraws] = None) -> torch.Tensor:
        """(B, num_ws, w_dim) float32: w(z) broadcast, mixed with w(z_mix)
        from the cutoff on."""
        with profiling.span("g.mapping"):
            w = self.mapping(z)
            ws = w[:, None].expand(-1, self.num_ws, -1)
            if style is not None and style.z_mix is not None:
                w2 = self.mapping(style.z_mix)
                idx = torch.arange(self.num_ws, device=w.device).view(1, -1, 1)
                ws = torch.where(idx < style.cutoff, ws, w2[:, None])
                if profiling.enabled() and not (w.is_cuda and
                                                torch.cuda.is_current_stream_capturing()):
                    profiling.count("g.mixed_rows",
                                    int(style.cutoff < self.num_ws) * z.shape[0])
        return ws

    def forward(self, z, compute_dtype: Optional[torch.dtype] = None,
                compose_layer: Optional[int] = None, compose_alpha=None,
                style: Optional[StyleDraws] = None,
                ws: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``z`` (B, z_dim), or ``ws`` (B, num_ws, w_dim) in its place."""
        if compose_layer is not None:
            raise NotImplementedError("multi-code composition needs the DCGAN backbone")
        if ws is None:
            ws = self.ws(z, style)
        dtype = compute_dtype or torch.float32
        with profiling.span("g.synthesis"):
            img = self.synthesis(ws, None if style is None else style.noise, dtype)
        outs, c = {}, 0
        for name, n in self.out_ch.items():
            outs[name] = img[:, c:c + n]
            c += n
        outs["depth"] = torch.tanh(outs["depth"])
        return outs


def minibatch_stddev(x: torch.Tensor, group_size: int = 4, channels: int = 1) -> torch.Tensor:
    """x (N, C, H, W) -> (N, C + channels, H, W): each group of
    min(group_size, N) samples (sample i in group i mod N / G) appends the
    mean over C / channels, H and W of its stddev over the group."""
    n, c, h, w = x.shape
    g = min(group_size, n)
    y = x.float().reshape(g, -1, channels, c // channels, h, w)
    y = (y - y.mean(dim=0)).square().mean(dim=0)
    y = (y + 1e-8).sqrt().mean(dim=(2, 3, 4))  # (N / G, channels)
    y = y.reshape(-1, channels, 1, 1).repeat(g, 1, h, w)
    return torch.cat([x, y.to(x.dtype)], dim=1)


class Discriminator(nn.Module):
    def __init__(self, in_ch: int = 1, channels: Sequence[int] = (256,) + (512,) * 4,
                 fc_dim: int = 512, mbstd_group: int = 4, mbstd_channels: int = 1,
                 shape: Sequence[int] = (64, 256)):
        super().__init__()
        self.shape = tuple(shape)
        ch = list(channels)
        self.fromrgb = EqualConv2d(in_ch, ch[0], 1)
        for i in range(len(ch) - 1):
            self.add_module(f"b{i}", nn.ModuleDict({
                "conv0": EqualConv2d(ch[i], ch[i], 3),
                "conv1": EqualConv2d(ch[i], ch[i + 1], 3, down=True),
                "skip": EqualConv2d(ch[i], ch[i + 1], 1, bias=False, down=True)}))
        self.blocks = len(ch) - 1
        h, w = self.shape[0] >> self.blocks, self.shape[1] >> self.blocks
        self.mbstd_group, self.mbstd_channels = int(mbstd_group), int(mbstd_channels)
        self.epilogue = nn.ModuleDict({
            "conv": EqualConv2d(ch[-1] + self.mbstd_channels, ch[-1], 3),
            "fc": EqualLinear(ch[-1] * h * w, fc_dim, activate=True),
            "out": EqualLinear(fc_dim, 1)})

    def forward(self, x, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(B, in_ch, H, W) -> (B, 1) float32 logits."""
        dtype = compute_dtype or torch.float32
        h = self.fromrgb(x.float(), torch.float32)
        h = fused_leaky_relu(h, self.fromrgb.bias)
        half = math.sqrt(0.5)
        for i in range(self.blocks):
            blk = self._modules[f"b{i}"]
            skip = blk["skip"](h, dtype) * half
            h = fused_leaky_relu(blk["conv0"](h, dtype), blk["conv0"].bias)
            h = fused_leaky_relu(blk["conv1"](h, dtype), blk["conv1"].bias, gain=SQRT2 * half)
            h = skip + h
        h = minibatch_stddev(h, self.mbstd_group, self.mbstd_channels)
        ep = self.epilogue
        h = fused_leaky_relu(ep["conv"](h, dtype), ep["conv"].bias)
        h = ep["fc"](h.float().flatten(1))
        return ep["out"](h)
