"""StyleGAN2's modulated convolution (Karras et al. 2020, eq. 1-3), NCHW,
zero padding.

For a sample's style ``s`` (one scale an input channel) the weight is
``w' = W * s`` over its input channels and, with demodulation,
``w'' = w' / sqrt(sum over (in, kh, kw) of w'^2 + 1e-8)`` per output
channel.  The port computes it as StyleGAN2's training path does
(NVlabs ``modulated_conv2d`` with ``fused_modconv=False``): the input
scaled by ``s``, one convolution with the shared weight ``W`` for the
whole batch, the output scaled by the demodulation coefficient ``d``.
That is the same arithmetic as the grouped per-sample weight
(``gpubench/reference/stylegan2.py`` computes that literal form), and one
dense convolution for the batch, where the grouped form runs B groups.

Precision: ``W`` is taken as given (float32, already scaled by its
equalized-LR gain); ``s`` and ``d`` are float32; the convolution runs in
``compute_dtype``.  StyleGAN2's fp16 pre-normalisation of ``W`` and ``s``
guards fp16's range; bf16 has float32's, so it is not taken.

``up=True``: a transposed convolution of stride 2 (the output 2H + 1
wide), then the FIR blur ``upfirdn2d(padding 1, gain 4)`` with the 1-D
taps ``resample_filter``, as NVlabs' ``conv2d_resample`` takes its fast
path for up = 2.

Both convolutions are ``ops/conv.py``'s, so that the path-length
penalty's outer pass forms their weight terms on cuDNN's wgrad.

Each call adds 1 to the tracer's counter ``g.modconv``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from dusty_gan_torch.ops import conv
from dusty_gan_torch.ops.upfirdn import upfirdn2d
from dusty_gan_torch.utils import profiling


def demodulation(weight: torch.Tensor, styles: torch.Tensor) -> torch.Tensor:
    """(B, O) float32 ``1 / sqrt(sum_{i,kh,kw} (W s)^2 + 1e-8)`` for weight
    (O, I, kh, kw) and styles (B, I)."""
    w2 = weight.float().square().sum(dim=(2, 3))  # (O, I)
    return torch.rsqrt(styles.float().square() @ w2.t() + 1e-8)


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor, styles: torch.Tensor, *,
                     demodulate: bool = True, up: bool = False,
                     resample_filter: Optional[Sequence[float]] = None,
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, I, H, W) -> (B, O, H, W) ((B, O, 2H, 2W) with ``up``) in
    ``compute_dtype`` (None: the input's)."""
    profiling.count("g.modconv")
    dtype = compute_dtype or x.dtype
    x = x.to(dtype) * styles.to(dtype)[:, :, None, None]
    w = weight.to(dtype)
    if up:
        x = conv.conv_transpose2d(x, w.transpose(0, 1), stride=2)
        x = upfirdn2d(x, resample_filter, padding=(1, 1, 1, 1), gain=4.0)
    else:
        x = conv.conv2d(x, w, padding=weight.shape[-1] // 2)
    if demodulate:
        x = x * demodulation(weight, styles).to(dtype)[:, :, None, None]
    return x
