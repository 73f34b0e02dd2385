"""Where the reference rounds.

The reference computes in float32 (``FLOAT32``): every ``round`` is the
identity.  The control (``FP8``) rounds each value that the program
computes in bf16 to fp8 instead, forward and backward, as fp8 training
recipes do: values to e4m3 and gradients to e5m2, each with a per-tensor
scale that maps the tensor's largest magnitude onto the format's largest
finite value.  The rounding of a gradient is itself differentiable, so a
double backward (R1) rounds there too.
"""

from __future__ import annotations

import dataclasses

import torch

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def _quantize(x: torch.Tensor, dtype) -> torch.Tensor:
    scale = torch.finfo(dtype).max / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, value_dtype, grad_dtype):
        ctx.grad_dtype = grad_dtype
        return _quantize(x, value_dtype)

    @staticmethod
    def backward(ctx, g):
        return _Round.apply(g, ctx.grad_dtype, ctx.grad_dtype), None, None


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str = "float32"

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        if self.name != "fp8":
            raise ValueError(f"unknown precision {self.name!r}")
        return _Round.apply(x, E4M3, E5M2)


FLOAT32 = Precision("float32")
FP8 = Precision("fp8")


def strict_float32() -> None:
    """True float32 matrix products and convolutions on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
