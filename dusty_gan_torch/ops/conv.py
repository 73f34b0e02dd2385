"""Training convolutions whose input gradient is itself a differentiable
convolution (the design of NVlabs' ``torch_utils/ops/conv2d_gradfix.py``,
stylegan2-ada-pytorch).

torch differentiates a convolution's backward (``_convolution_double_
backward``) by forming the weight term as a forward convolution of the
input's second gradient with the output gradient, batch and channels
swapped and stride and dilation exchanged: its "kernel" is as wide as the
output feature map, dilated by the stride, over "channels" that are the
batch.  No tensor-core engine of cuDNN takes that shape, and on the card it
falls to cuDNN's generic ``implicit_convolve_sgemm``.

Here a backward that keeps the graph of its gradients (``create_graph``)
forms the input gradient as the opposite builtin convolution (a transposed
convolution of the output gradient with the same weight, stride and
padding, and the ``output_padding`` that restores the input's size; the
converse for a transposed convolution), and the weight gradient as a
second Function over ``convolution_backward``, cuDNN's weight-gradient
(wgrad) engine.  An outer pass that differentiates the input gradient
again, as R1 and the path-length penalty do, then runs that builtin
convolution's first-order backward: its weight term is an ordinary wgrad,
of the convolution whose input is the input's second gradient and whose
output gradient is the first pass's.  No term is dropped, and each
convolution keeps its dtype.

``double_backward()``: inside it, a ``conv2d`` or ``conv_transpose2d``
with a gradient to form (grad mode on, the input or the weight requiring
grad) runs as these Functions; the penalties enter it around the forward
whose input gradient they take.  Anywhere else the plain ``F.`` op runs:
synthesis, serving and export, and every first-order pass of training run
the op and the backward they ran before, with no Python on their path (a
custom Function costs the host tens of microseconds a call, which the
per-step path, host-bound on the card, would pay on every convolution).  A
Function's backward that keeps no graph (the outer pass) is torch's own:
one ``convolution_backward`` for both gradients.  Nothing reads a device
value on the host, so a CUDA graph can capture the step.

``no_weight_gradients()``: inside it the Functions form no weight gradient.
An inner ``autograd.grad`` with respect to the input alone needs none, but
a custom Function's ``needs_input_grad`` is fixed when it is applied, so
without the context the inner pass would form every weight gradient and
drop it.

Each convolution's input gradient differentiated again (the outer pass
reaching a gradient formed with its graph kept) adds 1 to the tracer's
counter ``conv.grad2``, while the tracer is on.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from dusty_gan_torch.utils import profiling

# Process-wide, not per thread: the autograd engine runs a CUDA backward on
# its own device thread.
_double_backward = False
_weight_gradients = True
_FUNCTIONS: Dict[tuple, type] = {}


@contextlib.contextmanager
def _setting(name: str, value: bool):
    old = globals()[name]
    globals()[name] = value
    try:
        yield
    finally:
        globals()[name] = old


def double_backward():
    """The convolutions of a forward run inside are differentiable twice
    through cuDNN's kernels."""
    return _setting("_double_backward", True)


def no_weight_gradients():
    """The convolutions' backward forms no weight gradient inside."""
    return _setting("_weight_gradients", False)


def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _engages(x: torch.Tensor, w: torch.Tensor) -> bool:
    return _double_backward and torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """``F.conv2d(x, w, None, stride, padding)``."""
    if not _engages(x, w):
        return F.conv2d(x, w, None, stride, padding)
    return _function(False, tuple(w.shape), _pair(stride), _pair(padding)).apply(x, w)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """``F.conv_transpose2d(x, w, None, stride, padding)``."""
    if not _engages(x, w):
        return F.conv_transpose2d(x, w, None, stride, padding)
    return _function(True, tuple(w.shape), _pair(stride), _pair(padding)).apply(x, w)


def _count_grad2(_grad) -> None:
    profiling.count("conv.grad2")


def _function(transposed: bool, weight_shape: Tuple[int, ...], stride: Tuple[int, int],
              padding: Tuple[int, int]) -> type:
    """The autograd Function of one convolution configuration, cached."""
    key = (transposed, weight_shape, stride, padding)
    if key in _FUNCTIONS:
        return _FUNCTIONS[key]

    def conv_backward(gy, x, w, mask):
        """(input gradient, weight gradient) of this convolution of ``x`` by
        ``w`` whose output gradient is ``gy``, each where ``mask`` asks for
        it (else None): one ``convolution_backward``, torch's own
        first-order backward, cuDNN's dgrad and wgrad on the card."""
        gx, gw, _ = torch.ops.aten.convolution_backward.default(
            gy, x, w, None, stride, padding, (1, 1), transposed, (0, 0), 1,
            [mask[0], mask[1], False])
        return gx, gw

    def input_grad(gy, w, x_shape: Sequence[int]) -> torch.Tensor:
        """The input gradient as the opposite builtin convolution, whose own
        backward is the first-order one (a transposed convolution with the
        ``output_padding`` that restores the input's size; the converse for
        a transposed convolution)."""
        if transposed:
            return F.conv2d(gy, w, None, stride, padding)
        op = tuple(x_shape[i + 2] - (gy.shape[i + 2] - 1) * stride[i] + 2 * padding[i]
                   - weight_shape[i + 2] for i in range(2))
        return F.conv_transpose2d(gy, w, None, stride, padding, op)

    class Conv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            if transposed:
                return F.conv_transpose2d(x, w, None, stride, padding)
            return F.conv2d(x, w, None, stride, padding)

        @staticmethod
        def backward(ctx, gy):
            x, w = ctx.saved_tensors
            mask = (ctx.needs_input_grad[0], ctx.needs_input_grad[1] and _weight_gradients)
            if not torch.is_grad_enabled():  # no graph of the gradients is kept
                return conv_backward(gy, x, w, mask)
            gx = gw = None
            if mask[0]:
                gx = input_grad(gy, w, x.shape)
                if profiling.enabled() and gx.requires_grad:
                    gx.register_hook(_count_grad2)
            if mask[1]:
                gw = GradWeight.apply(gy, x, w.detach())
            return gx, gw

    class GradWeight(torch.autograd.Function):
        @staticmethod
        def forward(ctx, gy, x, w):
            """``w`` gives the weight's shape and layout; it takes no
            gradient."""
            ctx.save_for_backward(gy, x)
            return conv_backward(gy, x, w, (False, True))[1]

        @staticmethod
        def backward(ctx, ggw):
            gy, x = ctx.saved_tensors
            ggy = gx = None
            if ctx.needs_input_grad[0]:
                ggy = Conv.apply(x, ggw)
            if ctx.needs_input_grad[1]:
                gx = input_grad(gy, ggw, x.shape)
            return ggy, gx, None

    _FUNCTIONS[key] = Conv
    return Conv
