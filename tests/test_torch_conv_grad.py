"""The training convolutions of ``dusty_gan_torch/ops/conv.py`` against
torch's builtin ``F.conv2d`` / ``F.conv_transpose2d``, on the CPU in
float64.

Each configuration the models use (DCGAN D's 4x4 stride-2 VALID conv and
its full-extent logit convs, G's ConvTs and latent projection, StyleGAN2's
3x3, 1x1 and stride-2 convs and the stride-2 transposed modulated conv, and
one conv whose stride leaves a remainder, which needs ``output_padding``)
is held to the builtin op, its forward inside ``double_backward`` as a
penalty's runs: the output, the first-order gradients and the second-order
gradients (``autograd.grad`` twice), within float64 rounding (1e-12 of
each tensor's norm).  Outside that context, or without a gradient, it is
the plain op.  The penalties' parameter gradients (R1
through DCGAN's and StyleGAN2's D, the path length through StyleGAN2's
synthesis with respect to ws) are held to the builtin path, reached by
patching ``ops/conv.py``'s two functions to the plain ``F.`` ops, within
1e-10: there the two paths sum the second-order weight terms in different
orders through a whole network.
"""

import contextlib
import math
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from dusty_gan_torch.models import losses, stylegan2
from dusty_gan_torch.models.dcgan_eqlr import Discriminator as DcganD
from dusty_gan_torch.ops import conv
from dusty_gan_torch.utils import profiling

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

B = 3
F64 = torch.float64
RTOL, RTOL_NET = 1e-12, 1e-10
# name: (transposed, x shape, w shape, stride, padding)
CASES = {
    "dcgan_d_down": (False, (B, 2, 10, 34), (8, 2, 4, 4), 2, 0),  # ring-padded 8x32
    "dcgan_d_logit_4x16": (False, (B, 16, 4, 16), (1, 16, 4, 16), 1, 0),
    "dcgan_d_logit_2x16": (False, (B, 16, 2, 16), (1, 16, 2, 16), 1, 0),
    "dcgan_g_up": (True, (B, 16, 6, 18), (16, 8, 4, 4), 2, 3),  # ring-padded 4x16
    "dcgan_g_proj": (True, (B, 32, 1, 1), (32, 16, 4, 16), 1, 0),
    "sg2_3x3": (False, (B, 8, 8, 32), (16, 8, 3, 3), 1, 1),
    "sg2_1x1": (False, (B, 8, 8, 32), (16, 8, 1, 1), 1, 0),
    "sg2_3x3_down": (False, (B, 8, 9, 33), (16, 8, 3, 3), 2, 0),  # after the FIR's pad 2
    "sg2_up": (True, (B, 8, 4, 16), (8, 16, 3, 3), 2, 0),
    "stride_remainder": (False, (B, 4, 11, 12), (6, 4, 4, 4), 2, 1),
}


def _close(got, want, rtol, what=""):
    """|got - want| <= rtol |want|, in the 2-norm."""
    got, want = got.detach(), want.detach()
    err = float(torch.linalg.vector_norm(got - want))
    scale = float(torch.linalg.vector_norm(want))
    assert err <= rtol * scale, (what, err / max(scale, 1e-300))


def _case(name, seed=0):
    transposed, xs, ws, stride, padding = CASES[name]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(xs, generator=g, dtype=F64).requires_grad_(True)
    w = torch.randn(ws, generator=g, dtype=F64).requires_grad_(True)
    ours = conv.conv_transpose2d if transposed else conv.conv2d
    builtin = F.conv_transpose2d if transposed else F.conv2d
    return x, w, (lambda a, b: ours(a, b, stride, padding)), \
        (lambda a, b: builtin(a, b, None, stride, padding))


def _derivatives(fn, x, w):
    """The output; the gradients of <y, r> + |y|^2 / 2 for x and w (the
    output's gradient r + y depends on both), without and with the graph
    kept; and the gradients for x and w of a function of both first
    gradients and of x and w themselves."""
    with conv.double_backward():
        y = fn(x, w)
    r = torch.cos(torch.arange(y.numel(), dtype=F64)).view_as(y)
    loss = (y * r).sum() + y.square().sum() / 2
    first = torch.autograd.grad(loss, (x, w), retain_graph=True)
    gx, gw = torch.autograd.grad(loss, (x, w), create_graph=True)
    outer = (gx.square().sum() + (gw * gw.detach().sin()).sum() + (gx * x).sum()
             + (gw * w).sum())
    return (y,) + first + (gx, gw) + torch.autograd.grad(outer, (x, w))


@pytest.mark.parametrize("name", list(CASES))
def test_output_and_both_orders_of_gradient_match_the_builtin_op(name):
    x, w, ours, builtin = _case(name)
    got, want = _derivatives(ours, x, w), _derivatives(builtin, x, w)
    labels = ("y", "gx", "gw", "gx kept", "gw kept", "ggx", "ggw")
    assert torch.equal(got[0], want[0])
    for a, b, what in zip(got, want, labels):
        assert a.shape == b.shape, what
        _close(a, b, RTOL, what)


@pytest.mark.parametrize("name", list(CASES))
def test_without_a_second_order_it_is_the_plain_op(name):
    x, w, ours, builtin = _case(name)
    want = builtin(x, w)
    y = ours(x, w)  # outside a penalty's forward: torch's own node
    assert torch.equal(y, want) and type(y.grad_fn) is type(want.grad_fn)
    with conv.double_backward():
        with torch.no_grad():
            y = ours(x, w)
            assert torch.equal(y, want) and y.grad_fn is None
        y = ours(x.detach(), w.detach())  # grad mode on, nothing requires grad
        assert torch.equal(y, want) and y.grad_fn is None
        y = ours(x, w)
    assert torch.equal(y, want) and type(y.grad_fn) is not type(want.grad_fn)


def _chain(x, w1, w2):
    """A conv, tanh, then a transposed conv (the DCGAN D's and G's kinds),
    as a penalty's forward runs them."""
    with conv.double_backward():
        return conv.conv_transpose2d(torch.tanh(conv.conv2d(x, w1, 2, 0)), w2, 2, 1)


def _chain_inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, 4, 10, 18), generator=g, dtype=F64).requires_grad_(True)
    w1 = torch.randn((6, 4, 4, 4), generator=g, dtype=F64).requires_grad_(True)
    w2 = torch.randn((6, 4, 4, 4), generator=g, dtype=F64).requires_grad_(True)
    return x, w1, w2


def test_the_inner_pass_forms_no_weight_gradient():
    x, w1, w2 = _chain_inputs()
    with mock.patch.object(torch.ops.aten.convolution_backward, "default",
                           wraps=torch.ops.aten.convolution_backward.default) as calls:
        def wgrads():
            return sum(1 for c in calls.call_args_list if c.args[-1][1])

        (gx,) = torch.autograd.grad(_chain(x, w1, w2).sum(), x, create_graph=True)
        assert wgrads() == 2  # the Function cannot tell it is not wanted
        calls.reset_mock()
        y = _chain(x, w1, w2)
        with conv.no_weight_gradients():
            (gx,) = torch.autograd.grad(y.sum(), x, create_graph=True)
        assert wgrads() == 0
        (y.square().sum() + gx.square().sum()).backward()
        # the outer pass: each forward conv's weight gradient (the input
        # gradients' weight terms are their builtin convolutions' own)
        assert wgrads() == 2
    got = [x.grad, w1.grad, w2.grad]
    for t in (x, w1, w2):
        t.grad = None
    with _builtin():
        _r1_like(x, w1, w2)
    for a, t in zip(got, (x, w1, w2)):
        _close(a, t.grad, RTOL)


def _r1_like(x, w1, w2):
    """The chain's output and the square of its input gradient, taken
    inside the context, backward together, as R1 with the logits' loss."""
    y = _chain(x, w1, w2)
    with conv.no_weight_gradients():
        (gx,) = torch.autograd.grad(y.sum(), x, create_graph=True)
    assert conv._weight_gradients
    (y.square().sum() + gx.square().sum()).backward()


@pytest.mark.parametrize("order", [1, 2])
def test_the_counter_counts_each_conv_differentiated_twice(order):
    x, w1, w2 = _chain_inputs()
    profiling.drain()
    profiling.enable()
    try:
        if order == 2:
            _r1_like(x, w1, w2)
        else:
            _chain(x, w1, w2).square().sum().backward()
        got = profiling.drain()["counters"]
    finally:
        profiling.disable()
    assert got.get("conv.grad2", 0) == (2 if order == 2 else 0)


@contextlib.contextmanager
def _float64():
    """The models pin float32 where the card needs it (D's ends, the
    mapping, the skip image); inside, those pins read float64, so that both
    paths run wholly in float64."""
    with mock.patch.object(torch, "float32", F64), \
            mock.patch.object(torch.Tensor, "float", torch.Tensor.double):
        yield


@contextlib.contextmanager
def _builtin():
    """The builtin path: ``ops/conv.py``'s functions as the plain ops."""
    with mock.patch.object(conv, "conv2d",
                           lambda x, w, stride=1, padding=0: F.conv2d(x, w, None, stride,
                                                                      padding)), \
            mock.patch.object(conv, "conv_transpose2d",
                              lambda x, w, stride=1, padding=0: F.conv_transpose2d(
                                  x, w, None, stride, padding)):
        yield


def _dcgan_r1():
    torch.manual_seed(0)
    D = DcganD(in_ch=1, ch_base=4, ch_max=8, shape=(32, 64)).double()
    x = torch.rand((B, 1, 32, 64), generator=torch.Generator().manual_seed(1), dtype=F64)
    return D, lambda: losses.r1_penalty(lambda v: D(v, F64).reshape(-1), x)[0], 5


def _sg2_r1():
    torch.manual_seed(0)
    D = stylegan2.Discriminator(in_ch=1, channels=[4, 8, 8], fc_dim=8, shape=(16, 64)).double()
    x = torch.rand((4, 1, 16, 64), generator=torch.Generator().manual_seed(1), dtype=F64)
    # FromRGB, three convs a block, the epilogue's conv
    return D, lambda: losses.r1_penalty(lambda v: D(v, F64).reshape(-1), x)[0], 1 + 3 * 2 + 1


def _sg2_pl():
    torch.manual_seed(0)
    G = stylegan2.Generator(z_dim=8, w_dim=8, mapping_layers=2, channels=[8, 8, 4],
                            out_ch={"depth": 1, "confidence": 2}, shape=(8, 32)).double()
    g = torch.Generator().manual_seed(1)
    z = torch.randn((B, 8), generator=g, dtype=F64)
    noise = torch.randn((B, 1, 8, 32), generator=g, dtype=F64) / math.sqrt(8 * 32)
    pl_ema = torch.tensor(0.5, dtype=F64)

    def penalty():
        return losses.path_length_penalty(lambda ws: G(None, F64, ws=ws)["depth"],
                                          G.ws(z), noise, pl_ema)[0]
    # per level a modulated conv and ToOut's, and each level past the first
    # its stride-2 transposed conv
    return G, penalty, 3 * 3 - 1


@pytest.mark.parametrize("make", [_dcgan_r1, _sg2_r1, _sg2_pl],
                         ids=["dcgan_r1", "sg2_r1", "sg2_pl"])
def test_the_penalties_parameter_gradients_equal_the_builtin_path(make):
    with _float64():
        net, penalty, convs = make()
        profiling.drain()
        profiling.enable()
        try:
            got_pen = penalty()
            got_pen.backward()
            counted = profiling.drain()["counters"].get("conv.grad2", 0)
        finally:
            profiling.disable()
        got = {k: p.grad for k, p in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        with _builtin():
            want_pen = penalty()
            want_pen.backward()
    assert got_pen.dtype == F64 and counted == convs
    _close(got_pen.detach(), want_pen.detach(), RTOL_NET, "penalty")
    reached = 0
    for k, p in net.named_parameters():
        if p.grad is None:
            assert got[k] is None, k
            continue
        assert p.grad.dtype == F64
        _close(got[k], p.grad, RTOL_NET, k)
        reached += bool(p.grad.abs().max() > 0)
    assert reached >= convs
