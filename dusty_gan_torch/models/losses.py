"""GAN objectives, gradient penalties and the reconstruction loss
(``dusty_gan_tpu/models/losses.py``).

Seven adversarial objectives for D and G (nsgan, wgan, lsgan, hinge and the
relativistic ragan, rahinge, ralsgan), computed in float32; the R1 and
one-centred gradient penalties as ``torch.autograd.grad(..., create_graph=
True)`` on float32 inputs, so the outer backward differentiates through
them (the forward inside ``ops/conv.py``'s ``double_backward``, so that
the outer pass forms the convolutions' second-order weight terms on cuDNN's
wgrad; the inner pass inside its ``no_weight_gradients``: it wants the
input's gradient alone); StyleGAN2's path-length penalty with its EMA
baseline, with respect to z or to a StyleGAN2 generator's ws (its forward
and inner pass likewise); and
``masked_loss``.

The relativistic modes compare each logit with the other side's mean
over the batch.  In a process group of more than one rank that is the
global batch's mean (``mesh.global_mean``, differentiable), as the JAX
step's sharded ``jit`` takes it; a rank's loss is then the mean of its own
rows' terms, and the global loss the mean of the ranks' losses.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from dusty_gan_torch.ops import conv
from dusty_gan_torch.parallel import mesh

GAN_MODES = ("nsgan", "wgan", "lsgan", "hinge", "ragan", "rahinge", "ralsgan")
RELATIVISTIC = ("ragan", "rahinge", "ralsgan")


def _avg_diff(a, b):
    """``a`` less the batch mean of ``b``: over the global batch in a group
    of more than one rank, else the plain mean (no collective)."""
    return a - mesh.global_mean(b)


def gan_loss_d(metric: str, pred_real, pred_fake, smoothing: float = 1.0):
    """Discriminator objective."""
    pr, pf = pred_real.float(), pred_fake.float()
    if metric == "nsgan":
        return F.softplus(-pr).mean() + F.softplus(pf).mean()
    if metric == "wgan":
        return -pr.mean() + pf.mean()
    if metric == "lsgan":
        return ((pr - smoothing) ** 2).mean() + (pf ** 2).mean()
    if metric == "hinge":
        return F.relu(1.0 - pr).mean() + F.relu(1.0 + pf).mean()
    if metric == "ragan":
        return F.softplus(-_avg_diff(pr, pf)).mean() + F.softplus(_avg_diff(pf, pr)).mean()
    if metric == "rahinge":
        return (F.relu(1.0 - _avg_diff(pr, pf)).mean()
                + F.relu(1.0 + _avg_diff(pf, pr)).mean())
    if metric == "ralsgan":
        return ((_avg_diff(pr, pf) - 1.0) ** 2).mean() + ((_avg_diff(pf, pr) + 1.0) ** 2).mean()
    raise NotImplementedError(metric)


def gan_loss_g(metric: str, pred_real, pred_fake):
    """Generator objective; nsgan, wgan, lsgan and hinge ignore
    ``pred_real`` (pass None)."""
    pf = pred_fake.float()
    if metric == "nsgan":
        return F.softplus(-pf).mean()
    if metric in ("wgan", "hinge"):
        return -pf.mean()
    if metric == "lsgan":
        return ((pf - 1.0) ** 2).mean()
    if metric not in RELATIVISTIC:
        raise NotImplementedError(metric)
    pr = pred_real.float()
    if metric == "ragan":
        return F.softplus(_avg_diff(pr, pf)).mean() + F.softplus(-_avg_diff(pf, pr)).mean()
    if metric == "rahinge":
        return (F.relu(1.0 + _avg_diff(pr, pf)).mean()
                + F.relu(1.0 - _avg_diff(pf, pr)).mean())
    return ((_avg_diff(pr, pf) + 1.0) ** 2).mean() + ((_avg_diff(pf, pr) - 1.0) ** 2).mean()


def _input_grad(d_apply: Callable, x: torch.Tensor):
    """(logits, d sum(logits) / d x) with the graph kept for an outer
    backward; ``x`` is taken as float32 and detached."""
    x = x.detach().float().requires_grad_(True)
    with conv.double_backward():
        logits = d_apply(x)
    with conv.no_weight_gradients():
        (grads,) = torch.autograd.grad(logits.sum(), x, create_graph=True)
    return logits, grads.float()


def r1_penalty(d_apply: Callable, x_real: torch.Tensor):
    """Zero-centred gradient penalty on reals: the batch mean of
    ``||d D(x_i) / d x_i||^2``.  Returns (penalty, logits), so the forward
    is shared with the adversarial loss."""
    logits, grads = _input_grad(d_apply, x_real)
    return (grads ** 2).sum(dim=(1, 2, 3)).mean(), logits


def gradient_penalty_one_centered(d_apply: Callable, x: torch.Tensor):
    """One-centred gradient penalty (WGAN-GP flavour); (penalty, logits)."""
    logits, grads = _input_grad(d_apply, x)
    norms = torch.sqrt((grads ** 2).sum(dim=(1, 2, 3)) + 1e-12)
    return ((norms - 1.0) ** 2).mean(), logits


def path_length_noise(shape, generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
    """Standard normal image-space noise of ``shape`` (B, C, H, W) divided by
    sqrt(C*H*W)."""
    noise = torch.randn(shape, generator=generator, device=device)
    return noise / torch.sqrt(torch.tensor(float(shape[1] * shape[2] * shape[3])))


def path_lengths(grads: torch.Tensor) -> torch.Tensor:
    """Each row's path length from its latent gradient: ``sqrt(sum_k g^2)``
    for z (B, I), ``sqrt(mean_i sum_k g^2)`` for ws (B, num_ws, w_dim)."""
    sq = (grads.float() ** 2).sum(dim=-1)
    return torch.sqrt(sq.mean(dim=1) if sq.dim() > 1 else sq)


def path_length_penalty(g_depth_apply: Callable, latent: torch.Tensor, noise: torch.Tensor,
                        pl_ema: torch.Tensor, decay: float = 0.01,
                        batch_mean: Optional[Callable] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """StyleGAN2 path-length regularisation.  ``g_depth_apply`` maps latents
    to depth images (B, C, H, W); ``noise`` is ``path_length_noise`` of that
    shape.  The gradient is taken with respect to ``latent`` as it is given,
    which must require it: z detached from everything (the DCGAN form), or a
    StyleGAN2 generator's mapped ws (B, num_ws, w_dim), kept in the mapping's
    graph as NVlabs' ``StyleGAN2Loss`` keeps them (``path_lengths``).
    Returns (penalty, new pl_ema), pl_ema lerped toward the batch's mean path
    length by ``decay`` and carrying no gradient.  ``batch_mean`` maps this
    batch's mean to the global batch's (over ranks)."""
    with conv.double_backward():
        x = g_depth_apply(latent)
    with conv.no_weight_gradients():
        (grads,) = torch.autograd.grad((x * noise.to(x.dtype)).sum(), latent,
                                       create_graph=True)
    pl_lengths = path_lengths(grads)
    mean = pl_lengths.mean().detach()
    if batch_mean is not None:
        mean = batch_mean(mean)
    new_ema = (pl_ema + (mean - pl_ema) * decay).detach()
    return ((pl_lengths - new_ema) ** 2).mean(), new_ema


def masked_loss(img_ref: torch.Tensor, img_gen: torch.Tensor, mask: torch.Tensor,
                distance: str = "l1") -> torch.Tensor:
    """Per-sample masked reconstruction loss, (B,): the mean of the L1 or
    squared L2 error over the pixels where ``mask`` is set."""
    if distance == "l1":
        err = (img_ref - img_gen).abs()
    elif distance == "l2":
        err = (img_ref - img_gen) ** 2
    else:
        raise NotImplementedError(distance)
    dims = tuple(range(1, img_ref.dim()))
    return (err * mask).sum(dim=dims) / mask.sum(dim=dims)
