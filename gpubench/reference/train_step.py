"""The DUSty GAN train step, plain: non-saturating losses, R1 on the
augmented reals, Adam, EMA of G.

One step on a batch of real depths and one iteration's draws:

1. reals: normalised depth in [0, 1] (0 where the scan has no return) to
   inverse depth in [-1, 1], dropped pixels at ``drop_const``;
2. D phase: fakes from G (no gradient), both sides augmented with their own
   draws; loss ``softplus(-D(real)).mean() + softplus(D(fake)).mean() +
   gp / 2 * R1``, R1 the batch mean of ``|dD(x)/dx|^2`` at the augmented
   reals; one Adam update of D;
3. G phase against the updated D, with the same z and Gumbel noise: loss
   ``softplus(-D(aug(G(z)))).mean()``; one Adam update of G;
4. ``G_ema <- decay * G_ema + (1 - decay) * G``.

Adam: ``m <- b1 m + (1 - b1) g``, ``v <- b2 v + (1 - b2) g^2``, ``p <- p - lr
/ (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from gpubench.reference import models
from gpubench.reference.augment import augment
from gpubench.reference.precision import FLOAT32, Precision

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class Hyper:
    model: dict
    shape: tuple
    min_depth: float
    max_depth: float
    lr_g: float
    lr_d: float
    beta1: float
    beta2: float
    w_gan: float
    w_gp: float
    ema_decay: float
    eps: float = 1e-8

    @staticmethod
    def from_config(cfg: dict) -> "Hyper":
        s = cfg["solver"]
        return Hyper(model=cfg["model"], shape=tuple(cfg["dataset"]["shape"]),
                     min_depth=float(cfg["dataset"]["min_depth"]),
                     max_depth=float(cfg["dataset"]["max_depth"]),
                     lr_g=float(s["lr"]["alpha"]["gen"]), lr_d=float(s["lr"]["alpha"]["dis"]),
                     beta1=float(s["lr"]["beta1"]), beta2=float(s["lr"]["beta2"]),
                     w_gan=float(s["loss"]["gan"]), w_gp=float(s["loss"]["gp"]),
                     ema_decay=0.5 ** (int(s["batch_size"]) / (float(s["smoothing_kimg"]) * 1e3)))


@dataclasses.dataclass
class State:
    G: Params
    D: Params
    G_ema: Params
    m: Dict[str, Params]
    v: Dict[str, Params]
    t: int = 0

    @staticmethod
    def fresh(G: Params, D: Params) -> "State":
        z = lambda p: {k: torch.zeros_like(v) for k, v in p.items()}  # noqa: E731
        return State(G={k: v.clone() for k, v in G.items()},
                     D={k: v.clone() for k, v in D.items()},
                     G_ema={k: v.clone() for k, v in G.items()},
                     m={"G": z(G), "D": z(D)}, v={"G": z(G), "D": z(D)})


def reals(depth01: torch.Tensor, hp: Hyper) -> torch.Tensor:
    """(B, 1, H, W) normalised depth -> inverse depth in [-1, 1]."""
    lo, hi = hp.min_depth, hp.max_depth
    valid = (depth01 > 0).to(torch.float32)
    disp = 1.0 / (depth01 * (hi - lo) + lo)
    inv = (disp - 1.0 / hi) / (1.0 / lo - 1.0 / hi) * 2.0 - 1.0
    drop = float(hp.model["gen"]["drop_const"])
    return valid * inv + (1.0 - valid) * drop


def _adam(p: Params, g: Params, m: Params, v: Params, t: int, lr: float, hp: Hyper) -> None:
    bc1, bc2 = 1.0 - hp.beta1 ** t, 1.0 - hp.beta2 ** t
    for k in p:
        m[k] = hp.beta1 * m[k] + (1.0 - hp.beta1) * g[k]
        v[k] = hp.beta2 * v[k] + (1.0 - hp.beta2) * g[k] * g[k]
        p[k] = p[k] - lr / bc1 * m[k] / (v[k].sqrt() / bc2 ** 0.5 + hp.eps)


def _leaves(p: Params):
    return {k: v.detach().requires_grad_(True) for k, v in p.items()}


def step(st: State, depth01: torch.Tensor, draws: dict, hp: Hyper,
         prec: Precision = FLOAT32):
    """One step in place on ``st``; returns (losses, gradients, logits,
    reals): the step's ``loss/D/adversarial``, ``loss/D/gradient_penalty``
    and ``loss/G/adversarial`` as floats, {"D": ..., "G": ...} the gradients
    the two updates took, D's (B,) logits of the augmented reals and those
    augmented reals (B, 1, H, W)."""
    model, shape = hp.model, hp.shape
    x_real = reals(depth01.float(), hp)
    with torch.no_grad():
        x_fake = models.generator(st.G, draws["z"], draws["gumbel"], model, shape,
                                  prec=prec)["depth"]

    D = _leaves(st.D)
    x = augment(x_real, draws["aug_d_real"]).detach().requires_grad_(True)
    y_real = models.discriminator(D, x, prec)
    (gx,) = torch.autograd.grad(y_real.sum(), x, create_graph=True)
    r1 = (gx ** 2).sum(dim=(1, 2, 3)).mean()
    y_fake = models.discriminator(D, augment(x_fake, draws["aug_d_fake"]), prec)
    adv_d = F.softplus(-y_real).mean() + F.softplus(y_fake).mean()
    loss_d = hp.w_gan * adv_d + hp.w_gp / 2.0 * r1
    grads_d = dict(zip(D, torch.autograd.grad(loss_d, list(D.values()))))
    st.t += 1
    _adam(st.D, grads_d, st.m["D"], st.v["D"], st.t, hp.lr_d, hp)

    G = _leaves(st.G)
    synth = models.generator(G, draws["z"], draws["gumbel"], model, shape, prec=prec)
    y = models.discriminator(st.D, augment(synth["depth"], draws["aug_g_fake"]), prec)
    adv_g = F.softplus(-y).mean()
    grads_g = dict(zip(G, torch.autograd.grad(hp.w_gan * adv_g, list(G.values()))))
    _adam(st.G, grads_g, st.m["G"], st.v["G"], st.t, hp.lr_g, hp)

    d = hp.ema_decay
    for k in st.G_ema:
        st.G_ema[k] = st.G_ema[k] * d + st.G[k] * (1.0 - d)
    losses = {"loss/D/adversarial": float(adv_d.detach()),
              "loss/D/gradient_penalty": float(r1.detach()),
              "loss/G/adversarial": float(adv_g.detach())}
    return losses, {"D": grads_d, "G": grads_g}, y_real.detach(), x.detach()
