"""The train step of DUSty-II over StyleGAN2 (``stylegan2.py``), plain:
``train_step.py``'s step with StyleGAN2's style mixing and path-length
regularisation, as NVlabs' stylegan2-ada-pytorch ``training/loss.py``
(``StyleGAN2Loss``) takes them.

One step on a batch of real depths and one iteration's draws:

1. reals as ``train_step.reals``;
2. D phase: fakes from G (no gradient) with the round's z, style draws
   (mixing latent, cutoff, noise fields) and Gumbel noise; loss
   ``softplus(-D(aug(real))).mean() + softplus(D(aug(fake))).mean() + gp /
   2 * R1``; one Adam update of D;
3. G phase against the updated D with the same draws: ``softplus(-D(aug(
   G(z)))).mean()`` plus ``pl`` times the path-length penalty on the PL
   rows' own draws: ws from the mapping (not detached), depth = G(ws),
   ``y ~ N(0, 1) / sqrt(H W)`` (the draws), a row's length ``sqrt(mean_i
   sum_k (d <depth, y> / d ws[i, k])^2)``, the baseline ``a <- a + 0.01 *
   (mean length - a)``, the penalty ``mean((length - a)^2)``; one Adam
   update of G;
4. the EMA of G, every parameter.

Departures from NVlabs' loss: R1 and the path length every step, not
lazily every 16 and 4 minibatches (the solver has no interval key); R1's
weight is the DUSty solver's; the path-length rows draw their own
latents (the program's draws), not the first half of the batch's.
Plain torch in float32; the caller sets TF32 off
(``precision.strict_float32``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from gpubench.reference import stylegan2 as sg2
from gpubench.reference.augment import augment
from gpubench.reference.precision import FLOAT32, Precision
from gpubench.reference.train_step import Hyper, Params, _adam, _leaves, reals


@dataclasses.dataclass
class HyperSG2(Hyper):
    w_pl: float = 0.0
    pl_decay: float = 0.01

    @staticmethod
    def from_config(cfg: dict) -> "HyperSG2":
        base = Hyper.from_config(cfg)
        return HyperSG2(**dataclasses.asdict(base), w_pl=float(cfg["solver"]["loss"]["pl"]))


@dataclasses.dataclass
class State:
    G: Params
    D: Params
    G_ema: Params
    m: Dict[str, Params]
    v: Dict[str, Params]
    pl_ema: torch.Tensor
    t: int = 0

    @staticmethod
    def fresh(G: Params, D: Params) -> "State":
        z = lambda p: {k: torch.zeros_like(v) for k, v in p.items()}  # noqa: E731
        dev = next(iter(G.values())).device
        return State(G={k: v.clone() for k, v in G.items()},
                     D={k: v.clone() for k, v in D.items()},
                     G_ema={k: v.clone() for k, v in G.items()},
                     m={"G": z(G), "D": z(D)}, v={"G": z(G), "D": z(D)},
                     pl_ema=torch.zeros((), device=dev))


def path_length(G: Params, draws: dict, pl_ema: torch.Tensor, hp: HyperSG2,
                prec: Precision = FLOAT32):
    """(penalty, new baseline, each row's length) on the PL rows' draws."""
    z, y, gumbel = draws["pl"]
    style = draws["pl_style"]
    ws = sg2.ws_of(G, z, style, hp.model)
    depth = sg2.generator(G, None, style, gumbel, hp.model, prec=prec, ws=ws)["depth"]
    (g,) = torch.autograd.grad((depth * y).sum(), ws, create_graph=True)
    lengths = torch.sqrt(g.square().sum(dim=2).mean(dim=1))
    new = (pl_ema + (lengths.mean().detach() - pl_ema) * hp.pl_decay).detach()
    return ((lengths - new) ** 2).mean(), new, lengths.detach()


def step(st: State, depth01: torch.Tensor, draws: dict, hp: HyperSG2,
         prec: Precision = FLOAT32):
    """One step in place on ``st``; returns (losses, gradients, D's logits
    of the augmented reals, the augmented reals, slot record): the losses
    also hold ``loss/G/path_length`` and its baseline; the record holds
    the D phase's pre-mask depth and confidence and the path-length rows'
    lengths."""
    model = hp.model
    x_real = reals(depth01.float(), hp)
    with torch.no_grad():
        fake = sg2.generator(st.G, draws["z"], draws["style"], draws["gumbel"], model, prec=prec)

    D = _leaves(st.D)
    x = augment(x_real, draws["aug_d_real"]).detach().requires_grad_(True)
    y_real = sg2.discriminator(D, x, model, prec)
    (gx,) = torch.autograd.grad(y_real.sum(), x, create_graph=True)
    r1 = (gx ** 2).sum(dim=(1, 2, 3)).mean()
    y_fake = sg2.discriminator(D, augment(fake["depth"], draws["aug_d_fake"]), model, prec)
    adv_d = F.softplus(-y_real).mean() + F.softplus(y_fake).mean()
    loss_d = hp.w_gan * adv_d + hp.w_gp / 2.0 * r1
    grads_d = dict(zip(D, torch.autograd.grad(loss_d, list(D.values()))))
    st.t += 1
    _adam(st.D, grads_d, st.m["D"], st.v["D"], st.t, hp.lr_d, hp)

    G = _leaves(st.G)
    synth = sg2.generator(G, draws["z"], draws["style"], draws["gumbel"], model, prec=prec)
    y = sg2.discriminator(st.D, augment(synth["depth"], draws["aug_g_fake"]), model, prec)
    adv_g = F.softplus(-y).mean()
    loss_g = hp.w_gan * adv_g
    pl_pen = lengths = None
    if hp.w_pl > 0.0:
        pl_pen, st.pl_ema, lengths = path_length(G, draws, st.pl_ema, hp, prec)
        loss_g = loss_g + hp.w_pl * pl_pen
    grads_g = dict(zip(G, torch.autograd.grad(loss_g, list(G.values()))))
    _adam(st.G, grads_g, st.m["G"], st.v["G"], st.t, hp.lr_g, hp)

    d = hp.ema_decay
    for k in st.G_ema:
        st.G_ema[k] = st.G_ema[k] * d + st.G[k] * (1.0 - d)
    losses = {"loss/D/adversarial": float(adv_d.detach()),
              "loss/D/gradient_penalty": float(r1.detach()),
              "loss/G/adversarial": float(adv_g.detach())}
    if pl_pen is not None:
        losses["loss/G/path_length"] = float(pl_pen.detach())
        losses["loss/G/path_length/baseline"] = float(st.pl_ema)
    record = {"depth": fake.get("depth_orig", fake["depth"]), "confidence": fake["confidence"],
              "pl_lengths": lengths}
    return losses, {"D": grads_d, "G": grads_g}, y_real.detach(), x.detach(), record
