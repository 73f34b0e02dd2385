"""The GAN train step (``dusty_gan_tpu/train/step.py``): D phase with R1,
D's Adam update, G phase against the updated D (optional path-length
penalty), G's Adam update, then the EMA of G.

Semantics kept from the JAX package (and its reference):

* per accumulation round, a real microbatch and a latent batch; the D
  phase's fakes and the G phase use the SAME z and the SAME Gumbel noise
  fields (the reference reuses its cached fakes);
* DiffAugment draws fresh per phase and per branch; D sees the augmented
  reals and the augmented, detached fakes;
* R1 weighs gp/2 on the augmented float32 reals;
* the relativistic modes also score augmented reals in the G phase;
* A rounds of batch/A, each round's loss scaled by 1/A, one update per
  step, the logged scalars averaged over rounds;
* EMA after both updates.

Every random draw of one iteration is taken up front into ``RoundDraws``
(``sample_draws``, from one ``torch.Generator``), so the step itself is a
function of the state, the batch and the draws; a test passes the JAX
package's draws instead.

The step is graph-safe, so that ``train/graphs.py`` can capture it: no
host read of a device value, and the state is updated in place (the
parameters, the optimizer state, G_ema and ``pl_ema``); ``lr`` passes
each update's learning rate where the optimizer's count lives on the
card.

In a process group (``parallel/mesh.py``) each rank steps on its share
of the global batch with its rows of the global draws (``local_draws``:
its ``local_batch_slice`` of each accumulation round's rows); each
phase's gradients are averaged over ranks (one all-reduce of one flat
bucket) before its optimizer's update, the path-length baseline takes
the mean path length over ranks, and the logged scalars become global
means through one all-reduce of a stacked vector that also carries this
rank's stop flag (``stop/agreed`` in the result: above 0 when any rank
asked to stop).  The flag is a bool, or a 0-d float32 tensor on the
device, which a captured chunk (``train/graphs.py``) fills before each
replay.  The relativistic modes compare each logit with the other side's
mean over the global batch of each accumulation round
(``mesh.global_mean`` in ``models/losses.py``, as the JAX step's sharded
``jit`` takes it).  Parameters, optimizer state and G_ema then stay
equal on every rank.  Without a group the step issues no collective.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dusty_gan_torch.core.dtypes import DEFAULT_POLICY, Policy
from dusty_gan_torch.geometry.lidar import sigmoid_to_tanh
from dusty_gan_torch.models import losses
from dusty_gan_torch.models.dusty import DUSty1, DUSty2
from dusty_gan_torch.ops.diff_augment import DEFAULT_POLICY as AUGMENT_POLICY
from dusty_gan_torch.ops.diff_augment import diff_augment, draw_augment
from dusty_gan_torch.ops.gumbel import logistic_noise
from dusty_gan_torch.parallel import mesh
from dusty_gan_torch.train.state import TrainState, ema_update, scheduled_step

# the path-length penalty's batch divisor and baseline EMA rate (the
# reference's, fixed there too)
PL_BATCH_SHRINK, PL_DECAY = 2, 0.01


def fetch_reals(batch: Dict[str, torch.Tensor], lidar, drop_const: float):
    """{"depth": (B, 1, H, W) in [0, 1]} (+ optional "mask") -> (normalised
    inverse depth in [-1, 1] with dropped pixels at ``drop_const``, mask).
    An absent mask is ``depth > 0``: the dataset zeroes every invalid pixel
    and valid depths are strictly positive.  A depth sent in a narrow wire
    dtype (``transfer_dtype``) is upcast to float32 first, so the mask is
    derived from the upcast values: only depths that round to zero in
    float16 (< 2^-25 normalised, ~3.6 um above min_depth at KITTI scale)
    could leave it."""
    depth = batch["depth"]
    if depth.dtype != torch.float32:
        depth = depth.float()
    mask = batch["mask"].to(depth.dtype) if "mask" in batch else (depth > 0).to(depth.dtype)
    inv = sigmoid_to_tanh(lidar.invert_depth(depth))
    return mask * inv + (1.0 - mask) * drop_const, mask


def apply_g(G, z, noise, compute_dtype):
    """One calling convention for plain and DUSty generators in training
    mode; ``noise`` is the Gumbel noise a DUSty generator takes as
    ``fixed_noise``."""
    if isinstance(G, (DUSty1, DUSty2)):
        return G(z, compute_dtype, train=True, fixed_noise=noise)
    return G(z, compute_dtype)


def draw_gumbel_noise(G, b: int, shape, generator, device):
    """The logistic noise fields a DUSty generator consumes for a batch of
    ``b``: None (no masker), (b, 1, H, W) (DUSty-I) or {"pixel", "image"}
    (DUSty-II)."""
    if isinstance(G, DUSty1):
        return logistic_noise(generator, b, shape, True, device=device)
    if isinstance(G, DUSty2):
        return {"pixel": logistic_noise(generator, b, shape, True, device=device),
                "image": logistic_noise(generator, b, shape, False, device=device)}
    return None


@dataclasses.dataclass
class RoundDraws:
    """The draws of one accumulation round."""

    z: torch.Tensor  # (b, in_ch)
    gumbel: object  # draw_gumbel_noise(G, b, ...)
    aug_d_real: list
    aug_d_fake: list
    aug_g_fake: list
    aug_g_real: Optional[list] = None  # relativistic modes only
    # (z (b_pl, in_ch), image noise (b_pl, 1, H, W), Gumbel noise) with PL on
    pl: Optional[Tuple[torch.Tensor, torch.Tensor, object]] = None


def sample_draws(generator: torch.Generator, device, G, *, rounds: int, b: int,
                 in_ch: int, shape, augment_policy: Sequence[str] = AUGMENT_POLICY,
                 relativistic: bool = False, use_pl: bool = False) -> List[RoundDraws]:
    """Every draw of one iteration from ``generator`` (on ``device``), in
    a fixed order, round by round."""
    h, w = shape
    aug = lambda: draw_augment(augment_policy, b, h, w, generator, device)  # noqa: E731
    out = []
    for _ in range(rounds):
        d = RoundDraws(
            z=torch.randn((b, in_ch), generator=generator, device=device),
            gumbel=draw_gumbel_noise(G, b, shape, generator, device),
            aug_d_real=aug(), aug_d_fake=aug(), aug_g_fake=aug())
        if relativistic:
            d.aug_g_real = aug()
        if use_pl:
            b_pl = b // PL_BATCH_SHRINK
            d.pl = (torch.randn((b_pl, in_ch), generator=generator, device=device),
                    losses.path_length_noise((b_pl, 1, h, w), generator, device),
                    draw_gumbel_noise(G, b_pl, shape, generator, device))
        out.append(d)
    return out


def _map_rows(fn, *trees):
    """``fn`` over the tensors of equally shaped draw trees (dicts, lists,
    tuples, tensors; anything else, such as an op name or None, is taken
    from the first tree)."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: _map_rows(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_map_rows(fn, *xs) for xs in zip(*trees))
    return t


def local_draws(draws: List[RoundDraws], process_index: int,
                process_count: int) -> List[RoundDraws]:
    """This rank's rows of an iteration's global draws: local round r holds
    this rank's ``local_batch_slice`` of global round r's rows, so that at
    every world size round r meets global round r's draws, as the JAX
    step's round r is global rows r*b..(r+1)*b on any mesh.  A rank's
    batch is read the same way: its local round r is its share of global
    round r.  Each round's relativistic means over the global round and the
    path-length baseline carried from round to round then equal one
    process's."""
    rows = lambda x: x[mesh.local_batch_slice(x.shape[0], process_index,  # noqa: E731
                                              process_count)]
    return [RoundDraws(**{f.name: _map_rows(rows, getattr(d, f.name))
                          for f in dataclasses.fields(RoundDraws)})
            for d in draws]


def _mean_scalars(rounds: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    if len(rounds) == 1:
        return rounds[0]
    return {k: torch.stack([r[k] for r in rounds]).mean() for k in rounds[0]}


class TrainStep:
    """``step(state, batch, draws) -> scalars``: one optimisation step on a
    batch of ``batch_size`` (split into ``num_accumulation`` rounds),
    updating ``state`` in place; the scalars are detached 0-d tensors."""

    def __init__(self, lidar, *, gan_mode: str = "nsgan", label_smoothing: float = 1.0,
                 loss_weight: Optional[Dict[str, float]] = None, drop_const: float = -1.0,
                 num_accumulation: int = 1, ema_decay: float = 0.5 ** (32 / 10000.0),
                 batch_size: int = 32, policy: Policy = DEFAULT_POLICY):
        lw = dict(loss_weight or {"gan": 1.0, "gp": 1.0, "pl": 0.0})
        self.w_gan = float(lw.get("gan", 1.0))
        self.w_gp = float(lw.get("gp", 0.0))
        self.w_pl = float(lw.get("pl", 0.0))
        if gan_mode not in losses.GAN_MODES:
            raise NotImplementedError(gan_mode)
        self.lidar = lidar
        self.gan_mode = gan_mode
        self.relativistic = gan_mode in losses.RELATIVISTIC
        self.label_smoothing = float(label_smoothing)
        self.drop_const = float(drop_const)
        self.A = int(num_accumulation)
        self.ema_decay = float(ema_decay)
        self.batch_size = int(batch_size)
        self.cdt = policy.compute_dtype
        self.distributed = mesh.distributed()

    @property
    def use_pl(self) -> bool:
        return self.w_pl > 0.0

    def _apply_d(self, D, x):
        return D(x, self.cdt).reshape(-1)

    def _d_round(self, D, x_real, x_fake, d: RoundDraws):
        x_real_aug = diff_augment(x_real, d.aug_d_real)
        x_fake_aug = diff_augment(x_fake, d.aug_d_fake)
        d_fn = lambda x: self._apply_d(D, x)  # noqa: E731
        if self.w_gp > 0.0:
            r1, y_real = losses.r1_penalty(d_fn, x_real_aug)
        else:
            y_real, r1 = d_fn(x_real_aug), None
        y_fake = d_fn(x_fake_aug)
        adv = losses.gan_loss_d(self.gan_mode, y_real, y_fake, self.label_smoothing)
        loss = self.w_gan * adv
        scalars = {"loss/D/output/real": y_real.mean(),
                   "loss/D/output/fake": y_fake.mean(),
                   "loss/D/adversarial": adv}
        if r1 is not None:
            loss = loss + (self.w_gp / 2.0) * r1
            scalars["loss/D/gradient_penalty"] = r1
        return loss, scalars

    def _g_round(self, G, D, x_real, d: RoundDraws, pl_ema):
        synth = apply_g(G, d.z, d.gumbel, self.cdt)
        y_fake = self._apply_d(D, diff_augment(synth["depth"], d.aug_g_fake))
        y_real = None
        if self.relativistic:
            y_real = self._apply_d(D, diff_augment(x_real, d.aug_g_real))
        adv = losses.gan_loss_g(self.gan_mode, y_real, y_fake)
        loss = self.w_gan * adv
        scalars = {"loss/G/adversarial": adv}
        if self.use_pl:
            z_pl, noise, gumbel_pl = d.pl
            g_depth = lambda zz: apply_g(G, zz, gumbel_pl, self.cdt)["depth"]  # noqa: E731
            pl_pen, pl_ema = losses.path_length_penalty(
                g_depth, z_pl, noise, pl_ema, PL_DECAY,
                batch_mean=_rank_mean if self.distributed else None)
            loss = loss + self.w_pl * pl_pen
            scalars["loss/G/path_length"] = pl_pen
            scalars["loss/G/path_length/baseline"] = pl_ema
        return loss, scalars, pl_ema

    def _backward(self, loss):
        (loss / self.A if self.A > 1 else loss).backward()

    def _reduce_grads(self, optimizer) -> None:
        if self.distributed:
            mesh.all_reduce_mean_([p.grad for g in optimizer.param_groups
                                   for p in g["params"] if p.grad is not None])

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor],
                 draws: List[RoundDraws], lr=None, stop=False
                 ) -> Dict[str, torch.Tensor]:
        """``lr``: None (each optimizer's schedule at its update count) or
        the (D, G) learning rates of this update.  ``stop``: this rank's
        stop flag (a bool, or a 0-d float32 tensor on the device), voted on
        in a process group."""
        if len(draws) != self.A:
            raise ValueError(f"{len(draws)} rounds of draws for {self.A} rounds")
        G, D = state.G, state.D
        x_real, _ = fetch_reals(batch, self.lidar, self.drop_const)
        xs_real = x_real.reshape(self.A, -1, *x_real.shape[1:])
        with torch.no_grad():
            xs_fake = [apply_g(G, d.z, d.gumbel, self.cdt)["depth"] for d in draws]

        state.opt_D.zero_grad(set_to_none=True)
        d_scalars = []
        for r, d in enumerate(draws):
            loss, scalars = self._d_round(D, xs_real[r], xs_fake[r], d)
            self._backward(loss)
            d_scalars.append({k: v.detach() for k, v in scalars.items()})
        self._reduce_grads(state.opt_D)
        scheduled_step(state.opt_D, state.schedule_D, None if lr is None else lr[0])

        # G phase against the updated D; D's parameters take no gradient
        state.opt_G.zero_grad(set_to_none=True)
        D.requires_grad_(False)
        g_scalars, pl_ema = [], state.pl_ema
        try:
            for r, d in enumerate(draws):
                loss, scalars, pl_ema = self._g_round(G, D, xs_real[r], d, pl_ema)
                self._backward(loss)
                g_scalars.append({k: v.detach() for k, v in scalars.items()})
        finally:
            D.requires_grad_(True)
        self._reduce_grads(state.opt_G)
        scheduled_step(state.opt_G, state.schedule_G, None if lr is None else lr[1])

        ema_update(state.G_ema, G, self.ema_decay)
        if pl_ema is not state.pl_ema:
            state.pl_ema.copy_(pl_ema)
        state.step += self.batch_size
        scalars = {**_mean_scalars(d_scalars), **_mean_scalars(g_scalars)}
        if self.distributed:
            if isinstance(stop, torch.Tensor):
                flag = stop.reshape(()).float()
            else:
                # a fill, not a copy from the host: the host does not wait
                # for the step's work
                flag = torch.full((), float(stop), device=x_real.device)
            vec = torch.stack([v.float() for v in scalars.values()] + [flag])
            mesh.all_reduce_mean_([vec])
            scalars = dict(zip(list(scalars) + ["stop/agreed"], vec.unbind()))
        return scalars


def _rank_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of a detached 0-d tensor over ranks."""
    out = x.detach().reshape(1).clone()
    mesh.all_reduce_mean_([out])
    return out[0]
