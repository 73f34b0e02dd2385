"""Training state (``dusty_gan_tpu/train/state.py``): the image-step
counter, G, D, the EMA generator G_ema, one ``torch.optim.Adam`` each for G
and D, and the path-length EMA ``pl_ema`` — the contents of a reference
checkpoint ``{step, G, D, G_ema, optim_G, optim_D, pl_ema}``.

The solver's ``lr.alpha.decay`` is a StepLR schedule over optimizer
updates, ``lr * gamma ** (n // step_size)`` for the update after n
others, optax's staircase ``exponential_decay`` in the JAX package.  It is
computed from the optimizer's own update count before each update, so a
resumed run (whose Adam state carries the count) continues the schedule.

On CUDA, Adam steps in its capturable mode (``make_capturable``: its
update reads its step counter and a tensor learning rate in device
memory), on the per-step path and in CUDA-graph chunks
(``train/graphs.py``) alike, so that the two share one arithmetic.  A
host read of that count would synchronise (and inside a capture, fail),
so both pass each update's learning rate instead (``scheduled_step(...,
lr=)``), computed by the same schedule from the count the host tracks
(``Trainer.next_lrs``).
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class LRSchedule:
    lr: float
    gamma: float = 1.0
    step_size: int = 1

    def at(self, updates_done: int) -> float:
        return self.lr * self.gamma ** (updates_done // self.step_size)


def make_optimizer(module: nn.Module, beta1: float, beta2: float) -> torch.optim.Adam:
    """Adam over ``module.parameters()`` (the reference's order, which the
    checkpoint's parameter indices follow); the learning rate is set by the
    schedule before every update."""
    return torch.optim.Adam(module.parameters(), lr=0.0, betas=(beta1, beta2), eps=1e-8)


def updates_done(optimizer: torch.optim.Optimizer) -> int:
    """Updates the optimizer has made (its per-parameter ``step``)."""
    for state in optimizer.state.values():
        return int(state["step"])
    return 0


def scheduled_step(optimizer: torch.optim.Optimizer, schedule: LRSchedule,
                   lr=None) -> None:
    """One update at the schedule's rate, or at ``lr`` (a float, or a 0-d
    device tensor that a captured update reads at replay)."""
    set_lr(optimizer, schedule.at(updates_done(optimizer)) if lr is None else lr)
    optimizer.step()


def set_lr(optimizer: torch.optim.Optimizer, lr) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def make_capturable(optimizer: torch.optim.Adam) -> None:
    """Switch Adam to its capturable update, which a CUDA graph can hold:
    the step counter moves to the parameter's device, and a parameter
    without state gets the state a first update would create (zero
    moments, count 0), so that no capture allocates or zeroes it."""
    for group in optimizer.param_groups:
        group["capturable"] = True
        for p in group["params"]:
            state = optimizer.state[p]
            if not state:
                state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                state["exp_avg"] = torch.zeros_like(p)
                state["exp_avg_sq"] = torch.zeros_like(p)
            else:
                state["step"] = state["step"].to(p.device, torch.float32)


@dataclasses.dataclass
class TrainState:
    G: nn.Module
    D: nn.Module
    G_ema: nn.Module
    opt_G: torch.optim.Adam
    opt_D: torch.optim.Adam
    schedule_G: LRSchedule
    schedule_D: LRSchedule
    pl_ema: torch.Tensor  # float32 scalar on the models' device
    step: int = 0  # images seen


def create_train_state(G: nn.Module, D: nn.Module, *, lr_G: float, lr_D: float,
                       beta1: float, beta2: float, decay_gamma: float = 1.0,
                       decay_step_size: int = 1) -> TrainState:
    """G_ema starts as a copy of G; both optimizers and the schedules as the
    solver config gives them."""
    device = next(G.parameters()).device
    return TrainState(
        G=G, D=D, G_ema=copy.deepcopy(G).requires_grad_(False),
        opt_G=make_optimizer(G, beta1, beta2), opt_D=make_optimizer(D, beta1, beta2),
        schedule_G=LRSchedule(lr_G, decay_gamma, int(decay_step_size)),
        schedule_D=LRSchedule(lr_D, decay_gamma, int(decay_step_size)),
        pl_ema=torch.zeros((), dtype=torch.float32, device=device),
    )


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * model, parameter by parameter."""
    for e, p in zip(ema.parameters(), model.parameters()):
        e.copy_(e * decay + p.to(e.dtype) * (1.0 - decay))
