"""Trainer (``dusty_gan_tpu/train/trainer.py``): config -> models,
optimizers, datasets, loader and train state on one device; ``step(i,
batch)`` runs iteration i; ``step_chunk(iters, rows)`` runs consecutive
iterations in one call (``steps_per_call``); ``validation`` scores G_ema;
``save`` writes a reference-format checkpoint; ``cfg.resume`` continues
from one (the port's, or the JAX package's ``.pth`` export).

Randomness: the weights are initialised from ``seed``; iteration i draws
everything it needs (latents, Gumbel noise, DiffAugment, path-length
noise) from one generator seeded ``derived_seed(seed, TRAIN_STREAM, i)``,
as the JAX step folds i into its root key, so a resumed run replays the
uninterrupted run's draws; validation draws its latents from a generator
keyed on the image step.

Image logging (``generate``): G or G_ema in eval mode on ``fixed_latent``
(min(batch, 16) latents drawn once from the run's seed), with Gumbel pixel
noise from a generator of its own seed, the same at every call, as the JAX
trainer draws from one fixed key; it returns ``postprocess``'s dict.  In
chunk mode it runs between replays, reading G's parameters, which the
graphs update in place.

Validation (``validation``): the real side (val split, FPS to
``solver.validation.num_points``) is computed once per sample count;
G_ema in eval mode generates fresh samples; the scores are SWD, JSD,
COV/MMD/1-NNA over three pairwise Chamfer matrices (kernel K1,
``cd_block``, for CUDA tensors) and the drop-mask marginals
``drop_rate/fake``, ``drop_rate/real`` and ``drop_row_l1``.

Data: with ``cache_dataset`` (default true) the train and val splits read
the resized cache under ``<dataset.root>/cache`` (built at the first run,
shared with the JAX package).  ``device_iter`` feeds the step: by default
the loader's host batches, copied from pinned memory without a host wait
(``transfer_dtype`` narrows the copy, e.g. to float16); with
``cache_device=true`` the whole resized train split lives on the device
and each step sends only its indices (``data/device_cache.py``).  Either
way the batch stream is a function of the iteration alone.

Ranks (``parallel/mesh.py``): in a process group of W ranks each rank
holds the same state and trains on its share of the global batch of
``solver.batch_size`` (its ``Loader`` shard, or its rows of the device
cache, which holds the whole split on every card), its local round r
being its share of global round r, with its rows of the iteration's
global draws (``local_draws``); the step averages the gradients.
Validation, image logging and checkpoints are the caller's to run on rank
0 alone; ``validation`` issues no collective.  Every ``gan_mode`` trains
in a group: the relativistic ones take each side's mean over the global
batch (``mesh.global_mean``).

Adam (``next_lrs``): on CUDA both optimizers step in Adam's capturable
mode from the first update on, per step and in chunks alike, with each
update's learning rate a float32 tensor on the card, from the schedule at
the update count the host tracks; so a chunk's graph replays the
per-step path's arithmetic.  On the CPU Adam keeps its default update.

Chunks (``steps_per_call=K``, K > 1, which needs ``cache_device=true``):
``step_chunk`` runs k consecutive iterations on their device-cache rows
(``train/graphs.py``): on CUDA through one captured CUDA graph per chunk
length, with each iteration's draws made eagerly from its own generator
and its learning rate from the schedule; on the CPU eagerly through the
same buffers.  The batches and draws are the per-step path's.  In a
group each rank runs its rows of each iteration, the captured steps
all-reduce over NCCL, and ``step_chunk`` takes this rank's stop flag and
returns the vote in ``stop/agreed``; ``chunks.prepare`` captures a run's
chunk lengths up front on every rank.
"""

from __future__ import annotations

import collections
import os.path as osp
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dusty_gan_torch import synchronize
from dusty_gan_torch.core.dtypes import policy_from_cfg
from dusty_gan_torch.data.datasets import define_dataset
from dusty_gan_torch.data.device_cache import DeviceDatasetCache
from dusty_gan_torch.data.loader import Loader
from dusty_gan_torch.geometry.lidar import Lidar, tanh_to_sigmoid
from dusty_gan_torch.metrics.cov_mmd_1nna import compute_cov_mmd_1nna
from dusty_gan_torch.metrics.fps import downsample_point_clouds
from dusty_gan_torch.metrics.jsd import compute_jsd
from dusty_gan_torch.metrics.swd import TorchDraws, compute_swd
from dusty_gan_torch.models.dusty import DUSty1, DUSty2
from dusty_gan_torch.models.factory import define_D, define_G
from dusty_gan_torch.parallel import mesh
from dusty_gan_torch.train.checkpoint import (checkpoint_name, restore_checkpoint,
                                              save_checkpoint)
from dusty_gan_torch.train.graphs import ChunkRunner
from dusty_gan_torch.train.state import (create_train_state, make_capturable, set_lr,
                                         updates_done)
from dusty_gan_torch.train.step import (PL_BATCH_SHRINK, TrainStep, fetch_reals,
                                        local_draws, sample_draws)
from dusty_gan_torch.utils.postprocess import postprocess

TRAIN_STREAM, VALIDATION_STREAM, FIXED_LATENT_STREAM, GENERATE_STREAM = 0, 1, 2, 3
LOGGED_SAMPLES = 16  # latents of the logged samples, at most


def derived_seed(seed: int, stream: int, i: int) -> int:
    """64-bit generator seed for draw ``i`` of ``stream``.  A CPU generator
    keeps only the low 32 bits, so those carry (seed, stream, i) by odd
    multipliers (distinct for every i below 2**32 within a stream); the high
    bits carry the seed again for CUDA generators."""
    low = (seed * 0x9E3779B1 + stream * 0x85EBCA77 + i) & 0xFFFFFFFF
    return ((seed & 0x7FFFFFFF) << 32) | low


def wire_dtype(name) -> Optional[torch.dtype]:
    """``transfer_dtype`` -> the torch dtype host batches cross in (None:
    float32, as loaded).  Floating dtypes only: an integer dtype would
    truncate normalised depths to 0."""
    if not name:
        return None
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"transfer_dtype must be a floating dtype, got {name!r} (an "
                         "integer dtype would truncate normalized depths to 0)")
    return dt


class Trainer:
    def __init__(self, cfg, device: torch.device, verbose: bool = True):
        self.steps_per_call = int(cfg.get("steps_per_call") or 0)
        if self.steps_per_call > 1 and not cfg.get("cache_device"):
            raise ValueError(
                "steps_per_call needs cache_device=true (the scan body "
                "gathers batches from the device-resident dataset)")
        self.rank, self.world = mesh.rank(), mesh.world_size()
        self.cfg = cfg
        self.device = device
        self.policy = policy_from_cfg(bool(cfg.get("enable_amp", True)))
        self.seed = int(cfg.get("seed") or 0)
        self.transfer_dtype = wire_dtype(cfg.get("transfer_dtype"))
        cfg.model.gen.shape = list(cfg.dataset.shape)
        cfg.model.dis.shape = list(cfg.dataset.shape)
        self.shape = tuple(cfg.dataset.shape)
        self.in_ch = int(cfg.model.gen.in_ch)

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            G, D = define_G(cfg), define_D(cfg)
        self.masked = isinstance(G, (DUSty1, DUSty2))

        angle_file = next((p for p in (osp.join(cfg.dataset.root, c)
                                       for c in ("angles.npy", "angles.pt"))
                           if osp.exists(p)), None)
        if angle_file is None:
            raise FileNotFoundError(f"no angles.npy/angles.pt under {cfg.dataset.root}")
        self.lidar = Lidar.from_angle_file(angle_file, self.shape, cfg.dataset.min_depth,
                                           cfg.dataset.max_depth, device=device)

        solver = cfg.solver
        self.batch_size = int(solver.batch_size)
        self.num_accumulation = int(solver.get("num_accumulation", 1))
        if self.batch_size % (self.num_accumulation * self.world):
            raise ValueError(f"batch {self.batch_size} does not split into "
                             f"{self.num_accumulation} accumulation rounds on each "
                             f"of {self.world} ranks")
        pl_rows = self.batch_size // self.num_accumulation // PL_BATCH_SHRINK
        if float(solver.loss.get("pl", 0.0)) > 0.0 and pl_rows % self.world:
            raise ValueError(f"the path-length batch of {pl_rows} a round does not split "
                             f"over {self.world} ranks")
        self.ema_decay = 0.5 ** (self.batch_size / (float(solver.smoothing_kimg) * 1000.0))
        lr = solver.lr
        decay = lr.alpha.get("decay") or {}
        self.state = create_train_state(
            G.to(device), D.to(device), lr_G=float(lr.alpha.gen), lr_D=float(lr.alpha.dis),
            beta1=float(lr.beta1), beta2=float(lr.beta2),
            decay_gamma=float(decay.get("gamma", 1.0)),
            decay_step_size=int(decay.get("step_size", 1)))

        cache_dir = (osp.join(cfg.dataset.root, "cache")
                     if cfg.get("cache_dataset", True) else None)
        self.dataset = define_dataset(cfg.dataset, phase="train", cache_dir=cache_dir)
        if len(self.dataset) < self.batch_size:
            raise ValueError(
                f"train split has {len(self.dataset)} scans but one step needs "
                f"batch_size = {self.batch_size}; reduce solver.batch_size or add "
                f"data (root={cfg.dataset.root})")
        self.loader = Loader(self.dataset, self.batch_size, shuffle=True, drop_last=True,
                             seed=self.seed, process_index=self.rank,
                             process_count=self.world, keys=("depth",))
        self.val_dataset = define_dataset(cfg.dataset, phase="val", cache_dir=cache_dir)
        self.val_loader = Loader(self.val_dataset, self.batch_size)
        self.device_cache = (DeviceDatasetCache(self.loader, device, keys=("depth",))
                             if cfg.get("cache_device") else None)

        self.augment_policy = tuple(solver.augment or [])
        self.train_step = TrainStep(
            self.lidar, gan_mode=str(solver.gan_mode),
            label_smoothing=float((solver.get("label") or {}).get("smoothing", 1.0)),
            loss_weight={k: float(v) for k, v in dict(solver.loss).items()},
            drop_const=float(cfg.model.gen.drop_const),
            num_accumulation=self.num_accumulation, ema_decay=self.ema_decay,
            batch_size=self.batch_size, policy=self.policy)

        self.start_iteration = 0
        self.updates: Optional[Tuple[int, int]] = None  # (D, G) updates, counted on the host
        if cfg.get("resume"):
            seed = restore_checkpoint(str(cfg.resume), self.state, cfg)
            if seed is not None:  # the run's own seed rules its draws and its loader
                self.seed = self.loader.seed = seed
            self.start_iteration = self.state.step // self.batch_size
            if verbose:
                print(f"resumed from {cfg.resume} at iteration {self.start_iteration}")
        g = torch.Generator().manual_seed(derived_seed(self.seed, FIXED_LATENT_STREAM, 0))
        self.fixed_latent = torch.randn((min(self.batch_size, LOGGED_SAMPLES), self.in_ch),
                                        generator=g).to(device)
        self._val_cache: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.chunks = (ChunkRunner(self, self.steps_per_call) if self.steps_per_call > 1
                       else None)

        if verbose:
            if self.device_cache is not None:
                print(f"device cache: {self.device_cache.n} scans"
                      f"{' and their flips' if self.device_cache.flip else ''}, "
                      f"{self.device_cache.nbytes / 1e6:.1f} MB")
            n = sum(p.numel() for p in self.state.G.parameters())
            print(f"device: {device}, G params: {n:,}, batch {self.batch_size} x accum "
                  f"{self.num_accumulation}, ema decay {self.ema_decay:.6f}"
                  + (f", {self.world} ranks" if self.world > 1 else ""))

    # ------------------------------------------------------------------
    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """(B, H, W, 1) host arrays -> (B, 1, H, W) tensors on the device, in
        ``transfer_dtype`` when one is set (through pinned memory, without
        a host wait, on CUDA)."""
        out = {}
        for k in ("depth", "mask"):
            if k in batch:
                t = torch.from_numpy(np.ascontiguousarray(batch[k])).permute(0, 3, 1, 2)
                if self.transfer_dtype is not None:
                    t = t.to(self.transfer_dtype)
                if self.device.type == "cuda":
                    t = t.pin_memory().to(self.device, non_blocking=True)
                out[k] = t
        return out

    def device_iter(self, lookahead: int = 2, start_iteration: Optional[int] = None):
        """Infinite stream of device batches from ``start_iteration``
        (default: the resume point).  The copies of the next ``lookahead``
        batches are issued before the current one is handed out: pinned,
        non-blocking copies on the current stream, which the host does not
        wait for.  With the device cache only the indices cross."""
        start = self.start_iteration if start_iteration is None else int(start_iteration)
        q = collections.deque()
        if self.device_cache is not None:
            ix = self.loader.index_stream(start)
            while True:
                while len(q) < lookahead:
                    q.append(self.device_cache.batch(*next(ix)))
                yield q.popleft()
        it = self.loader.iter_from(start)
        try:
            while True:
                while len(q) < lookahead:
                    q.append(self.to_device(next(it)))
                yield q.popleft()
        finally:
            it.close()

    def draws(self, i: int):
        """Every draw of iteration ``i`` for the global batch; in a group of
        more than one rank, this rank's rows of them."""
        g = torch.Generator(device=self.device)
        g.manual_seed(derived_seed(self.seed, TRAIN_STREAM, i))
        draws = sample_draws(
            g, self.device, self.state.G, rounds=self.num_accumulation,
            b=self.batch_size // self.num_accumulation, in_ch=self.in_ch, shape=self.shape,
            augment_policy=self.augment_policy,
            relativistic=self.train_step.relativistic, use_pl=self.train_step.use_pl)
        return local_draws(draws, self.rank, self.world) if self.world > 1 else draws

    def next_lrs(self, k: int = 1) -> list:
        """The (D, G) learning rates of the next ``k`` updates by the
        schedules, which the caller makes.  The update count is read from
        Adam's state while it lives on the host; on CUDA the first call
        moves it to the card (``make_capturable``), and from there on the
        host counts."""
        st = self.state
        if self.updates is None or self.device.type != "cuda":
            self.updates = (updates_done(st.opt_D), updates_done(st.opt_G))
            if self.device.type == "cuda":
                make_capturable(st.opt_D)
                make_capturable(st.opt_G)
        n_d, n_g = self.updates
        self.updates = (n_d + k, n_g + k)
        return [(st.schedule_D.at(n_d + j), st.schedule_G.at(n_g + j)) for j in range(k)]

    def step(self, i: int, batch, stop: bool = False, draws=None) -> Dict[str, torch.Tensor]:
        """Iteration ``i`` (1-based) on a host or device batch (this rank's
        rows), with ``draws`` (default ``draws(i)``); ``stop`` is this
        rank's stop flag, voted on in a group."""
        if isinstance(batch["depth"], np.ndarray):
            batch = self.to_device(batch)
        draws = self.draws(i) if draws is None else draws
        if self.device.type != "cuda":
            return self.train_step(self.state, batch, draws, stop=stop)
        lrs = self.next_lrs()[0]
        # fills, not copies from the host: the host does not wait for the step
        lr = tuple(torch.full((), v, dtype=torch.float32, device=self.device) for v in lrs)
        with warnings.catch_warnings():
            # Adam's capturable update warns that it steps outside a capture
            warnings.filterwarnings("ignore", message=".*capturable=True")
            scalars = self.train_step(self.state, batch, draws, lr, stop=stop)
        for opt, v in zip((self.state.opt_D, self.state.opt_G), lrs):
            set_lr(opt, v)  # what a checkpoint records
        return scalars

    def step_chunk(self, iters, rows: np.ndarray, draws=None,
                   stop: bool = False) -> Dict[str, torch.Tensor]:
        """Consecutive iterations ``iters`` (1-based) in one call: ``rows``
        (k, B / W) holds each one's device-cache rows of this rank
        (``device_cache.rows``), ``draws`` k lists of RoundDraws (default:
        ``draws(i)``; a test passes the JAX package's), ``stop`` this
        rank's stop flag, voted on in a group.  Returns the last
        iteration's scalars."""
        if self.chunks is None:
            raise ValueError("step_chunk needs steps_per_call > 1")
        return self.chunks.run(iters, rows, draws, stop)

    @torch.no_grad()
    def generate(self, ema: bool = True, latent: Optional[torch.Tensor] = None,
                 noise=None, train_mode: bool = False) -> Dict[str, torch.Tensor]:
        """Samples of G_ema (``ema``) or G for image logging, postprocessed
        (B, H, W, C).  ``latent`` defaults to ``fixed_latent``; ``noise`` is
        the Gumbel noise in ``fixed_noise``'s form (default: drawn from the
        generator of ``GENERATE_STREAM``)."""
        G = self.state.G_ema if ema else self.state.G
        z = self.fixed_latent if latent is None else latent.to(self.device)
        cdt = self.policy.compute_dtype
        if self.masked:
            g = torch.Generator(device=self.device)
            g.manual_seed(derived_seed(self.seed, GENERATE_STREAM, 0))
            out = G(z, cdt, train=train_mode, fixed_noise=noise, generator=g)
        else:
            out = G(z, cdt)
        return postprocess({k: v.permute(0, 2, 3, 1) for k, v in out.items()}, self.lidar)

    # ------------------------------------------------------------------
    def _inv_to_points(self, inv_nhwc: torch.Tensor) -> torch.Tensor:
        inv01 = torch.clamp(tanh_to_sigmoid(inv_nhwc), 0.0, 1.0)
        xyz = self.lidar.inv_to_xyz(inv01, 1e-8)
        return downsample_point_clouds(xyz.reshape(xyz.shape[0], -1, 3),
                                       int(self.cfg.solver.validation.num_points))

    def _val_real_side(self, n_total: int):
        """(inverse depth (N, H, W, 1), clouds (N, P, 3)) of the first
        ``n_total`` val scans, computed once per ``n_total``."""
        hit = self._val_cache.get(n_total)
        if hit is None:
            real_2d, real_3d, seen = [], [], 0
            drop = float(self.cfg.model.gen.drop_const)
            for batch in self.val_loader.epoch(0):
                inv, _ = fetch_reals(self.to_device(batch), self.lidar, drop)
                inv = inv.permute(0, 2, 3, 1)
                real_2d.append(inv)
                real_3d.append(self._inv_to_points(inv))
                seen += inv.shape[0]
                if seen >= n_total:
                    break
            hit = (torch.cat(real_2d)[:n_total], torch.cat(real_3d)[:n_total])
            self._val_cache[n_total] = hit
        return hit

    @torch.no_grad()
    def validation(self, max_samples: Optional[int] = None) -> Dict[str, float]:
        """Scores of G_ema against the val split."""
        n_total = len(self.val_dataset) if max_samples is None else min(
            len(self.val_dataset), max_samples)
        real_2d, real_3d = self._val_real_side(n_total)
        G = self.state.G_ema.eval()
        g = torch.Generator(device=self.device)
        g.manual_seed(derived_seed(self.seed, VALIDATION_STREAM, self.state.step))
        cdt = self.policy.compute_dtype
        fake_2d, fake_3d = [], []
        for _ in range(0, n_total, self.batch_size):
            z = torch.randn((self.batch_size, self.in_ch), generator=g, device=self.device)
            out = (G(z, cdt, train=False, generator=g) if self.masked else G(z, cdt))
            inv = out["depth"].permute(0, 2, 3, 1)
            fake_2d.append(inv)
            fake_3d.append(self._inv_to_points(inv))
        fake_2d = torch.cat(fake_2d)[:n_total]
        fake_3d = torch.cat(fake_3d)[:n_total]

        scores = dict(compute_swd(fake_2d, real_2d, TorchDraws(self.seed)))
        scores["jsd"] = compute_jsd(fake_3d / 2.0, real_3d / 2.0)
        scores.update(compute_cov_mmd_1nna(fake_3d, real_3d, 512, ("cd",)))
        # per-elevation-row drop rates: dropped pixels sit at drop_const on
        # both sides
        drop_thr = float(self.cfg.model.gen.drop_const) + 1e-3
        p_fake = (fake_2d < drop_thr).float().mean(dim=(0, 2, 3))
        p_real = (real_2d < drop_thr).float().mean(dim=(0, 2, 3))
        scores["drop_rate/fake"] = p_fake.mean()
        scores["drop_rate/real"] = p_real.mean()
        scores["drop_row_l1"] = (p_fake - p_real).abs().mean()
        synchronize(self.device)
        return {k: float(v) for k, v in scores.items()}

    # ------------------------------------------------------------------
    def save(self, models_dir: str, images_seen: int) -> str:
        return save_checkpoint(osp.join(models_dir, checkpoint_name(images_seen)),
                               self.state, self.seed)
