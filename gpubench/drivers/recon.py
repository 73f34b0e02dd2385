"""The reconstruction benchmark (``cli/evaluate_reconstruction.py``):
``reconstruct_batch`` on batches of seeded test scans: the inversion of a
spherical latent through the EMA generator in bf16 on fixed Gumbel noise
against the masked L1 of the inverse depth, then the scores, the Chamfer
distance on the full clouds through K2 (``nn_dist``) among them, copied
to the host a batch at a time as the CLI collects its rows.

Set-up makes the seeded generator, noise and test scans (depth, mask and
unit-space points, as the dataset serves them) and runs a two-step
inversion of the first batch, which builds K2 and settles the
convolutions' algorithms.  The window inverts batches in turn, each from
its own seeded initial latent and per-step noise; the rate is scans times
inversion steps over the window's time.

The check, on the last batch, reads what the timed path computed there:

* ``gen_start_gap``: the generator's first output (the depth before the
  masks at the first noise-perturbed latent, bf16) against the
  reference's at the same latent: mean absolute gap over mean absolute
  value;
* ``move5_gap``: the latent that the inversion's step 5 took against the
  reference's float32 inversion from the same initial latents and noise,
  over the reference's move from its first latent (a loop that does not
  move reads 1);
* ``loop_steps_gap``: over every batch of the run, the largest gap between
  the loss evaluations the inversion made and the ``num_step + 1`` that
  ``recon_scan_steps_per_s`` counts (a step each, and the loss at z*):
  exact, limit 0;
* ``gen_end_gap``: the reconstruction, the generator's output at the
  latent z* that the inversion returned (the depth before the masks,
  bf16), against the reference generator's at that same z*, as
  ``gen_start_gap``;
* ``cd_gap``: the largest relative gap of the program's Chamfer score of
  ``checked_scans`` scans, drawn from the seed, against the reference's
  score of the same two clouds (the scan's and the reconstruction's, as
  the program formed them: the check follows the program from its own
  reconstruction there).

The latent z* itself is not compared with the reference's: from the same
latents and noise an fp8 inversion ends within 3e-4 of the float32 one's
loss and within 0.4-0.56 of its latents (relative), and the bf16 program
within 3e-5 and 0.2-0.31, so neither separates the program from its
control; by step 5 the three have parted by 0.08-0.09 (bf16) and
0.31-0.33 (fp8).  So a fault in the loop's schedules after step 5 that
keeps the number of steps shows in no number.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from gpubench import flops, inputs, trace
from gpubench.reference import inversion as ref
from gpubench.reference import models
from gpubench.reference.precision import FLOAT32, FP8, Precision, strict_float32

NUMBERS = ("gen_start_gap", "move5_gap", "loop_steps_gap", "gen_end_gap", "cd_gap")
WARMUP_STEPS = 2
MOVE_STEP = 5  # the inversion step whose latent the check reads


def scan_items(depth01: torch.Tensor, sensor: dict, shape, min_depth: float,
               max_depth: float) -> Dict[str, np.ndarray]:
    """The dataset's items of normalised depths (n, H, W): depth and mask
    (n, H, W, 1) and unit-space points (n, H, W, 3), zero where no return."""
    grid = torch.from_numpy(inputs.angles(sensor, shape)).to(depth01.device)
    pitch, yaw = grid[0], grid[1]
    ray = torch.stack([torch.cos(pitch) * torch.cos(yaw), torch.cos(pitch) * torch.sin(yaw),
                       torch.sin(pitch)], dim=-1)
    valid = depth01 > 0
    metres = depth01 * (max_depth - min_depth) + min_depth
    xyz = torch.where(valid[..., None], metres[..., None] * ray / max_depth,
                      torch.zeros((), device=depth01.device))
    return {"depth": depth01[..., None].cpu().numpy(),
            "mask": valid[..., None].float().cpu().numpy(), "xyz": xyz.cpu().numpy()}


def _mean_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().mean() / b.abs().mean())


def _move(got: dict, want: dict) -> float:
    """Step ``MOVE_STEP``'s latent against the reference's, over the
    reference's move from the first step's latent; a loop that never took
    that step is read where it started."""
    x = got.get(MOVE_STEP, got[0])
    return float(torch.linalg.vector_norm(x - want[MOVE_STEP])
                 / torch.linalg.vector_norm(want[MOVE_STEP] - want[0]))


class Run:
    def __init__(self, spec: dict, seed: int, device, rec):
        self.cfg, self.traffic = spec["config_data"], spec["traffic"]
        self.limits = self.traffic["limits"]
        self.seed, self.device, self.rec = int(seed), device, rec
        proto = self.cfg["protocol"]
        self.batch = int(proto["recon_batch"])
        self.steps = int(proto["num_step"])
        self.distance = str(proto["distance"])
        self.tol = float(proto["tol"])
        self.shape = tuple(self.cfg["dataset"]["shape"])
        self.in_ch = int(self.cfg["model"]["gen"]["in_ch"])
        self.attempted = self.failed = 0
        self.trace_on = False
        self.context: dict = {}
        self.loss_calls: list = []  # the inversion's loss evaluations, batch by batch

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def noise_field(self):
        gen = inputs.generator(self.seed, inputs.EXTRA, self.device)
        return {"pixel": inputs.logistic(gen, (1, 1) + self.shape, self.device),
                "image": inputs.logistic(gen, (1, 1, 1, 1), self.device)}

    def weights(self):
        gen = inputs.generator(self.seed, inputs.WEIGHTS, self.device)
        return models.make_params(models.generator_spec(self.cfg["model"], self.shape), gen,
                                  self.device)

    def draws(self, bi: int):
        """Batch ``bi``'s initial latents and its per-step noise."""
        z0 = torch.randn((self.batch, self.in_ch), device=self.device,
                         generator=inputs.generator(self.seed, 100 + 2 * bi, self.device))
        g = inputs.generator(self.seed, 101 + 2 * bi, self.device)
        return z0, (lambda step, shape: torch.randn(shape, generator=g, device=self.device))

    def items(self, bi: int) -> Dict[str, np.ndarray]:
        nb = len(self.scans["depth"]) // self.batch
        s = (bi % nb) * self.batch
        return {k: v[s:s + self.batch] for k, v in self.scans.items()}

    def setup(self) -> None:
        from dusty_gan_torch import resolve_device
        from dusty_gan_torch.cli import evaluate_reconstruction as er
        from dusty_gan_torch.config import Config
        from dusty_gan_torch.geometry.lidar import Lidar
        from dusty_gan_torch.models.factory import define_G
        from dusty_gan_torch.utils.setup import make_eval_generator

        resolve_device(self.device)
        cfg, dev, ds = self.cfg, self.device, self.cfg["dataset"]
        self.er = er
        lo, hi = float(ds["min_depth"]), float(ds["max_depth"])
        with self.rec.span("setup.inputs"):
            depth = inputs.scans(int(self.traffic["test_scans"]), self.shape, ds["sensor"], lo,
                                 hi, inputs.generator(self.seed, inputs.SCANS, dev), dev)
            self.scans = scan_items(depth, ds["sensor"], self.shape, lo, hi)
            del depth
        with self.rec.span("setup.generator"):
            pcfg = Config.wrap({"model": dict(cfg["model"]), "dataset": dict(ds)})
            pcfg.model.gen = Config.wrap(dict(cfg["model"]["gen"], shape=list(self.shape)))
            G = define_G(pcfg)
            missing = G.load_state_dict(self.weights(), strict=False)
            if missing.unexpected_keys or any(k != "drop_const" for k in missing.missing_keys):
                raise ValueError(f"the program's generator does not take the reference's "
                                 f"parameters: {missing}")
            self.G = G.to(dev).eval().requires_grad_(False)
            self.gen = make_eval_generator(self.G, self.noise_field())
            self.lidar = Lidar.from_angle_array(inputs.angles(ds["sensor"], self.shape),
                                                self.shape, lo, hi, device=dev)
        with self.rec.span("setup.warmup"):
            z0, noise = self.draws(0)
            er.reconstruct_batch(self.gen, self.lidar, self.items(0), z0, noise, True,
                                 self.distance, WARMUP_STEPS, self.tol)
            self._sync()
        self.context["setup_parts_s"] = {n: b - a for n, a, b in self.rec.spans
                                         if n.startswith("setup.")}

    def _batch(self, bi: int) -> None:
        er = self.er
        loop, cd = er.make_inversion_loop, er.compute_cd
        seen: dict = {}

        def spy_loop(loss_fn, *args, **kw):
            def tapped(x):  # the latent and the loss of each step, as the loop takes them
                out = loss_fn(x)
                k = seen.setdefault("calls", 0)
                if k in (0, MOVE_STEP):
                    seen.setdefault("x", {})[k] = x.detach().clone()
                seen["calls"] = k + 1
                return out
            run = loop(tapped, *args, **kw)

            def spied(z0, noise):
                seen["z_star"], seen["loss"] = run(z0, noise)
                return seen["z_star"], seen["loss"]
            return spied

        def spy_cd(a, b):
            seen["clouds"] = (a, b)
            seen["cd"] = cd(a, b)
            return seen["cd"]

        def spy_gen(z, *args, **kw):
            out = self.gen(z, *args, **kw)
            # the first output (the start) and the last (the reconstruction)
            seen.setdefault("gen0", out["depth_orig"].detach().clone())
            seen["gen_end"] = out["depth_orig"].detach()
            return out

        er.make_inversion_loop, er.compute_cd = spy_loop, spy_cd
        try:
            z0, noise = self.draws(bi)
            res = er.reconstruct_batch(spy_gen, self.lidar, self.items(bi), z0, noise, True,
                                       self.distance, self.steps, self.tol)
            rows = {k: v.float().cpu() for k, v in res.items()}  # the CLI's per-batch rows
        finally:
            er.make_inversion_loop, er.compute_cd = loop, cd
        self.loss_calls.append(seen.get("calls", 0))
        self.last = dict(seen, bi=bi, rows=rows)

    def window(self, seconds: float, trace_on: bool) -> dict:
        self._sync()
        self.rec.spans.clear()
        t0 = time.perf_counter()
        batches = 0
        while True:
            with self.rec.span("recon.batch"):
                self._batch(batches)
            batches += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        window_s = time.perf_counter() - t0
        self.attempted = batches
        self.trace_on = trace_on
        self.context.update(window_s=window_s, batches=batches, batch=self.batch,
                            steps=self.steps)
        return {"recon_scan_steps_per_s": batches * self.batch * self.steps / window_s}

    def traced(self) -> dict:
        return trace.traced(lambda: self._batch(self.context["batches"]), self._sync)

    def release(self) -> None:
        last = self.last
        a, b = last["clouds"]
        self.out = {"bi": last["bi"], "z_star": last["z_star"].detach().clone(),
                    "x": last["x"], "gen0": last["gen0"], "gen_end": last["gen_end"].clone(),
                    "ref_points": a.cpu(), "gen_points": b.cpu(), "cd": last["cd"].cpu()}
        self.G = self.gen = self.last = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --------------------------------------------------------------- check
    def loss_fn(self, bi: int, prec: Precision = FLOAT32):
        """The reference's per-scan masked L1 of batch ``bi`` at a latent."""
        strict_float32()
        ds = self.cfg["dataset"]
        lo, hi = float(ds["min_depth"]), float(ds["max_depth"])
        it = self.items(bi)
        mask = torch.from_numpy(it["mask"]).to(self.device).permute(0, 3, 1, 2)
        d = torch.from_numpy(it["depth"]).to(self.device).permute(0, 3, 1, 2)
        inv_ref = (1.0 / (d * (hi - lo) + lo) - 1.0 / hi) / (1.0 / lo - 1.0 / hi) * mask
        p, noise = self.weights(), self.noise_field()

        def loss(z):
            out = models.generator(p, z, noise, self.cfg["model"], self.shape, train=False,
                                   prec=prec)
            return ref.masked_l1(inv_ref, (out["depth_orig"] + 1.0) / 2.0, mask)
        return loss

    def reference_gen(self, z: torch.Tensor, prec: Precision = FLOAT32) -> torch.Tensor:
        """(B, H, W, 1) depth before the masks, of the reference generator."""
        strict_float32()
        with torch.no_grad():
            out = models.generator(self.weights(), z, self.noise_field(), self.cfg["model"],
                                   self.shape, train=False, prec=prec)
        return out["depth_orig"].permute(0, 2, 3, 1)

    def sample(self):
        g = np.random.default_rng([self.seed, 0x2EC0])
        return sorted(g.choice(self.batch, int(self.traffic["checked_scans"]), replace=False))

    def check(self) -> list:
        numbers = self.numbers()
        return [{"name": k, "value": numbers[k], "limit": float(self.limits[k])}
                for k in NUMBERS]

    def numbers(self) -> dict:
        out, bi = self.out, self.out["bi"]
        z0, noise = self.draws(bi)
        xs = ref.invert(self.loss_fn(bi), z0, noise, self.steps, stop=MOVE_STEP)
        numbers = {"gen_start_gap": _mean_gap(out["gen0"], self.reference_gen(out["x"][0])),
                   "move5_gap": _move(out["x"], xs),
                   "loop_steps_gap": float(max(abs(c - (self.steps + 1))
                                               for c in self.loss_calls)),
                   "gen_end_gap": _mean_gap(out["gen_end"], self.reference_gen(out["z_star"]))}
        gaps = []
        for i in self.sample():
            a = out["ref_points"][i].to(self.device)
            b = out["gen_points"][i].to(self.device)
            w = ref.chamfer(a, b)
            gaps.append(abs(float(out["cd"][i]) - w) / max(abs(w), 1e-12))
        if self.trace_on:
            p, fixed = self.weights(), self.noise_field()
            z = z0.detach().requires_grad_(True)
            self.context["flop_per_step"] = flops.count(lambda: torch.autograd.grad(
                models.generator(p, z, fixed, self.cfg["model"], self.shape,
                                 train=False)["depth_orig"].sum(), z))
        numbers["cd_gap"] = max(gaps)
        return numbers


def program_numbers(spec: dict, seed: int, device) -> Dict[str, float]:
    """A sound run's numbers: set-up and one batch, checked."""
    from gpubench.harness import Recorder

    run = Run(spec, seed, device, Recorder())
    run.setup()
    run._batch(0)
    run.release()
    return run.numbers()


def control_numbers(spec: dict, seed: int, device) -> Dict[str, Dict[str, float]]:
    """The control put in the program's place: the generator and the
    inversion in fp8 (the reconstruction at the float32 inversion's z*),
    and the Chamfer score with bf16 distances (K2 computes in float32
    without a matrix product), each against the reference."""
    from gpubench.harness import Recorder

    run = Run(spec, seed, device, Recorder())
    ds = run.cfg["dataset"]
    depth = inputs.scans(int(run.traffic["test_scans"]), run.shape, ds["sensor"],
                         float(ds["min_depth"]), float(ds["max_depth"]),
                         inputs.generator(seed, inputs.SCANS, device), device)
    run.scans = scan_items(depth, ds["sensor"], run.shape, float(ds["min_depth"]),
                           float(ds["max_depth"]))
    z0, noise = run.draws(0)
    low = ref.invert(run.loss_fn(0, FP8), z0, noise, run.steps, stop=MOVE_STEP)
    z0, noise = run.draws(0)
    want = ref.invert(run.loss_fn(0), z0, noise, run.steps, stop=MOVE_STEP)
    gen_start_gap = _mean_gap(run.reference_gen(want[0], FP8), run.reference_gen(want[0]))
    z0, noise = run.draws(0)
    z_star, _ = ref.invert(run.loss_fn(0), z0, noise, run.steps)
    gen_end_gap = _mean_gap(run.reference_gen(z_star, FP8), run.reference_gen(z_star))
    xyz = torch.from_numpy(run.items(0)["xyz"]).to(device).reshape(run.batch, -1, 3)
    gaps = []
    for i in run.sample():
        a, b = xyz[i], xyz[(i + 1) % run.batch]
        w = ref.chamfer(a, b)
        w_low = ref.chamfer(a.to(torch.bfloat16), b.to(torch.bfloat16))
        gaps.append(abs(w_low - w) / max(abs(w), 1e-12))
    return {"control": {"gen_start_gap": gen_start_gap, "move5_gap": _move(low, want),
                        "gen_end_gap": gen_end_gap, "cd_gap": max(gaps)}}
