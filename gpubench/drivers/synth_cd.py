"""The synthesis protocol with Chamfer distances
(``cli/evaluate_synthesis.py --metrics cd``): the EMA generator in bf16 on
fixed Gumbel noise, ``to_points`` (points and FPS), then
``compute_cov_mmd_1nna`` (three pairwise matrices through K1,
``cd_block``, and COV, MMD and 1-NNA on the host).

Set-up makes the seeded generator, fixed noise and a pool of seeded real
scans, turns the pool into clouds through the port's real-tensor path
(inverse depth, ``to_points`` at the real tolerance), and warms each
shape once.  Each round of the window draws fresh latents for
``num_test`` fakes and ``num_test`` reals from the pool, and runs
generation, FPS and the scores; the rate counts the pairs the protocol
needs (``rooflines.protocol_pairs``) over the window's whole rounds.

The check follows the program stage by stage on the last round, since FPS
makes discrete choices that a bf16 generator moves against a float32 one:

* ``gen_gap``: the reference generator (float32) against the program's
  fakes on the same latents and noise: mean absolute gap over mean
  absolute value;
* ``fps_mismatch``: the share of the round's clouds that differ from the
  reference's: its FPS of the program's own fakes, and its inverse depth,
  points and FPS of the round's real scans (the pool's clouds are made by
  the program in set-up);
* ``cd_gap``: the largest relative gap of ``checked_pairs`` entries of the
  three matrices, drawn from the seed among the pairs the protocol needs,
  against the reference's Chamfer of the program's clouds;
* ``score_gap``: the largest gap of the program's scores against the
  reference's scores of the program's matrices (exact: limit 0).
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from gpubench import flops, inputs, rooflines, trace
from gpubench.reference import models
from gpubench.reference import synthesis as ref
from gpubench.reference.precision import FLOAT32, FP8, Precision, strict_float32

NUMBERS = ("gen_gap", "fps_mismatch", "cd_gap", "score_gap")
REAL_TOL = 1e-8  # the protocol's tolerance for real scans


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().mean() / b.abs().mean())


class Run:
    def __init__(self, spec: dict, seed: int, device, rec):
        self.cfg, self.traffic = spec["config_data"], spec["traffic"]
        self.limits = self.traffic["limits"]
        self.seed, self.device, self.rec = int(seed), device, rec
        proto = self.cfg["protocol"]
        self.n = int(proto["num_test"])
        self.points = int(proto["num_points"])
        self.cd_batch = int(proto["cd_batch"])
        self.tol = float(proto["tol"])
        self.shape = tuple(self.cfg["dataset"]["shape"])
        self.attempted = self.failed = 0
        self.trace_on = False
        self.context: dict = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -------------------------------------------------------------- set-up
    def noise(self):
        gen = inputs.generator(self.seed, inputs.EXTRA, self.device)
        return {"pixel": inputs.logistic(gen, (1, 1) + self.shape, self.device),
                "image": inputs.logistic(gen, (1, 1, 1, 1), self.device)}

    def weights(self):
        gen = inputs.generator(self.seed, inputs.WEIGHTS, self.device)
        return models.make_params(models.generator_spec(self.cfg["model"], self.shape), gen,
                                  self.device)

    def setup(self) -> None:
        from dusty_gan_torch import resolve_device
        from dusty_gan_torch.cli.evaluate_synthesis import to_points
        from dusty_gan_torch.config import Config
        from dusty_gan_torch.geometry.lidar import Lidar, sigmoid_to_tanh
        from dusty_gan_torch.metrics import cov_mmd_1nna
        from dusty_gan_torch.models.factory import define_G
        from dusty_gan_torch.utils.setup import make_eval_generator

        resolve_device(self.device)
        cfg, dev, ds = self.cfg, self.device, self.cfg["dataset"]
        self.to_points, self.cov = to_points, cov_mmd_1nna
        with self.rec.span("setup.inputs"):
            self.angles = inputs.angles(ds["sensor"], self.shape)
            pool = inputs.scans(int(self.traffic["real_pool"]), self.shape, ds["sensor"],
                                float(ds["min_depth"]), float(ds["max_depth"]),
                                inputs.generator(self.seed, inputs.SCANS, dev), dev)
        with self.rec.span("setup.generator"):
            pcfg = Config.wrap({"model": dict(cfg["model"]), "dataset": dict(ds)})
            pcfg.model.gen = Config.wrap(dict(cfg["model"]["gen"], shape=list(self.shape)))
            G = define_G(pcfg)
            missing = G.load_state_dict(self.weights(), strict=False)
            if missing.unexpected_keys or any(k != "drop_const" for k in missing.missing_keys):
                raise ValueError(f"the program's generator does not take the reference's "
                                 f"parameters: {missing}")
            self.G = G.to(dev).eval().requires_grad_(False)
            self.gen = make_eval_generator(self.G, self.noise())
            self.lidar = Lidar.from_angle_array(self.angles, self.shape, ds["min_depth"],
                                                ds["max_depth"], device=dev)
        with self.rec.span("setup.reals"):
            # the CLI's real-tensor path: inverse depth, dropped pixels at
            # drop_const, then points and FPS at the real tolerance
            drop = float(cfg["model"]["gen"]["drop_const"])
            depth = pool[..., None]
            mask = (depth > 0).float()
            inv = sigmoid_to_tanh(self.lidar.invert_depth(depth))
            self.pool_3d = to_points(self.lidar, mask * inv + (1 - mask) * drop, REAL_TOL,
                                     self.points)
            del pool, depth, mask, inv
        with self.rec.span("setup.warmup"):
            z = torch.zeros((self.gen_batch, int(cfg["model"]["gen"]["in_ch"])), device=dev)
            self.gen(z)
            rows = self.pool_3d[:cov_mmd_1nna.ROW_BLOCK].contiguous()
            cov_mmd_1nna.cd_block(rows, self.pool_3d[:self.cd_batch].contiguous())
            self._sync()
        self.round_gen = inputs.generator(self.seed, inputs.LATENTS, dev)
        self.context["setup_parts_s"] = {n: b - a for n, a, b in self.rec.spans
                                         if n.startswith("setup.")}

    @property
    def gen_batch(self) -> int:
        return int(self.cfg["solver"]["batch_size"])

    # -------------------------------------------------------------- window
    def _round(self) -> None:
        dev, n = self.device, self.n
        in_ch = int(self.cfg["model"]["gen"]["in_ch"])
        z = torch.randn((n, in_ch), generator=self.round_gen, device=dev)
        pick = torch.randperm(len(self.pool_3d), generator=self.round_gen, device=dev)[:n]
        with self.rec.span("synth.generation"):
            fake_2d = torch.cat([self.gen(z[i:i + self.gen_batch])["depth"]
                                 for i in range(0, n, self.gen_batch)]).contiguous()
            self._sync()
        with self.rec.span("synth.fps"):
            fake_3d = self.to_points(self.lidar, fake_2d, self.tol, self.points)
            self._sync()
        ref_3d = self.pool_3d[pick]
        matrices = []
        pairwise = self.cov.PAIRWISE["cd"]

        def spy(*args, **kw):
            matrices.append(pairwise(*args, **kw))
            return matrices[-1]

        self.cov.PAIRWISE["cd"] = spy
        try:
            with self.rec.span("synth.pairwise_cd"):
                scores = self.cov.compute_cov_mmd_1nna(fake_3d, ref_3d, self.cd_batch, ("cd",))
        finally:
            self.cov.PAIRWISE["cd"] = pairwise
        self.last = {"z": z, "pick": pick, "fake_2d": fake_2d, "fake_3d": fake_3d,
                     "ref_3d": ref_3d, "matrices": matrices, "scores": scores}

    def window(self, seconds: float, trace_on: bool) -> dict:
        self._sync()
        self.rec.spans.clear()
        t0 = time.perf_counter()
        rounds = 0
        while True:
            self._round()
            rounds += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        window_s = time.perf_counter() - t0
        pairs = rooflines.protocol_pairs(self.n, self.n)
        self.attempted = rounds
        self.trace_on = trace_on
        self.context.update(
            window_s=window_s, rounds=rounds, pairs_per_round=pairs, clouds=self.n,
            points=self.points, scan_points=self.shape[0] * self.shape[1],
            fps_s=self.rec.durations("synth.fps"),
            pairwise_cd_s=self.rec.durations("synth.pairwise_cd"))
        return {"synth_pairs_per_s": rounds * pairs / window_s}

    def traced(self) -> dict:
        return trace.traced(self._round, self._sync)

    def release(self) -> None:
        last = self.last
        self.out = {"z": last["z"], "pick": last["pick"].cpu(), "fake_2d": last["fake_2d"].cpu(),
                    "fake_3d": last["fake_3d"].cpu(), "ref_3d": last["ref_3d"].cpu(),
                    "matrices": last["matrices"], "scores": last["scores"]}
        self.G = self.gen = self.last = self.pool_3d = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --------------------------------------------------------------- check
    def reference_fakes(self, z: torch.Tensor, prec: Precision = FLOAT32) -> torch.Tensor:
        """(B, H, W, 1) fakes of the reference generator."""
        strict_float32()
        p, noise = self.weights(), self.noise()
        with torch.no_grad():
            out = [models.generator(p, z[i:i + 256], noise, self.cfg["model"], self.shape,
                                    train=False, prec=prec)["depth"]
                   for i in range(0, len(z), 256)]
        return torch.cat(out).permute(0, 2, 3, 1)

    def pool_inverse_depth(self) -> torch.Tensor:
        """(real_pool, H, W, 1) inverse depth of the pool's scans, made
        again from the seed."""
        ds = self.cfg["dataset"]
        lo, hi = float(ds["min_depth"]), float(ds["max_depth"])
        pool = inputs.scans(int(self.traffic["real_pool"]), self.shape, ds["sensor"], lo, hi,
                            inputs.generator(self.seed, inputs.SCANS, self.device), self.device)
        return ref.inverse_depth(pool[..., None], lo, hi,
                                 float(self.cfg["model"]["gen"]["drop_const"]))

    def xyz(self, inv: torch.Tensor, tol: float) -> torch.Tensor:
        ds = self.cfg["dataset"]
        angles = torch.from_numpy(inputs.angles(ds["sensor"], self.shape)).to(self.device)
        return ref.inv_to_points(inv, angles.permute(1, 2, 0), float(ds["min_depth"]),
                                 float(ds["max_depth"]), tol)

    def sample_pairs(self):
        """``checked_pairs`` (matrix, row, column) among the needed pairs."""
        g = np.random.default_rng([self.seed, 0x5A17])
        n, out = self.n, []
        for _ in range(int(self.traffic["checked_pairs"])):
            m = int(g.integers(3))
            i, j = int(g.integers(n)), int(g.integers(n))
            if m != 1:
                while i == j:
                    j = int(g.integers(n))
                i, j = min(i, j), max(i, j)
            out.append((m, i, j))
        return out

    def cd_of(self, fake_3d, ref_3d, pairs, dtype=torch.float32) -> np.ndarray:
        """The reference's Chamfer of the sampled pairs: M_rr (0), M_rg (1),
        M_gg (2), with distances in ``dtype`` (float32; the control
        bfloat16)."""
        dev = self.device
        side = {0: (ref_3d, ref_3d), 1: (ref_3d, fake_3d), 2: (fake_3d, fake_3d)}
        out = []
        for s in range(0, len(pairs), 16):
            chunk = pairs[s:s + 16]
            a = torch.stack([side[m][0][i] for m, i, _ in chunk]).to(dev)
            b = torch.stack([side[m][1][j] for m, _, j in chunk]).to(dev)
            out.append(ref.chamfer_pairs(a.to(dtype), b.to(dtype)).float().cpu())
        return torch.cat(out).double().numpy()

    def check(self) -> list:
        out = self.out
        fake_ref = self.reference_fakes(out["z"])
        gen_gap = _gap(out["fake_2d"].to(self.device), fake_ref)
        fakes = ref.fps(self.xyz(out["fake_2d"].to(self.device), self.tol), self.points).cpu()
        inv = self.pool_inverse_depth()[out["pick"].to(self.device)]
        reals = ref.fps(self.xyz(inv, REAL_TOL), self.points).cpu()
        del inv
        differ = torch.cat([(fakes != out["fake_3d"]).any(dim=2).any(dim=1),
                            (reals != out["ref_3d"]).any(dim=2).any(dim=1)])
        fps_mismatch = float(differ.double().mean())
        pairs = self.sample_pairs()
        want = self.cd_of(out["fake_3d"], out["ref_3d"], pairs)
        got = np.array([out["matrices"][m][i, j] for m, i, j in pairs], dtype=np.float64)
        cd_gap = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-12)))
        wanted = ref.scores(*out["matrices"])
        score_gap = max(abs(out["scores"][k] - v) for k, v in wanted.items())
        if self.trace_on:
            p, noise = self.weights(), self.noise()
            z = out["z"][:self.gen_batch]
            with torch.no_grad():
                flop = flops.count(lambda: models.generator(
                    p, z, noise, self.cfg["model"], self.shape, train=False))
            self.context["gen_flop_per_round"] = flop * self.n / self.gen_batch
        numbers = {"gen_gap": gen_gap, "fps_mismatch": fps_mismatch, "cd_gap": cd_gap,
                   "score_gap": score_gap}
        return [{"name": k, "value": numbers[k], "limit": float(self.limits[k])}
                for k in NUMBERS]


def program_numbers(spec: dict, seed: int, device) -> Dict[str, float]:
    """A sound run's numbers: set-up and one round, checked."""
    from gpubench.harness import Recorder

    run = Run(spec, seed, device, Recorder())
    run.setup()
    run._round()
    run.release()
    return {c["name"]: c["value"] for c in run.check()}


def control_numbers(spec: dict, seed: int, device) -> Dict[str, Dict[str, float]]:
    """The control, stage by stage, put in the program's place against the
    reference: the generator in fp8, FPS and Chamfer with bf16 distances
    (K1 and FPS compute in float32 without a matrix product, so TF32 has
    no place in them)."""
    from gpubench.harness import Recorder

    run = Run(spec, seed, device, Recorder())
    g = inputs.generator(seed, inputs.LATENTS, device)
    z = torch.randn((run.n, int(run.cfg["model"]["gen"]["in_ch"])), generator=g, device=device)
    fake = run.reference_fakes(z)
    gen_gap = _gap(run.reference_fakes(z, FP8), fake)
    xyz = run.xyz(fake, run.tol)
    clouds = ref.fps(xyz, run.points)
    low = ref.fps(xyz, run.points, dtype=torch.bfloat16)
    fps_mismatch = float((low != clouds).any(dim=2).any(dim=1).double().mean())
    reals = ref.fps(run.xyz(run.pool_inverse_depth()[:run.n], REAL_TOL), run.points)
    pairs = run.sample_pairs()
    want = run.cd_of(clouds.cpu(), reals.cpu(), pairs)
    low_cd = run.cd_of(clouds.cpu(), reals.cpu(), pairs, torch.bfloat16)
    cd_gap = float(np.max(np.abs(low_cd - want) / np.maximum(np.abs(want), 1e-12)))
    return {"control": {"gen_gap": gen_gap, "fps_mismatch": fps_mismatch, "cd_gap": cd_gap}}
