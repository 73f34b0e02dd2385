"""Chunked training: the loop ``cli/train.py`` runs with ``steps_per_call=K
cache_device=true`` (``Trainer`` + ``ChunkRunner.run``: eager draws, one
pinned upload of the chunk's rows, one CUDA-graph replay of K steps).

Set-up makes the train split (seeded scans, on the card, then the
program's ``DeviceDatasetCache``) and the weights, and builds one
``Trainer``.  Its first chunk of K iterations is the checked one: it runs
through the window's own call (``Trainer.step_chunk``) and, on the card,
the one CUDA graph of K steps that the window replays, captured here, on
rows and draws the benchmark chose for all K slots: rows all distinct,
flipped variants included where the split flips.  Taps captured in that
graph, and so run in every replay, copy each slot's augmented reals as D
gets them (2 MB a slot), D's logits of slot 0's, and the norm of every
leaf's first moment after slot 0's two updates (two grouped norms).
After the chunk the run reads every leaf's change over it; then it runs
``warmup_chunks`` more.  The window runs chunks of K on the loader's
index stream, as the CLI does, with validation, images and checkpoints
off (their paper cadences are thousands of iterations).

The check runs the plain reference (``gpubench/reference``) over the same
K steps from the same weights, rows and draws:

* ``reals_gap``: each slot's augmented reals (its rows of the cache, the
  inverse depth, DiffAugment with its draws), the norm of the difference
  over the reference's, the worst slot's; a row the program left out
  counts as 0.  This holds every slot's rows and draws, and reads no
  weight;
* ``d_real_gap``: D's logits of slot 0's augmented reals (the forward that
  R1 differentiates, read as the step computes it), the norm of their
  difference over the reference's norm of those logits or the median
  slot's, whichever is larger (a slot's logits can all but cancel).  Slot
  0 alone: from slot 1 on, D's logits follow the trajectory, and sound
  runs part from the reference's by up to 0.38 of a slot's logits by slot
  7 (D's mean logit swings in sign from step to step at this rate);
* ``grad_gap``: the first gradient of G's and of D's median leaf, as Adam
  holds it after one update (its first moment over 1 - beta1).  The worst
  leaf is not compared: it is a bias of G's heads, whose gradient sums
  terms of both signs over every pixel through the straight-through
  masks, so that a mask flipped by rounding moves it by up to 0.77 of the
  median leaf's norm in a sound bf16 run (``detail`` keeps it);
* ``change_gap``: the change of each leaf of G, D and G_ema over the
  chunk, the worst leaf's, leaving out leaves whose first gradient in the
  reference is under a thousandth of the median leaf's (round-off moves
  them under Adam).

A leaf's gap in the last two is the gap between the two sides' norms
against the reference's norm of that leaf or of the median leaf,
whichever is larger.  The losses are not compared, since no loss
separates the program from its fp8 control on every seed: the
adversarial ones see G's fakes, whose hard Gumbel masks flip a pixel (by
up to 2) wherever a rounding moves logit plus noise across 0; R1, a
batch mean of squared input gradients, reads 0.4–6% in the control; and
the later steps carry the noise of Adam's first updates, which move
every element by about one learning rate whatever its gradient.
"""

from __future__ import annotations

import copy
import gc
import statistics
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional
from unittest import mock

import numpy as np
import torch

from gpubench import flops, inputs, trace
from gpubench.reference import models
from gpubench.reference import train_step as ref
from gpubench.reference.precision import FLOAT32, FP8, Precision, strict_float32

LOSSES = ("loss/D/adversarial", "loss/D/gradient_penalty", "loss/G/adversarial")
NUMBERS = ("reals_gap", "d_real_gap", "grad_gap", "change_gap")
SMALL_GRADIENT = 1e-3  # of the median leaf's first gradient


class MemoryScans:
    """The split in host memory, serving items as the program's datasets
    do: {"depth": (H, W, 1)}, mirrored in azimuth when flipped."""

    def __init__(self, depth: np.ndarray, flip: bool):
        self.depth, self.flip = depth, bool(flip)

    def __len__(self) -> int:
        return len(self.depth)

    def item(self, index: int, flip: bool = False, keys=None) -> Dict[str, np.ndarray]:
        d = self.depth[index, :, ::-1] if flip else self.depth[index]
        return {"depth": d[..., None]}

    def get(self, index: int, rng=None, keys=None) -> Dict[str, np.ndarray]:
        return self.item(index, self.flip and rng is not None and rng.random() > 0.5, keys)


def batch_of(depth: np.ndarray, rows: np.ndarray, device) -> torch.Tensor:
    """(B, 1, H, W) reals of cache rows: row r is scan r mod n, mirrored in
    azimuth where r >= n (the flipped variants)."""
    n = len(depth)
    scans = [depth[r % n, :, ::-1] if r >= n else depth[r % n] for r in rows]
    return torch.from_numpy(np.stack(scans)[:, None].copy()).to(device)


def _half(d, h: int):
    if isinstance(d, torch.Tensor):
        return d[:h]
    if isinstance(d, dict):
        return {k: _half(v, h) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return type(d)(_half(v, h) for v in d)
    return d


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: _norm(v.detach()) for k, v in tensors.items()}


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def _gap(got: torch.Tensor, want: torch.Tensor, scale: Optional[float] = None) -> float:
    """The norm of the difference over ``scale`` (default: the reference's
    norm); rows the program left out count as 0."""
    full = torch.zeros_like(want)
    full[:len(got)] = got[:len(want)]
    return _norm(full - want) / (_norm(want) if scale is None else scale)


def compare(prog: dict, refr: dict) -> Dict[str, float]:
    """The four numbers of a program record against a reference record."""
    reals_gap = max(_gap(x, w) for x, w in zip(prog["reals"], refr["reals"]))
    want = refr["d_real"][0]
    scale = max(_norm(want), statistics.median(_norm(w) for w in refr["d_real"]))
    d_real_gap = _gap(prog["d_real"][0], want, scale)

    def gaps(p: Dict[str, float], r: Dict[str, float], keep=None) -> list:
        keys = [k for k in r if keep is None or keep(k)]
        med = statistics.median(r[k] for k in keys)
        return [abs(p[k] - r[k]) / max(r[k], med) for k in keys]

    grad_gap = max(statistics.median(gaps(prog["grads"][m], refr["grads"][m]))
                   for m in ("G", "D"))
    change_gap = 0.0
    for m, g in (("G", "G"), ("D", "D"), ("G_ema", "G")):
        grads = refr["grads"][g]
        small = SMALL_GRADIENT * statistics.median(grads.values())
        change_gap = max(change_gap, *gaps(prog["change"][m], refr["change"][m],
                                           lambda k, grads=grads, small=small: grads[k] >= small))
    return {"reals_gap": reals_gap, "d_real_gap": d_real_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


class Inputs:
    """What one seed gives a training cell: the split's depths on the host,
    the checked chunk's rows and draws, and the weights."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, int(seed), device
        ds = cfg["dataset"]
        self.shape = tuple(ds["shape"])
        self.batch = int(cfg["solver"]["batch_size"])
        self.steps = int(traffic["steps_per_call"])
        n = int(traffic["train_scans"])
        depth = inputs.scans(n, self.shape, ds["sensor"], float(ds["min_depth"]),
                             float(ds["max_depth"]), inputs.generator(seed, inputs.SCANS, device),
                             device)
        self.depth = depth.cpu().numpy()
        del depth
        variants = 2 if ds.get("flip") else 1
        perm = torch.randperm(n * variants, device=device,
                              generator=inputs.generator(seed, inputs.ROWS, device))
        self.rows = perm[:self.steps * self.batch].view(self.steps, self.batch).cpu().numpy()

    def weights(self):
        gen = inputs.generator(self.seed, inputs.WEIGHTS, self.device)
        model = self.cfg["model"]
        G = models.make_params(models.generator_spec(model, self.shape), gen, self.device)
        D = models.make_params(models.discriminator_spec(model, self.shape), gen, self.device)
        return G, D

    def draws(self):
        gen = inputs.generator(self.seed, inputs.DRAWS, self.device)
        policy = self.cfg["solver"]["augment"]
        return [inputs.step_draws(self.cfg["model"], policy, self.batch, self.shape, gen,
                                  self.device) for _ in range(self.steps)]


def reference_record(inp: Inputs, prec: Precision = FLOAT32, half_batch: bool = False,
                     rows=None) -> dict:
    """The record of the checked chunk by the plain reference (``rows``:
    other rows in the program's place, for a fault)."""
    strict_float32()
    hp = ref.Hyper.from_config(inp.cfg)
    G, D = inp.weights()
    st = ref.State.fresh(G, D)
    before = {m: {k: v.clone() for k, v in getattr(st, m).items()} for m in ("G", "D", "G_ema")}
    rows = inp.rows if rows is None else rows
    rec = {"d_real": [], "reals": []}
    for j, d in enumerate(inp.draws()):
        batch = batch_of(inp.depth, rows[j], inp.device)
        if half_batch:
            h = inp.batch // 2
            batch, d = batch[:h], _half(d, h)
        losses, grads, y_real, x = ref.step(st, batch, d, hp, prec)
        rec["d_real"].append(y_real.cpu())
        rec["reals"].append(x.cpu())
        if j == 0:
            rec["grads"] = {m: _norms(grads[m]) for m in ("G", "D")}
    rec["losses"] = losses
    rec["change"] = {m: _norms({k: v - before[m][k] for k, v in getattr(st, m).items()})
                     for m in ("G", "D", "G_ema")}
    return rec


def program_config(cfg: dict, traffic: dict, seed: int, root: str) -> dict:
    from dusty_gan_torch.config import Config

    return Config.wrap({
        "model": copy.deepcopy(cfg["model"]), "dataset": dict(cfg["dataset"], root=root),
        "solver": copy.deepcopy(cfg["solver"]), "enable_amp": bool(cfg["enable_amp"]),
        "seed": seed % (1 << 31), "cache_dataset": False, "cache_device": True,
        "steps_per_call": int(traffic["steps_per_call"])})


class Run:
    def __init__(self, spec: dict, seed: int, device, rec):
        self.cfg, self.traffic = spec["config_data"], spec["traffic"]
        self.limits = self.traffic["limits"]
        self.seed, self.device, self.rec = int(seed), device, rec
        self.K = int(self.traffic["steps_per_call"])
        self.attempted = self.failed = 0
        self.trace_on = False
        self.context: dict = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build(self) -> None:
        """The inputs, and one Trainer over them holding the seeded weights."""
        from dusty_gan_torch import resolve_device
        from dusty_gan_torch.train import trainer as trainer_mod

        resolve_device(self.device)  # as the CLI: float32 means TF32 off
        with self.rec.span("setup.inputs"):
            self.inp = inp = Inputs(self.cfg, self.traffic, self.seed, self.device)
        self.work = tempfile.TemporaryDirectory(prefix="gpubench-")
        np.save(Path(self.work.name) / "angles.npy",
                inputs.angles(self.cfg["dataset"]["sensor"], inp.shape))
        splits = {"train": MemoryScans(inp.depth, self.cfg["dataset"].get("flip", False)),
                  "val": MemoryScans(inp.depth[:inp.batch], False)}
        pcfg = program_config(self.cfg, self.traffic, self.seed, self.work.name)
        with mock.patch.object(trainer_mod, "define_dataset",
                               lambda c, phase="train", **kw: splits[phase]), \
                self.rec.span("setup.trainer"):
            self.trainer = trainer_mod.Trainer(pcfg, self.device, verbose=False)
        G, D = inp.weights()
        st = self.trainer.state
        for module, params in ((st.G, G), (st.G_ema, G), (st.D, D)):
            named = dict(module.named_parameters())
            if set(named) != set(params):
                raise ValueError(f"the program's parameters {sorted(set(named) ^ set(params))} "
                                 "differ from the reference's")
            with torch.no_grad():
                for k, p in named.items():
                    p.copy_(params[k])

    def checked_chunk(self) -> None:
        """The first chunk of K through the window's call and graph, read
        into ``self.record``."""
        from dusty_gan_torch.train import step as step_mod

        tr, inp, K = self.trainer, self.inp, self.K
        st, runner = tr.state, tr.chunks
        beta1 = float(self.cfg["solver"]["lr"]["beta1"])
        before = {m: {k: p.detach().clone() for k, p in getattr(st, m).named_parameters()}
                  for m in ("G", "D", "G_ema")}
        names = {p: (m, k) for m in ("G", "D") for k, p in getattr(st, m).named_parameters()}
        self.taps = taps = {"reals": [], "d_real": [], "grads": []}
        calls = {"D": 0, "update": 0}
        apply_d, scheduled = step_mod.TrainStep._apply_d, step_mod.scheduled_step

        def recording() -> bool:  # in the chunk's steps, not the warm-up's
            return not runner.graphed or torch.cuda.is_current_stream_capturing()

        def tapped(step, D, x):
            y = apply_d(step, D, x)
            if recording():
                # each step's D calls: reals (under R1), fakes, G's fakes
                if calls["D"] % 3 == 0:
                    taps["reals"].append(x.detach().clone())
                if calls["D"] == 0:
                    taps["d_real"].append(y.detach().clone())
                calls["D"] += 1
            return y

        def stepped(optimizer, schedule, lr=None):
            scheduled(optimizer, schedule, lr)
            if recording():
                if calls["update"] < 2:  # slot 0's updates: D's, then G's
                    params = [p for g in optimizer.param_groups for p in g["params"]]
                    # a parameter that Adam has not updated has no moment: nought
                    state = [optimizer.state.get(p, {}) for p in params]
                    moments = [st_p["exp_avg"] if "exp_avg" in st_p else torch.zeros_like(p)
                               for st_p, p in zip(state, params)]
                    taps["grads"].append(([names[p] for p in params],
                                          torch.stack(torch._foreach_norm(moments))))
                calls["update"] += 1

        draws = [[step_mod.RoundDraws(z=d["z"], gumbel=d["gumbel"], aug_d_real=d["aug_d_real"],
                                      aug_d_fake=d["aug_d_fake"], aug_g_fake=d["aug_g_fake"])]
                 for d in inp.draws()]
        with mock.patch.object(step_mod.TrainStep, "_apply_d", tapped), \
                mock.patch.object(step_mod, "scheduled_step", stepped):
            with self.rec.span("setup.capture"):
                runner.prepare([K])  # the graph of K steps, the taps inside it
            scalars = tr.step_chunk(range(1, K + 1), inp.rows, draws=draws)
        if calls["D"] != 3 * K or calls["update"] != 2 * K:
            raise RuntimeError(f"{calls} calls of D and updates in a chunk of {K} steps")
        grads: Dict[str, Dict[str, float]] = {"G": {}, "D": {}}
        for keys, norms in taps["grads"]:
            for (m, k), v in zip(keys, norms.tolist()):
                grads[m][k] = v / (1 - beta1)
        self.record = {
            "reals": [x.cpu() for x in taps["reals"]],
            "d_real": [y.float().cpu() for y in taps["d_real"]],
            "losses": {k: float(scalars[k]) for k in LOSSES}, "grads": grads,
            "change": {m: _norms({k: p.detach() - before[m][k]
                                  for k, p in getattr(st, m).named_parameters()})
                       for m in ("G", "D", "G_ema")}}
        self.done = K

    def setup(self) -> None:
        self.build()
        with self.rec.span("setup.checked_chunk"):
            self.checked_chunk()
        self.ix = self.trainer.loader.index_stream(self.done)
        with self.rec.span("setup.warmup"):
            for _ in range(int(self.traffic["warmup_chunks"])):
                self._chunk()
            self._sync()
        self.context["setup_parts_s"] = {n: b - a for n, a, b in self.rec.spans
                                         if n.startswith("setup.")}

    def _chunk(self) -> None:
        tr, K = self.trainer, self.K
        rows = np.stack([tr.device_cache.rows(*next(self.ix)) for _ in range(K)])
        with self.rec.span("train.chunk"):
            tr.step_chunk(range(self.done + 1, self.done + K + 1), rows)
        self.done += K

    def host_chunks(self, n: int) -> list:
        """Host seconds of ``n`` chunk calls, each begun on an idle device
        (after a synchronise), so that no part of a call waits for the
        previous chunk: the draws, the rows' upload and the replay's
        launch."""
        self.rec.spans.clear()
        for _ in range(n):
            self._sync()
            self._chunk()
        self._sync()
        return self.rec.durations("train.chunk")

    def window(self, seconds: float, trace_on: bool) -> dict:
        self._sync()
        self.rec.spans.clear()
        t0 = time.perf_counter()
        chunks = 0
        while True:
            self._chunk()
            chunks += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        window_s = time.perf_counter() - t0
        steps = chunks * self.K
        self.attempted = steps
        self.trace_on = trace_on
        self.context.update(window_s=window_s, window_steps=steps, batch=self.inp.batch)
        return {"train_scans_per_s": steps * self.inp.batch / window_s}

    def traced(self) -> dict:
        n = int(self.traffic["trace_chunks"])
        out = trace.traced(lambda: [self._chunk() for _ in range(n)], self._sync)
        self.context["chunk_host_s"] = self.host_chunks(n)
        return out

    def release(self) -> None:
        self.trainer = self.ix = self.taps = None
        self.work.cleanup()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        numbers = compare(self.record, reference_record(self.inp))
        if self.trace_on:
            self.context["flop_per_step"] = self.step_flop()
        return [{"name": k, "value": numbers[k], "limit": float(self.limits[k])}
                for k in NUMBERS]

    def step_flop(self) -> int:
        """FLOP of one train step at the cell's shapes, counted on the
        reference."""
        inp = self.inp
        hp = ref.Hyper.from_config(inp.cfg)
        st = ref.State.fresh(*inp.weights())
        d = inp.draws()[0]
        batch = batch_of(inp.depth, inp.rows[0], inp.device)
        return flops.count(lambda: ref.step(st, batch, d, hp))


def detail(prog: dict, refr: dict) -> dict:
    """Where the numbers come from: the last step's relative loss gaps,
    each slot's reals gap, and the worst and the median leaf's gap of the
    first gradients and the changes."""
    out = {"loss": {k: abs(prog["losses"][k] - refr["losses"][k]) / abs(refr["losses"][k])
                    for k in LOSSES},
           "reals_slots": [_gap(x, w) for x, w in zip(prog["reals"], refr["reals"])]}
    for part in ("grads", "change"):
        for m, r in refr[part].items():
            med = statistics.median(r.values())
            gaps = {k: abs(prog[part][m][k] - v) / max(v, med) for k, v in r.items()}
            worst = max(gaps, key=gaps.get)
            out[f"{part}.{m}"] = {"worst": [worst, gaps[worst], r[worst] / med],
                                  "median": statistics.median(gaps.values())}
    return out


def program_numbers(spec: dict, seed: int, device) -> Dict[str, float]:
    """The numbers of a sound run of the program on ``seed``: set-up and
    the checked chunk, against the reference."""
    from gpubench.harness import Recorder

    run = Run(spec, seed, device, Recorder())
    run.build()
    run.checked_chunk()
    record = run.record
    run.release()
    want = reference_record(run.inp)
    return dict(compare(record, want), detail=detail(record, want))


def control_numbers(spec: dict, seed: int, device) -> Dict[str, Dict[str, float]]:
    """The numbers of the control (the reference in fp8 where the program
    computes in bf16), of half the batch left out (the mean over the rest)
    and of every slot reading slot 0's rows, each put in the program's
    place against the reference."""
    inp = Inputs(spec["config_data"], spec["traffic"], seed, device)
    want = reference_record(inp)
    out = {}
    for name, kw in (("fp8", {"prec": FP8}), ("half_batch", {"half_batch": True}),
                     ("slot0_rows", {"rows": inp.rows[[0] * inp.steps]})):
        got = reference_record(inp, **kw)
        out[name] = dict(compare(got, want), detail=detail(got, want))
    return out
