"""Chunked training of DUSty-II over StyleGAN2 (``dusty2_sg2_kitti``): the
loop of ``train_chunks`` (``cli/train.py`` with ``steps_per_call=K
cache_device=true``), whose set-up, window, traced segment and checks this
driver reuses, with the StyleGAN2 reference (``gpubench/reference/
stylegan2.py``, ``train_step_sg2.py``), its weights and its draws.

Each step's draws add, to ``train_chunks``' (z, DUSty-II's Gumbel noise,
DiffAugment's), the style draws: a mixing latent and a cutoff (uniform in
[1, num_ws) with probability ``solver.mix_prob`` a round, else num_ws) and
an N(0, 1) field for each of the 9 noise layers; and the path-length rows'
own (half the batch): z, the image-space noise N(0, 1) / sqrt(H W), Gumbel
noise and style draws.  The benchmark hands the same draws to both sides.

The check holds ``train_chunks``' four numbers (``reals_gap``,
``d_real_gap``, ``grad_gap``, ``change_gap``, as that driver defines them)
and two more, taken in the checked chunk's slot 0, the one step whose
inputs both sides share exactly.  ``change_gap`` follows the trajectory
here: Adam moves an element by about one learning rate whatever its
gradient, so elements whose gradient all but cancels take the sign that
rounding gives them, and by the chunk's last steps the two sides' updates
agree in sign on 60-85% of G's elements; sound runs read up to 0.35, the
program in float32 0.08 (``PERF.md``).  Its limit holds a leaf that was
left unchanged or moved twice (1).

* ``fake_gap``: the D phase's fakes before the mask, depth (tanh) and
  confidence, each the norm of the difference over the reference's norm,
  the larger; it reads the mapping, the mixing, the noise, the modulated
  convolutions and the skip outputs;
* ``pl_gap``: the path length of each of the path-length rows, its
  difference over the reference's, the median row's; it reads the ws-form
  gradient (a gradient with respect to z, or a synthesis left
  undemodulated, moves every row many times over).  Not the penalty or
  the baseline, nor the worst row: a row's length sums the depth's
  gradient over every pixel through DUSty-II's hard masks, whose pixels
  flip where bf16 moves a logit across 0 (11-66 of a row's 16,384 on the
  sound seeds looked at, none with the program in float32).  On one sound
  seed that moved the largest row's length by 20%, and with it the
  penalty, which its largest rows make, by 21%; the program in float32
  reads 6e-5 on every row there (``PERF.md``).

With ``--trace 1``, after ``train_chunks``' traced segment (the CUDA-graph
chunks, which cannot put a kernel down to a host span), an eager
diagnostic: one step unprofiled, then ``DIAGNOSTIC_STEPS`` steps of the
per-step path (``Trainer.step``, the same step the graph holds) with the
program's tracer on under torch.profiler, each step's D and G phases
annotated by this driver (``phases``).  Each kernel is put down to
every span open on the host when the operator that launched it started
(the autograd engine's operators run while the step's thread waits inside
``backward()``, so they fall in the span that called it).  The context
gets each step's device seconds under ``step.g``, the device seconds
under ``g.synthesis``, and the FLOP of the synthesis forwards a step (two
at the batch, one at the path-length rows), counted on the reference.  A
diagnostic step whose ``g.modconv`` counter reads 0 counts as failed.
"""

from __future__ import annotations

import collections
import contextlib
import math
from typing import Dict, List
from unittest import mock

import torch

from gpubench import flops, inputs
from gpubench.drivers import train_chunks as tc
from gpubench.reference import stylegan2 as sg2
from gpubench.reference import train_step_sg2 as ref
from gpubench.reference.precision import FLOAT32, FP8, Precision, strict_float32

NUMBERS = tc.NUMBERS + ("fake_gap", "pl_gap")
DIAGNOSTIC_STEPS = 3
SPANS = ("step.d", "step.g", "g.mapping", "g.synthesis")


def style_draws(model: dict, b: int, shape, mix_prob: float, gen, device) -> dict:
    """{"z_mix", "cutoff", "noise"} for a batch of ``b``, in the program's
    order (``train/step.py::draw_style``)."""
    n = sg2.num_ws(model)
    z_mix = cutoff = None
    if mix_prob > 0.0:
        z_mix = torch.randn((b, int(model["gen"]["in_ch"])), generator=gen, device=device)
        c = torch.randint(1, n, (), generator=gen, device=device)
        u = torch.rand((), generator=gen, device=device)
        cutoff = torch.where(u < mix_prob, c, torch.full_like(c, n))
    noise = [torch.randn((b, 1) + tuple(s), generator=gen, device=device)
             for s in sg2.noise_shapes(model, shape)]
    return {"z_mix": z_mix, "cutoff": cutoff, "noise": noise}


def step_draws(cfg: dict, b: int, shape, gen, device) -> dict:
    """One train step's draws: ``inputs.step_draws``' and the style and
    path-length rows' draws."""
    model, solver = cfg["model"], cfg["solver"]
    mix = float(solver["mix_prob"])
    d = inputs.step_draws(model, solver["augment"], b, shape, gen, device)
    d["style"] = style_draws(model, b, shape, mix, gen, device)
    h = b // 2
    pixel = (h, 1) + tuple(shape)
    d["pl"] = (torch.randn((h, int(model["gen"]["in_ch"])), generator=gen, device=device),
               torch.randn(pixel, generator=gen, device=device) / math.sqrt(shape[0] * shape[1]),
               {"pixel": inputs.logistic(gen, pixel, device),
                "image": inputs.logistic(gen, (h, 1, 1, 1), device)})
    d["pl_style"] = style_draws(model, h, shape, mix, gen, device)
    return d


class Inputs(tc.Inputs):
    def weights(self):
        gen = inputs.generator(self.seed, inputs.WEIGHTS, self.device)
        model = self.cfg["model"]
        G = sg2.make_params(sg2.generator_spec(model, self.shape), gen, self.device)
        D = sg2.make_params(sg2.discriminator_spec(model, self.shape), gen, self.device)
        return G, D

    def draws(self):
        gen = inputs.generator(self.seed, inputs.DRAWS, self.device)
        return [step_draws(self.cfg, self.batch, self.shape, gen, self.device)
                for _ in range(self.steps)]


def _half(d, h: int):
    """The first ``h`` rows of a batch's draws (the path-length rows' half
    of them); a 0-d cutoff is kept."""
    if isinstance(d, torch.Tensor):
        return d[:h] if d.dim() else d
    if isinstance(d, dict):
        return {k: _half(v, (h + 1) // 2 if k in ("pl", "pl_style") else h)
                for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return type(d)(_half(v, h) for v in d)
    return d


def reference_record(inp: Inputs, prec: Precision = FLOAT32, half_batch: bool = False,
                     rows=None) -> dict:
    """``train_chunks.reference_record`` on the StyleGAN2 reference, with
    slot 0's fakes (``fake``) and path lengths (``pl``)."""
    strict_float32()
    hp = ref.HyperSG2.from_config(inp.cfg)
    G, D = inp.weights()
    st = ref.State.fresh(G, D)
    before = {m: {k: v.clone() for k, v in getattr(st, m).items()} for m in ("G", "D", "G_ema")}
    rows = inp.rows if rows is None else rows
    rec = {"d_real": [], "reals": []}
    for j, d in enumerate(inp.draws()):
        batch = tc.batch_of(inp.depth, rows[j], inp.device)
        if half_batch:
            h = inp.batch // 2
            batch, d = batch[:h], _half(d, h)
        losses, grads, y_real, x, fake = ref.step(st, batch, d, hp, prec)
        rec["d_real"].append(y_real.cpu())
        rec["reals"].append(x.cpu())
        if j == 0:
            rec["grads"] = {m: tc._norms(grads[m]) for m in ("G", "D")}
            rec["pl"] = fake.pop("pl_lengths").cpu()
            rec["fake"] = {k: v.float().cpu() for k, v in fake.items()}
    rec["losses"] = losses
    rec["change"] = {m: tc._norms({k: v - before[m][k] for k, v in getattr(st, m).items()})
                     for m in ("G", "D", "G_ema")}
    return rec


def compare(prog: dict, refr: dict) -> Dict[str, float]:
    out = tc.compare(prog, refr)
    out["fake_gap"] = max(tc._gap(prog["fake"][k], refr["fake"][k]) for k in refr["fake"])
    r = refr["pl"].double()
    p = torch.zeros_like(r)  # a row the program left out counts as 0
    p[:len(prog["pl"])] = prog["pl"][:len(r)].double()
    out["pl_gap"] = float(((p - r).abs() / r.abs()).median())
    return out


def round_draws(d: dict):
    """The program's ``RoundDraws`` of one step's draws."""
    from dusty_gan_torch.models.stylegan2 import StyleDraws
    from dusty_gan_torch.train.step import RoundDraws

    return RoundDraws(z=d["z"], gumbel=d["gumbel"], aug_d_real=d["aug_d_real"],
                      aug_d_fake=d["aug_d_fake"], aug_g_fake=d["aug_g_fake"], pl=d["pl"],
                      style=StyleDraws(**d["style"]), pl_style=StyleDraws(**d["pl_style"]))


def kernels_by_span(events, names) -> List[dict]:
    """For each instance of a span in ``names`` (a host annotation), its
    name, host interval and the device seconds of the kernels launched by
    operators that started inside it (each operator's ``kernels``, which
    the profiler links to it by correlation id)."""
    from torch.autograd import DeviceType

    spans, launches = [], []
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name in names:
            spans.append({"name": e.name, "start": float(e.time_range.start),
                          "end": float(e.time_range.end), "device_s": 0.0})
        elif e.kernels:
            launches.append((float(e.time_range.start),
                             sum(k.duration for k in e.kernels) / 1e6))
    for t, seconds in launches:
        for s in spans:
            if s["start"] <= t <= s["end"]:
                s["device_s"] += seconds
    return sorted(spans, key=lambda s: s["start"])


@contextlib.contextmanager
def phases():
    """Annotate each train step's phases for the profiler: ``step.d`` from
    the step's start to the end of D's update, ``step.g`` from there to the
    end of G's (each round's ``backward()`` inside), as host ranges
    (``record_function``) around the program's own ``TrainStep``."""
    from dusty_gan_torch.train import step as step_mod

    call, scheduled = step_mod.TrainStep.__call__, step_mod.scheduled_step
    open_ = []

    def annotate(name):
        r = torch.profiler.record_function(name)
        r.__enter__()
        open_.append(r)

    def close():
        open_.pop().__exit__(None, None, None)

    def stepped(optimizer, schedule, lr=None):
        scheduled(optimizer, schedule, lr)
        close()
        if optimizer is stepped.state.opt_D:
            annotate("step.g")

    def phased(self, state, *a, **kw):
        stepped.state = state
        annotate("step.d")
        try:
            return call(self, state, *a, **kw)
        finally:
            while open_:
                close()

    with mock.patch.object(step_mod.TrainStep, "__call__", phased), \
            mock.patch.object(step_mod, "scheduled_step", stepped):
        yield


class Run(tc.Run):
    def build(self) -> None:
        """``train_chunks.Run.build`` with this cell's inputs and weights."""
        with mock.patch.object(tc, "Inputs", Inputs):
            super().build()

    def checked_chunk(self) -> None:
        """``train_chunks.Run.checked_chunk`` with the StyleGAN2 draws, and
        taps of slot 0's fakes (the D phase's generator call) and path
        length."""
        from dusty_gan_torch.train import step as step_mod

        tr, inp, K = self.trainer, self.inp, self.K
        st, runner = tr.state, tr.chunks
        beta1 = float(self.cfg["solver"]["lr"]["beta1"])
        before = {m: {k: p.detach().clone() for k, p in getattr(st, m).named_parameters()}
                  for m in ("G", "D", "G_ema")}
        names = {p: (m, k) for m in ("G", "D") for k, p in getattr(st, m).named_parameters()}
        self.taps = taps = {"reals": [], "d_real": [], "grads": [], "fake": [], "pl": []}
        calls = collections.Counter()
        apply_d, apply_g = step_mod.TrainStep._apply_d, step_mod.apply_g
        scheduled, lengths_of = step_mod.scheduled_step, step_mod.losses.path_lengths

        def recording() -> bool:
            return not runner.graphed or torch.cuda.is_current_stream_capturing()

        def tapped_d(step, D, x):
            y = apply_d(step, D, x)
            if recording():
                if calls["D"] % 3 == 0:
                    taps["reals"].append(x.detach().clone())
                if calls["D"] == 0:
                    taps["d_real"].append(y.detach().clone())
                calls["D"] += 1
            return y

        def tapped_g(*a, **kw):
            out = apply_g(*a, **kw)
            if recording():
                if calls["G"] == 0:  # slot 0's fakes of the D phase
                    taps["fake"].append({"depth": out["depth_orig"].detach().clone(),
                                         "confidence": out["confidence"].detach().clone()})
                calls["G"] += 1
            return out

        def tapped_pl(grads):
            lengths = lengths_of(grads)
            if recording():
                if calls["pl"] == 0:
                    taps["pl"].append(lengths.detach().clone())
                calls["pl"] += 1
            return lengths

        def stepped(optimizer, schedule, lr=None):
            scheduled(optimizer, schedule, lr)
            if recording():
                if calls["update"] < 2:
                    params = [p for g in optimizer.param_groups for p in g["params"]]
                    state = [optimizer.state.get(p, {}) for p in params]
                    moments = [st_p["exp_avg"] if "exp_avg" in st_p else torch.zeros_like(p)
                               for st_p, p in zip(state, params)]
                    taps["grads"].append(([names[p] for p in params],
                                          torch.stack(torch._foreach_norm(moments))))
                calls["update"] += 1

        draws = [[round_draws(d)] for d in inp.draws()]
        with mock.patch.object(step_mod.TrainStep, "_apply_d", tapped_d), \
                mock.patch.object(step_mod, "apply_g", tapped_g), \
                mock.patch.object(step_mod.losses, "path_lengths", tapped_pl), \
                mock.patch.object(step_mod, "scheduled_step", stepped):
            with self.rec.span("setup.capture"):
                runner.prepare([K])
            scalars = tr.step_chunk(range(1, K + 1), inp.rows, draws=draws)
        if calls["D"] != 3 * K or calls["update"] != 2 * K or calls["pl"] != K:
            raise RuntimeError(f"{dict(calls)} calls of D, PL and updates in a chunk of {K}")
        grads: Dict[str, Dict[str, float]] = {"G": {}, "D": {}}
        for keys, norms in taps["grads"]:
            for (m, k), v in zip(keys, norms.tolist()):
                grads[m][k] = v / (1 - beta1)
        self.record = {
            "reals": [x.cpu() for x in taps["reals"]],
            "d_real": [y.float().cpu() for y in taps["d_real"]],
            "losses": {k: float(scalars[k]) for k in tc.LOSSES}, "grads": grads,
            "fake": {k: v.float().cpu() for k, v in taps["fake"][0].items()},
            "pl": taps["pl"][0].float().cpu(),
            "change": {m: tc._norms({k: p.detach() - before[m][k]
                                     for k, p in getattr(st, m).named_parameters()})
                       for m in ("G", "D", "G_ema")}}
        self.done = K

    def diagnostic(self) -> None:
        """The eager steps under the tracer and torch.profiler."""
        from torch.profiler import ProfilerActivity, profile

        from dusty_gan_torch.utils import profiling

        tr = self.trainer

        def one():
            self.done += 1
            tr.step(self.done, tr.device_cache.batch(*next(self.ix)))

        one()
        self._sync()
        modconv, g_ms, synth_s = [], [], 0.0
        profiling.drain()
        profiling.enable()
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                    phases():
                for _ in range(DIAGNOSTIC_STEPS):
                    one()
                    modconv.append(profiling.drain()["counters"].get("g.modconv", 0))
                self._sync()
        finally:
            profiling.disable()
        for s in kernels_by_span(prof.events(), SPANS):
            if s["name"] == "step.g":
                g_ms.append(s["device_s"] * 1e3)
            elif s["name"] == "g.synthesis":
                synth_s += s["device_s"]
        self.failed += sum(1 for n in modconv if n == 0)
        self.context.update(sg2_g_phase_ms=g_ms, synthesis_device_s=synth_s,
                            diagnostic_steps=DIAGNOSTIC_STEPS, modconv_per_step=modconv)

    def traced(self) -> dict:
        out = super().traced()
        self.diagnostic()
        return out

    def check(self) -> list:
        numbers = compare(self.record, reference_record(self.inp))
        if self.trace_on:
            self.context["flop_per_step"] = self.step_flop()
            self.context["synthesis_flop_per_step"] = self.synthesis_flop()
        return [{"name": k, "value": numbers[k], "limit": float(self.limits[k])}
                for k in NUMBERS]

    def _reference_step_inputs(self):
        inp = self.inp
        hp = ref.HyperSG2.from_config(inp.cfg)
        st = ref.State.fresh(*inp.weights())
        return inp, hp, st, inp.draws()[0]

    def step_flop(self) -> int:
        inp, hp, st, d = self._reference_step_inputs()
        batch = tc.batch_of(inp.depth, inp.rows[0], inp.device)
        return flops.count(lambda: ref.step(st, batch, d, hp))

    def synthesis_flop(self) -> int:
        """FLOP of a step's synthesis forwards: the D phase's fakes and the
        G phase's at the batch, the path length's at its rows."""
        inp, hp, st, d = self._reference_step_inputs()
        model = hp.model
        with torch.no_grad():
            ws = sg2.ws_of(st.G, d["z"], d["style"], model)
            full = flops.count(lambda: sg2.synthesis(st.G, ws, d["style"]["noise"], model))
            ws = sg2.ws_of(st.G, d["pl"][0], d["pl_style"], model)
            pl = flops.count(lambda: sg2.synthesis(st.G, ws, d["pl_style"]["noise"], model))
        return 2 * full + (pl if hp.w_pl > 0 else 0)


def program_numbers(spec: dict, seed: int, device) -> Dict[str, float]:
    """The numbers of a sound run of the program on ``seed``."""
    from gpubench.harness import Recorder

    run = Run(spec, seed, device, Recorder())
    run.build()
    run.checked_chunk()
    record = run.record
    run.release()
    want = reference_record(run.inp)
    return dict(compare(record, want), detail=tc.detail(record, want))


def _no_demodulation(fn):
    def conv(x, weight, styles, *, demodulate=True, up=False, prec=FLOAT32):
        return fn(x, weight, styles, demodulate=False, up=up, prec=prec)
    return conv


def _pl_wrt_z(G, draws, pl_ema, hp, prec=FLOAT32):
    z, y, gumbel = draws["pl"]
    z = z.detach().requires_grad_(True)
    depth = sg2.generator(G, z, draws["pl_style"], gumbel, hp.model, prec=prec)["depth"]
    (g,) = torch.autograd.grad((depth * y).sum(), z, create_graph=True)
    lengths = torch.sqrt(g.square().sum(dim=1))
    new = (pl_ema + (lengths.mean().detach() - pl_ema) * hp.pl_decay).detach()
    return ((lengths - new) ** 2).mean(), new, lengths.detach()


def control_numbers(spec: dict, seed: int, device) -> Dict[str, Dict[str, float]]:
    """The numbers of the control (the reference in fp8 where the program
    computes in bf16) and of the faults of this cell, each planted in the
    reference put in the program's place: half the batch, slot 0's rows
    in every slot, mixing ignored, noise dropped, demodulation skipped,
    the path length taken with respect to z."""
    inp = Inputs(spec["config_data"], spec["traffic"], seed, device)
    want = reference_record(inp)
    draws = inp.draws()

    def with_draws(fn):
        return mock.patch.object(inp, "draws", lambda: [fn(d) for d in draws])

    plants = {
        "fp8": ({"prec": FP8}, None),
        "half_batch": ({"half_batch": True}, None),
        "slot0_rows": ({"rows": inp.rows[[0] * inp.steps]}, None),
        "no_mixing": ({}, with_draws(lambda d: dict(d, style=dict(d["style"], z_mix=None)))),
        "no_noise": ({}, with_draws(lambda d: dict(d, style=dict(
            d["style"], noise=[0 * n for n in d["style"]["noise"]])))),
        "no_demodulation": ({}, mock.patch.object(
            sg2, "modulated_conv", _no_demodulation(sg2.modulated_conv))),
        "pl_wrt_z": ({}, mock.patch.object(ref, "path_length", _pl_wrt_z)),
    }
    out = {}
    for name, (kw, patch) in plants.items():
        if patch is None:
            got = reference_record(inp, **kw)
        else:
            with patch:
                got = reference_record(inp, **kw)
        out[name] = dict(compare(got, want), detail=tc.detail(got, want))
    return out
