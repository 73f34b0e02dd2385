"""The StyleGAN2 cell (``dusty2_sg2_kitti.train``, driver ``train_sg2``) on
the CPU at tiny widths: it runs through the harness and comes out correct
unbroken, with its per-layer metrics in a traced run; a run with a fault
of its own planted in the program comes out not correct, the fault caught
by the number named for it; and the control and the faults that
calibration plants in the reference read above the limits."""

from __future__ import annotations

import copy
import dataclasses

import pytest
import torch

from gpubench import harness
from gpubench.drivers import train_sg2

CPU = torch.device("cpu")
CELL = "dusty2_sg2_kitti.train"
SEED = 2 ** 31 + 29  # slot 0 of the checked chunk mixes on this seed
CAUGHT_BY = {"no_mixing": "fake_gap", "no_noise": "fake_gap", "no_demodulation": "fake_gap",
             "pl_wrt_z": "pl_gap"}


def tiny(spec: dict) -> dict:
    spec = copy.deepcopy(spec)
    c = spec["config_data"]
    c["model"]["gen"].update(in_ch=32, w_dim=32, mapping_layers=2, channels=[32, 16, 8])
    c["model"]["dis"].update(channels=[8, 16, 32], fc_dim=32)
    c["dataset"]["shape"] = [16, 64]
    c["solver"]["batch_size"] = 8
    # float32, where the program and the reference agree to rounding at any
    # width, so that only a fault can fail a limit at these tiny widths
    c["enable_amp"] = False
    spec["traffic"].update(train_scans=256, steps_per_call=2, warmup_chunks=1, trace_chunks=2)
    return spec


@pytest.fixture
def spec():
    torch.set_num_threads(2)
    return tiny(harness.cell_spec(CELL))


def run(spec, trace=False):
    return harness.run_cell(CELL, SEED, 0.2, trace, CPU, spec=spec)


def test_the_cell_runs_correct_with_its_metrics(spec):
    out = run(spec, trace=True)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert list(out["checks"]) == list(train_sg2.NUMBERS)
    assert {"sg2_g_phase_ms_per_step", "train_mfu", "device_idle_share.train",
            "train_host_ms_per_chunk"} <= set(out["metrics"])


def test_the_seed_mixes_in_slot_0(spec):
    inp = train_sg2.Inputs(spec["config_data"], spec["traffic"], SEED, CPU)
    assert int(inp.draws()[0]["style"]["cutoff"]) < 6


def _plant(monkeypatch, fault):
    from dusty_gan_torch.models import losses, stylegan2
    from dusty_gan_torch.train import step

    if fault == "no_mixing":
        ws = stylegan2.Generator.ws
        monkeypatch.setattr(stylegan2.Generator, "ws", lambda self, z, style=None: ws(
            self, z, None if style is None else dataclasses.replace(style, z_mix=None)))
    elif fault == "no_noise":
        forward = stylegan2.SynthesisLayer.forward
        monkeypatch.setattr(stylegan2.SynthesisLayer, "forward",
                            lambda self, x, w, noise, dtype: forward(
                                self, x, w, None if noise is None else 0 * noise, dtype))
    elif fault == "no_demodulation":
        conv = stylegan2.modulated_conv2d
        monkeypatch.setattr(stylegan2, "modulated_conv2d",
                            lambda *a, **kw: conv(*a, **dict(kw, demodulate=False)))
    elif fault == "pl_wrt_z":
        def pl_z(self, G, d, pl_ema):
            z, noise, gumbel = d.pl
            return losses.path_length_penalty(
                lambda zz: step.apply_g(G, zz, gumbel, self.cdt, d.pl_style)["depth"],
                z.detach().requires_grad_(True), noise, pl_ema, step.PL_DECAY)
        monkeypatch.setattr(step.TrainStep, "_path_length", pl_z)


@pytest.mark.parametrize("fault", sorted(CAUGHT_BY))
def test_a_planted_fault_fails(spec, monkeypatch, fault):
    _plant(monkeypatch, fault)
    out = run(spec)
    c = out["checks"][CAUGHT_BY[fault]]
    assert not out["correct"] and c["value"] > c["limit"], out["checks"]


def test_the_control_and_the_reference_faults_read_above_the_limits(spec):
    limits = spec["traffic"]["limits"]
    got = train_sg2.control_numbers(spec, SEED, CPU)
    want = {"half_batch": "reals_gap", "slot0_rows": "reals_gap", **CAUGHT_BY}
    for name, number in want.items():
        assert got[name][number] > limits[number], (name, got[name])
    fp8 = got["fp8"]
    assert any(fp8[k] > limits[k] for k in train_sg2.NUMBERS), fp8
