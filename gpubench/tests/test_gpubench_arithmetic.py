"""The yardstick's arithmetic against shapes worked by hand."""

from __future__ import annotations

import importlib.util
import math

import pytest
import torch

from gpubench import flops, harness, rooflines, trace
from gpubench.reference import models


def reader(name):
    path = harness.ROOT / "gpubench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_protocol_pairs_are_the_needed_ones():
    # M_rg whole, M_rr's and M_gg's strict upper triangles
    assert rooflines.protocol_pairs(1024, 1024) == 1024 * 1024 + 2 * (1024 * 1023 // 2)
    assert rooflines.protocol_pairs(1024, 1024) == 2_096_128
    assert rooflines.protocol_pairs(2, 3) == 6 + 3 + 1


def test_k1_least_time_is_its_operation_bound_at_protocol_scale():
    ops = 8 * 2048 * 2048 * 2_096_128
    assert rooflines.k1_least_s(2_096_128, 2048, 2048) == pytest.approx(ops / 67e12)
    assert ops / 67e12 == pytest.approx(1.049766, rel=1e-5)
    # one pair of one-point clouds is bound by its bytes: 2 clouds of 12 B, 4 B out
    assert rooflines.k1_least_s(1, 1, 2) == pytest.approx(28 / 3.35e12)


def test_fps_least_time():
    assert rooflines.fps_least_s(1024, 16384, 2048) == pytest.approx(
        9 * 1024 * 16384 * 2047 / 67e12)


def test_flop_count_of_matmul_and_convolution():
    a, b = torch.randn(3, 5), torch.randn(5, 7)
    assert flops.count(lambda: a @ b) == 2 * 3 * 5 * 7
    x, w = torch.randn(2, 4, 10, 12), torch.randn(6, 4, 3, 3)
    ho, wo = 8, 10
    assert flops.count(lambda: torch.nn.functional.conv2d(x, w)) == 2 * 2 * 6 * ho * wo * 4 * 9


def test_flop_count_of_the_reference_generator():
    model = {"gen": {"arch": "none/dcgan_eqlr", "in_ch": 32, "out_ch": {"depth": 1},
                     "ch_base": 8, "ch_max": 16, "drop_const": -1}}
    shape, b = (32, 64), 3
    p = models.make_params(models.generator_spec(model, shape), torch.Generator(), "cpu")
    z = torch.randn(b, 32)
    got = flops.count(lambda: models.generator(p, z, None, model, shape))
    # projection: a (b, 32) x (32, 16 * 2 * 4) product; then transposed
    # convolutions k4 on ring-padded inputs: 2 * b * Cin * Cout * 16 * Hin * Win
    want = 2 * b * 32 * 16 * 2 * 4
    for (cin, cout, h, w) in ((16, 16, 2, 4), (16, 16, 4, 8), (16, 8, 8, 16), (8, 1, 16, 32)):
        want += 2 * b * cin * cout * 16 * (h + 2) * (w + 2)
    assert got == want


def test_busy_time_is_the_union_of_device_intervals():
    device = [("k1", 0.0, 10.0), ("k2", 5.0, 12.0), ("k1", 20.0, 25.0)]
    host = [("cudaGraphLaunch", 11.0, 30.0), ("aten::randn", 0.0, 4.0)]
    out = trace.reduce_events(device, host, 50e-6)
    assert out["busy_s"] == pytest.approx(17e-6)
    assert out["device_s_by_name"] == pytest.approx({"k1": 15e-6, "k2": 7e-6})
    assert out["breakdown"]["idle_gaps"] == [["cudaGraphLaunch", pytest.approx(8e-6)]]
    assert reader("device_idle_share.train")({"trace": out}) == pytest.approx(100 * (1 - 17 / 50))


def test_share_readers():
    ctx = {"flop_per_step": 6e11, "window_steps": 400, "window_s": 10.0}
    assert reader("train_mfu")(ctx) == pytest.approx(100 * 6e11 * 400 / (10 * 989e12))
    tr = {"device_s_by_name": {"void cd_block_kernel<true>(...)": 3.0, "other": 1.0}}
    ctx = {"trace": tr, "pairs_per_round": 2_096_128, "points": 2048, "clouds": 1024}
    assert reader("k1_roofline")(ctx) == pytest.approx(100 * 1.049766 / 3.0, rel=1e-5)
    assert reader("k1_roofline")({"trace": {"device_s_by_name": {}}}) is None
    ctx = {"gen_flop_per_round": 1e13, "rounds": 2, "window_s": 12.0,
           "pairs_per_round": 2_096_128, "points": 2048, "clouds": 1024, "scan_points": 16384}
    least = (rooflines.k1_least_s(2_096_128, 2048, 2048)
             + rooflines.fps_least_s(1024, 16384, 2048) + 1e13 / 989e12)
    assert reader("synth_mfu")(ctx) == pytest.approx(100 * least * 2 / 12.0)
    ctx = {"flop_per_step": 1.2e12, "batches": 3, "steps": 100, "window_s": 10.0}
    assert reader("recon_mfu")(ctx) == pytest.approx(100 * 1.2e12 * 300 / (10 * 989e12))
    assert reader("train_host_ms_per_chunk")({"chunk_host_s": [0.002, 0.004]}) == \
        pytest.approx(3.0)
    assert math.isclose(reader("fps_ms_per_round")({"fps_s": [1.5]}), 1500.0)
