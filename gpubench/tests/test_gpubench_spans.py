"""``gpubench/spans.py``: idle gaps put down to the program's innermost
span, the five readers of ``spans.METRICS``, and CPU traced runs of a
shrunken training cell and of the synthesis cell that print them."""

from __future__ import annotations

import pytest
import torch

from gpubench import harness, spans
from gpubench.drivers import train_chunks

CPU = torch.device("cpu")
NAMES = [m["name"] for m in spans.METRICS]


def test_gaps_go_to_the_innermost_open_span():
    device = [("k", 0, 10), ("k", 20, 30), ("k", 40, 50), ("k", 60, 70), ("k", 100, 110)]
    host = [("chunk", 5, 75), ("chunk.draws", 12, 35), ("chunk.launch", 56, 68)]
    idle, busy_s = spans.attribute(device, host)
    # the gaps' middles: 15 and 35 (its end) in chunk.draws, 55 in chunk
    # alone, 85 outside every span
    assert idle == pytest.approx({"chunk.draws": 20e-6, "chunk": 10e-6,
                                  spans.NO_SPAN: 30e-6})
    assert busy_s == pytest.approx(50e-6)


def test_the_window_edges_count_as_idle():
    device = [("k", 10, 20), ("k", 30, 40)]
    host = [("chunk.draws", 0, 12), ("cd.scores", 40, 90)]
    # before the first event: middle 5 in chunk.draws; between: 25, in no
    # span; after the last: middle 70 in cd.scores
    idle, _ = spans.attribute(device, host, window=(0, 100))
    assert idle == pytest.approx({"chunk.draws": 10e-6, spans.NO_SPAN: 10e-6,
                                  "cd.scores": 60e-6})
    assert spans.attribute([], host, window=(0, 100))[0] == pytest.approx(
        {"cd.scores": 100e-6})


def test_overlapping_device_events_leave_no_gap():
    idle, busy_s = spans.attribute([("a", 0, 10), ("b", 5, 20), ("c", 30, 40)],
                                   [("fps", 0, 40)])
    assert idle == pytest.approx({"fps": 10e-6}) and busy_s == pytest.approx(30e-6)


def test_blocked_launches_go_to_the_innermost_open_span():
    host = [("chunk", 0, 100), ("chunk.draws", 10, 40), ("chunk.launch", 60, 90)]
    blocked = [(12, 20), (30, 38), (45, 55), (70, 90), (95, 99)]
    assert spans.by_span(blocked, host) == pytest.approx(
        {"chunk.draws": 16e-6, "chunk": 14e-6, "chunk.launch": 20e-6})


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_returns_none_without_its_context(name):
    assert harness.read_layer_metric(name, {}) is None
    assert harness.read_layer_metric(name, {"program": {}, "program_idle": {}}) is None


def test_readers_read_the_segments():
    ctx = {"program": {"units": 2, "window_s": 1.0, "counters": {"fps.steps": 4000},
                       "spans_s": {"chunk.draws": [0.5, 0.5], "fps": [0.2, 0.2],
                                   "cd.scores": [0.3]}},
           "program_idle": {"units": 2, "window_s": 1.0, "busy_s": 0.5,
                            "idle_s": {"chunk": 0.002, "chunk.launch": 0.004,
                                       "fps": 0.1, spans.NO_SPAN: 1.0},
                            "spans_s": {"chunk.draws": [0.01, 0.05]},
                            "blocked_s": {"chunk.draws": 0.02, "chunk.launch": 0.3}}}
    got = {n: harness.read_layer_metric(n, ctx) for n in NAMES}
    assert got == pytest.approx({"train_draws_ms_per_chunk": 20.0,
                                 "train_boundary_idle_ms_per_chunk": 3.0,
                                 "fps_idle_ms_per_round": 50.0,
                                 "fps_host_us_per_step": 100.0,
                                 "cd_scores_ms_per_round": 150.0})


def test_the_metrics_keep_the_contract():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    layers = {m["layer"] for m in bench["per_layer"]}
    reported = {w["name"]: {m["name"] for m in harness.metrics_of(bench["end_to_end"],
                                                                  w["name"])}
                for w in bench["workloads"]}
    for m in spans.METRICS:
        assert m["layer"] in layers and m["name"] not in {x["name"] for x in bench["per_layer"]}
        assert all(m["moves"] in reported[c] for c in m["workloads"])
        assert (harness.ROOT / "gpubench" / "layer_metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell,want", [
    ("dusty2_kitti.train", {"train_draws_ms_per_chunk", "train_boundary_idle_ms_per_chunk"}),
    ("dusty2_kitti.synth_cd", {"fps_idle_ms_per_round", "fps_host_us_per_step",
                               "cd_scores_ms_per_round"})])
def test_a_cpu_traced_run_prints_the_new_metrics(tiny_spec, cell, want):
    out = spans.run_cell(cell, 2 ** 31 + 29, 0.5, CPU, spec=tiny_spec(cell))
    assert out["correct"] and out["failed"] == 0
    assert want <= set(out["metrics"]) and not (set(NAMES) - want) & set(out["metrics"])
    assert all(out["metrics"][n]["value"] >= 0 for n in want)
    prog = out["program"]
    count = {k: len(v) for k, v in prog["span_ms"].items()}
    if cell.endswith(".train"):
        assert count == {s: 2 for s in ("chunk", "chunk.draws", "chunk.upload", "chunk.launch")}
    else:
        assert count["cd.scores"] == 1
        points = tiny_spec(cell)["config_data"]["protocol"]["num_points"]
        assert prog["counters"]["fps.steps"] == count["fps"] * (points - 1)
    assert set(prog["units_per_s"]) == {"window", "plain", "traced", "profiled"}


def test_the_drivers_own_segment_records_no_program_span(tiny_spec):
    from dusty_gan_torch.utils import profiling

    profiling.drain()
    run = train_chunks.Run(tiny_spec("dusty2_kitti.train"), 7, CPU, harness.Recorder())
    run.setup()
    run.window(0.2, True)
    traced = run.traced()  # the profiled segment and the idle-device calls
    run.release()
    assert profiling.drain() == {"spans": [], "counters": {}}
    assert traced["window_s"] > 0

