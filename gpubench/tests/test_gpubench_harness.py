"""The harness: cells, configurations and per-layer metrics found by name,
the result line's schema, and the refusals."""

from __future__ import annotations

import json
import re
import shutil
import sys

import pytest
import torch

from gpubench import harness, run
from gpubench.conftest import shrink

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
CPU = torch.device("cpu")


def test_benchmark_json_keeps_the_contract():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpubench"] and 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (harness.ROOT / c["file"]).is_file() and c["file"].startswith("gpubench/")
    reported = {}
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (harness.ROOT / "gpubench" / "workloads" / f"{w['name']}.json").is_file()
        e2e = [m["name"] for m in harness.metrics_of(bench["end_to_end"], w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        reported[w["name"]] = set(e2e)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["workloads"]
        assert (harness.ROOT / "gpubench" / "layer_metrics" / f"{m['name']}.py").is_file()
        assert all(m["moves"] in reported[c] for c in m["workloads"])
    for w in bench["workloads"]:
        assert harness.metrics_of(bench["per_layer"], w["name"])


def _copy_root(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def test_a_new_cell_configuration_and_metric_are_files_and_entries(tmp_path):
    root = _copy_root(tmp_path)
    spec = shrink(harness.cell_spec("dusty1_mpo.train"))
    (root / "gpubench/configs/tiny_mpo.json").write_text(json.dumps(spec["config_data"]))
    (root / "gpubench/workloads/tiny_mpo.train.json").write_text(json.dumps(spec["traffic"]))
    (root / "gpubench/layer_metrics/train_window_steps.py").write_text(
        "def read(ctx):\n    return ctx.get('window_steps')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_mpo", "source": "a test", "reduced": [],
                             "file": "gpubench/configs/tiny_mpo.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny_mpo.train", "config": "tiny_mpo",
                               "traffic": "train", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "dusty1_mpo.train" in m.get("workloads", ()):
            m["workloads"].append("tiny_mpo.train")
    bench["per_layer"].append({"name": "train_window_steps", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "chunk loop", "moves": "train_scans_per_s",
                               "workloads": ["tiny_mpo.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    torch.set_num_threads(2)
    out = harness.run_cell("tiny_mpo.train", 5, 0.5, False, CPU, root=root)
    assert set(out["metrics"]) == {"train_scans_per_s", "setup_s"} and out["correct"]
    out = harness.run_cell("tiny_mpo.train", 5, 0.5, True, CPU, root=root)
    assert out["metrics"]["train_window_steps"]["value"] == out["attempted"] > 0


@pytest.mark.parametrize("trace", [0, 1])
def test_the_result_line(tiny_spec, capsys, trace):
    spec = tiny_spec("dusty2_kitti.train")
    out = harness.run_cell("dusty2_kitti.train", 2 ** 31 + 11, 0.5, bool(trace), CPU, spec=spec)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert isinstance(out["correct"], bool) and out["attempted"] > 0 and out["failed"] == 0
    want = ({"train_host_ms_per_chunk", "train_mfu", "device_idle_share.train"} if trace
            else {"train_scans_per_s", "setup_s"})
    assert set(out["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert all(len(v) <= 10 for v in out["breakdown"].values())
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    harness.emit(out)
    got = capsys.readouterr()
    assert json.loads(got.out.strip().splitlines()[-1]) == json.loads(json.dumps(out))
    tail = got.err.strip().splitlines()[-len(out["checks"]):]
    assert [line.split()[1] for line in tail] == list(out["checks"])


def test_metrics_of_selects_by_cell():
    entries = [{"name": "a", "workloads": ["x"]}, {"name": "b", "workloads": ["x", "y"]},
               {"name": "c"}]
    assert [m["name"] for m in harness.metrics_of(entries, "x")] == ["a", "b", "c"]
    assert [m["name"] for m in harness.metrics_of(entries, "y")] == ["b", "c"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("jaxtyping", "dusty_gan_torch.train", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dusty_gan_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["dusty_gan_tpu", "jax"]


def test_a_run_without_a_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    rc = run.main(["--workload", "dusty2_kitti.train", "--seed", "1", "--seconds", "1"])
    got = capsys.readouterr()
    assert rc != 0 and got.out == "" and "CUDA" in got.err
