"""The port's tracer (``dusty_gan_torch/utils/profiling.py``): off, it
records nothing; on, spans keep their parents and counters add, ``drain``
clears, a span is a user annotation in a torch.profiler trace; and the
spans and counters of the chunk loop, FPS and the pairwise scores, where a
chunk's scalars and state are bit-equal with the tracer on and off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dusty_gan_torch.config import compose
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.metrics.cov_mmd_1nna import compute_cov_mmd_1nna
from dusty_gan_torch.metrics.fps import downsample_point_clouds, furthest_point_sampling
from dusty_gan_torch.train.trainer import Trainer
from dusty_gan_torch.utils import profiling

from test_torch_steps_per_call import CONFIG_DIR, TINY, _state_tensors
from torch_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts and leaves the tracer off, with nothing recorded."""
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


def _names(rec):
    return [(name, parent) for name, parent, _, _ in rec["spans"]]


def test_off_records_nothing():
    with profiling.span("a"):
        profiling.count("n", 3)
    downsample_point_clouds(torch.randn(2, 40, 3), 8)
    assert profiling.span("a") is profiling.span("b")  # the shared do-nothing context
    assert profiling.drain() == {"spans": [], "counters": {}}


def test_nested_spans_record_their_parents_and_counters_add():
    profiling.enable()
    with profiling.span("outer"):
        with profiling.span("inner"):
            profiling.count("n")
        profiling.count("n", 4)
        with profiling.span("inner"):
            pass
    with profiling.span("alone"):
        pass
    rec = profiling.drain()
    assert _names(rec) == [("inner", "outer"), ("inner", "outer"), ("outer", None),
                           ("alone", None)]
    assert rec["counters"] == {"n": 5}
    spans = {name: (a, b) for name, _, a, b in rec["spans"]}
    assert spans["outer"][0] <= spans["inner"][0] <= spans["inner"][1] <= spans["outer"][1]


def test_drain_clears_what_was_recorded():
    profiling.enable()
    with profiling.span("a"):
        profiling.count("n")
    assert len(profiling.drain()["spans"]) == 1
    assert profiling.drain() == {"spans": [], "counters": {}}
    profiling.disable()
    with profiling.span("b"):
        pass
    assert profiling.drain() == {"spans": [], "counters": {}}


def test_a_span_is_a_user_annotation_in_a_profiler_trace():
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer.span"):
            with profiling.span("inner.span"):
                torch.randn(8, 8).sum()
    with profiling.span("after.profile"):
        pass
    events = {e.name: e for e in prof.events()}
    assert events["inner.span"].cpu_parent.name == "outer.span"
    assert "after.profile" not in events
    assert [n for n, _ in _names(profiling.drain())] == ["inner.span", "outer.span",
                                                         "after.profile"]


def test_a_chunk_records_its_parts_and_is_bit_equal_with_the_tracer_on(tmp_path):
    root = build_synthetic_kitti(str(tmp_path / "data"), n_scans_per_seq=10, w0=512,
                                 sequences=(0, 8))
    cfg = compose(CONFIG_DIR, TINY + [f"dataset.root={root}", "steps_per_call=2"])
    runs = {}
    for on in (False, True):
        trainer = Trainer(cfg, torch.device("cpu"), verbose=False)
        ix = trainer.loader.index_stream(0)
        rows = np.stack([trainer.device_cache.rows(*next(ix)) for _ in range(2)])
        if on:
            profiling.enable()
        scalars = trainer.step_chunk([1, 2], rows)
        profiling.disable()
        runs[on] = (scalars, _state_tensors(trainer), profiling.drain())
    assert runs[False][2]["spans"] == []
    assert sorted(_names(runs[True][2])) == [("chunk", None), ("chunk.draws", "chunk"),
                                             ("chunk.launch", "chunk"),
                                             ("chunk.upload", "chunk")]
    for i in (0, 1):
        off, on = runs[False][i], runs[True][i]
        assert off.keys() == on.keys()
        for key in off:
            assert torch.equal(off[key], on[key]), key


def test_fps_adds_its_steps_once_a_call():
    profiling.enable()
    for k in (8, 5):
        downsample_point_clouds(torch.randn(3, 40, 3), k)
    rec = profiling.drain()
    assert rec["counters"] == {"fps.steps": 7 + 4}
    assert _names(rec) == [("fps", None), ("fps", None)]


def test_fps_counts_no_kernel_clouds_on_the_cpu():
    """``fps.kernel_clouds`` counts the kernel's clouds: the plain loop on
    the CPU adds none, only its steps."""
    profiling.enable()
    furthest_point_sampling(torch.randn(4, 30, 3), 6)
    rec = profiling.drain()
    assert "fps.kernel_clouds" not in rec["counters"]
    assert rec["counters"] == {"fps.steps": 5}
    assert furthest_point_sampling.launches == 0


def test_the_scores_are_one_span_a_metric():
    g = torch.Generator().manual_seed(0)
    gen, ref = (torch.randn(4, 16, 3, generator=g) for _ in range(2))
    want = compute_cov_mmd_1nna(gen, ref, 4, ("cd", "emd"))
    profiling.enable()
    got = compute_cov_mmd_1nna(gen, ref, 4, ("cd", "emd"))
    rec = profiling.drain()
    assert got == want
    assert _names(rec) == [("cd.scores", None), ("emd.scores", None)]
