"""pytest settings of the benchmark's own tests (``gpubench/tests``):

    python -m pytest gpubench/tests -q

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; whether there
is one is decided inside the ``cuda_device`` fixture, never while a module
is imported.  ``tiny_spec`` shrinks a cell to widths and sizes the CPU runs
in seconds; the arithmetic and the control flow are the cell's own.
"""

from __future__ import annotations

import copy

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: runs on an NVIDIA GPU; skipped without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def shrink(spec: dict) -> dict:
    """The cell at tiny widths and sizes, everything else as it is."""
    spec = copy.deepcopy(spec)
    c = spec["config_data"]
    c["model"]["gen"].update(in_ch=32, ch_base=8, ch_max=16)
    c["model"]["dis"].update(ch_base=8, ch_max=16)
    c["dataset"]["shape"] = [32, 64]
    c["solver"]["batch_size"] = 8
    if "protocol" in c:
        c["protocol"].update(num_test=64, num_points=128, cd_batch=32, recon_batch=4,
                             num_step=8)
    t = spec["traffic"]
    for key, value in (("train_scans", 256), ("steps_per_call", 2), ("warmup_chunks", 1),
                       ("trace_chunks", 2), ("real_pool", 128), ("checked_pairs", 24),
                       ("test_scans", 8), ("checked_scans", 2)):
        if key in t:
            t[key] = value
    return spec


@pytest.fixture
def tiny_spec():
    """``tiny_spec(cell)``: the cell's spec from the repository's files,
    shrunk."""
    import torch

    from gpubench import harness

    torch.set_num_threads(2)
    return lambda name: shrink(harness.cell_spec(name))
