"""k consecutive train steps per call (``steps_per_call``): the
counterpart of the JAX trainer's scan chunk (``dusty_gan_tpu/train/
trainer.py``: ``_make_chunk_step``, ``_chunk_args``, ``precompile_chunk``).

A chunk of k iterations reads four static buffers:

* ``rows`` (k, B / W) int64: each iteration's rows of the device-resident
  train split (``data/device_cache.py``), this rank's share of the
  global batch in a group of W ranks (its ``Loader`` shard, as each JAX
  process contributes its local column slice), filled by one pinned,
  non-blocking copy;
* ``slots``: k sets of ``RoundDraws``.  Iteration i's draws are made
  eagerly, outside the graph, from its own generator (``Trainer.draws``:
  one generator seeded per iteration, which a graph cannot re-seed), and
  copied into slot j, by one grouped copy a dtype for the chunk;
* ``lrs`` (k, 2) float32: the (D, G) learning rate of each update, the
  schedule at the update count the host tracks;
* ``stop`` 0-d float32: this rank's stop flag, filled before each chunk
  and read by every step's scalar all-reduce in a group.

Each step gathers its batch from ``rows`` and runs ``TrainStep``
(``fetch_reals``, the D phase with R1's double backward, D's Adam, the G
phase, G's Adam, the EMA) on the trainer's state in place.  The chunk
returns the last iteration's scalars, as the JAX chunk ships back only
those; in a group they carry ``stop/agreed``, the last step's vote, as
the JAX chunk returns the maximum of its ranks' stop flags.

On CUDA each distinct chunk length is one ``torch.cuda.CUDAGraph`` (at
most three in a run: the first chunk, which realigns a resume to the
K-grid, K, and the tail), captured at its first use with Adam in its
capturable mode, in which the per-step path on CUDA steps it too
(``Trainer.next_lrs``), so that a replay repeats the per-step path's
arithmetic.  Before the first capture two steps run on a deep copy
of the state on a side stream, which settles cuDNN's algorithm choices,
workspaces and lazy handles without advancing the run.

In a process group each step's all-reduces (the gradient buckets, the
scalar vector with the stop vote, a relativistic loss's global means) are
NCCL collectives captured into the graph.  Every rank must capture and
replay the same lengths in the same order: ``prepare`` captures a run's
lengths up front, and the CLI then holds one host barrier before the
first replay.  The warm-up steps issue real all-reduces, so every rank
runs them before any captures, and they make the NCCL communicator,
which must exist before a capture.  The capture keeps torch's default
``capture_error_mode`` ("global"): the NCCL watchdog's event queries of
the warm-up's collectives did not disturb it at world size 1 on an H100,
where "thread_local" captured the same graphs (``PERF.md``).
A collective inside a replay has no watchdog timeout: a rank that dies
leaves the others waiting on the card.  A capture or a
replay that fails raises: nothing falls back to the eager loop.  The
graph's scalars are cloned after each replay, since the next replay
overwrites them.  On the CPU the same buffers are filled and the k steps
run eagerly, so a chunk equals the per-step path bit for bit there.
"""

from __future__ import annotations

import copy
import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dusty_gan_torch.parallel import mesh
from dusty_gan_torch.train.state import set_lr
from dusty_gan_torch.utils import profiling

WARMUP_STEPS = 2  # eager steps on a copy of the state before the first capture


def _map(fn, obj):
    """``obj`` (tensors in dataclasses, dicts, lists and tuples) with ``fn``
    applied to every tensor."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(fn, v) for v in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _map(fn, getattr(obj, f.name))
                                          for f in dataclasses.fields(obj)})
    return obj


def _leaves(obj) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map(out.append, obj)
    return out


class ChunkRunner:
    """Chunks of up to ``max_len`` iterations on ``trainer``'s state (a
    ``Trainer`` with a device cache), at the learning rates of
    ``trainer.next_lrs``."""

    def __init__(self, trainer, max_len: int):
        self.trainer = trainer
        self.state = trainer.state
        self.cache = trainer.device_cache
        self.device = trainer.device
        self.graphed = self.device.type == "cuda"
        self.rows = torch.zeros((max_len, trainer.batch_size // mesh.world_size()),
                                dtype=torch.int64, device=self.device)
        # valid draws from the start: the warm-up may run before a chunk
        # has filled the slots (``prepare``)
        template = trainer.draws(1)
        self.slots = [_map(torch.clone, template) for _ in range(max_len)]
        self.lrs = torch.zeros((max_len, 2), dtype=torch.float32, device=self.device)
        self.stop = torch.zeros((), dtype=torch.float32, device=self.device)
        self.graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, torch.Tensor, Tuple[str, ...]]] = {}
        self.capture_s: Dict[int, float] = {}  # seconds to capture each length
        self.replays = self.replayed_iterations = 0

    def _step(self, state, j: int, lr) -> Dict[str, torch.Tensor]:
        return self.trainer.train_step(state, self.cache.gather(self.rows[j]), self.slots[j],
                                       lr, stop=self.stop)

    def prepare(self, lengths: Sequence[int]) -> None:
        """Capture the graph of each chunk length in ``lengths`` not yet
        captured, shortest first (on CUDA; the CPU has nothing to
        capture)."""
        if self.graphed:
            self.trainer.next_lrs(0)  # Adam in its capturable mode, as a chunk runs it
            for k in sorted(set(int(k) for k in lengths) - set(self.graphs)):
                self._capture(k)

    def run(self, iters: Sequence[int], rows: np.ndarray, draws: Optional[list] = None,
            stop: bool = False) -> Dict[str, torch.Tensor]:
        """Iterations ``iters`` on the batches of ``rows`` (k, B / W) with
        ``draws`` (k lists of RoundDraws; default ``Trainer.draws(i)``) and
        this rank's stop flag; returns the last iteration's scalars.  The
        tracer's span ``chunk`` holds ``chunk.draws`` (the draws),
        ``chunk.upload`` (rows, draws and learning rates to the device) and
        ``chunk.launch`` (the replay, or on the CPU the k steps)."""
        with profiling.span("chunk"):
            return self._run(iters, rows, draws, stop)

    def _run(self, iters, rows, draws, stop) -> Dict[str, torch.Tensor]:
        iters = [int(i) for i in iters]
        k = len(iters)
        rows = np.asarray(rows)
        if not 0 < k <= len(self.slots) or rows.shape != (k, self.rows.shape[1]):
            raise ValueError(f"a chunk of {k} iterations with rows {rows.shape}: at most "
                             f"{len(self.slots)} iterations of {self.rows.shape[1]} rows")
        with profiling.span("chunk.draws"):
            if draws is None:
                draws = [self.trainer.draws(i) for i in iters]
        if len(draws) != k:
            raise ValueError(f"{len(draws)} iterations of draws for a chunk of {k}")
        dst = [t for slot in self.slots[:k] for t in _leaves(slot)]
        src = [t for d in draws for t in _leaves(d)]
        if len(src) != len(dst):
            raise ValueError(f"{len(src)} draw tensors for the chunk's {len(dst)}")
        with profiling.span("chunk.upload"):
            self.cache.upload_rows(rows, self.rows[:k])
            for dtype in {t.dtype for t in dst}:  # a grouped copy takes one dtype
                pairs = [(a, b) for a, b in zip(dst, src) if a.dtype == dtype]
                torch._foreach_copy_([a for a, _ in pairs], [b for _, b in pairs])
            self.stop.fill_(float(stop))
            lrs = self.trainer.next_lrs(k)
            if self.graphed:
                self.lrs[:k].copy_(torch.tensor(lrs, dtype=torch.float32).pin_memory(),
                                   non_blocking=True)
        st = self.state
        if not self.graphed:
            with profiling.span("chunk.launch"):
                for j in range(k):
                    scalars = self._step(st, j, lrs[j])
            return scalars

        graph, out, keys = self.graphs.get(k) or self._capture(k)
        with profiling.span("chunk.launch"):
            graph.replay()
            out = out.clone()
        self.replays += 1
        self.replayed_iterations += k
        st.step += k * self.trainer.batch_size
        for opt, lr in zip((st.opt_D, st.opt_G), lrs[-1]):
            set_lr(opt, lr)  # what a checkpoint records
        return dict(zip(keys, out.unbind()))

    def _warm_up(self) -> None:
        twin = copy.deepcopy(self.state)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side), warnings.catch_warnings():
            # capturable Adam warns once that it steps outside a capture
            warnings.filterwarnings("ignore", message=".*capturable=True")
            for _ in range(WARMUP_STEPS):
                self._step(twin, 0, (self.lrs[0, 0], self.lrs[0, 1]))
        main.wait_stream(side)
        torch.cuda.synchronize(self.device)

    def _capture(self, k: int):
        t0 = time.perf_counter()
        if not self.graphs:
            self._warm_up()
        graph = torch.cuda.CUDAGraph()
        step = self.state.step
        with torch.cuda.graph(graph):
            for j in range(k):
                scalars = self._step(self.state, j, (self.lrs[j, 0], self.lrs[j, 1]))
            keys = tuple(scalars)
            out = torch.stack([scalars[key] for key in keys])
        self.state.step = step  # the host counts replayed steps
        self.graphs[k] = (graph, out, keys)
        self.capture_s[k] = time.perf_counter() - t0
        return self.graphs[k]
