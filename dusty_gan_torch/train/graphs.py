"""k consecutive train steps per call (``steps_per_call``): the
counterpart of the JAX trainer's scan chunk (``dusty_gan_tpu/train/
trainer.py``: ``_make_chunk_step``, ``_chunk_args``, ``precompile_chunk``).

A chunk of k iterations reads three static buffers:

* ``rows`` (k, B) int64: each iteration's rows of the device-resident
  train split (``data/device_cache.py``), filled by one pinned,
  non-blocking copy;
* ``slots``: k sets of ``RoundDraws``.  Iteration i's draws are made
  eagerly, outside the graph, from its own generator (``Trainer.draws``:
  one generator seeded per iteration, which a graph cannot re-seed), and
  copied into slot j, by one grouped copy a dtype for the chunk;
* ``lrs`` (k, 2) float32: the (D, G) learning rate of each update, the
  schedule at the update count the host tracks.

Each step gathers its batch from ``rows`` and runs ``TrainStep``
(``fetch_reals``, the D phase with R1's double backward, D's Adam, the G
phase, G's Adam, the EMA) on the trainer's state in place.  The chunk
returns the last iteration's scalars, as the JAX chunk ships back only
those.

On CUDA each distinct chunk length is one ``torch.cuda.CUDAGraph`` (at
most three in a run: the first chunk, which realigns a resume to the
K-grid, K, and the tail), captured at its first use with Adam in its
capturable mode.  Before the first capture two steps run on a deep copy
of the state on a side stream, which settles cuDNN's algorithm choices,
workspaces and lazy handles without advancing the run.  A capture or a
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

from dusty_gan_torch.train.state import make_capturable, updates_done

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
    ``Trainer`` with a device cache).  The optimizers' update count is
    read at the first chunk and counted on the host from there on (on
    CUDA it moves to the card then), so per-step updates belong before
    the first chunk."""

    def __init__(self, trainer, max_len: int):
        self.trainer = trainer
        self.state = trainer.state
        self.cache = trainer.device_cache
        self.device = trainer.device
        self.graphed = self.device.type == "cuda"
        self.rows = torch.zeros((max_len, trainer.batch_size), dtype=torch.int64,
                                device=self.device)
        template = trainer.draws(1)
        self.slots = [_map(torch.empty_like, template) for _ in range(max_len)]
        self.lrs = torch.zeros((max_len, 2), dtype=torch.float32, device=self.device)
        self.updates: Optional[Tuple[int, int]] = None  # (D, G) updates made
        self.graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, torch.Tensor, Tuple[str, ...]]] = {}
        self.capture_s: Dict[int, float] = {}  # seconds to capture each length
        self.replays = self.replayed_iterations = 0

    def _step(self, state, j: int, lr) -> Dict[str, torch.Tensor]:
        return self.trainer.train_step(state, self.cache.gather(self.rows[j]), self.slots[j], lr)

    def run(self, iters: Sequence[int], rows: np.ndarray,
            draws: Optional[list] = None) -> Dict[str, torch.Tensor]:
        """Iterations ``iters`` on the batches of ``rows`` (k, B) with
        ``draws`` (k lists of RoundDraws; default ``Trainer.draws(i)``);
        returns the last iteration's scalars."""
        iters = [int(i) for i in iters]
        k = len(iters)
        rows = np.asarray(rows)
        if not 0 < k <= len(self.slots) or rows.shape != (k, self.rows.shape[1]):
            raise ValueError(f"a chunk of {k} iterations with rows {rows.shape}: at most "
                             f"{len(self.slots)} iterations of {self.rows.shape[1]} rows")
        if draws is None:
            draws = [self.trainer.draws(i) for i in iters]
        if len(draws) != k:
            raise ValueError(f"{len(draws)} iterations of draws for a chunk of {k}")
        self.cache.upload_rows(rows, self.rows[:k])
        dst = [t for slot in self.slots[:k] for t in _leaves(slot)]
        src = [t for d in draws for t in _leaves(d)]
        if len(src) != len(dst):
            raise ValueError(f"{len(src)} draw tensors for the chunk's {len(dst)}")
        for dtype in {t.dtype for t in dst}:  # a grouped copy takes one dtype
            pairs = [(a, b) for a, b in zip(dst, src) if a.dtype == dtype]
            torch._foreach_copy_([a for a, _ in pairs], [b for _, b in pairs])
        st = self.state
        if self.updates is None:
            self.updates = (updates_done(st.opt_D), updates_done(st.opt_G))
            if self.graphed:
                make_capturable(st.opt_D)
                make_capturable(st.opt_G)
        n_d, n_g = self.updates
        lrs = [(st.schedule_D.at(n_d + j), st.schedule_G.at(n_g + j)) for j in range(k)]
        self.updates = (n_d + k, n_g + k)
        if not self.graphed:
            for j in range(k):
                scalars = self._step(st, j, lrs[j])
            return scalars

        self.lrs[:k].copy_(torch.tensor(lrs, dtype=torch.float32).pin_memory(),
                           non_blocking=True)
        graph, out, keys = self.graphs.get(k) or self._capture(k)
        graph.replay()
        self.replays += 1
        self.replayed_iterations += k
        st.step += k * self.trainer.batch_size
        for opt, lr in zip((st.opt_D, st.opt_G), lrs[-1]):
            for group in opt.param_groups:  # what a checkpoint records
                group["lr"] = lr
        return dict(zip(keys, out.clone().unbind()))

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
