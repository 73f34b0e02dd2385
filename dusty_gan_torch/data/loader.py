"""Host-side batch loader (``dusty_gan_tpu/data/loader.py``): epoch-shuffled,
per-process sharded, drop-last batches, with a prefetch thread so that
collation overlaps the device step.

* The epoch permutation is ``RandomState(seed + epoch)``; process p of P
  takes the contiguous slice p of it, in batches of batch_size / P (the
  trainer's rank of its process group).
* Item i of epoch e draws its horizontal flip from
  ``default_rng([seed, e, i])`` (``dataset.get``), so the batch stream is
  a function of the position alone: ``iter_from(k)`` yields exactly what
  an uninterrupted stream yields after k batches.

By default (evaluation: ``shuffle=False, drop_last=False``) ``epoch(0)``
yields consecutive items, the last batch short; the trainer asks for
``shuffle=True, drop_last=True``.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Tuple

import numpy as np

PREFETCH = 2  # batches collated ahead


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, process_index: int = 0,
                 process_count: int = 1, keys=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.keys = tuple(keys) if keys is not None else None
        if self.batch_size % process_count:
            raise ValueError(f"batch {batch_size} does not split over {process_count} "
                             "processes")

    def __len__(self):
        n = len(self.dataset) // self.process_count
        b = self.batch_size // self.process_count
        return n // b if self.drop_last else -(-n // b)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        perm = (np.random.RandomState(self.seed + epoch).permutation(n)
                if self.shuffle else np.arange(n))
        per = n // self.process_count
        return perm[self.process_index * per:(self.process_index + 1) * per]

    def _collate(self, idxs, epoch: int) -> Dict[str, np.ndarray]:
        kw = {"keys": self.keys} if self.keys is not None else {}
        items = [self.dataset.get(int(i), np.random.default_rng([self.seed, epoch, int(i)]),
                                  **kw)
                 for i in idxs]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def index_batches(self, epoch: int, start_batch: int = 0) -> Iterator[np.ndarray]:
        """One epoch of this process's batch index arrays."""
        idx = self._epoch_indices(epoch)
        b = self.batch_size // self.process_count
        end = len(idx) - (len(idx) % b) if self.drop_last else len(idx)
        for i in range(start_batch * b, end, b):
            yield idx[i:i + b]

    def index_stream(self, start_iteration: int = 0) -> Iterator[Tuple[int, np.ndarray]]:
        """Infinite ``(epoch, batch indices)`` stream positioned as
        ``iter_from(start_iteration)``, without loading an item (the device
        cache ships indices instead of batches)."""
        epoch, start = divmod(int(start_iteration), max(len(self), 1))
        while True:
            yield from ((epoch, idx) for idx in self.index_batches(epoch, start_batch=start))
            epoch, start = epoch + 1, 0

    def flip_bits(self, epoch: int, idx: np.ndarray) -> np.ndarray:
        """The flip bits that ``_collate`` would draw for these items: the
        first draw of ``default_rng([seed, epoch, i])`` above 0.5.  Reads
        ``self.seed`` at call time (a resumed trainer sets it)."""
        if not getattr(self.dataset, "flip", False):
            return np.zeros(len(idx), dtype=bool)
        return np.fromiter(
            (np.random.default_rng([self.seed, int(epoch), int(i)]).random() > 0.5
             for i in idx), dtype=bool, count=len(idx))

    def epoch(self, epoch: int = 0, start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch of batches from batch ``start_batch`` on (the skipped
        ones are not loaded)."""
        for idx in self.index_batches(epoch, start_batch=start_batch):
            yield self._collate(idx, epoch)

    def iter_from(self, start_iteration: int) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite epoch-cycling stream positioned after ``start_iteration``
        batches, collated ahead by a daemon thread (``PREFETCH`` batches).
        Closing the iterator stops the thread."""
        epoch0, offset = divmod(int(start_iteration), max(len(self), 1))
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        failure = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            epoch, start = epoch0, offset
            try:
                while not stop.is_set():
                    for batch in self.epoch(epoch, start_batch=start):
                        if not put(batch):
                            return
                    epoch, start = epoch + 1, 0
            except BaseException as e:  # handed to the consumer, which raises it
                failure.append(e)
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    raise failure[0]
                yield batch
        finally:
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=2.0)
