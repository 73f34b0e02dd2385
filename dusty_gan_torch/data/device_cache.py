"""Device-resident dataset cache: ship indices, not batches
(``dusty_gan_tpu/data/device_cache.py``).

The resized train split is small next to the card's memory (KITTI's
19,130 train scans at 64x256 float32 depth are 1.25 GB, 2.5 GB with the
flipped variants), so it goes to the device once, in the step's layout
(N, C, H, W) float32, with the flipped variants as rows [N, 2N) when the
dataset flips.  Each step then sends only its batch's row indices, from
pinned memory without a host wait, and the batch is an exact gather on
the device.

The indices come from ``Loader.index_stream`` (the host path's
permutations, epoch cycling and resume position) and the flip bits from
``Loader.flip_bits`` (a replay of the per-item streams), and the rows are
the items ``dataset.item`` serves, so the batches equal the host path's
bit for bit and a run resumes across a switch of ``cache_device``.

A CUDA-graph chunk of k iterations (``steps_per_call``) takes its (k, B)
rows in one pinned, non-blocking copy into a static buffer
(``upload_rows``), and its captured steps gather from that buffer
(``gather``).
"""

from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import torch


class DeviceDatasetCache:
    def __init__(self, loader, device, keys: Sequence[str] = ("depth",)):
        self.loader = loader
        self.device = torch.device(device)
        self.keys = tuple(keys)
        ds = loader.dataset
        self.n = len(ds)
        self.flip = bool(getattr(ds, "flip", False))

        # host staging, filled row by row (memmap-friendly), then one copy
        # per key in the step's (N, C, H, W) layout
        variants = (False, True) if self.flip else (False,)
        first = ds.item(0, flip=False, keys=self.keys)
        host = {k: np.empty((self.n * len(variants),) + first[k].shape, np.float32)
                for k in self.keys}
        for v, flip in enumerate(variants):
            for i in range(self.n):
                item = ds.item(i, flip=flip, keys=self.keys)
                for k in self.keys:
                    host[k][v * self.n + i] = item[k]
        self.nbytes = sum(a.nbytes for a in host.values())
        t = time.perf_counter()
        self._data = {k: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(self.device)
                      for k, a in host.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload_s = time.perf_counter() - t

    def rows(self, epoch: int, idx: np.ndarray) -> np.ndarray:
        """Batch indices -> rows of the device arrays (a flipped draw reads
        row N + i)."""
        rows = np.asarray(idx, dtype=np.int64)
        if self.flip:
            rows = rows + self.n * self.loader.flip_bits(epoch, idx).astype(np.int64)
        return rows

    def upload_rows(self, rows: np.ndarray, out: torch.Tensor) -> None:
        """Host rows (any shape) into the device tensor ``out`` of that
        shape: from pinned memory without a host wait on CUDA."""
        host = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64))
        if self.device.type == "cuda":
            host = host.pin_memory()
        out.copy_(host, non_blocking=True)

    def gather(self, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        """{key: (B, C, H, W)} rows ``rows`` (B,) of the device arrays."""
        return {k: v.index_select(0, rows) for k, v in self._data.items()}

    def batch(self, epoch: int, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        """{key: (B, C, H, W)} for the loader's batch ``idx`` of ``epoch``."""
        rows = torch.empty(len(idx), dtype=torch.int64, device=self.device)
        self.upload_rows(self.rows(epoch, idx), rows)
        return self.gather(rows)
