"""Sequential batch loader for evaluation (``dusty_gan_tpu/data/loader.py``,
non-shuffled epoch only): consecutive dataset items collated into numpy
batches, the last one short."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class Loader:
    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = int(batch_size)

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        for i in range(0, n, self.batch_size):
            items = [self.dataset[k] for k in range(i, min(i + self.batch_size, n))]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
