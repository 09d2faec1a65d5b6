"""Epoch index schedules (counterpart of data/pipeline.py::epoch_batches).

The dataset lives on the device as two uint8 tensors; each step gathers its
batch from them by index (`training/loop.py`), so the host's only work per
step is one slice of a numpy permutation.
"""

from typing import Iterator, Tuple

import numpy as np


def epoch_batches(n: int, batch_size: int, rng: np.random.Generator,
                  shuffle: bool = True, drop_last: bool = True
                  ) -> Iterator[Tuple[np.ndarray, int]]:
    """Yield (index array, valid count) for one epoch (reference DataLoader
    semantics: shuffle + drop_last for train, neither for val).

    Without drop_last the final short batch is padded by repeating its last
    index, so every batch has one shape; `valid` says how many are real.
    """
    order = rng.permutation(n) if shuffle else np.arange(n)
    for start in range(0, n, batch_size):
        chunk = order[start:start + batch_size]
        if len(chunk) < batch_size:
            if drop_last:
                return
            pad = np.full(batch_size - len(chunk), chunk[-1], chunk.dtype)
            yield np.concatenate([chunk, pad]), len(chunk)
        else:
            yield chunk, batch_size
