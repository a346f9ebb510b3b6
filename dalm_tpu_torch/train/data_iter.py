"""Host-side batch iteration (own copy of ``dalm_tpu/train/data_iter.py``,
single process): batches are dicts of numpy arrays, shuffling is seeded per
epoch by the caller's generator, the trailing partial batch is kept unless
``drop_last``; ``skip_batches`` serves the resume path."""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np


def epoch_batches(dataset, columns: Sequence[str], batch_size: int, rng: Optional[np.random.Generator] = None,
                  shuffle: bool = True, drop_last: bool = False, skip_batches: int = 0) -> Iterator[dict]:
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    table = {c: np.asarray(dataset[c]) for c in columns}
    for b in range(num_batches_per_epoch(n, batch_size, drop_last)):
        if b < skip_batches:
            continue
        idx = order[b * batch_size:(b + 1) * batch_size]
        yield {c: table[c][idx] for c in columns}


def num_batches_per_epoch(n: int, batch_size: int, drop_last: bool = False) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


def pad_to_batch(batch: dict, batch_size: int) -> tuple:
    """Pad a partial trailing batch up to ``batch_size`` rows by repeating the
    last row. Returns (padded_batch, real_rows)."""
    real = len(next(iter(batch.values())))
    if real == batch_size:
        return batch, real
    pad = batch_size - real
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
    return out, real
