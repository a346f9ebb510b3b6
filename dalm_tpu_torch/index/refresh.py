"""Incremental re-embedding of an index (counterpart of ``dalm_tpu/index/refresh.py``).

After the retriever's weights change, the passage index is re-embedded in
small slices instead of one offline pass, so serving (or training) goes on
between them:

- the refresher keeps a STAGING buffer beside the index's ACTIVE rows: a
  clone in storage of its own, never a view, so a tick never writes into
  what searches read;
- ``tick()`` embeds the next ``slice_size`` passages with the retriever as
  it is now and writes them into staging;
- when the cursor wraps, staging becomes active (a Python attribute
  exchange on the index, no copy) and the version counter moves on.

Consistency: a search between two swaps sees the previous complete set of
rows, never a mix. After a swap the next sweep writes into the buffer that
was active; searches launched before that write may still be reading it.
That is safe because every launch of the port (the ticks' embedding and
copies, K3's search, from any thread) goes on the device's one legacy
default stream, which runs them in launch order. A caller that moves ticks
or searches to a side stream must order them with an event.

The port's modules hold their own weights (as its decode engine does), so
``embed_fn(ids, mask)`` closes over the retriever and ``tick()`` /
``refresh_fully()`` take no ``params``. The last slice is embedded at its
own size; the reference pads it to ``slice_size`` with copies of its last
row, and the same real rows are embedded either way.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dalm_tpu_torch.index.dense import DenseIndex


class AsyncIndexRefresher:
    def __init__(self, index: DenseIndex, embed_fn: Callable, passage_input_ids, passage_attention_mask,
                 slice_size: int = 256):
        """``embed_fn(ids, mask) -> (rows, D)`` takes host arrays of one slice. ``slice_size`` passages are
        re-embedded a tick; a full sweep takes ``ceil(N / slice_size)`` ticks."""
        if index.scales is not None or index.int4:
            raise ValueError(
                "AsyncIndexRefresher updates full-precision rows in place; quantized (int8/int4) indexes are "
                "rebuilt instead — DenseIndex.build(quantize=...) with fresh embeddings (RagPipeline.refresh "
                "does this automatically)"
            )
        if slice_size < 1:
            raise ValueError(f"slice_size must be at least 1, not {slice_size}")
        self.index = index
        self.embed_fn = embed_fn
        self.ids = np.asarray(passage_input_ids, np.int64)
        self.mask = np.asarray(passage_attention_mask, np.int64)
        self.slice_size = slice_size
        self.num_passages = len(self.ids)
        self.cursor = 0
        self.version = 0
        self.sweeps_started = 0
        self._staging = index.embeddings.clone()

    @torch.no_grad()
    def tick(self) -> dict:
        """Embed and stage one slice; at the end of a sweep, swap. Returns progress."""
        start = self.cursor
        end = min(start + self.slice_size, self.num_passages)
        embs = self.embed_fn(self.ids[start:end], self.mask[start:end])
        self._staging[start:end] = embs.to(self._staging.dtype)
        self.cursor = end
        swapped = False
        if self.cursor >= self.num_passages:
            self.index.embeddings, self._staging = self._staging, self.index.embeddings
            self.cursor = 0
            self.version += 1
            self.sweeps_started += 1
            swapped = True
        return {
            "cursor": self.cursor,
            "version": self.version,
            "progress": self.cursor / self.num_passages if self.num_passages else 1.0,
            "swapped": swapped,
        }

    def refresh_fully(self) -> int:
        """A blocking full sweep (the offline rebuild's equivalent); returns the new version."""
        start_version = self.version
        while self.version == start_version:
            self.tick()
        return self.version
