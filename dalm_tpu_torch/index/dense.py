"""Exact dense inner-product index on one device (counterpart of
``dalm_tpu/index/dense.py:ShardedDenseIndex``).

The (N, D) passage embeddings live on the device as float32 (or
bfloat16) rows, as int8 rows with per-row scales, or as half-split int4
nibbles with per-row scales; the quantisation is the reference's numpy
code (``dense.py:102-124``). ``search`` runs K3 (``kernels/topk.py``): on
a CUDA index the hand-written kernel, on a CPU index its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from dalm_tpu_torch.device import resolve_device
from dalm_tpu_torch.kernels.topk import fused_dot_topk


def quantize_int8(e: np.ndarray) -> tuple:
    """Symmetric per-row int8: scale = absmax / 127 (1 for zero rows)."""
    e = np.asarray(e, np.float32)
    absmax = np.max(np.abs(e), axis=1, keepdims=True)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    return np.clip(np.round(e / scale), -127, 127).astype(np.int8), scale


def quantize_int4(e: np.ndarray) -> tuple:
    """Per-row int4, absmax / 7, stored +8 as half-split nibbles: byte r
    holds column r (low) and column D/2 + r (high)."""
    e = np.asarray(e, np.float32)
    d = e.shape[1]
    if d % 2:
        raise ValueError("an int4 index needs an even embedding dim")
    absmax = np.max(np.abs(e), axis=1, keepdims=True)
    scale = np.where(absmax > 0, absmax / 7.0, 1.0).astype(np.float32)
    q = np.clip(np.round(e / scale), -7, 7).astype(np.int32) + 8
    return (q[:, : d // 2] | (q[:, d // 2 :] << 4)).astype(np.uint8), scale


class DenseIndex:
    """Typical life cycle::

        index = DenseIndex.build(embeddings)         # host → device
        scores, ids = index.search(query_embs, k=10)  # host (Q, k) arrays
    """

    def __init__(self, embeddings: torch.Tensor, scales: "torch.Tensor | None" = None, int4: bool = False):
        self.embeddings = embeddings  # (N, D) float/int8, or (N, D/2) uint8 when int4
        self.scales = scales          # (N, 1) float32 for quantised rows
        self.int4 = int4
        self.num_real = embeddings.shape[0]

    @property
    def device(self) -> torch.device:
        return self.embeddings.device

    @classmethod
    def build(cls, embeddings, dtype=torch.float32, quantize: "bool | str" = False,
              device=None) -> "DenseIndex":
        """``quantize``: False/None/"none" float rows in ``dtype``;
        True/"int8" int8 rows; "int4" nibble rows."""
        dev = resolve_device(device)
        if quantize in (None, "none", False):
            if isinstance(embeddings, torch.Tensor):  # float rows stay on the device: a copy in ``dtype``
                return cls(embeddings.detach().float().to(device=dev, dtype=dtype, copy=True))
            return cls(torch.as_tensor(np.asarray(embeddings, np.float32)).to(device=dev, dtype=dtype))
        e = embeddings.detach().cpu().numpy() if isinstance(embeddings, torch.Tensor) else np.asarray(embeddings)
        if quantize == "int4":
            packed, scale = quantize_int4(e)
            return cls(torch.from_numpy(packed).to(dev), torch.from_numpy(scale).to(dev), int4=True)
        if quantize in (True, "int8"):
            q8, scale = quantize_int8(e)
            return cls(torch.from_numpy(q8).to(dev), torch.from_numpy(scale).to(dev))
        raise ValueError(f"unknown quantize mode {quantize!r}")

    def refresh(self, embeddings) -> None:
        """Swap in re-embedded passages of the same shape (``dense.py:126-160``): float rows are copied in the
        index's dtype into storage of its own, int8 rows are quantised again; int4 indexes are rebuilt."""
        if self.int4:
            raise NotImplementedError("int4 indexes are rebuilt, not refreshed in place "
                                      "(DenseIndex.build(quantize='int4'))")
        if embeddings.shape[0] != self.num_real:
            raise ValueError(f"refresh takes {self.num_real} rows, not {embeddings.shape[0]}")
        if self.scales is not None:
            e = embeddings.detach().cpu().numpy() if isinstance(embeddings, torch.Tensor) else embeddings
            q8, scale = quantize_int8(e)
            self.embeddings = torch.from_numpy(q8).to(self.device)
            self.scales = torch.from_numpy(scale).to(self.device)
            return
        e = torch.as_tensor(embeddings)
        self.embeddings = e.to(device=self.device, dtype=self.embeddings.dtype, copy=True)

    def search(self, queries, k: int) -> tuple:
        """Exact top-k: (scores (Q, k) float32, ids (Q, k) int32) numpy arrays.
        ``k > N`` pads with score -inf and id 0."""
        q_dtype = torch.bfloat16 if self.scales is not None else self.embeddings.dtype
        q = torch.as_tensor(np.asarray(queries, np.float32)) if not isinstance(queries, torch.Tensor) else queries
        q = q.to(device=self.device, dtype=q_dtype).contiguous()
        s, i = fused_dot_topk(q, self.embeddings, k, num_valid=self.num_real, scales=self.scales, int4=self.int4)
        return s.cpu().numpy(), i.cpu().numpy()
