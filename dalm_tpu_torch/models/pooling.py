"""Sentence-embedding pooling (counterpart of ``dalm_tpu/models/pooling.py:20-34``).

``emb = L2norm( sum_t h_t * mask_t / max(sum_t mask_t, 1e-9) )`` with an
L2 eps of 1e-12.
"""

from __future__ import annotations

import torch


def mean_pool_l2(hidden: torch.Tensor, attention_mask: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Masked mean over tokens, then L2 normalize. hidden: (B, L, H)."""
    mask = attention_mask[:, :, None].to(hidden.dtype)
    summed = torch.sum(hidden * mask, dim=1)
    counts = torch.clamp(torch.sum(mask, dim=1), min=1e-9)
    emb = summed / counts
    if normalize:
        emb = l2_normalize(emb)
    return emb


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) over the last axis."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=eps)
