"""Sentence-embedding pooling (counterpart of ``dalm_tpu/models/pooling.py``).

- mean pooling: ``emb = L2norm( sum_t h_t * mask_t / max(sum_t mask_t, 1e-9) )``
  with an L2 eps of 1e-12;
- EOS pooling (the autoregressive retriever): the final hidden state at
  each sequence's EOS position, taken through the same mean pooling with a
  one-hot mask, so the clamp is the same. Left padding puts EOS in the last
  column, right padding at ``sum(mask) - 1``.
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


def eos_mask(attention_mask: torch.Tensor, padding: str = "left") -> torch.Tensor:
    """A mask selecting each sequence's final (EOS) token: the last column for
    left padding, position ``sum(mask) - 1`` for right padding."""
    if padding == "right":
        cols = torch.arange(attention_mask.shape[1], device=attention_mask.device)[None, :]
        return (cols == attention_mask.sum(dim=1, keepdim=True) - 1).to(attention_mask.dtype)
    out = torch.zeros_like(attention_mask)
    out[:, -1] = 1
    return out


def eos_pool(hidden: torch.Tensor, attention_mask: torch.Tensor, padding: str = "left",
             normalize: bool = True) -> torch.Tensor:
    """Hidden state at EOS, L2-normalised: mean pooling over the one-hot EOS mask."""
    return mean_pool_l2(hidden, eos_mask(attention_mask, padding), normalize=normalize)
