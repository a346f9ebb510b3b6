"""In-batch-negative symmetric NT-Xent contrastive loss (counterpart of
``dalm_tpu/losses/contrastive.py``).

``S = (Q @ P^T) * logit_scale`` on L2-normalised embeddings, in f32;
``loss = (CE(S, arange(B)) + CE(S^T, arange(B))) / 2``: positives on the
diagonal, every other in-batch passage a negative. ``extra_negative_logits``
(B, K), hard-negative scores from the live index (logit-scaled already),
extend each row's query->passage softmax and the returned (B, B+K) matrix,
whose positives stay at column i; the passage->query direction stays
square. The reference's ``local_negatives_block`` (needs a device mesh) is
not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cosine_sim_logits(query_embs: torch.Tensor, passage_embs: torch.Tensor, logit_scale: float = 100.0) -> torch.Tensor:
    """f32 product even for bf16 embeddings: the values are scaled by 100 and fed to exp."""
    return (query_embs.float() @ passage_embs.float().T) * logit_scale


def nt_xent_loss(sim_scores: torch.Tensor) -> torch.Tensor:
    """Cross-entropy against the diagonal."""
    labels = torch.arange(sim_scores.shape[0], device=sim_scores.device)
    return F.cross_entropy(sim_scores, labels)


def contrastive_loss(query_embs: torch.Tensor, passage_embs: torch.Tensor, logit_scale: float = 100.0,
                     local_negatives_block=None, extra_negative_logits=None) -> tuple:
    """Symmetric NT-Xent over the batch; returns (loss, sim_logits (B, B) or (B, B + K))."""
    if local_negatives_block:
        raise NotImplementedError("local_negatives_block is not ported yet")
    logits = cosine_sim_logits(query_embs, passage_embs, logit_scale)
    aug = logits
    if extra_negative_logits is not None:
        aug = torch.cat([logits, extra_negative_logits.to(logits.dtype)], dim=1)
    loss = (nt_xent_loss(aug) + nt_xent_loss(logits.T)) / 2.0
    return loss, aug
