"""Plain causal-LM next-token cross entropy, the generator-SFT objective
(counterpart of ``dalm_tpu/losses/causal.py:10``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_lm_loss(logits: torch.Tensor, input_ids: torch.Tensor, attention_mask=None) -> torch.Tensor:
    """Mean NLL of ``input_ids[:, 1:]`` under ``logits[:, :-1]`` in f32; with a
    mask, the mean over positions whose TARGET token is real
    (``sum(nll * mask) / max(sum(mask), 1)``)."""
    logits = logits[:, :-1, :].float()
    labels = input_ids[:, 1:].long()
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1), reduction="none")
    nll = nll.reshape(labels.shape)
    if attention_mask is None:
        return nll.mean()
    mask = attention_mask[:, 1:].float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
