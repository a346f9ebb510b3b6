"""Marginalised causal next-token loss (counterpart of
``dalm_tpu/losses/marginalized.py``).

Given generator logits over ``#query# q #passage# p #answer# a``:
next-token log-likelihoods, plus, from position ``L_i - 1`` on (``L_i`` the
un-padded length of the ``... #answer#`` prefix), the log-probability of
the positive passage ``diag(log_softmax(S, dim=1))``; NLL of the labels
``input[:, 1:]`` under ``attention_mask[:, 1:]``, mean over unmasked
positions. Differentiable in the logits and, through ``scores``, in the
retriever's embeddings.
"""

from __future__ import annotations

import torch


def marginalized_nll_loss(logits: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                          scores: torch.Tensor, query_passage_input_len: torch.Tensor) -> torch.Tensor:
    """logits (B, L, V) any float type; input_ids, attention_mask (B, L);
    scores (B, B) similarity logits; query_passage_input_len (B,).

    Gather / logsumexp form: the (B, L, V) log-probabilities are never kept,
    ``ll_t = logits_t[label_t] - logsumexp(logits_t) + answer_t * doc_lp``."""
    logits = logits[:, :-1, :].float()
    labels = input_ids[:, 1:].long()
    label_logits = torch.gather(logits, 2, labels[:, :, None])[:, :, 0]
    lse = torch.logsumexp(logits, dim=-1)
    doc_logprobs = torch.diagonal(torch.log_softmax(scores.float(), dim=1))
    positions = torch.arange(logits.shape[1], device=logits.device)[None, :]
    answer_region = positions >= (query_passage_input_len[:, None] - 1)
    ll = label_logits - lse + torch.where(answer_region, doc_logprobs[:, None], torch.zeros_like(lse))
    mask = attention_mask[:, 1:].float()
    return -(ll * mask).sum() / mask.sum()


def rag_e2e_loss(query_embs, passage_embs, generator_logits, generator_input_ids, generator_attention_mask,
                 query_passage_input_len, logit_scale: float = 100.0) -> tuple:
    """Combined objective ``contrastive + marginalised``; returns (total, parts)."""
    from dalm_tpu_torch.losses.contrastive import contrastive_loss

    retriever_loss, sim_logits = contrastive_loss(query_embs, passage_embs, logit_scale)
    generator_loss = marginalized_nll_loss(
        generator_logits, generator_input_ids, generator_attention_mask, sim_logits, query_passage_input_len)
    total = retriever_loss + generator_loss
    return total, {
        "loss": total,
        "retriever_contrastive_loss": retriever_loss,
        "generator_marginalized_loss": generator_loss,
    }
