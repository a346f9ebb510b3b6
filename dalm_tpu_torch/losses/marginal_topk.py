"""True top-k RAG marginalisation (counterpart of ``dalm_tpu/losses/marginal_topk.py:51-200``).

The generator runs once per (sample, candidate passage) over inputs assembled on the device from tokenised
segments ``[#query# q][#passage# z_j][#answer# y]``, and the answer likelihoods are marginalised over the
candidates' posterior ``softmax_j(s(q, z_j))``:

- RAG-sequence (``topk_marginal_loss``): one posterior per sample,
  ``-sum_i logsumexp_j(log softmax_j(s_ij) + ll_ij) / sum_i |y_i|``;
- RAG-token (``topk_marginal_token_loss``): one per answer token, the candidates compared at the same answer
  ordinal (``aligned_answer_token_loglik``),
  ``-sum_i sum_t logsumexp_j(log softmax_j(s_ij) + ll_ijt) / sum |y|``.

Gradients reach the retriever through the fresh candidate scores and the generator through every candidate's
likelihood. Every function keeps the reference's shapes and arithmetic in f32.
"""

from __future__ import annotations

import torch


def assemble_generator_inputs(q_ids: torch.Tensor, q_len: torch.Tensor, p_ids: torch.Tensor, p_len: torch.Tensor,
                              a_ids: torch.Tensor, a_len: torch.Tensor, pad_id: int = 0):
    """Concatenate right-padded segments into static shapes: q_ids (B, Lq) / q_len (B,), p_ids (B, K, Lp) /
    p_len (B, K), a_ids (B, La) / a_len (B,) (the ``#answer#`` marker at its head). Returns (ids (B, K, L),
    attention_mask (B, K, L), boundary (B, K)) with ``L = Lq + Lp + La`` and ``boundary = q_len + p_len``, where
    the answer segment starts."""
    B, Lq = q_ids.shape
    K, Lp = p_ids.shape[1], p_ids.shape[2]
    La = a_ids.shape[1]
    L = Lq + Lp + La
    t = torch.arange(L, device=q_ids.device)[None, None, :]
    ql = q_len[:, None, None]
    pl = p_len[:, :, None]
    al = a_len[:, None, None]
    in_q = t < ql
    in_p = (~in_q) & (t < ql + pl)
    in_a = (~in_q) & (~in_p) & (t < ql + pl + al)
    idx_q = torch.clamp(t, 0, Lq - 1).expand(B, 1, L)
    idx_p = torch.clamp(t - ql, 0, Lp - 1).expand(B, K, L)
    idx_a = torch.clamp(t - ql - pl, 0, La - 1).expand(B, K, L)
    qg = torch.gather(q_ids[:, None, :], 2, idx_q).expand(B, K, L)
    pg = torch.gather(p_ids, 2, idx_p)
    ag = torch.gather(a_ids[:, None, :].expand(B, K, La), 2, idx_a)
    pad = torch.full((), pad_id, dtype=q_ids.dtype, device=q_ids.device)
    ids = torch.where(in_q, qg, torch.where(in_p, pg, torch.where(in_a, ag, pad)))
    mask = (in_q | in_p | in_a).to(torch.int64).expand(B, K, L)
    boundary = q_len[:, None] + p_len
    return ids, mask, boundary


def answer_token_loglik(logits: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor, boundary: torch.Tensor,
                        marker_len: int):
    """logits (B, K, L, V); ids / mask (B, K, L); boundary (B, K). Returns (ll_tok (B, K, L-1), is_answer
    (B, K, L-1) bool): label position t predicts token t+1; answer-text labels start after the marker."""
    lp = logits[:, :, :-1, :].float()
    labels = ids[:, :, 1:].long()
    label_lp = torch.gather(lp, 3, labels[..., None])[..., 0]
    ll_tok = label_lp - torch.logsumexp(lp, dim=-1)
    pos_next = torch.arange(1, ids.shape[2], device=ids.device)[None, None, :]
    is_answer = (pos_next >= (boundary + marker_len)[:, :, None]) & (mask[:, :, 1:] > 0)
    return ll_tok, is_answer


def answer_loglik(logits: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor, boundary: torch.Tensor,
                  marker_len: int):
    """Per-candidate log-likelihood of the answer text: (ll (B, K), n_answer_labels (B,), the same for every
    candidate)."""
    ll_tok, is_answer = answer_token_loglik(logits, ids, mask, boundary, marker_len)
    ll = (ll_tok * is_answer).sum(dim=2)
    n = is_answer[:, 0, :].sum(dim=1)
    return ll, n


def topk_marginal_loss(candidate_scores: torch.Tensor, answer_ll: torch.Tensor,
                       n_answer_tokens: torch.Tensor) -> torch.Tensor:
    """RAG-sequence: ``-sum_i logsumexp_j(log softmax_j(s_ij) + ll_ij) / max(sum_i |y_i|, 1)``."""
    d = torch.log_softmax(candidate_scores.float(), dim=1)
    marg = torch.logsumexp(d + answer_ll, dim=1)
    total = torch.clamp(n_answer_tokens.sum(), min=1)
    return -marg.sum() / total


def aligned_answer_token_loglik(logits: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor, boundary: torch.Tensor,
                                marker_len: int, max_answer_tokens: int) -> torch.Tensor:
    """Answer log-likelihoods gathered by answer-token ordinal: (B, K, A), ordinal a of candidate j at label
    position ``boundary_ij + marker_len - 1 + a`` (clipped; entries past a sample's answer are masked by
    ``answer_token_mask``)."""
    ll_tok, _ = answer_token_loglik(logits, ids, mask, boundary, marker_len)
    Lm1 = ll_tok.shape[2]
    a = torch.arange(max_answer_tokens, device=ids.device)[None, None, :]
    idx = torch.clamp(boundary[:, :, None] + marker_len - 1 + a, 0, Lm1 - 1)
    return torch.gather(ll_tok, 2, idx)


def answer_token_mask(a_len: torch.Tensor, marker_len: int, max_answer_tokens: int) -> torch.Tensor:
    """(B, A) bool: ordinal a is a real answer-text token (the marker at the segment head excluded)."""
    a = torch.arange(max_answer_tokens, device=a_len.device)[None, :]
    return a < (a_len - marker_len)[:, None]


def topk_marginal_token_loss(candidate_scores: torch.Tensor, ll_tok: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """RAG-token: ``-sum_i sum_t logsumexp_j(log softmax_j(s_ij) + ll_ijt) * valid / max(sum valid, 1)``."""
    d = torch.log_softmax(candidate_scores.float(), dim=1)
    marg_t = torch.logsumexp(d[:, :, None] + ll_tok, dim=1)
    v = valid.float()
    return -(marg_t * v).sum() / torch.clamp(v.sum(), min=1.0)
