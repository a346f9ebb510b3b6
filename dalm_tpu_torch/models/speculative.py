"""Prompt-lookup speculative decoding (counterpart of ``dalm_tpu/models/speculative.py``).

A decode step reads every weight to make one token a row. A verify pass runs
the decoder over ``gamma + 1`` tokens a row, the current token and ``gamma``
drafts, for about the same weight reads, and commits the drafts the model
agrees with plus its own next token: 1 to ``gamma + 1`` tokens a pass.

Drafts come from prompt lookup (``prompt_lookup``): the tokens that followed
the most recent earlier occurrence of the row's last ``ngram`` tokens. RAG
answers quote their passage, so copied spans verify in one pass.

Verification (``rejection_verify``) is shared by the lockstep generator
below and every schedule of ``models/decode_engine.py`` and
``models/streaming.py``:

- greedy: a draft is accepted while it equals the argmax, so the output is
  the plain greedy output token for token (in exact arithmetic; in bf16 a
  verify pass rounds its products otherwise than a one-token step, and the
  argmax can flip where the top two logits lie within rounding of each other);
- sampled: rejection sampling with a point-mass proposal. Draft ``d`` at a
  position whose filtered target is ``p`` is accepted with probability
  ``p(d)``; the first rejection draws from ``p`` without ``d``; after ``gamma``
  accepted drafts a bonus token is drawn from ``p``. Every emitted token
  follows the plain sampler's distribution. The draws are keyed per
  (request, emitted-token index, use), ``models/sampling.py:token_uniforms``.

Cache discipline as the reference's: a pass writes keys and values of its
``gamma + 1`` tokens from the row's write head; entries past the accepted
prefix are overwritten by the next pass before any query can attend to them.
The cache is ``P + max_new_tokens + gamma + 1`` long, so the last window
never writes past its end.

The reference's ``lax.while_loop`` is a Python loop here with one read-back a
pass (whether a row is still short of ``max_new_tokens``); its ``gather_lanes``
(a one-hot einsum that avoids an XLA TPU compiler crash on lane gathers) is
``torch.gather``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from dalm_tpu_torch.models.decoder import Decoder
from dalm_tpu_torch.models.sampling import NEG_INF, SamplerConfig, draw, filtered, resolve, select_token, \
    token_uniforms


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src.gather(1, idx)`` with the index clamped into range, as XLA clamps a gather."""
    return src.gather(1, idx.clamp(0, src.shape[1] - 1))


def prompt_lookup(buf: torch.Tensor, q_end: torch.Tensor, pad_lens: torch.Tensor, gamma: int,
                  ngram: int) -> torch.Tensor:
    """Per-row n-gram prompt lookup over a token buffer.

    ``buf`` (B, L) token history (left-padded prompt, then generated tokens);
    ``q_end`` (B,) index of the newest token; ``pad_lens`` (B,) left-pad length
    (a match must start at or after it). Returns (B, gamma) drafts: the tokens
    after the most recent earlier occurrence of the row's last ``ngram`` tokens,
    or the newest token repeated where there is none."""
    B, L = buf.shape
    cur = torch.cat([_take(buf, (q_end - (ngram - 1 - t))[:, None]) for t in range(ngram)], dim=1)  # (B, ngram)
    pos = torch.arange(L, device=buf.device)[None, :]
    match = torch.ones((B, L), dtype=torch.bool, device=buf.device)
    for t in range(ngram):
        match &= torch.roll(buf, -t, dims=1) == cur[:, t:t + 1]
    # a match starts at l: wholly in the real (unpadded) region and strictly before the current n-gram
    match &= (pos >= pad_lens[:, None]) & (pos + (ngram - 1) < q_end[:, None] - (ngram - 1))
    last_l = torch.where(match, pos, torch.full_like(pos, -1)).argmax(dim=1)  # the most recent
    draft = _take(buf, last_l[:, None] + ngram + torch.arange(gamma, device=buf.device)[None, :])
    fallback = _take(buf, q_end[:, None]).expand(B, gamma)
    return torch.where(match.any(dim=1)[:, None], draft, fallback)


def rejection_verify(logits: torch.Tensor, draft: torch.Tensor, cfg: SamplerConfig, request_idx,
                     tok0) -> tuple:
    """Verify (B, G) drafts against the verifier's (B, G + 1, V) logits.

    ``request_idx`` (B,) the ORIGINAL request ids and ``tok0`` (B,) the
    emitted-token index of position 0 (the sampling keys; unused when greedy).
    Returns ``(ok (B, G) bool, fallback (B, G + 1) int64)``: whether each draft
    is accepted, and the verifier's token for the first rejected position (or
    the bonus position G)."""
    B, G = draft.shape
    if cfg.greedy:
        greedy = torch.argmax(logits, dim=-1)
        return draft == greedy[:, :G], greedy
    V = logits.shape[-1]
    lg = filtered(logits, cfg).reshape(B, G + 1, V)
    probs = torch.softmax(lg, dim=-1)
    draft_pad = F.pad(draft, (0, 1))  # (B, G + 1); column G unused
    tok_idx = torch.as_tensor(tok0).reshape(B, 1).cpu() + torch.arange(G + 1)[None, :]
    req = torch.as_tensor(request_idx).reshape(B, 1).cpu().expand(B, G + 1)
    u = token_uniforms(cfg.seed, req, tok_idx, use=0).reshape(B, G + 1).to(logits.device)
    p_d = probs.gather(2, draft_pad[..., None])[..., 0]
    ok = u[:, :G] < p_d[:, :G]
    # the residual (the draft masked out) at j < G; the bonus draw from p itself at j == G
    masked = F.one_hot(draft_pad, V).bool() & (torch.arange(G + 1, device=lg.device) < G)[None, :, None]
    res = torch.where(masked, torch.full_like(lg, NEG_INF), lg)
    fallback = draw(res.reshape(B * (G + 1), V), token_uniforms(cfg.seed, req, tok_idx, use=1))
    return ok, fallback.reshape(B, G + 1)


def commit(logits: torch.Tensor, draft: torch.Tensor, cfg: SamplerConfig, request_idx, tok0, active: torch.Tensor,
           budget: torch.Tensor) -> tuple:
    """One pass's outcome: ``emit`` (B, G + 1), position j the draft if j is below the accepted count and the
    verifier's token otherwise, and ``m`` (B,) the tokens committed, ``min(accepted + 1, budget)`` on ``active``
    rows and 0 on the rest."""
    ok, fallback = rejection_verify(logits, draft, cfg, request_idx, tok0)
    acc = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    m = torch.where(active, torch.minimum(acc + 1, budget.clamp(min=0)), torch.zeros_like(acc))
    j = torch.arange(draft.shape[1] + 1, device=draft.device)[None, :]
    return torch.where(j < acc[:, None], F.pad(draft, (0, 1)), fallback), m


def build_speculative_generate(
    decoder: Decoder,
    max_new_tokens: int,
    eos_token_id: Optional[int] = None,
    pad_token_id: int = 0,
    gamma: int = 8,
    ngram: int = 2,
    return_stats: bool = False,
    sampler: Optional[SamplerConfig] = None,
):
    """Returns ``fn(input_ids, attention_mask) -> (B, max_new_tokens)`` int32,
    greedy output equal to ``build_greedy_generate``'s; with ``return_stats``
    also the verify passes (B,) each row took (the first token comes from the
    prefill: (max_new - 1) / passes tokens a pass, one more than the accepted
    drafts). Inputs are left-padded (B, P) prompts on the
    decoder's device. ``gamma`` drafts a pass, prompt lookup over ``ngram``
    tokens. ``sampler``: rejection-sampled verification; ``top_k=1`` equals
    greedy."""
    cfg = resolve(sampler)

    @torch.no_grad()
    def generate(input_ids: torch.Tensor, attention_mask: torch.Tensor):
        B, P = input_ids.shape
        MN, G, dev = max_new_tokens, gamma, input_ids.device
        L = P + MN + G + 1  # slack for the last window
        cache = decoder.init_kv_cache(B, L, device=dev)
        pad_lens = P - attention_mask.sum(dim=1)
        slot_mask = torch.cat([attention_mask, torch.ones((B, L - P), dtype=attention_mask.dtype, device=dev)], dim=1)
        logits, cache = decoder(input_ids, slot_mask, positions=torch.clamp(torch.cumsum(attention_mask, dim=1) - 1,
                                                                            min=0),
                                kv_cache=cache, cache_index=0, logits_last_only=True)
        rows = torch.arange(B, dtype=torch.int32)
        first = select_token(logits[:, -1, :], cfg, rows, torch.zeros_like(rows))  # token index 0
        buf = torch.zeros((B, L), dtype=torch.long, device=dev)
        buf[:, :P] = input_ids
        buf[:, P] = first.long()
        n_gen = torch.ones(B, dtype=torch.long, device=dev)
        n_pass = torch.zeros(B, dtype=torch.long, device=dev)
        j = torch.arange(G + 1, device=dev)[None, :]
        l_idx = torch.arange(L, device=dev)[None, :]
        while bool((n_gen < MN).any()):
            active = n_gen < MN
            q_end = P + n_gen - 1  # the newest token's buffer index = its cache slot
            tok = buf.gather(1, q_end[:, None])
            draft = prompt_lookup(buf, q_end, pad_lens, G, ngram)
            positions = (q_end - pad_lens)[:, None] + j  # the rope position of tok is its row's real index
            logits, cache = decoder(torch.cat([tok, draft], dim=1), slot_mask, positions=positions, kv_cache=cache,
                                    cache_index=q_end)
            emit, m = commit(logits, draft, cfg, rows, n_gen, active, MN - n_gen)
            # emit[:, :m] goes to buffer indices q_end + 1 .. q_end + m
            g = l_idx - (q_end + 1)[:, None]
            buf = torch.where((g >= 0) & (g < m[:, None]), emit.gather(1, g.clamp(0, G)), buf)
            n_gen = n_gen + m
            n_pass = n_pass + active.long()
        out = buf[:, P:P + MN].to(torch.int32)
        if eos_token_id is not None:
            is_eos = (out == eos_token_id).to(torch.int32)
            after_eos = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
            out = torch.where(after_eos, torch.full_like(out, pad_token_id), out)
        if return_stats:
            return out, n_pass.to(torch.int32)
        return out

    return generate
