"""KV-cache generation, greedy or sampled (counterpart of ``dalm_tpu/models/generate.py``).

Same semantics as the reference (``generate.py:52-108``):

- prompts are LEFT-padded to ``P``; rope positions are
  ``clip(cumsum(mask) - 1, 0)``;
- the slot mask is ``[mask, ones(max_new_tokens)]``;
- prefill writes cache slots ``[0, P)``; decode step ``t`` writes slot
  ``P + t`` at position ``real_len + t``;
- tokens strictly after the first EOS are replaced by pad;
- a sampler draws the token of row ``b`` at step ``t`` keyed by the request
  index ``b`` and the token index ``t`` (``models/sampling.py``).

The reference's ``lax.scan`` is a Python loop here, and the cache is
written in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from dalm_tpu_torch.models.decoder import Decoder
from dalm_tpu_torch.models.sampling import SamplerConfig, resolve, select_token


def build_greedy_generate(
    decoder: Decoder,
    max_new_tokens: int,
    eos_token_id: Optional[int] = None,
    pad_token_id: int = 0,
    sampler: Optional[SamplerConfig] = None,
):
    """Returns ``fn(input_ids, attention_mask) -> (B, max_new_tokens)`` int32
    token ids; inputs are left-padded (B, P) prompts on the decoder's device."""
    cfg = resolve(sampler)

    @torch.no_grad()
    def generate(input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        B, P = input_ids.shape
        cache = decoder.init_kv_cache(B, P + max_new_tokens, device=input_ids.device)
        prompt_positions = torch.clamp(torch.cumsum(attention_mask, dim=1) - 1, min=0)
        pos = attention_mask.sum(dim=1)  # real_len, (B,)
        slot_mask = torch.cat(
            [attention_mask, torch.ones((B, max_new_tokens), dtype=attention_mask.dtype, device=input_ids.device)],
            dim=1,
        )
        logits, cache = decoder(
            input_ids, slot_mask, positions=prompt_positions, kv_cache=cache,
            cache_index=0, logits_last_only=True,
        )
        rows = torch.arange(B, dtype=torch.int32)  # request index = batch row
        tok = select_token(logits[:, -1, :], cfg, rows, torch.zeros_like(rows))
        toks = [tok]
        for t in range(max_new_tokens - 1):
            logits, cache = decoder(
                tok[:, None], slot_mask, positions=pos[:, None], kv_cache=cache, cache_index=P + t,
            )
            tok = select_token(logits[:, 0, :], cfg, rows, torch.full_like(rows, t + 1))
            toks.append(tok)
            pos = pos + 1
        out = torch.stack(toks, dim=1)
        if eos_token_id is not None:
            is_eos = (out == eos_token_id).to(torch.int32)
            after_eos = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
            out = torch.where(after_eos, torch.full_like(out, pad_token_id), out)
        return out

    return generate
