"""Token selection: greedy, or temperature / top-k / top-p sampling
(counterpart of ``dalm_tpu/models/sampling.py``).

``temperature == 0`` selects the argmax. Otherwise the logits are divided by
the temperature, filtered as the reference filters them (``_filter_logits``,
``:54-72``), and one token is drawn per row by inverse-CDF sampling from one
uniform number. That number comes from a ``torch.Generator`` seeded from
``(seed, request_idx, token_idx)`` alone, so a request draws the same token
at the same position whatever batch or device it runs in. The reference keys
``jax.random.categorical`` with ``fold_in(fold_in(key(seed), request), token)``:
the same distribution, other numbers.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import torch

NEG_INF = -1e30  # the reference's masked-logit value (kernels/flash_attention.py NEG_INF)


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0            # 0 = no top-k filter
    top_p: float = 1.0        # 1 = no nucleus filter
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def _filter_logits(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """Top-k, then top-p masks on (B, V) f32 logits: a masked logit becomes NEG_INF."""
    neg = torch.full_like(logits, NEG_INF)
    if 0 < cfg.top_k < logits.shape[-1]:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep tokens until the cumulative probability exceeds p (always the top one)
        keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool), cum[..., :-1] < cfg.top_p], dim=-1)
        thresh = torch.where(keep, sorted_logits, torch.full_like(sorted_logits, float("inf"))).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, neg, logits)
    return logits


def token_uniforms(seed: int, request_idx, token_idx) -> torch.Tensor:
    """One uniform number in [0, 1) per (request, token) pair, f64 on the CPU,
    each from a ``torch.Generator`` seeded with a hash of ``(seed, request, token)``."""
    out = []
    for r, t in zip(torch.as_tensor(request_idx).reshape(-1).tolist(), torch.as_tensor(token_idx).reshape(-1).tolist()):
        key = hashlib.blake2b(f"{seed}/{r}/{t}".encode(), digest_size=8).digest()
        gen = torch.Generator().manual_seed(int.from_bytes(key, "little") >> 1)
        out.append(torch.rand((), generator=gen, dtype=torch.float64))
    return torch.stack(out)


def select_token(logits: torch.Tensor, cfg: SamplerConfig, request_idx=None, token_idx=None) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 next tokens. Greedy takes the first maximum
    (as ``jnp.argmax``); sampling needs the rows' request and token indices."""
    if cfg.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if request_idx is None or token_idx is None:
        raise ValueError("sampling needs request_idx and token_idx for every row")
    lf = logits.float()
    lf = _filter_logits(lf / torch.full_like(lf, cfg.temperature), cfg)
    cdf = torch.cumsum(torch.softmax(lf, dim=-1).double(), dim=-1)
    u = token_uniforms(cfg.seed, request_idx, token_idx).to(cdf.device)
    # the first token whose cumulative probability exceeds u * total: never one of probability 0
    tok = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)[:, 0]
    return torch.clamp(tok, max=logits.shape[-1] - 1).to(torch.int32)


def resolve(sampler: Optional[SamplerConfig]) -> SamplerConfig:
    return sampler if sampler is not None else SamplerConfig()
