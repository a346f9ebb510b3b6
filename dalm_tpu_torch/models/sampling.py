"""Token selection (counterpart of ``dalm_tpu/models/sampling.py``).

Greedy only in this slice: ``temperature == 0`` selects the argmax.
Temperature / top-k / top-p sampling waits for the serving-engine slice
and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def select_token(logits: torch.Tensor, cfg: SamplerConfig, request_idx=None, token_idx=None) -> torch.Tensor:
    """(B, V) logits → (B,) int32 next tokens (first maximum on ties, as
    ``jnp.argmax``)."""
    if not cfg.greedy:
        raise NotImplementedError("sampling is not ported yet; only greedy decode")
    return torch.argmax(logits, dim=-1).to(torch.int32)


def resolve(sampler: Optional[SamplerConfig]) -> SamplerConfig:
    cfg = sampler if sampler is not None else SamplerConfig()
    if not cfg.greedy:
        raise NotImplementedError("sampling is not ported yet; only greedy decode")
    return cfg
