"""Sentence embedder (counterpart of ``dalm_tpu/models/embedder.py``).

Non-autoregressive only in this slice: an Encoder whose hidden states
are mean-pooled and L2-normalised. The autoregressive (EOS-pooled
decoder) retriever waits for a later slice.
"""

from __future__ import annotations

import torch
from torch import nn

from dalm_tpu_torch.models.encoder import Encoder, EncoderConfig
from dalm_tpu_torch.models.pooling import mean_pool_l2


class SentenceEmbedder(nn.Module):
    def __init__(self, config: EncoderConfig, is_autoregressive: bool = False,
                 normalize: bool = True, device=None):
        super().__init__()
        if is_autoregressive:
            raise NotImplementedError("autoregressive retrievers are not ported yet")
        self.config = config
        self.is_autoregressive = is_autoregressive
        self.normalize = normalize
        self.module = Encoder(config, device=device)

    @property
    def embedding_dim(self) -> int:
        return self.config.hidden_size

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.module.reset_parameters(generator)

    @torch.no_grad()
    def embed(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) ids and mask → (B, H) pooled embeddings."""
        hidden = self.module(input_ids, attention_mask)
        return mean_pool_l2(hidden, attention_mask, normalize=self.normalize)
