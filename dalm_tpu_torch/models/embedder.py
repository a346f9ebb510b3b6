"""Sentence embedder (counterpart of ``dalm_tpu/models/embedder.py``).

An Encoder (bge / BERT class) whose hidden states are mean-pooled and
L2-normalised, or, with ``is_autoregressive``, a Decoder whose final hidden
state at the EOS position is the embedding (``dalm_tpu/models/embedder.py:28-64``).
"""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from dalm_tpu_torch.models.decoder import DecoderConfig
from dalm_tpu_torch.models.encoder import Encoder, EncoderConfig
from dalm_tpu_torch.models.pooling import eos_pool, mean_pool_l2
from dalm_tpu_torch.models.registry import build_decoder


class SentenceEmbedder(nn.Module):
    def __init__(self, config: Union[EncoderConfig, DecoderConfig], is_autoregressive: bool = False,
                 normalize: bool = True, device=None):
        super().__init__()
        self.config = config
        self.is_autoregressive = is_autoregressive
        self.normalize = normalize
        self.module = build_decoder(config, device=device) if is_autoregressive else Encoder(config, device=device)

    @property
    def embedding_dim(self) -> int:
        return self.config.hidden_size

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.module.reset_parameters(generator)

    @torch.no_grad()
    def embed(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) ids and mask → (B, H) pooled embeddings."""
        if self.is_autoregressive:
            hidden = self.module(input_ids, attention_mask, return_hidden=True)
            return eos_pool(hidden, attention_mask, normalize=self.normalize)
        hidden = self.module(input_ids, attention_mask)
        return mean_pool_l2(hidden, attention_mask, normalize=self.normalize)
