"""Joint retriever + generator model for RAG-e2e training (counterpart of
``dalm_tpu/models/rag.py``).

One object holding both sub-models with a task-switched forward and a
``Mode`` enum that says which sub-model gets LoRA / quantisation. The
sub-models are ``nn.Module``s that carry their own storage (plain, or
packed with factors, ``models/qlora.py``), so ``embed_with`` and
``logits_with`` take no variable collections: they run the modules as
they stand, with gradients. The autoregressive (EOS-pooled decoder)
retriever is not ported yet.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
from dalm_tpu_torch.models.encoder import Encoder, EncoderConfig
from dalm_tpu_torch.models.pooling import mean_pool_l2


class Mode(str, enum.Enum):
    """Which sub-models receive PEFT / quantisation."""

    RETRIEVER = "retriever"
    GENERATOR = "generator"
    BOTH = "both"


class RagE2EModel:
    def __init__(self, retriever_config: EncoderConfig, generator_config: DecoderConfig,
                 retriever_is_autoregressive: bool = False, normalize: bool = True, device=None):
        """Builds both sub-models on ``device``, or on ``device["retriever"]``
        and ``device["generator"]`` (``"meta"`` for a model that
        ``qlora.init_packed_on_device`` fills later); parameters are
        uninitialised until the caller loads or resets them."""
        if retriever_is_autoregressive:
            raise NotImplementedError("retriever_is_autoregressive is not ported yet")
        self.retriever_config = retriever_config
        self.generator_config = generator_config
        self.normalize = normalize
        devices = device if isinstance(device, dict) else {"retriever": device, "generator": device}
        self.retriever = Encoder(retriever_config, device=devices["retriever"])
        self.generator = Decoder(generator_config, device=devices["generator"])

    def embed_with(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                   dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """"retrieval" task: pooled, L2-normalised embeddings (B, H); the encoder's dropout draws from
        ``dropout_generator`` when one is given (the reference's ``deterministic=False``)."""
        hidden = self.retriever(input_ids, attention_mask, dropout_generator=dropout_generator)
        return mean_pool_l2(hidden, attention_mask, normalize=self.normalize)

    def logits_with(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """"generation" task: causal LM logits (B, L, V)."""
        return self.generator.train_forward(input_ids, attention_mask)

    def forward(self, task: str, input_ids, attention_mask):
        if task == "retrieval":
            return self.embed_with(input_ids, attention_mask)
        if task == "generation":
            return self.logits_with(input_ids, attention_mask)
        raise ValueError(f"unknown task {task!r}")
