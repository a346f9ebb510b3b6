"""Joint retriever + generator model for RAG-e2e training (counterpart of
``dalm_tpu/models/rag.py``).

One object holding both sub-models with a task-switched forward and a
``Mode`` enum that says which sub-model gets LoRA / quantisation. The
sub-models are ``nn.Module``s that carry their own storage (plain, or
packed with factors, ``models/qlora.py``), so ``embed_with`` and
``logits_with`` take no variable collections: they run the modules as
they stand, with gradients. With ``retriever_is_autoregressive`` the
retriever is a Decoder whose hidden state at EOS is the embedding
(``dalm_tpu/models/rag.py:44-57,73-85,98-117``); it has no dropout.
"""

from __future__ import annotations

import enum
from typing import Optional, Union

import torch

from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
from dalm_tpu_torch.models.encoder import Encoder, EncoderConfig
from dalm_tpu_torch.models.pooling import eos_pool, mean_pool_l2
from dalm_tpu_torch.models.registry import build_decoder


class Mode(str, enum.Enum):
    """Which sub-models receive PEFT / quantisation."""

    RETRIEVER = "retriever"
    GENERATOR = "generator"
    BOTH = "both"


class RagE2EModel:
    def __init__(self, retriever_config: Union[EncoderConfig, DecoderConfig], generator_config: DecoderConfig,
                 retriever_is_autoregressive: bool = False, normalize: bool = True, device=None):
        """Builds both sub-models on ``device``, or on ``device["retriever"]``
        and ``device["generator"]`` (``"meta"`` for a model that
        ``qlora.init_packed_on_device`` fills later); parameters are
        uninitialised until the caller loads or resets them. An
        autoregressive retriever takes a ``DecoderConfig``."""
        self.retriever_config = retriever_config
        self.generator_config = generator_config
        self.retriever_is_autoregressive = retriever_is_autoregressive
        self.normalize = normalize
        devices = device if isinstance(device, dict) else {"retriever": device, "generator": device}
        r_cls = Decoder if retriever_is_autoregressive else Encoder
        self.retriever = r_cls(retriever_config, device=devices["retriever"])
        self.generator = build_decoder(generator_config, device=devices["generator"])

    def embed_with(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                   dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """"retrieval" task: pooled, L2-normalised embeddings (B, H); the encoder's dropout draws from
        ``dropout_generator`` when one is given (the reference's ``deterministic=False``). An autoregressive
        retriever EOS-pools its decoder's final hidden states and ignores ``dropout_generator``."""
        if self.retriever_is_autoregressive:
            hidden = self.retriever.train_forward(input_ids, attention_mask, return_hidden=True)
            return eos_pool(hidden, attention_mask, normalize=self.normalize)
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
