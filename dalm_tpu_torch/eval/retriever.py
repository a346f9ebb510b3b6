"""Retriever loading for serving and eval (counterpart of
``dalm_tpu/eval/retriever.py:40-80``): a non-autoregressive retriever
without PEFT adapters. The eval loop itself waits for a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from dalm_tpu_torch.core.dtypes import parse_dtype
from dalm_tpu_torch.data.tokenizer import resolve_tokenizer
from dalm_tpu_torch.device import resolve_device
from dalm_tpu_torch.models.embedder import SentenceEmbedder
from dalm_tpu_torch.models.registry import resolve_encoder


def build_embed_fn(model: SentenceEmbedder):
    """(ids, mask) host arrays or tensors → (B, H) embeddings on the model's device."""
    device = next(model.parameters()).device

    def fn(ids, mask):
        ids = torch.as_tensor(ids, dtype=torch.long, device=device)
        mask = torch.as_tensor(mask, dtype=torch.long, device=device)
        return model.embed(ids, mask)

    return fn


def load_retriever_for_eval(
    retriever_name_or_path: str,
    retriever_peft_model_path: Optional[str] = None,
    is_autoregressive: bool = False,
    torch_dtype: Optional[str] = None,
    tokenizer: str = "byte",
    device=None,
):
    """→ (SentenceEmbedder on ``device``, tokenizer). A preset name is
    random-initialised from seed 0; a saved directory loads its weights."""
    if retriever_peft_model_path:
        raise NotImplementedError("PEFT adapters are not ported yet")
    if is_autoregressive:
        raise NotImplementedError("autoregressive retrievers are not ported yet")
    dev = resolve_device(device)
    dtype = parse_dtype(torch_dtype) if torch_dtype else None
    cfg, state = resolve_encoder(retriever_name_or_path, dtype=dtype)
    model = SentenceEmbedder(cfg, device=dev)
    if state is None:
        model.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    else:
        model.module.load_state_dict(state)
    model.eval()
    return model, resolve_tokenizer(tokenizer)
