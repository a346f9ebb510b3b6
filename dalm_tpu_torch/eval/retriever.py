"""Retriever loading and evaluation (counterpart of ``dalm_tpu/eval/retriever.py``).

``load_retriever_for_eval`` builds the retriever (an encoder, mean-pooled;
or, with ``is_autoregressive``, a decoder EOS-pooled, its tokenizer adding
EOS and padding on the left) and merges a PEFT adapter into its weights.
``evaluate_retriever`` embeds the dataset's unique passages into a
``DenseIndex``, searches it with K3 for every query and scores recall,
precision, hit rate and MRR (``eval/common.py``).

Differences from the reference that a caller sees: one device (``device``,
default the CUDA card; ``"cpu"`` for tests), so ``mesh`` is inert;
``index_kernel`` is accepted and inert: on the card K3, the hand-written
kernel, runs whatever it says, and on the CPU its plain version; query and
passage batches are embedded at their own size, with no padding rows.
"""

from __future__ import annotations

import logging
from typing import Optional, Union

import numpy as np
import torch

from dalm_tpu_torch.core.dtypes import parse_dtype
from dalm_tpu_torch.data.loading import ColumnDataset, load_dataset
from dalm_tpu_torch.data.tokenizer import resolve_tokenizer
from dalm_tpu_torch.device import resolve_device
from dalm_tpu_torch.eval.common import (
    aggregate_results,
    embed_dataset,
    filter_unique_passages,
    preprocess_eval_dataset,
    score_batch,
    threshold_hits,
)
from dalm_tpu_torch.eval.results import EvalResults
from dalm_tpu_torch.index.dense import DenseIndex
from dalm_tpu_torch.models.embedder import SentenceEmbedder
from dalm_tpu_torch.models.lora import load_adapter, merge_lora_inplace
from dalm_tpu_torch.models.registry import resolve_decoder, resolve_encoder

logger = logging.getLogger(__name__)


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
    random-initialised from seed 0; a saved directory loads its weights. An
    adapter saved by ``models.lora.save_adapter`` at
    ``retriever_peft_model_path`` is merged into the model's kernels
    (``dalm_tpu/eval/retriever.py:50-80``)."""
    dev = resolve_device(device)
    dtype = parse_dtype(torch_dtype) if torch_dtype else None
    resolve = resolve_decoder if is_autoregressive else resolve_encoder
    cfg, state = resolve(retriever_name_or_path, dtype=dtype)
    model = SentenceEmbedder(cfg, is_autoregressive=is_autoregressive, device=dev)
    if state is None:
        model.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    else:
        model.module.load_state_dict(state)
    if retriever_peft_model_path:
        merge_lora_inplace(model.module, *load_adapter(retriever_peft_model_path))
    model.eval()
    tok = resolve_tokenizer(tokenizer, add_eos_token=is_autoregressive)
    if is_autoregressive:
        tok.padding_side = "left"
    return model, tok


def embed_and_index(model: SentenceEmbedder, processed: ColumnDataset, passage_column_name: str,
                    test_batch_size: int, embed_dim: Optional[int], index_quantize) -> tuple:
    """The unique passages of ``processed`` embedded in batches of ``test_batch_size`` into a ``DenseIndex``
    on the model's device → (index, {index row: passage})."""
    if embed_dim is not None and embed_dim != model.embedding_dim:
        raise ValueError(f"embed_dim={embed_dim} but the retriever embeds into {model.embedding_dim} dimensions")
    unique_passages = filter_unique_passages(processed, passage_column_name)
    logger.info("embedding %d unique passages", len(unique_passages))
    passage_embs = embed_dataset(build_embed_fn(model), unique_passages, "retriever_passage_input_ids",
                                 "retriever_passage_attention_mask", test_batch_size, model.embedding_dim)
    index = DenseIndex.build(passage_embs, quantize=index_quantize, device=next(model.parameters()).device)
    return index, dict(enumerate(unique_passages[passage_column_name]))


def search_and_score(model: SentenceEmbedder, processed: ColumnDataset, index: DenseIndex, id_to_passage: dict,
                     passage_column_name: str, batch_size: int, top_k: int, threshold: float = 0.0,
                     on_batch=None) -> EvalResults:
    """Every query searched with K3 in batches of ``batch_size`` and scored against its gold passage →
    recall, precision, hit rate and MRR over the dataset. ``on_batch(start, end, top-1 passages)`` sees each
    batch's top-1 passages (``""`` where every score is under ``threshold``)."""
    embed_fn = build_embed_fn(model)
    q_ids = np.asarray(processed["retriever_query_input_ids"], np.int64)
    q_mask = np.asarray(processed["retriever_query_attention_mask"], np.int64)
    precisions, recalls, rrs, total_hit = [], [], [], 0
    gold = processed[passage_column_name]
    for start in range(0, len(processed), batch_size):
        end = min(start + batch_size, len(processed))
        scores, found = index.search(embed_fn(q_ids[start:end], q_mask[start:end]).float(), top_k)
        p, r, h, top_passages, rr = score_batch(threshold_hits(scores, found, id_to_passage, threshold),
                                                gold[start:end])
        precisions.extend(p)
        recalls.extend(r)
        total_hit += h
        rrs.extend(rr)
        if on_batch is not None:
            on_batch(start, end, top_passages)
    return aggregate_results(len(processed), precisions, recalls, total_hit, rrs)


def evaluate_retriever(
    dataset_or_path: Union[ColumnDataset, dict, str],
    retriever_name_or_path: str,
    retriever_peft_model_path: Optional[str] = None,
    passage_column_name: str = "Abstract",
    query_column_name: str = "Question",
    embed_dim: Optional[int] = None,
    max_length: int = 128,
    test_batch_size: int = 8,
    device=None,
    torch_dtype: str = "bfloat16",
    top_k: int = 10,
    is_autoregressive: bool = False,
    tokenizer: str = "byte",
    mesh=None,  # inert: one device
    query_batch_size: Optional[int] = None,
    index_kernel: str = "auto",  # inert: K3 on the card, its plain version on the CPU
    index_quantize: "bool | str" = False,  # True / "int8" = int8 rows, "int4" = nibbles
    threshold: float = 0.0,
) -> EvalResults:
    """Recall, precision, hit rate and MRR of the retriever at ``top_k`` over every query of the dataset
    (``dalm_tpu/eval/retriever.py:83-158``)."""
    model, tok = load_retriever_for_eval(retriever_name_or_path, retriever_peft_model_path, is_autoregressive,
                                         torch_dtype, tokenizer, device=device)
    processed = preprocess_eval_dataset(load_dataset(dataset_or_path), tok, query_column_name, passage_column_name,
                                        max_length)
    index, id_to_passage = embed_and_index(model, processed, passage_column_name, test_batch_size, embed_dim,
                                           index_quantize)
    results = search_and_score(model, processed, index, id_to_passage, passage_column_name,
                               query_batch_size or test_batch_size, top_k, threshold)
    logger.info("Retriever results: %s", results)
    return results
