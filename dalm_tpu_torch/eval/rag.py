"""RAG evaluation: retrieval metrics plus the generator's exact match
(counterpart of ``dalm_tpu/eval/rag.py:53-195``).

- The retrieval half is ``evaluate_retriever``'s (the same index, search and
  metrics).
- For each query the TOP-1 retrieved passage (K3's first id) is formatted as
  ``#query# {q} #passage# {p} #answer# ``; the prompts are left-padded to
  ``max_length`` and decoded greedily with the KV cache
  (``models/generate.py:build_greedy_generate``) in batches of
  ``query_batch_size``, the last one padded with copies of its last prompt.
- Exact match: the prompt plus the generation is split on ``#answer#`` and
  segment [1], stripped, must equal the answer column.

Kept from the JAX package (its documented deviations from the reference):
deterministic order, so generated answers line up with the answer column;
the prompt capped at ``max_length`` and the generation at
``max_new_tokens``. Differences from the JAX package: ``torch_dtype`` sets
the generator's compute dtype too (the JAX package leaves it at the
config's); one device, so ``mesh`` is inert; ``index_kernel`` is inert.
"""

from __future__ import annotations

import logging
from typing import Optional, Union

import torch

from dalm_tpu_torch.core.dtypes import parse_dtype
from dalm_tpu_torch.data.loading import ColumnDataset, load_dataset
from dalm_tpu_torch.data.tokenizer import resolve_tokenizer
from dalm_tpu_torch.device import resolve_device
from dalm_tpu_torch.eval.common import preprocess_eval_dataset
from dalm_tpu_torch.eval.results import EvalResults
from dalm_tpu_torch.eval.retriever import embed_and_index, load_retriever_for_eval, search_and_score
from dalm_tpu_torch.models.decoder import Decoder
from dalm_tpu_torch.models.generate import build_greedy_generate
from dalm_tpu_torch.models.lora import load_adapter, merge_lora_inplace
from dalm_tpu_torch.models.registry import build_decoder, resolve_decoder

logger = logging.getLogger(__name__)


def load_generator_for_eval(generator_name_or_path: str, generator_peft_model_path: Optional[str] = None,
                            torch_dtype: Optional[str] = None, device=None, seed: int = 0) -> Decoder:
    """The generator on ``device``: a preset random-initialised from ``seed`` (0 here, as the reference's eval;
    ``RagPipeline.from_pretrained`` uses 1), or a saved directory's weights, with an adapter at
    ``generator_peft_model_path`` merged into its kernels."""
    dev = resolve_device(device)
    cfg, state = resolve_decoder(generator_name_or_path, dtype=parse_dtype(torch_dtype) if torch_dtype else None)
    generator = build_decoder(cfg, device=dev)
    if state is None:
        generator.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    else:
        generator.load_state_dict(state)
    if generator_peft_model_path:
        merge_lora_inplace(generator, *load_adapter(generator_peft_model_path))
    return generator.eval()


def rag_prompt(query: str, passage: str) -> str:
    return f"#query# {query} #passage# {passage} #answer# "


def evaluate_rag(
    dataset_or_path: Union[str, ColumnDataset, dict],
    retriever_name_or_path: str,
    generator_name_or_path: str,
    retriever_peft_model_path: Optional[str] = None,
    generator_peft_model_path: Optional[str] = None,
    passage_column_name: str = "Abstract",
    query_column_name: str = "Question",
    answer_column_name: str = "Answer",
    embed_dim: Optional[int] = None,
    max_length: int = 128,
    test_batch_size: int = 8,
    query_batch_size: int = 16,
    device=None,
    torch_dtype: str = "bfloat16",
    top_k: int = 10,
    evaluate_generator: bool = True,
    retriever_is_autoregressive: bool = False,
    retriever_tokenizer: str = "byte",
    generator_tokenizer: str = "byte",
    mesh=None,  # inert: one device
    max_new_tokens: int = 64,
    index_kernel: str = "auto",  # inert: K3 on the card, its plain version on the CPU
    index_quantize: "bool | str" = False,  # True / "int8" = int8 rows, "int4" = nibbles
    threshold: float = 0.0,
) -> EvalResults:
    """``evaluate_retriever``'s metrics over the dataset, plus ``exact_match`` with ``evaluate_generator``."""
    dev = resolve_device(device)
    retriever, r_tok = load_retriever_for_eval(retriever_name_or_path, retriever_peft_model_path,
                                               retriever_is_autoregressive, torch_dtype, retriever_tokenizer,
                                               device=dev)
    generator = load_generator_for_eval(generator_name_or_path, generator_peft_model_path, torch_dtype, dev)
    g_tok = resolve_tokenizer(generator_tokenizer)
    g_tok.padding_side = "left"

    processed = preprocess_eval_dataset(load_dataset(dataset_or_path), r_tok, query_column_name,
                                        passage_column_name, max_length)
    index, id_to_passage = embed_and_index(retriever, processed, passage_column_name, test_batch_size, embed_dim,
                                           index_quantize)
    generate = build_greedy_generate(generator, max_new_tokens, eos_token_id=g_tok.eos_token_id,
                                     pad_token_id=g_tok.pad_token_id or 0)

    raw_queries = processed[query_column_name]
    prompts_pending: list = []
    generated: list = []

    def flush_generation():
        if not prompts_pending:
            return
        batch_prompts = list(prompts_pending)
        prompts_pending.clear()
        real = len(batch_prompts)
        batch_prompts += [batch_prompts[-1]] * (query_batch_size - real)
        toks = g_tok(batch_prompts, padding="max_length", max_length=max_length, truncation=True)
        out = generate(torch.as_tensor(toks["input_ids"], dtype=torch.long, device=dev),
                       torch.as_tensor(toks["attention_mask"], dtype=torch.long, device=dev)).cpu().numpy()
        for i in range(real):
            generated.append(batch_prompts[i] + g_tok.decode(out[i], skip_special_tokens=True))

    def queue_prompts(start, end, top_passages):
        for q, passage in zip(raw_queries[start:end], top_passages):
            prompts_pending.append(rag_prompt(q, passage))
            if len(prompts_pending) >= query_batch_size:
                flush_generation()

    results = search_and_score(retriever, processed, index, id_to_passage, passage_column_name, test_batch_size,
                               top_k, threshold, queue_prompts if evaluate_generator else None)
    n = len(processed)
    if evaluate_generator:
        flush_generation()
        em_hits = 0
        for full_text, answer in zip(generated, processed[answer_column_name]):
            parts = full_text.split("#answer#")
            if len(parts) >= 2 and parts[1].strip() == answer:
                em_hits += 1
        results = results.model_copy(update={"exact_match": em_hits / n})
        logger.info("Generator exact match: %.5f", em_hits / n)
    logger.info("RAG eval results: %s", results)
    return results
