"""Tokenise / map preprocessors (own copy of ``dalm_tpu/data/preprocess.py``).

Marker semantics kept exactly, including the doubled markers of the rag-e2e
causal text (``#query# #query# q #passage# #passage# p #answer# a``):
training and evaluation both see them. Outputs are fixed-length; the
un-padded prefix length ``query_passage_input_len`` marks where the answer
region starts for the marginalised loss.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence


def preprocess_rag_e2e_dataset(
    examples: Mapping[str, Sequence[str]],
    retriever_tokenizer: Any,
    generator_tokenizer: Any,
    query_column_name: str,
    passage_column_name: str,
    answer_column_name: str,
    query_max_len: int,
    passage_max_len: int,
    generator_max_len: int,
) -> Dict[str, Any]:
    queries = [f"#query# {q}" for q in examples[query_column_name]]
    passages = [f"#passage# {p}" for p in examples[passage_column_name]]
    answers = examples[answer_column_name]

    retriever_query_tokens = retriever_tokenizer(
        queries, padding="max_length", max_length=query_max_len, truncation=True)
    retriever_passage_tokens = retriever_tokenizer(
        passages, padding="max_length", max_length=passage_max_len, truncation=True)

    causal_input_text = [
        f"#query# {query} #passage# {passage} #answer# {answer}"
        for passage, query, answer in zip(passages, queries, answers)
    ]
    causal_input_tokens = generator_tokenizer(
        causal_input_text, padding="max_length", max_length=generator_max_len, truncation=True)

    query_passage_text = [f"#query# {query} #passage# {passage} #answer#" for passage, query in zip(passages, queries)]
    query_passage_tokens = generator_tokenizer(query_passage_text, padding=False)

    pre_batch: Dict[str, Any] = {}
    for k, v in retriever_query_tokens.items():
        pre_batch[f"retriever_query_{k}"] = v
    for k, v in retriever_passage_tokens.items():
        pre_batch[f"retriever_passage_{k}"] = v
    for k, v in causal_input_tokens.items():
        pre_batch[f"generator_input_{k}"] = v
    pre_batch["query_passage_input_len"] = [len(ids) for ids in query_passage_tokens["input_ids"]]
    return pre_batch
