"""Shared eval machinery (counterpart of ``dalm_tpu/eval/common.py:23-178``).

Metric semantics, as in the reference:

- retrieval hits are deduplicated passage strings, so precision's
  denominator is the deduplicated retrieved set;
- recall is against the single gold passage, hence recall == hit rate;
- a score threshold filters hits (``score >= threshold``);
- averages divide by the total query count; MRR is 1 / the rank of the
  first gold match (0 on a miss).

Datasets are ``data/loading.py:ColumnDataset``s. ``embed_dataset`` returns
the embeddings as one float32 tensor on the embedding function's device and
embeds the last batch at its own size (the reference pads it to
``batch_size``; the real rows take the same computation).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from dalm_tpu_torch.data.loading import ColumnDataset
from dalm_tpu_torch.eval.results import EvalResults


def filter_unique_passages(dataset: ColumnDataset, passage_column_name: str) -> ColumnDataset:
    """The rows whose passage occurs for the first time: the first occurrence of each passage wins."""
    seen = set()
    keep = []
    for i, p in enumerate(dataset[passage_column_name]):
        if p not in seen:
            seen.add(p)
            keep.append(i)
    return dataset.select(keep)


def calculate_precision_recall(retrieved_items: Sequence[str], correct_items: Sequence[str]) -> Tuple[float, float]:
    """Set-based precision and recall."""
    retrieved_set = set(retrieved_items)
    correct_set = set(correct_items)
    correct_retrieved = len(retrieved_set & correct_set)
    return correct_retrieved / len(retrieved_set), correct_retrieved / len(correct_set)


def threshold_hits(scores: np.ndarray, ids: np.ndarray, id_to_passage: Dict[int, str],
                   threshold: float = 0.0) -> List[List[Tuple[str, float]]]:
    """(Q, k) search output → per query, [(passage, score)] for every score >= ``threshold``."""
    return [
        [(id_to_passage[int(i)], float(s)) for s, i in zip(scores[q], ids[q]) if s >= threshold]
        for q in range(scores.shape[0])
    ]


def embed_dataset(embed_fn: Callable, dataset: ColumnDataset, ids_column: str, mask_column: str,
                  batch_size: int, embed_dim: int) -> torch.Tensor:
    """(N, embed_dim) float32 embeddings of the dataset's rows, ``batch_size`` rows an ``embed_fn(ids, mask)``
    call, on the device ``embed_fn`` returns them on."""
    n = len(dataset)
    ids_all = np.asarray(dataset[ids_column], np.int64)
    mask_all = np.asarray(dataset[mask_column], np.int64)
    out = None
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        e = embed_fn(ids_all[start:end], mask_all[start:end])
        if out is None:
            out = torch.empty((n, embed_dim), dtype=torch.float32, device=e.device)
        out[start:end] = e
    return out if out is not None else torch.empty((0, embed_dim), dtype=torch.float32)


def aggregate_results(total_examples: int, precisions: List[float], recalls: List[float], total_hit: int,
                      reciprocal_ranks: "List[float] | None" = None) -> EvalResults:
    """Averages over ``total_examples`` queries, plus MRR when reciprocal ranks are given."""
    return EvalResults(
        total_examples=total_examples,
        recall=sum(recalls) / total_examples,
        precision=sum(precisions) / total_examples,
        hit_rate=total_hit / float(total_examples),
        mrr=(sum(reciprocal_ranks) / total_examples) if reciprocal_ranks else None,
    )


def score_batch(search_results: List[List[Tuple[str, float]]], correct_passages: Sequence[str]
                ) -> Tuple[List[float], List[float], int, List[str], List[float]]:
    """One batch's metrics: (precisions, recalls, hits, top-1 passages, reciprocal ranks). A query whose
    hits all fell below the threshold scores 0 / 0 (the reference would divide by zero)."""
    precisions, recalls, top_passages, rrs = [], [], [], []
    total_hit = 0
    for i, result in enumerate(search_results):
        retrieved = [p for p, _ in result]
        top_passages.append(retrieved[0] if retrieved else "")
        correct = [correct_passages[i]]
        p, r = calculate_precision_recall(retrieved, correct) if retrieved else (0.0, 0.0)
        precisions.append(p)
        recalls.append(r)
        total_hit += int(any(c in retrieved for c in correct))
        rr = 0.0
        for rank, passage in enumerate(retrieved, start=1):
            if passage in correct:
                rr = 1.0 / rank
                break
        rrs.append(rr)
    return precisions, recalls, total_hit, top_passages, rrs


def preprocess_eval_dataset(dataset: ColumnDataset, tokenizer, query_column_name: str, passage_column_name: str,
                            max_length: int) -> ColumnDataset:
    """Tokenised queries and passages (``retriever_query_*`` / ``retriever_passage_*`` columns, padded to
    ``max_length``), keeping the raw string columns that the metrics match on."""

    def _map(columns):
        out = dict(columns)
        for prefix, name in (("retriever_query_", query_column_name), ("retriever_passage_", passage_column_name)):
            toks = tokenizer(list(columns[name]), padding="max_length", max_length=max_length, truncation=True)
            for k, v in toks.items():
                out[prefix + k] = v
        return out

    return dataset.map(_map)
