"""Document → passage chunking (counterpart of ``dalm_tpu/data/docs_to_passage.py``).

Split each document at every ``max_words``-th space (default 100), drop
passages under ``min_words`` (default 5), cap at ``max_docs`` documents
(the reference's constant is 500k), on the port's ``ColumnDataset``.

Known differences from the JAX package: the ``max_docs`` sample is drawn from
an unseeded ``numpy.random.default_rng()`` (the JAX package's
``train_test_split`` is unseeded too, so neither run repeats); ``main_to_csv``
reads a ``.csv`` / ``.json`` / ``.jsonl`` file, where the JAX package reads a
``datasets`` directory.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from dalm_tpu_torch.data.loading import ColumnDataset, load_dataset

DEFAULT_MAX_WORDS = 100
DEFAULT_MIN_WORDS = 5
MAX_NUM_DOCUMENTS = 500_000
TITLE_COL = "title"
TEXT_COL = "text"


def split_text(text: str, n: int = DEFAULT_MAX_WORDS, character: str = " ") -> List[str]:
    """Every n-th occurrence of ``character`` (`utils.py:9-12`)."""
    pieces = text.split(character)
    return [character.join(pieces[i : i + n]).strip() for i in range(0, len(pieces), n)]


def split_documents(documents: dict, max_words: int = DEFAULT_MAX_WORDS) -> dict:
    titles, texts = [], []
    for title, text in zip(documents[TITLE_COL], documents[TEXT_COL]):
        if text is None:
            continue
        for passage in split_text(text, n=max_words):
            titles.append(title if title is not None else "")
            texts.append(passage)
    return {TITLE_COL: titles, TEXT_COL: texts}


def keep_sufficiently_long_passages(example: dict, min_words: int = DEFAULT_MIN_WORDS) -> bool:
    return len(example[TEXT_COL].split()) >= min_words


def docs_to_passages(
    df,
    max_words: int = DEFAULT_MAX_WORDS,
    title_col: str = TITLE_COL,
    text_col: str = TEXT_COL,
    max_docs: Optional[int] = None,
) -> ColumnDataset:
    """The reference's ``docs_to_passages`` (`main.py:26-71`) over a
    ``ColumnDataset``, a mapping of columns or a file ``load_dataset`` reads:
    ``title`` / ``text`` columns of the passages."""
    dataset = load_dataset(df)
    if title_col not in dataset.column_names or text_col not in dataset.column_names:
        raise AssertionError(
            f"{title_col} and {text_col} must be present; pass title_col/text_col"
        )
    dataset = ColumnDataset({TITLE_COL: dataset[title_col], TEXT_COL: dataset[text_col]})

    if max_docs is not None and len(dataset) > max_docs:
        dataset = dataset.select(np.random.default_rng().permutation(len(dataset))[:max_docs].tolist())

    return dataset.map(lambda cols: split_documents(cols, max_words=max_words)).filter(
        keep_sufficiently_long_passages)


def main_to_csv(dataset_path: str, title_col=TITLE_COL, text_col=TEXT_COL, output_dir=".",
                max_words=DEFAULT_MAX_WORDS, max_docs=None) -> str:
    """``passages.csv`` in ``output_dir``, the bytes ``Dataset.to_csv`` writes."""
    passages = docs_to_passages(load_dataset(dataset_path), max_words, title_col, text_col, max_docs)
    out = os.path.join(output_dir, "passages.csv")
    passages.to_csv(out)
    return out
