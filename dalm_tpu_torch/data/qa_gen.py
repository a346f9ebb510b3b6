"""Synthetic question generation over passages, QA-gen (counterpart of
``dalm_tpu/data/qa_gen.py``).

One question per passage from an instruction-tuned LLM with a one-shot
example, a malformed-question filter, and a title-grouped 80/20 train / test
split (the reference's ``question_answer_generation.py``), in the JAX
package's order of operations on the port's ``ColumnDataset``:
``shuffle(seed=42)``, the first ``sample_size`` rows, the split by title,
generation in batches of ``batch_size`` within each split (train, then test),
then the filter.

- The title split is scikit-learn's ``train_test_split(sorted(titles),
  test_size=0.2, random_state=42)`` written in numpy: ``ceil(0.2 n)`` test
  titles, the first of ``RandomState(42).permutation(n)``; it raises where
  scikit-learn raises (one title leaves no train title).
- ``as_csv=True`` writes the bytes ``Dataset.to_csv`` writes. Where the JAX
  package needs ``datasets`` (``as_csv=False``, i.e. ``save_to_disk``; a saved
  dataset directory; a hub name) this raises ``NotImplementedError`` naming it.
- Generation goes through ``generate_fn``; without one, a
  ``TorchTextGenerator`` of ``model_spec`` on ``device`` (default the card).
"""

from __future__ import annotations

import logging
import math
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dalm_tpu_torch.data.backends import GenerateFn, TorchTextGenerator
from dalm_tpu_torch.data.loading import ColumnDataset, load_dataset

logger = logging.getLogger(__name__)

TEST_SIZE = 0.2
SPLIT_SEED = 42

_EXAMPLE_PASSAGE = (
    "Dense retrieval models encode queries and passages into a shared "
    "vector space and are trained with contrastive objectives so that a "
    "query lands near its relevant passages. In-batch negatives reuse the "
    "other passages in a training batch as negative examples, which makes "
    "large-batch training an effective way to sharpen the ranking."
)
_EXAMPLE_QUESTION = (
    "How do in-batch negatives contribute to training dense retrieval "
    "models, and why does batch size matter for ranking quality?"
)

PROMPT_TEMPLATE = (
    "Read the passage below and write exactly one question grounded in its "
    "content. Keep the question between 10 and 100 words. Output only the "
    "question itself: no labels such as 'Question:' or 'Answer:', no "
    "explanations, no line breaks.\n\n"
    "Example:\nPassage: {example_passage}\n{example_question}\n\n"
    "Now write a question for this passage:\n{passage}\n"
)

_NEEDS_DATASETS = "needs the 'datasets' package, which the port does not use"


def build_prompt(passage: str) -> str:
    return PROMPT_TEMPLATE.format(
        example_passage=_EXAMPLE_PASSAGE,
        example_question=_EXAMPLE_QUESTION,
        passage=passage,
    )


def generate_question_answer_pairs(examples, generate_fn: GenerateFn, passage_column_name: str):
    """Batch-map fn: one generated Question per passage; Answer left ""
    (the reference does the same — answers come from elsewhere)."""
    prompts = [build_prompt(p) for p in examples[passage_column_name]]
    responses = generate_fn(prompts)
    return {
        "Question": [r.strip().replace("\n", " ") for r in responses],
        "Answer": ["" for _ in responses],
    }


def filter_malformed_questions(record: dict) -> bool:
    """The reference's filter (`:153-166`)."""
    q = record["Question"]
    return (
        q is not None
        and q != ""
        and q != "-"
        and len(q.split()) >= 5
        and not q.startswith("<")
        and "instruction" not in q.lower()
        and "question" not in q.lower()
        and "answer" not in q.lower()
    )


def train_test_split(items: Sequence, test_size=TEST_SIZE, random_state: int = SPLIT_SEED) -> Tuple[List, List]:
    """scikit-learn's ``train_test_split(items, test_size=..., random_state=...)``
    (shuffled, no stratification): the test items are the first ``n_test`` of
    ``RandomState(random_state).permutation(n)``, the train items the rest."""
    n = len(items)
    if isinstance(test_size, float):
        if not 0 < test_size < 1:
            raise ValueError(f"test_size={test_size} should be either positive and smaller than the number of "
                             f"samples {n} or a float in the (0, 1) range")
        n_test = math.ceil(test_size * n)
    else:
        n_test = int(test_size)
        if not 0 < n_test < n:
            raise ValueError(f"test_size={test_size} should be either positive and smaller than the number of "
                             f"samples {n} or a float in the (0, 1) range")
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n}, test_size={test_size} and train_size=None, the resulting train set "
                         "will be empty. Adjust any of the aforementioned parameters.")
    perm = np.random.RandomState(random_state).permutation(n)
    return [items[i] for i in perm[n_test:]], [items[i] for i in perm[:n_test]]


def split_dataset(shuffled: ColumnDataset, title_column_name: str,
                  test_size: float = TEST_SIZE) -> Dict[str, ColumnDataset]:
    """Group split by unique title, 80/20, seed 42 (`:169-184`)."""
    train_titles, test_titles = train_test_split(sorted(set(shuffled[title_column_name])), test_size=test_size)
    train_titles, test_titles = set(train_titles), set(test_titles)
    return {
        "train": shuffled.filter(lambda ex: ex[title_column_name] in train_titles),
        "test": shuffled.filter(lambda ex: ex[title_column_name] in test_titles),
    }


def _map_batches(ds: ColumnDataset, fn, batch_size: int) -> ColumnDataset:
    """``Dataset.map(fn, batched=True, batch_size=...)``: ``fn`` on each batch of
    columns; the columns it returns replace their namesakes in place and the new
    ones follow. A dataset without rows is returned as it is."""
    if len(ds) == 0:
        return ds
    out: Dict[str, List] = {}
    for start in range(0, len(ds), batch_size):
        batch = ds.select(range(start, min(start + batch_size, len(ds))))
        for name, values in fn(batch.columns).items():
            out.setdefault(name, []).extend(values)
    return ColumnDataset({**ds.columns, **out})


def generate_qa_from_dataset(
    dataset: ColumnDataset,
    passage_column_name: str,
    title_column_name: str,
    sample_size: int,
    batch_size: int,
    max_input_tokens: int = 512,
    generate_fn: Optional[GenerateFn] = None,
    model_spec: str = "tiny",
    tokenizer: str = "byte",
    device=None,
) -> Dict[str, ColumnDataset]:
    """The reference's ``generate_qa_from_dataset`` (`:187-227`): ``{"train",
    "test"}`` splits of the rows whose generated question passes the filter."""
    if generate_fn is None:
        generate_fn = TorchTextGenerator(
            model_spec, tokenizer=tokenizer,
            max_input_tokens=max_input_tokens, batch_size=batch_size, device=device,
        )

    dataset = load_dataset(dataset).shuffle(seed=SPLIT_SEED)
    small = dataset.select(range(min(sample_size, len(dataset))))
    splits = split_dataset(small, title_column_name)
    logger.info("train split: %d rows, test split: %d rows", len(splits["train"]), len(splits["test"]))

    def qa_map(examples):
        return generate_question_answer_pairs(examples, generate_fn, passage_column_name)

    processed = {name: _map_batches(split, qa_map, batch_size) for name, split in splits.items()}
    filtered = {name: split.filter(filter_malformed_questions) for name, split in processed.items()}
    logger.info(
        "dropped malformed questions: train %d, test %d",
        len(processed["train"]) - len(filtered["train"]),
        len(processed["test"]) - len(filtered["test"]),
    )
    return filtered


def _load_dataset_from_path(dataset_path: str) -> ColumnDataset:
    """A CSV file (`:230-252`); a saved dataset directory or a hub name needs ``datasets``."""
    if dataset_path.endswith(".csv"):
        return load_dataset(dataset_path)
    if not os.path.splitext(dataset_path)[-1]:
        what = "a saved dataset directory" if os.path.isdir(dataset_path) else "a hub dataset name"
        raise NotImplementedError(f"{dataset_path!r}: {what} {_NEEDS_DATASETS}; give a .csv file")
    raise ValueError("dataset-path must be a csv, a saved dataset dir, or a hub name")


def generate_qa_from_disk(
    dataset_path: str,
    passage_column_name: str,
    title_column_name: str,
    sample_size: int,
    batch_size: int,
    output_dir: str,
    as_csv: bool,
    max_input_tokens: int = 512,
    generate_fn: Optional[GenerateFn] = None,
    model_spec: str = "tiny",
    tokenizer: str = "byte",
    device=None,
) -> None:
    """The reference's ``generate_qa_from_disk`` (`:255-276`): writes
    ``question_answer_pairs_{train,test}.csv`` into ``output_dir``."""
    if not as_csv:
        raise NotImplementedError(f"as_csv=False (a dataset saved by save_to_disk) {_NEEDS_DATASETS}; "
                                  "write CSV files with as_csv=True")
    dataset = _load_dataset_from_path(dataset_path)
    qa = generate_qa_from_dataset(
        dataset, passage_column_name, title_column_name, sample_size, batch_size,
        max_input_tokens, generate_fn=generate_fn, model_spec=model_spec, tokenizer=tokenizer, device=device,
    )
    out = Path(output_dir)
    out.mkdir(exist_ok=True, parents=True)
    for split_name, split_ds in qa.items():
        path = out / f"question_answer_pairs_{split_name}.csv"
        split_ds.to_csv(str(path))
        logger.info("saved split %s to %s", split_name, path)
