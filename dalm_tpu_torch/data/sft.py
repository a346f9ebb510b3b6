"""Generator-SFT data utilities (the port's own copy of
``dalm_tpu/data/sft.py:25-169``; numpy only).

- ``format_chat``: chatml rendering of ``messages`` rows;
- ``create_datasets``: a local JSON / JSON-lines file of ``messages`` rows,
  split into train and validation rows with ``numpy.random.default_rng(seed)``;
- ``chars_token_ratio``: average characters per token over a 400-sample probe;
- ``pack_dataset``: token streams joined with EOS and cut into fixed
  ``seq_length`` blocks (TRL ``packing=True``);
- ``pad_dataset``: one sample per row, right-padded, with its mask.

Known difference from the reference: it reads ``datasets`` directories, the
hub and streams, and splits with ``train_test_split``. This package has no
``datasets`` dependency, so those sources raise ``NotImplementedError`` and
the split, though seeded and repeatable, puts other rows into validation than
the reference's does.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from dalm_tpu_torch.data.loading import load_dataset

logger = logging.getLogger(__name__)


def format_chat(messages: List[Dict[str, str]]) -> str:
    """Render a ``messages`` list as chatml."""
    parts = []
    for m in messages:
        parts.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
    return "".join(parts)


def prepare_sample_text(example: Dict[str, Any]) -> str:
    """Row → training text; malformed rows yield "" and are skipped."""
    try:
        return format_chat(example["messages"])
    except Exception:
        logger.exception("error preparing text; skipping example")
        return ""


def create_datasets(
    dataset_name: str,
    split: str = "train",
    validation_split: Optional[float] = 0.05,
    size_valid_set: Optional[int] = None,
    streaming: bool = False,
    shuffle_buffer: Optional[int] = None,
    num_workers: int = 4,
    local_dataset: bool = True,
    seed: int = 42,
) -> Tuple[List[dict], List[dict]]:
    """(train rows, validation rows) of a ``.json`` / ``.jsonl`` file whose rows
    hold ``messages``. ``seed`` fixes the split: a permutation of the rows, of
    which the first ``ceil(validation_split * n)`` (a float is a share, an int
    a count, as ``train_test_split`` reads ``test_size``) validate."""
    if streaming:
        raise NotImplementedError("streaming=True is not ported: datasets are local JSON / JSON-lines files")
    if not local_dataset:
        raise NotImplementedError("local_dataset=False (a hub dataset) is not ported")
    if os.path.isdir(dataset_name):
        raise NotImplementedError(f"{dataset_name!r}: a load_from_disk directory is not ported; "
                                  "give a .json or .jsonl file of messages rows")
    if not validation_split:
        raise ValueError("validation_split must be set when streaming is disabled")
    ds = load_dataset(dataset_name)
    rows = [{name: ds[name][i] for name in ds.column_names} for i in range(len(ds))]
    n = len(rows)
    n_valid = int(validation_split) if validation_split >= 1 else int(np.ceil(validation_split * n))
    if not 0 < n_valid < n:
        raise ValueError(f"validation_split={validation_split} leaves {n_valid} of {n} rows for validation")
    order = np.random.default_rng(seed).permutation(n)
    valid_data = [rows[i] for i in order[:n_valid]]
    train_data = [rows[i] for i in order[n_valid:]]
    logger.info("train set: %d rows, validation set: %d rows", len(train_data), len(valid_data))
    return train_data, valid_data


def chars_token_ratio(
    dataset,
    tokenizer,
    formatting_func: Callable[[Dict[str, Any]], str] = prepare_sample_text,
    sample_size: int = 400,
) -> float:
    total_chars, total_tokens = 0, 0
    for _, example in zip(range(sample_size), iter(dataset)):
        text = formatting_func(example)
        total_chars += len(text)
        total_tokens += len(tokenizer.encode_batch([text], padding=False)["input_ids"][0])
    return total_chars / max(total_tokens, 1)


def pack_dataset(
    dataset: Iterable[Dict[str, Any]],
    tokenizer,
    seq_length: int,
    formatting_func: Callable[[Dict[str, Any]], str] = prepare_sample_text,
    max_blocks: Optional[int] = None,
) -> np.ndarray:
    """Concatenate tokenized texts (EOS-joined) into (N, seq_length) blocks.
    The tail remainder shorter than ``seq_length`` is dropped."""
    eos = tokenizer.eos_token_id
    buf: List[int] = []
    blocks: List[List[int]] = []
    for example in dataset:
        text = formatting_func(example)
        if not text:
            continue
        ids = tokenizer.encode_batch([text], padding=False)["input_ids"][0]
        buf.extend(ids)
        if eos is not None:
            buf.append(eos)
        while len(buf) >= seq_length:
            blocks.append(buf[:seq_length])
            buf = buf[seq_length:]
            if max_blocks and len(blocks) >= max_blocks:
                return np.asarray(blocks, np.int32)
    return np.asarray(blocks, np.int32) if blocks else np.zeros((0, seq_length), np.int32)


def pad_dataset(
    dataset: Iterable[Dict[str, Any]],
    tokenizer,
    seq_length: int,
    formatting_func: Callable[[Dict[str, Any]], str] = prepare_sample_text,
    max_samples: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One sample per row: tokenized, EOS-terminated, truncated to
    ``seq_length`` and right-padded; the mask zeroes the pad region."""
    eos = tokenizer.eos_token_id
    pad = getattr(tokenizer, "pad_token_id", None)
    if pad is None:
        pad = eos if eos is not None else 0
    ids_rows: List[List[int]] = []
    mask_rows: List[List[int]] = []
    for example in dataset:
        text = formatting_func(example)
        if not text:
            continue
        ids = tokenizer.encode_batch([text], padding=False)["input_ids"][0]
        if eos is not None:
            ids = list(ids) + [eos]
        ids = list(ids)[:seq_length]
        n = len(ids)
        ids_rows.append(ids + [pad] * (seq_length - n))
        mask_rows.append([1] * n + [0] * (seq_length - n))
        if max_samples and len(ids_rows) >= max_samples:
            break
    if not ids_rows:
        return np.zeros((0, seq_length), np.int32), np.zeros((0, seq_length), np.int32)
    return np.asarray(ids_rows, np.int32), np.asarray(mask_rows, np.int32)
