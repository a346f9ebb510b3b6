"""Reading-comprehension generation utilities (the port's own copy of
``dalm_tpu/data/rc_utils.py``).

File / CSV input iteration, token-budget chunking (on the port's
``ByteTokenizer.encode_batch(padding=False)``), domain tokenizer creation
(re-exported from ``data/spm.py``), and the state machine that turns an LLM's
QUESTION / ANSWER text into a chat conversation.
"""

from __future__ import annotations

import csv
import logging
import os
import re
from typing import Dict, Iterator, List, Optional, Tuple

from dalm_tpu_torch.data.segmentation import split_to_sentences  # noqa: F401  (re-export)
from dalm_tpu_torch.data.spm import (  # noqa: F401  (re-exports)
    create_domain_tokenizer,
    create_domain_tokenizer_from_files,
)

logger = logging.getLogger(__name__)


# ---- input iteration (`utils.py:14-58`) ----------------------------------

def input_generator(
    directory_or_file: str,
    csv_column: Optional[str] = None,
    title_column: Optional[str] = None,
) -> Iterator[Tuple]:
    """Yield (name, text) from a file, CSV column, or directory of files.

    With ``title_column`` set, yields (name, text, title) — title is the
    CSV row's title cell (None for plain files), feeding the RC
    generator's title template bank.
    """
    if os.path.isfile(directory_or_file):
        if directory_or_file.endswith(".csv") and csv_column:
            yield from _iter_csv(directory_or_file, csv_column, title_column)
        elif not csv_column:
            yield from _iter_plain(directory_or_file, title_column)
        else:
            raise ValueError("CSV column specified for non-CSV file")
    elif os.path.isdir(directory_or_file):
        for name in sorted(os.listdir(directory_or_file)):
            path = os.path.join(directory_or_file, name)
            if path.endswith(".csv") and csv_column:
                yield from _iter_csv(path, csv_column, title_column)
            elif not path.endswith(".csv"):
                yield from _iter_plain(path, title_column)
    else:
        raise ValueError("The input should be a directory or a file.")


def _iter_csv(path: str, column: str, title_column: Optional[str] = None) -> Iterator[Tuple]:
    with open(path, newline="", encoding="utf-8") as f:
        for index, row in enumerate(csv.DictReader(f)):
            name = os.path.basename(path) + str(index)
            if title_column is not None:
                yield name, row[column], row.get(title_column)
            else:
                yield name, row[column]


def _iter_plain(path: str, title_column: Optional[str] = None) -> Iterator[Tuple]:
    with open(path, encoding="utf-8", errors="replace") as f:
        if title_column is not None:
            yield os.path.basename(path), f.read(), None
        else:
            yield os.path.basename(path), f.read()


# ---- chunking (`utils.py:61-67`) ------------------------------------------

def text_chunker(text: str, tokenizer, chunk_size: int) -> Iterator[str]:
    """Token-budget chunking: encode once, decode ``chunk_size`` windows."""
    ids = tokenizer.encode_batch([text], padding=False)["input_ids"][0]
    for i in range(0, len(ids), chunk_size):
        yield tokenizer.decode(ids[i : i + chunk_size], skip_special_tokens=True)


# ---- QA extraction state machine (`utils.py:155-329`) ----------------------

_EXTRACT_RE_TEMPLATE = r".*\[?{kind}[:\]]*(?:.*?\])?\s*(.*)"
_TASK_RE = re.compile(r"^\*?\*?task\s*\d*")


def extract_question_or_answer(text: str, extract_type: str = "question") -> Tuple[bool, str]:
    """Line → (found, captured text). Handles 'QUESTION: ...', numbered
    '1. Question: ...', and bracketed '[question type: ...] ...' forms."""
    match = re.match(_EXTRACT_RE_TEMPLATE.format(kind=extract_type), text, re.IGNORECASE)
    captured = match.group(1) if match else ""
    return bool(captured), captured


def extract_question(text: str) -> Tuple[bool, str]:
    return extract_question_or_answer(text, "question")


def extract_answer(text: str) -> Tuple[bool, str]:
    return extract_question_or_answer(text, "answer")


def _raw_question_and_answer_extractor(whole_text: str) -> List[Dict[str, str]]:
    """Two-state line scanner: wait-for-question → wait-for-answer."""
    qa_pairs: List[Dict[str, str]] = []
    pending: Dict[str, str] = {}
    waiting_for_answer = False

    for raw_line in whole_text.split("\n"):
        line = raw_line.strip().lower()
        if not line:
            continue
        if _TASK_RE.match(line):
            logger.warning("found a task line: %s", line)

        if not waiting_for_answer:
            found, question = extract_question(line)
            if found:
                pending = {"question": question, "answer": "TBD"}
                waiting_for_answer = True
        else:
            found, answer = extract_answer(line)
            if found:
                pending["answer"] = answer
                if pending["question"] and pending["answer"]:
                    qa_pairs.append(pending)
                else:
                    logger.warning("empty question or answer in %s; skipping", pending)
            else:
                logger.warning("question with no answer: %s; skipping", pending)
            waiting_for_answer = False
    return qa_pairs


def wrap_context_with_rag_instruction(context: str) -> str:
    return f"Based on the following text: \n {context}, \n I'd like you to answer a few questions\n"


def convert_qa_pairs_to_chat_completions(qa_pairs: List[Dict[str, str]]) -> List[Dict[str, str]]:
    completions: List[Dict[str, str]] = []
    for pair in qa_pairs:
        completions.append({"content": pair["question"], "role": "user"})
        completions.append({"content": pair["answer"], "role": "assistant"})
    return completions


def question_and_answer_extractor(whole_text: str, context: str) -> Optional[List[Dict[str, str]]]:
    """LLM output + source context → chatml conversation, or None if no QA
    pairs were extractable (`utils.py:290-329`)."""
    qa_pairs = _raw_question_and_answer_extractor(whole_text)
    if not qa_pairs:
        logger.warning("no QA pairs extracted from generation")
        return None
    conversation = [{"content": wrap_context_with_rag_instruction(context), "role": "user"}]
    conversation.extend(convert_qa_pairs_to_chat_completions(qa_pairs))
    return conversation
