"""Rule-based sentence segmentation (the port's own copy of
``dalm_tpu/data/segmentation.py``).

The reference segments chunk text with pysbd before mining completion tasks;
this is a compact English segmenter: terminal punctuation splitting with
guards for common abbreviations, initials, decimals and ellipses, enough for
the reading-comprehension miners, which need plausible sentence units.
"""

from __future__ import annotations

import re
from typing import List

_ABBREVIATIONS = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc", "inc",
    "ltd", "co", "corp", "dept", "est", "fig", "figs", "eq", "eqs", "no",
    "nos", "vol", "vols", "al", "e.g", "i.e", "cf", "ca", "approx", "dept",
    "univ", "assn", "bros", "ph.d", "u.s", "u.k", "a.m", "p.m",
}

_BOUNDARY = re.compile(r"([.!?]+)(\s+|$)")


def _is_abbreviation(prefix: str) -> bool:
    last = prefix.rsplit(" ", 1)[-1].rstrip(".").lower()
    if last in _ABBREVIATIONS:
        return True
    # single-letter initial ("J. Smith") or dotted acronym ("U.S.")
    if re.fullmatch(r"[a-z]", last) or re.fullmatch(r"(?:[a-z]\.)+[a-z]?", last):
        return True
    return False


def segment(text: str) -> List[str]:
    """Split text into sentences; whitespace between sentences is dropped,
    punctuation retained."""
    sentences: List[str] = []
    start = 0
    for m in _BOUNDARY.finditer(text):
        end = m.end(1)
        candidate = text[start:end]
        # decimal number like "3.14" — the char after '.' is a digit, so
        # _BOUNDARY (which requires whitespace/EOS) never matched; but a
        # sentence ending in digits can still be legit. Only guard
        # abbreviations / initials here.
        if _is_abbreviation(candidate):
            continue
        stripped = candidate.strip()
        if stripped:
            sentences.append(stripped)
        start = m.end()
    tail = text[start:].strip()
    if tail:
        sentences.append(tail)
    return sentences


def split_to_sentences(text: str) -> List[str]:
    """Coarse splitter used for tokenizer-training lines (`utils.py:121-124`)."""
    return re.split(r"[.?!]\s+", text)
