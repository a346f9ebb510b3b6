"""Subword piece vocabularies for domain-keyword mining (the port's own copy
of ``dalm_tpu/data/spm.py``).

Two roles of the reference's sentencepiece use:

1. train a *domain* unigram tokenizer on raw domain text (vocab 32000,
   backing off when the corpus is too small): ``UnigramPieceTokenizer.train``
   runs the Hugging Face ``tokenizers`` crate's Unigram trainer behind a
   Metaspace pre-tokenizer, so pieces carry the same "▁" word-boundary marker;
2. diff its vocabulary against a *general* one to pick domain keywords
   (pieces starting with "▁", longer than 10 characters): ``read_spm_vocab``
   walks a sentencepiece ``.model`` / ``.spm`` file's protobuf wire format in
   pure Python, no protobuf runtime.

``tokenizers`` is imported only by ``UnigramPieceTokenizer.train`` and by a
``.json`` vocabulary in ``load_piece_vocab``; where it is not installed they
raise ``ImportError`` naming it, and nothing falls back to another tokenizer.
"""

from __future__ import annotations

import logging
from typing import Iterable, List, Optional, Sequence

logger = logging.getLogger(__name__)

WORD_BOUNDARY = "▁"  # ▁


def _tokenizers(*names):
    """Attributes of the ``tokenizers`` package, or ``ImportError`` naming it."""
    try:
        import tokenizers
    except ImportError as e:
        raise ImportError("training or loading a unigram piece tokenizer needs the 'tokenizers' package, which is "
                          "not installed; a sentencepiece .model / .spm vocabulary is read without it") from e
    return tuple(getattr(tokenizers, n) for n in names)


class PieceVocab:
    """A piece vocabulary (possibly without an encoder) for keyword diffs."""

    def __init__(self, pieces: Sequence[str]):
        self._pieces = list(pieces)

    def pieces(self) -> List[str]:
        return self._pieces

    def __len__(self) -> int:
        return len(self._pieces)


class UnigramPieceTokenizer(PieceVocab):
    """Trained unigram tokenizer with encode/decode (domain tokenizer)."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        super().__init__(
            [p for p, _ in sorted(tokenizer.get_vocab().items(), key=lambda kv: kv[1])]
        )

    @classmethod
    def train(
        cls,
        files: Optional[Sequence[str]] = None,
        iterator: Optional[Iterable[str]] = None,
        vocab_size: int = 32000,
    ) -> "UnigramPieceTokenizer":
        """Train with vocab-size back-off (reference retry loop,
        `utils.py:98-115` — sentencepiece raises when the corpus can't
        fill the vocab; the tokenizers crate needs the same treatment)."""
        Tokenizer, models, pre_tokenizers, trainers = _tokenizers("Tokenizer", "models", "pre_tokenizers", "trainers")

        lines: Optional[List[str]] = None
        if iterator is not None:
            lines = list(iterator)

        size = vocab_size
        while True:
            tok = Tokenizer(models.Unigram())
            tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement=WORD_BOUNDARY)
            trainer = trainers.UnigramTrainer(
                vocab_size=size, special_tokens=["<unk>"], unk_token="<unk>"
            )
            try:
                if lines is not None:
                    tok.train_from_iterator(lines, trainer)
                else:
                    tok.train(list(files or []), trainer)
            except Exception as e:  # pragma: no cover - trainer variance
                logger.warning("unigram training failed at vocab %d: %s", size, e)
                if size <= 64:
                    raise
                size //= 2
                continue
            got = tok.get_vocab_size()
            if got < 16 and size > 64:
                size //= 2
                continue
            return cls(tok)

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(text).ids

    def decode(self, ids: Sequence[int]) -> str:
        # Metaspace decode: join pieces, restore spaces from ▁ markers.
        pieces = [self._pieces[i] for i in ids if 0 <= i < len(self._pieces)]
        return "".join(pieces).replace(WORD_BOUNDARY, " ").strip()


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def read_spm_vocab(path: str) -> PieceVocab:
    """Extract piece strings from a sentencepiece ``.spm`` model file.

    The model is a protobuf ``ModelProto`` whose field 1 is a repeated
    ``SentencePiece`` message with field 1 = piece (string). Only the
    wire format is walked — no protobuf runtime or schema needed.
    """
    with open(path, "rb") as f:
        buf = f.read()
    pieces: List[str] = []
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # repeated SentencePiece
            length, pos = _read_varint(buf, pos)
            sub = buf[pos : pos + length]
            pos += length
            spos = 0
            while spos < len(sub):
                stag, spos = _read_varint(sub, spos)
                sfield, swire = stag >> 3, stag & 7
                if sfield == 1 and swire == 2:  # piece string
                    slen, spos = _read_varint(sub, spos)
                    pieces.append(sub[spos : spos + slen].decode("utf-8", "replace"))
                    spos += slen
                elif swire == 2:
                    slen, spos = _read_varint(sub, spos)
                    spos += slen
                elif swire == 0:
                    _, spos = _read_varint(sub, spos)
                elif swire == 5:
                    spos += 4
                elif swire == 1:
                    spos += 8
                else:
                    break
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            pos += length
        elif wire == 0:
            _, pos = _read_varint(buf, pos)
        elif wire == 5:
            pos += 4
        elif wire == 1:
            pos += 8
        else:
            break
    return PieceVocab(pieces)


def load_piece_vocab(path_or_tokenizer) -> PieceVocab:
    """Accepts a PieceVocab, a ``.spm`` path, or a tokenizers-json path."""
    if isinstance(path_or_tokenizer, PieceVocab):
        return path_or_tokenizer
    if isinstance(path_or_tokenizer, str):
        if path_or_tokenizer.endswith((".model", ".spm")):
            return read_spm_vocab(path_or_tokenizer)
        if path_or_tokenizer.endswith(".json"):
            (Tokenizer,) = _tokenizers("Tokenizer")
            return UnigramPieceTokenizer(Tokenizer.from_file(path_or_tokenizer))
    raise ValueError(f"cannot load piece vocab from {path_or_tokenizer!r}")


def domain_keywords(
    general: PieceVocab, domain: PieceVocab, min_len: int = 10
) -> set[str]:
    """Domain-specific word-initial pieces (`regex_based.py:131-139`):
    pieces in the domain vocab but not the general one, starting with the
    word boundary marker and longer than ``min_len``."""
    general_set = set(general.pieces())
    specific = set(domain.pieces()) - general_set
    return {p for p in specific if p.startswith(WORD_BOUNDARY) and len(p) > min_len}


def create_domain_tokenizer(text_file: str, vocab_size: int = 32000) -> UnigramPieceTokenizer:
    """The reference's ``create_domain_tokenizer``: a unigram tokenizer trained on one text file."""
    return UnigramPieceTokenizer.train(files=[text_file], vocab_size=vocab_size)


def create_domain_tokenizer_from_files(
    directory_or_file: str, csv_column: Optional[str], vocab_size: int = 32000
) -> UnigramPieceTokenizer:
    """The reference's ``create_domain_tokenizer_from_files``, with sentences
    from every document (not only the last) feeding the trainer."""
    from dalm_tpu_torch.data.rc_utils import input_generator, split_to_sentences

    def sentence_iter():
        for _, text in input_generator(directory_or_file, csv_column):
            for sentence in split_to_sentences(text):
                sentence = sentence.strip()
                if sentence:
                    yield sentence

    return UnigramPieceTokenizer.train(iterator=sentence_iter(), vocab_size=vocab_size)
