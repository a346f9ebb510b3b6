"""Byte-level tokenizer (the port's own copy of ``dalm_tpu/data/tokenizer.py``'s
``ByteTokenizer``; the HF adapter waits for a later slice).

Protocol: ``encode_batch(texts, max_length, padding, truncation) ->
{"input_ids", "attention_mask"}``, ``__call__`` and ``decode``.
"""

from __future__ import annotations

from typing import Iterable, Sequence


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: ids 0..255 = bytes, then specials.

    pad=256, bos=257, eos=258 → vocab_size 259.
    """

    PAD, BOS, EOS = 256, 257, 258

    def __init__(self, add_eos_token: bool = False, vocab_pad: int | None = None):
        self.add_eos_token = add_eos_token
        self.pad_token_id = self.PAD
        self.bos_token_id = self.BOS
        self.eos_token_id = self.EOS
        self.padding_side = "right"
        # Reported vocab size for a full-size model fed byte ids: the
        # extra embedding/LM-head rows are simply unused.
        self._vocab_pad = vocab_pad

    @property
    def vocab_size(self) -> int:
        return max(259, self._vocab_pad or 0)

    def encode(self, text: str) -> list[int]:
        ids = list(text.encode("utf-8"))
        if self.add_eos_token:
            ids.append(self.EOS)
        return ids

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        # Specials have no byte form; they are always dropped from text.
        data = bytes(int(i) for i in ids if i < 256)
        return data.decode("utf-8", errors="replace")

    def encode_batch(
        self,
        texts: Sequence[str],
        max_length: int | None = None,
        padding: str | bool = "max_length",
        truncation: bool = True,
    ) -> dict:
        encoded = [self.encode(t) for t in texts]
        if truncation and max_length is not None:
            encoded = [e[:max_length] for e in encoded]
        if padding == "max_length" and max_length is not None:
            width = max_length
        elif padding in (True, "longest"):
            width = max(len(e) for e in encoded) if encoded else 0
        else:
            return {
                "input_ids": encoded,
                "attention_mask": [[1] * len(e) for e in encoded],
            }
        ids, mask = [], []
        for e in encoded:
            pad = width - len(e)
            if self.padding_side == "left":
                ids.append([self.pad_token_id] * pad + e)
                mask.append([0] * pad + [1] * len(e))
            else:
                ids.append(e + [self.pad_token_id] * pad)
                mask.append([1] * len(e) + [0] * pad)
        return {"input_ids": ids, "attention_mask": mask}

    def __call__(self, texts, padding="max_length", max_length=None, truncation=True):
        if isinstance(texts, str):
            texts = [texts]
        return self.encode_batch(texts, max_length=max_length, padding=padding, truncation=truncation)


def resolve_tokenizer(name: str, add_eos_token: bool = False) -> ByteTokenizer:
    """"byte" (or "byte@N" with a padded vocab) → ByteTokenizer. HF
    tokenizers are not ported yet and raise."""
    if name in ("byte", "bytes", "byte-level"):
        return ByteTokenizer(add_eos_token=add_eos_token)
    if name.startswith("byte@"):
        return ByteTokenizer(add_eos_token=add_eos_token, vocab_pad=int(name[5:]))
    raise NotImplementedError(f"tokenizer {name!r}: only the byte tokenizer is ported")
