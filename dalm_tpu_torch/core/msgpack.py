"""A reader for flax's ``params.msgpack`` in pure Python (the files ``dalm_tpu/models/registry.py:save_pretrained``
writes with ``flax.serialization.msgpack_serialize``).

Decodes the MessagePack types that writer emits (nil, booleans, integers, floats, str, bin, arrays, maps and ext)
and flax's extensions on top: ext 1 is an ndarray, itself a packed ``(shape, dtype name, C-order bytes)`` triple;
ext 3 a numpy scalar in the same form; ext 2 a complex ``(real, imag)`` pair; and a map marked
``__msgpack_chunked_array__`` an array too large for one leaf, split into flat chunks. Arrays come back as numpy
arrays viewing the file's bytes (read-only), except bfloat16, which numpy has no type for: those come back as
``torch.bfloat16`` tensors. Nothing here needs the ``msgpack`` or ``flax`` packages.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.at = 0

    def take(self, n: int) -> memoryview:
        if self.at + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.at:self.at + n]
        self.at += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        lengths = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= b <= 0xC6:  # bin 8 / 16 / 32
            return self.take(self.unpack(lengths[b - 0xC4]))
        if 0xD9 <= b <= 0xDB:  # str 8 / 16 / 32
            return str(self.take(self.unpack(lengths[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        if 0xC7 <= b <= 0xC9:  # ext 8 / 16 / 32
            n = self.unpack(lengths[b - 0xC7])
            return _ext(self.unpack(">b"), self.take(n))
        if 0xD4 <= b <= 0xD8:  # fixext 1 / 2 / 4 / 8 / 16
            code = self.unpack(">b")
            return _ext(code, self.take(1 << (b - 0xD4)))
        raise ValueError(f"byte 0x{b:02x} starts no msgpack object")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _array(shape, dtype_name: str, buf: memoryview):
    if dtype_name == "bfloat16":
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).reshape(tuple(shape))
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(tuple(shape))


def _ext(code: int, payload: memoryview):
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, dtype_name, buf = unpackb(payload)
        arr = _array(shape, dtype_name, buf)
        return arr if code == _EXT_NDARRAY else arr[()]
    if code == _EXT_COMPLEX:
        real, imag = unpackb(payload)
        return complex(real, imag)
    raise ValueError(f"msgpack extension type {code} is not one flax writes")


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data) -> Any:
    """One msgpack object from ``data`` (bytes or a memoryview), which it must use up."""
    r = _Reader(data)
    out = r.value()
    if r.at != len(r.data):
        raise ValueError(f"{len(r.data) - r.at} bytes after the msgpack object")
    return out


def restore(data) -> Any:
    """``flax.serialization.msgpack_restore``: the tree of ``data``, chunked arrays joined."""
    return _unchunk(unpackb(data))


def load(path: str) -> Any:
    """The tree of a ``params.msgpack`` file."""
    with open(path, "rb") as f:
        return restore(f.read())
