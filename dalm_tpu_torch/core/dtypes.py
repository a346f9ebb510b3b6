"""dtype flags → ``torch.dtype`` (counterpart of ``dalm_tpu/core/dtypes.py``)."""

from __future__ import annotations

import torch

_TABLE = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
    "fp32": torch.float32,
}

DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16"}


def parse_dtype(name: "str | torch.dtype") -> torch.dtype:
    """Parse a dtype flag; a ``torch.dtype`` passes through."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _TABLE:
        raise ValueError(f"unknown dtype {name!r}; expected one of {sorted(_TABLE)}")
    return _TABLE[name]
