"""Model resolution + save/load (counterpart of ``dalm_tpu/models/registry.py``).

A model spec is a preset name (random init by the caller) or a directory
written by :func:`save_pretrained`: ``config.json`` in the reference's
schema (``__class__`` + dataclass fields, ``registry.py:74-100``) plus a
``torch.save`` state dict, ``state_dict.pt``. Reading the reference's
``params.msgpack`` and HF checkpoints waits for a later slice.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import torch

from dalm_tpu_torch.core.dtypes import DTYPE_NAMES, parse_dtype
from dalm_tpu_torch.models.decoder import DecoderConfig, check_unported
from dalm_tpu_torch.models.encoder import EncoderConfig

STATE_FILE = "state_dict.pt"

ENCODER_PRESETS = {
    "tiny": EncoderConfig.tiny,
    "bge-small": EncoderConfig.bge_small,
    "bge-large": EncoderConfig.bge_large,
}

DECODER_PRESETS = {
    "tiny": DecoderConfig.tiny,
    "tiny-decoder": DecoderConfig.tiny,
    "llama2-7b": DecoderConfig.llama2_7b,
}

_CLASSES = {"EncoderConfig": EncoderConfig, "DecoderConfig": DecoderConfig}


def config_to_json(cfg) -> dict:
    out = {"__class__": type(cfg).__name__}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = DTYPE_NAMES[v] if f.name in ("dtype", "param_dtype") else v
    return out


def config_from_json(d: dict):
    d = dict(d)
    cls_name = d.pop("__class__")
    if cls_name not in _CLASSES:
        raise NotImplementedError(f"config class {cls_name!r} is not ported yet")
    cls = _CLASSES[cls_name]
    if cls is DecoderConfig:
        check_unported(d)
    names = {f.name for f in dataclasses.fields(cls)}
    d = {k: v for k, v in d.items() if k in names}  # drop metadata and inert knobs
    for k in ("dtype", "param_dtype"):
        if k in d:
            d[k] = parse_dtype(d[k])
    return cls(**d)


def save_pretrained(output_dir: str, config, state_dict: dict, extra: Optional[dict] = None) -> None:
    """Write ``config.json`` + ``state_dict.pt`` (tensors moved to the CPU)."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump({**config_to_json(config), **(extra or {})}, f, indent=2)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, os.path.join(output_dir, STATE_FILE))


def load_pretrained(path: str) -> Tuple[object, dict]:
    """Read a :func:`save_pretrained` dir → (config, CPU state dict)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_json(json.load(f))
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    return cfg, state


def _resolve(spec: str, presets: dict, kind: str, dtype, vocab_size):
    if spec in presets:
        cfg, state = presets[spec](), None
        if vocab_size is not None:
            cfg = dataclasses.replace(cfg, vocab_size=vocab_size)
    elif os.path.isdir(spec) and os.path.exists(os.path.join(spec, STATE_FILE)):
        cfg, state = load_pretrained(spec)
    elif os.path.isdir(spec):
        raise NotImplementedError(
            f"{spec!r}: only state_dict.pt artifacts are read; params.msgpack and HF checkpoints wait"
        )
    else:
        raise ValueError(f"unknown {kind} spec {spec!r}")
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=parse_dtype(dtype))
    return cfg, state


def resolve_encoder(spec: str, dtype=None, vocab_size: Optional[int] = None):
    """Model spec → (config, state-dict-or-None). None = caller random-inits."""
    cfg, state = _resolve(spec, ENCODER_PRESETS, "encoder", dtype, vocab_size)
    if not isinstance(cfg, EncoderConfig):
        raise ValueError(f"{spec!r} holds a {type(cfg).__name__}, not an EncoderConfig")
    return cfg, state


def resolve_decoder(spec: str, dtype=None, vocab_size: Optional[int] = None):
    cfg, state = _resolve(spec, DECODER_PRESETS, "decoder", dtype, vocab_size)
    if not isinstance(cfg, DecoderConfig):
        raise ValueError(f"{spec!r} holds a {type(cfg).__name__}, not a DecoderConfig")
    return cfg, state
