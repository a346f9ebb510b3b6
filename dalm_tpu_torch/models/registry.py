"""Model resolution + save/load (counterpart of ``dalm_tpu/models/registry.py``).

A model spec is a preset name (random init by the caller) or a directory:

- written by the port's :func:`save_pretrained`: ``config.json`` in the reference's schema (``__class__`` +
  dataclass fields, ``registry.py:74-100``) plus a ``torch.save`` state dict, ``state_dict.pt``. A saved int8
  base (a layer's ``q`` + ``scale`` leaves, what the merge runtime with ``use_bnb`` saves) resolves to the
  dequantised ``kernel = q * scale`` in f32, as the reference's ``dequantize_params`` forms it;
- written by the reference's ``save_pretrained``: ``config.json`` + flax's ``params.msgpack``, read by the port's
  own reader (``core/msgpack.py``); an int8 node (``{"__int8__": q, "scale": s}``) resolves the same way;
- a Hugging Face checkpoint (``config.json`` + ``model.safetensors`` or ``pytorch_model.bin``), read by
  ``models/hf_loader.py``: the decoder families by ``model_type`` (``registry.py:156-183``; ``gpt2`` through
  ``models/gpt2.py:load_hf_gpt2``), BERT encoders.

A decoder config is a ``DecoderConfig`` or a ``GPT2Config``; :func:`build_decoder` makes the module of either.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import torch

from dalm_tpu_torch.core.dtypes import DTYPE_NAMES, parse_dtype
from dalm_tpu_torch.core.tree import flatten
from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig, check_unported
from dalm_tpu_torch.models.encoder import EncoderConfig
from dalm_tpu_torch.models.gpt2 import GPT2Config, GPT2Decoder, is_hf_gpt2, load_hf_gpt2

STATE_FILE = "state_dict.pt"
MSGPACK_FILE = "params.msgpack"
HF_FILES = ("model.safetensors", "pytorch_model.bin")

ENCODER_PRESETS = {
    "tiny": EncoderConfig.tiny,
    "bge-small": EncoderConfig.bge_small,
    "bge-large": EncoderConfig.bge_large,
}

DECODER_PRESETS = {
    "tiny": DecoderConfig.tiny,
    "tiny-decoder": DecoderConfig.tiny,
    "llama2-7b": DecoderConfig.llama2_7b,
    "llama3-8b": DecoderConfig.llama3_8b,
    "llama2-13b": DecoderConfig.llama2_13b,
    "mistral-7b": DecoderConfig.mistral_7b,
    "qwen2.5-7b": DecoderConfig.qwen25_7b,
    "qwen3-8b": DecoderConfig.qwen3_8b,
    "llama3.1-8b": DecoderConfig.llama31_8b,
    "phi3-mini": DecoderConfig.phi3_mini,
    "gemma-2b": DecoderConfig.gemma_2b,
    "gemma2-2b": DecoderConfig.gemma2_2b,
    "gemma3-1b": DecoderConfig.gemma3_1b,
    "mixtral-8x7b": DecoderConfig.mixtral_8x7b,
    "mixtral-mini-4b": DecoderConfig.mixtral_mini_4b,
    "qwen3-moe-30b": DecoderConfig.qwen3_moe_30b,
    "tiny-moe": DecoderConfig.tiny_moe,
    "tiny-mla": DecoderConfig.tiny_mla,
    "deepseek-v3-mini": DecoderConfig.deepseek_v3_mini,
    "deepseek-v3-mid-7b": DecoderConfig.deepseek_v3_mid_7b,
    "tiny-gpt2": GPT2Config.tiny,
    "gpt2": GPT2Config.gpt2_124m,
}


def build_decoder(cfg, device=None):
    """Config type -> the matching decoder module (``registry.py:65-68``)."""
    if isinstance(cfg, GPT2Config):
        return GPT2Decoder(cfg, device=device)
    return Decoder(cfg, device=device)


_CLASSES = {"EncoderConfig": EncoderConfig, "DecoderConfig": DecoderConfig, "GPT2Config": GPT2Config}


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
        raise ValueError(f"unknown config class {cls_name!r}")
    cls = _CLASSES[cls_name]
    if cls is DecoderConfig:
        check_unported(d)
    names = {f.name for f in dataclasses.fields(cls)}
    d = {k: v for k, v in d.items() if k in names}  # drop metadata and inert knobs
    for k in ("dtype", "param_dtype"):
        if k in d:
            d[k] = parse_dtype(d[k])
    # JSON gives the per-layer sliding pattern and the llama3 / YaRN rope tuples back as lists
    for k in ("sliding_layers", "rope_llama3", "rope_yarn"):
        if isinstance(d.get(k), list):
            d[k] = tuple(d[k])
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


def dequantize_state(state: dict) -> dict:
    """``state`` with every int8 layer (``<layer>.q`` + ``<layer>.scale``, and any calibrated scales beside
    them) replaced by its f32 ``<layer>.kernel = q * scale``; other leaves as they are."""
    layers = {k[:-2] for k in state if k.endswith(".q") and f"{k[:-2]}.scale" in state}
    out = {k: v for k, v in state.items()
           if not (k.rpartition(".")[0] in layers and k.rpartition(".")[2] in ("q", "scale", "a_scale", "dy_scale"))}
    for layer in layers:
        out[f"{layer}.kernel"] = state[f"{layer}.q"].float() * state[f"{layer}.scale"].float()
    return out


def tree_to_state(tree) -> dict:
    """A flax-named parameter tree (numpy arrays or tensors) → a state dict of CPU tensors; an int8 node
    ``{"__int8__": q, "scale": s}`` becomes its f32 ``q * s``."""
    import numpy as np

    def tensor(x):
        return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, copy=True))

    flat = flatten(tree)
    int8 = {k[: -len(".__int8__")] for k in flat if k.endswith(".__int8__")}
    out = {}
    for key, v in flat.items():
        owner = key.rpartition(".")[0]
        if owner in int8:
            if key.endswith(".__int8__"):
                out[owner] = tensor(v).float() * tensor(flat[owner + ".scale"]).float()
        else:
            out[key] = tensor(v)
    return out


def load_msgpack_pretrained(path: str) -> Tuple[object, dict]:
    """A reference ``save_pretrained`` directory (``config.json`` + ``params.msgpack``) → (config, CPU state dict)."""
    from dalm_tpu_torch.core import msgpack

    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_json(json.load(f))
    return cfg, tree_to_state(msgpack.load(os.path.join(path, MSGPACK_FILE)))


def _has(path: str, *names) -> bool:
    return os.path.isdir(path) and any(os.path.exists(os.path.join(path, n)) for n in names)


def _resolve(spec: str, presets: dict, kind: str, dtype, vocab_size):
    if spec in presets:
        cfg, state = presets[spec](), None
        if vocab_size is not None:
            cfg = dataclasses.replace(cfg, vocab_size=vocab_size)
    elif _has(spec, STATE_FILE):
        cfg, state = load_pretrained(spec)
        state = dequantize_state(state)
    elif _has(spec, MSGPACK_FILE):
        cfg, state = load_msgpack_pretrained(spec)
    elif _has(spec, *HF_FILES):
        from dalm_tpu_torch.models import hf_loader

        if kind == "encoder":
            cfg, tree = hf_loader.load_hf_encoder(spec)
        elif is_hf_gpt2(spec):
            cfg, tree = load_hf_gpt2(spec)
        else:
            cfg, tree = hf_loader.load_hf_decoder(spec)
        state = tree_to_state(tree)
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
    if not isinstance(cfg, (DecoderConfig, GPT2Config)):
        raise ValueError(f"{spec!r} holds a {type(cfg).__name__}, not a DecoderConfig or GPT2Config")
    return cfg, state
