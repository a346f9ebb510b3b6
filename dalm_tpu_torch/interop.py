"""Parameter trees of the JAX package → the port's state dicts.

Takes the reference's flax parameter trees as nested dicts of numpy
arrays (``unbox``ed params, e.g. ``jax.tree.map(np.asarray, params)``)
and returns state dicts for the port's ``Encoder``, ``SentenceEmbedder``
and ``Decoder``. The port names its parameters after the flax tree and
keeps Dense kernels in the flax ``(in, out)`` layout (``FlexLinear``
computes ``x @ kernel``; no ``nn.Linear`` is involved), so each leaf maps
to the key of its dotted path unchanged. A leaf the module lacks, a
module parameter no leaf fills, or a shape mismatch raises.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """Nested dict → {"a.b.c": leaf}."""
    out = {}
    for name, v in tree.items():
        key = f"{prefix}{name}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _to_tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: widen exactly, then narrow
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def state_dict_for(module: nn.Module, params: Mapping, prefix: str = "") -> dict:
    """Map a flax tree onto ``module``'s parameter names (``prefix`` is
    prepended to every leaf path). Raises on missing or unused leaves."""
    leaves = {prefix + k: v for k, v in flatten(params).items()}
    expected = module.state_dict()
    missing = sorted(set(expected) - set(leaves))
    unused = sorted(set(leaves) - set(expected))
    if missing or unused:
        raise KeyError(f"parameter tree does not match the module: missing {missing}, unused {unused}")
    out = {}
    for k, ref in expected.items():
        t = _to_tensor(leaves[k])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{k}: leaf shape {tuple(t.shape)} != parameter shape {tuple(ref.shape)}")
        out[k] = t.to(ref.dtype)
    return out


def load_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Copy a flax tree into the port's ``Encoder``, ``Decoder`` or
    ``SentenceEmbedder`` in place; returns ``module``. An embedder's
    encoder sits under ``module.``, where the flax embedder keeps the
    encoder's tree at its root."""
    from dalm_tpu_torch.models.embedder import SentenceEmbedder

    prefix = "module." if isinstance(module, SentenceEmbedder) else ""
    module.load_state_dict(state_dict_for(module, params, prefix))
    return module
