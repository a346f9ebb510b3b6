"""Parameter trees of the JAX package → the port's state dicts.

Takes the reference's flax parameter trees as nested dicts of numpy
arrays (``unbox``ed params, e.g. ``jax.tree.map(np.asarray, params)``)
and returns state dicts for the port's ``Encoder``, ``SentenceEmbedder``
and ``Decoder``. The port names its parameters after the flax tree and
keeps Dense kernels in the flax ``(in, out)`` layout (``FlexLinear``
computes ``x @ kernel``; no ``nn.Linear`` is involved), so each leaf maps
to the key of its dotted path unchanged, every family's leaves too (the MoE
blocks' stacked ``router`` / ``w_gate`` / ``w_up`` / ``w_down``, MLA's raw
``kv_b_proj``, GPT-2's ``c_attn`` / ``c_proj`` / ``c_fc`` / ``mlp_proj``; the dense families'
q/k/v ``bias``, ``q_norm`` / ``k_norm``, the sandwich norms
``post_attention_norm`` / ``pre_feedforward_norm`` / ``post_feedforward_norm``,
and no ``lm_head`` where the head is tied). A leaf the module lacks, a
module parameter no leaf fills, or a shape mismatch raises. Leaves may be
numpy arrays or tensors (the port's own readers give bfloat16 as tensors).

The fused-QLoRA collections carry across the same way: ``load_packed``
takes the reference's ``params`` residual, ``quant`` (``q`` + ``scale``,
``w``, or the 4-bit ``q4`` + ``scale4`` with an ``nf4`` or ``pcol`` marker)
and ``lora`` (``a``, ``b``) trees into a module's buffers and parameters, ``load_factors`` replaces only the factors, and
``factors_tree`` reads them back as a tree of numpy arrays.

The merge-runtime LoRA tree of the SFT trainer (``{"layer_0/attention/q_proj/
kernel": {"lora_a", "lora_b"}}``, scaling not folded in) goes onto a module
with ``load_merge_lora`` and comes back as numpy arrays with
``merge_lora_tree``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from dalm_tpu_torch.core.tree import flatten, unflatten


def _to_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):  # the port's own readers (a bfloat16 leaf of params.msgpack, HF checkpoints)
        return x.detach().clone()
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


def _tensor_tree(tree: Mapping) -> dict:
    return unflatten({k: _to_tensor(v) for k, v in flatten(tree).items()})


def load_packed(module: nn.Module, params: Mapping, quant: Mapping, lora: Mapping = None) -> nn.Module:
    """Copy the reference's fused-QLoRA collections into the port's
    ``Encoder`` or ``Decoder`` in place: the ``quant`` tree becomes frozen
    buffers, the ``lora`` tree trainable f32 parameters, the ``params``
    residual the remaining parameters. Returns ``module``."""
    from dalm_tpu_torch.models import qlora

    return qlora.load_packed(module, _tensor_tree(params), _tensor_tree(quant),
                             _tensor_tree(lora) if lora is not None else None)


def load_factors(module: nn.Module, lora: Mapping) -> nn.Module:
    """Overwrite the LoRA factors a module already has with a ``lora`` tree;
    the tree must name exactly the module's factors."""
    leaves = {k: _to_tensor(v) for k, v in flatten(lora).items()}
    mine = {k: p for k, p in module.named_parameters() if k.rpartition(".")[2] in ("a", "b")}
    if set(leaves) != set(mine):
        raise KeyError(f"lora tree does not match the module's factors: "
                       f"missing {sorted(set(mine) - set(leaves))}, unused {sorted(set(leaves) - set(mine))}")
    with torch.no_grad():
        for k, p in mine.items():
            if tuple(leaves[k].shape) != tuple(p.shape):
                raise ValueError(f"{k}: leaf shape {tuple(leaves[k].shape)} != parameter shape {tuple(p.shape)}")
            p.copy_(leaves[k])
    return module


def factors_tree(module: nn.Module) -> dict:
    """The module's LoRA factors as a ``lora`` tree of numpy arrays."""
    return unflatten({k: p.detach().cpu().float().numpy() for k, p in module.named_parameters()
                      if k.rpartition(".")[2] in ("a", "b")})


def load_merge_lora(module: nn.Module, lora_params: Mapping, spec) -> nn.Module:
    """Attach the reference's flat merge-runtime LoRA dict (numpy leaves) to the
    port's module as trainable ``lora_a`` / ``lora_b`` factors; a module that
    has them already gets them overwritten."""
    from dalm_tpu_torch.models import lora as lora_mod

    flat = {path: {k: _to_tensor(v).float() for k, v in ab.items()} for path, ab in lora_params.items()}
    return lora_mod.attach_merge_lora(module, flat, spec)


def merge_lora_tree(module: nn.Module) -> dict:
    """The module's merge-runtime factors in the reference's flat form, as numpy arrays."""
    from dalm_tpu_torch.models import lora as lora_mod

    return {path: {k: p.detach().cpu().float().numpy() for k, p in ab.items()}
            for path, ab in lora_mod.merge_lora_params(module).items()}
