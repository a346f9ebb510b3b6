"""Fused QLoRA: frozen packed base + trainable low-rank factors (counterpart
of ``dalm_tpu/models/qlora.py:71-145,216-298,365-423``).

The frozen base kernels are stored int8 (``q`` + ``scale``), bf16 (``w``) or
4-bit (``q4`` + ``scale4``, with an ``nf4`` or ``pcol`` marker for the nf4 and
int4pc formats), and every ``FlexLinear`` computes ``x @ dequant(W) + (x @ a) @ b``
locally. ``quantize`` names the storage as the reference does: True or "int8",
False (bf16), "int4", "nf4", "int4pc".
Two views of the same state:

- trees (nested dicts of tensors, the reference's collections):
  ``pack_qlora_frozen`` -> (residual, quant), ``init_qlora_factors`` -> lora,
  ``unpack_to_params``, ``factors_to_flat`` / ``flat_to_factors``;
- a module: ``load_packed`` restructures its ``FlexLinear`` layers after the
  trees and fills them, ``pack_module`` + ``init_module_factors`` do the same
  from the module's own kernels, ``split_state`` reads the trees back, and
  ``init_packed_on_device`` random-initialises a model built on the ``meta``
  device straight into packed storage, one leaf at a time, so a
  full-precision tree of a 7B model never exists.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from dalm_tpu_torch.core.tree import flatten, set_path, unflatten
from dalm_tpu_torch.models.layers import PACKED_LEAVES, UNPORTED_QUANT_LEAVES, FlexLinear
from dalm_tpu_torch.models.lora import LoraSpec, _target_kernel_paths
from dalm_tpu_torch.models.quant import (dequantize_tensor_int4, quantize_tensor, quantize_tensor_int4,
                                         quantize_tensor_int4pc, quantize_tensor_nf4)

MIN_SIZE = 4096
_QUANTISERS = {"int4": quantize_tensor_int4, "nf4": quantize_tensor_nf4, "int4pc": quantize_tensor_int4pc}


def storage_of(quantize) -> str:
    """The storage a ``quantize`` value names: True / "int8" -> "int8",
    False -> "bf16", "int4" / "nf4" / "int4pc" as they are."""
    if quantize is True or quantize == "int8":
        return "int8"
    if quantize is False:
        return "bf16"
    if quantize in _QUANTISERS:
        return quantize
    raise ValueError(f"quantize must be True, False, 'int8', 'int4', 'nf4' or 'int4pc', not {quantize!r}")


def _pack_leaf(kernel: torch.Tensor, storage: str) -> dict:
    """One kernel in a storage, as the leaves of its ``quant`` node."""
    if storage == "int8":
        qt = quantize_tensor(kernel)
        return {"q": qt["__int8__"], "scale": qt["scale"]}
    if storage == "bf16":
        return {"w": kernel.to(torch.bfloat16)}
    return _QUANTISERS[storage](kernel)


def _storage_of_node(node: dict) -> str:
    if "q4" in node:
        return "nf4" if "nf4" in node else "int4pc" if "pcol" in node else "int4"
    return "int8" if "q" in node else "bf16"


def _walk_kernels(params: Any, path=()):
    """Yield (path, leaf) for every 2-D ``kernel`` leaf."""
    for k, v in params.items():
        if isinstance(v, dict):
            yield from _walk_kernels(v, path + (k,))
        elif k == "kernel" and v.dim() == 2:
            yield path + (k,), v


def pack_qlora_frozen(params: Any, quantize: "bool | str" = True, min_size: int = MIN_SIZE) -> Tuple[dict, dict]:
    """Move every 2-D kernel of >= ``min_size`` elements out of ``params`` into
    a ``quant`` tree in the storage ``quantize`` names (``storage_of``).
    Returns (residual, quant); the input is not changed."""
    storage = storage_of(quantize)
    residual = flatten(params)
    quant: dict = {}
    for path, kernel in _walk_kernels(params):
        if kernel.numel() < min_size:
            continue
        for leaf, value in _pack_leaf(kernel, storage).items():
            set_path(quant, path[:-1] + (leaf,), value)
        del residual[".".join(path)]
    return unflatten(residual), quant


def _factors(generator: torch.Generator, d_in: int, d_out: int, spec: LoraSpec, device) -> tuple:
    """``a ~ N(0, 0.02) * alpha/r`` (scaling folded in), ``b = 0``, both f32."""
    a = torch.randn((d_in, spec.rank), generator=generator, device=generator.device) * 0.02 * spec.scaling
    return a.to(device), torch.zeros((spec.rank, d_out), dtype=torch.float32, device=device)


def init_qlora_factors(generator: torch.Generator, params: Any, spec: LoraSpec) -> dict:
    """Trainable ``lora`` tree for the spec's target modules of ``params``."""
    lora: dict = {}
    for path in _target_kernel_paths(params, spec):
        kernel = params
        for k in path:
            kernel = kernel[k]
        a, b = _factors(generator, kernel.shape[0], kernel.shape[1], spec, kernel.device)
        set_path(lora, path[:-1] + ("a",), a)
        set_path(lora, path[:-1] + ("b",), b)
    if not lora:
        raise ValueError(f"no kernels matched LoRA targets {spec.target_modules}")
    return lora


def unpack_to_params(residual: Any, quant: Any, dtype=torch.bfloat16) -> dict:
    """A full parameter tree from packed storage: each packed kernel is
    dequantised (``q * scale``, the 4-bit formats' ``dequantize_tensor_int4``,
    or the stored ``w``) back into its module's ``kernel`` slot, on the CPU."""
    out = {k: v.detach().cpu() for k, v in flatten(residual).items()}

    def walk(node, path):
        if "q" in node or "w" in node or "q4" in node:
            if "q4" in node:
                kernel = dequantize_tensor_int4(node)
            elif "q" in node:
                kernel = node["q"].float() * node["scale"].float()
            else:
                kernel = node["w"].float()
            out[".".join(path + ("kernel",))] = kernel.to(dtype).cpu()
        else:
            for k, v in node.items():
                walk(v, path + (k,))

    walk(quant, ())
    return unflatten(out)


def factors_to_flat(lora_tree: dict, spec: LoraSpec) -> Dict[str, dict]:
    """``lora`` tree -> the flat adapter dict ``{"path/to/kernel": {lora_a,
    lora_b}}`` with the scaling taken out of ``a`` again."""
    flat: Dict[str, dict] = {}

    def walk(node, path):
        if "a" in node and "b" in node and not isinstance(node["a"], dict):
            flat["/".join(path + ("kernel",))] = {"lora_a": node["a"] / spec.scaling, "lora_b": node["b"]}
        else:
            for k, v in node.items():
                walk(v, path + (k,))

    walk(lora_tree, ())
    return flat


def flat_to_factors(flat: Dict[str, dict], spec: LoraSpec) -> dict:
    """Inverse of :func:`factors_to_flat` (scaling folded into ``a`` again)."""
    tree: dict = {}
    for path_str, ab in flat.items():
        module_path = tuple(path_str.split("/"))[:-1]
        set_path(tree, module_path + ("a",), ab["lora_a"] * spec.scaling)
        set_path(tree, module_path + ("b",), ab["lora_b"])
    return tree


# --------------------------------------------------------------------------
# The module view
# --------------------------------------------------------------------------

def _flex(module: nn.Module, path: tuple) -> FlexLinear:
    sub = module.get_submodule(".".join(path))
    if not isinstance(sub, FlexLinear):
        raise TypeError(f"{'.'.join(path)} is not a FlexLinear")
    return sub


def _sites(tree: dict, keys: tuple, path=()):
    """Yield (module path, node) for every node of ``tree`` that holds leaves named in ``keys``."""
    if any(k in tree and not isinstance(tree[k], dict) for k in keys):
        yield path, tree
        return
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _sites(v, keys, path + (k,))


def load_packed(module: nn.Module, residual: dict, quant: dict, lora: Optional[dict] = None) -> nn.Module:
    """Restructure ``module``'s layers after the ``quant`` and ``lora`` trees
    and copy all three trees in. Tensors land on the device the module's
    parameters are on."""
    device = next(module.parameters()).device
    for path, node in _sites(quant, ("q", "w", "q4") + UNPORTED_QUANT_LEAVES):
        bad = [k for k in UNPORTED_QUANT_LEAVES if k in node]
        if bad:
            raise NotImplementedError(f"quant leaves {bad} at {'.'.join(path)} are not ported yet")
        storage = _storage_of_node(node)
        group = None
        if storage in ("int4", "nf4"):
            group = 2 * node["q4"].shape[0] // node["scale4"].shape[0]
        _flex(module, path).to_packed(storage, device=device, group=group)
    for path, node in _sites(lora or {}, ("a",)):
        _flex(module, path).add_lora(node["a"].shape[1], device=device)
    state = {**flatten(residual), **flatten(quant), **flatten(lora or {})}
    module.load_state_dict(state)
    return module


def pack_module(module: nn.Module, quantize: "bool | str" = True, min_size: int = MIN_SIZE) -> nn.Module:
    """:func:`pack_qlora_frozen` on the module's own kernels, in place."""
    residual, quant = pack_qlora_frozen(unflatten(dict(module.state_dict())), quantize, min_size)
    return load_packed(module, residual, quant)


def init_module_factors(module: nn.Module, spec: LoraSpec, generator: torch.Generator) -> int:
    """Add freshly initialised factors to every ``FlexLinear`` whose name is a
    target of ``spec``, in sorted-path order. Returns how many."""
    names = sorted(n for n, m in module.named_modules()
                   if isinstance(m, FlexLinear) and n.split(".")[-1] in spec.target_modules)
    if not names:
        raise ValueError(f"no kernels matched LoRA targets {spec.target_modules}")
    for name in names:
        m = module.get_submodule(name)
        m.add_lora(spec.rank)
        a, b = _factors(generator, m.in_features, m.out_features, spec, m.a.device)
        with torch.no_grad():
            m.a.copy_(a)
            m.b.copy_(b)
    return len(names)


def split_state(module: nn.Module) -> Tuple[dict, dict, dict]:
    """(residual, quant, lora) trees of a module's current state (no copies)."""
    residual, quant, lora = {}, {}, {}
    packed = {n for n, m in module.named_modules() if isinstance(m, FlexLinear)}
    for key, v in module.state_dict().items():
        owner, _, leaf = key.rpartition(".")
        if owner in packed and leaf in PACKED_LEAVES:
            quant[key] = v
        elif owner in packed and leaf in ("a", "b"):
            lora[key] = v
        else:
            residual[key] = v
    return unflatten(residual), unflatten(quant), unflatten(lora)


def init_packed_on_device(module: nn.Module, generator: torch.Generator, spec: Optional[LoraSpec] = None,
                          quantize: "bool | str" = True, min_size: int = MIN_SIZE,
                          dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Random-initialise a model built on the ``meta`` device straight into
    packed storage on the generator's device. Every leaf is drawn, cast to
    ``dtype``, quantised if it is a big kernel, and freed before the next:
    the peak beyond the packed model is one kernel in f32. Kernels and
    embeddings are N(0, 0.02), norm scales 1, other vectors 0; factors (for
    ``spec``'s targets) ``a ~ N(0, 0.02) * alpha/r``, ``b = 0``. ``quantize``
    names the storage (``storage_of``)."""
    device = generator.device
    storage = storage_of(quantize)

    def draw(shape):
        return (torch.randn(shape, generator=generator, device=device) * 0.02).to(dtype)

    for name, m in module.named_modules():
        if isinstance(m, FlexLinear):
            shape = (m.in_features, m.out_features)
            if shape[0] * shape[1] >= min_size:
                leaf = draw(shape)
                m.to_packed(storage, device=device)
                for buf, value in _pack_leaf(leaf, storage).items():
                    getattr(m, buf).copy_(value)
                del leaf
            else:
                m.kernel = nn.Parameter(draw(shape))
            if spec is not None and name.split(".")[-1] in spec.target_modules:
                m.add_lora(spec.rank, device=device)
                a, _ = _factors(generator, shape[0], shape[1], spec, device)
                with torch.no_grad():
                    m.a.copy_(a)
    for name, p in list(module.named_parameters()):
        if not p.is_meta:
            continue
        owner = module.get_submodule(name.rpartition(".")[0])
        leaf = name.rpartition(".")[2]
        if p.dim() >= 2:
            value = draw(p.shape)
        elif leaf == "scale":
            value = torch.ones(p.shape, dtype=dtype, device=device)
        else:
            value = torch.zeros(p.shape, dtype=dtype, device=device)
        setattr(owner, leaf, nn.Parameter(value))
    return module
