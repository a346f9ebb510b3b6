"""LoRA specs and adapter files (counterpart of ``dalm_tpu/models/lora.py:41-96,139-171``).

r = 8, alpha = 16, dropout 0.05, targets ``query/key/value`` for encoders
and ``q_proj/v_proj`` for causal LMs; generator SFT uses r = 256,
alpha = 512. Adapters are flat dicts ``{"path/to/kernel": {"lora_a",
"lora_b"}}`` (scaling not folded in), saved as ``adapter_config.json`` in
the reference's schema plus a ``torch.save`` file.

The merge runtime (generator SFT): ``init_lora_params`` draws such a flat
dict for a parameter tree, ``merge_lora`` folds one into a tree
(``W + (A @ B * scaling).to(W.dtype)``, the reference's ``dropout_rng=None``
form), ``merge_lora_inplace`` folds one
into a module's ``FlexLinear`` kernels (a PEFT adapter loaded for serving or
eval, before any packing), and ``attach_merge_lora`` /
``merge_lora_params`` put the factors onto a module's ``FlexLinear`` layers
(``add_merge_lora``) and read them back, so that autograd gives dA and dB;
``set_merge_dropout`` draws one step's masks onto those layers: the
reference's scale-preserving dropout on ``A`` (``:98-121``), one mask a site
keyed by ``crc32(path)``, applied in the layer's forward. The masks come from
the port's generators, not JAX's keys: they differ between the packages, their
rate and scaling do not.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Any, Optional, Tuple

import torch

from dalm_tpu_torch.models.layers import FlexLinear

ENCODER_TARGETS = ("query", "key", "value")
CAUSAL_LM_TARGETS = ("q_proj", "v_proj")
ADAPTER_FILE = "adapter_params.pt"


@dataclasses.dataclass(frozen=True)
class LoraSpec:
    rank: int = 8
    alpha: float = 16.0
    dropout: float = 0.05
    target_modules: Tuple[str, ...] = ENCODER_TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    @staticmethod
    def for_encoder(rank: int = 8, alpha: float = 16.0) -> "LoraSpec":
        return LoraSpec(rank=rank, alpha=alpha, target_modules=ENCODER_TARGETS)

    @staticmethod
    def for_causal_lm(rank: int = 8, alpha: float = 16.0) -> "LoraSpec":
        return LoraSpec(rank=rank, alpha=alpha, target_modules=CAUSAL_LM_TARGETS)

    @staticmethod
    def for_sft(rank: int = 256, alpha: float = 512.0) -> "LoraSpec":
        return LoraSpec(rank=rank, alpha=alpha, target_modules=CAUSAL_LM_TARGETS)


def _target_kernel_paths(params: Any, spec: LoraSpec) -> list:
    """Paths (tuples of keys) of the 2-D ``kernel`` leaves whose parent
    module is named by the spec, in sorted-key order (the order in which
    the reference flattens a tree)."""
    paths = []

    def visit(node, path):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                visit(v, path + (k,))
            elif k == "kernel" and path and path[-1] in spec.target_modules and getattr(v, "ndim", 0) == 2:
                paths.append(path + (k,))

    visit(params, ())
    return paths


def _get_path(tree: Any, path: tuple):
    node = tree
    for k in path:
        node = node[k]
    return node


def init_lora_params(generator: torch.Generator, params: Any, spec: LoraSpec) -> dict:
    """``{"path/to/kernel": {"lora_a", "lora_b"}}`` for the spec's targets in the
    nested tree ``params``: A ~ N(0, 0.02) drawn from ``generator``, B = 0, both
    f32 on the kernels' device (so the initial delta is zero)."""
    lora = {}
    for path in _target_kernel_paths(params, spec):
        kernel = _get_path(params, path)
        d_in, d_out = kernel.shape
        a = torch.randn((d_in, spec.rank), generator=generator, device=generator.device, dtype=torch.float32) * 0.02
        lora["/".join(path)] = {
            "lora_a": a.to(kernel.device),
            "lora_b": torch.zeros((spec.rank, d_out), dtype=torch.float32, device=kernel.device),
        }
    if not lora:
        raise ValueError(f"no kernels matched LoRA targets {spec.target_modules}; check module naming")
    return lora


def dropout_keep(path_str: str, shape, rate: float, seed: int, device) -> torch.Tensor:
    """The keep mask (probability ``1 - rate``) of one site's ``A`` for one step: drawn from a generator seeded
    by ``seed`` and ``crc32(path)``, so each site has a stream of its own, as the reference folds its key."""
    g = torch.Generator(device=device).manual_seed((int(seed) * 2_147_483_647 + zlib.crc32(path_str.encode()))
                                                   % (2 ** 63))
    return torch.rand(tuple(shape), generator=g, device=device) < 1.0 - rate


def merge_lora(params: Any, lora_params: dict, spec: LoraSpec) -> dict:
    """``W + scaling * A @ B`` on every adapted kernel of the nested tree
    ``params`` (the delta cast to the kernel's type first). Returns a new
    tree; untouched leaves are shared."""
    def put(tree, path, value):
        if len(path) == 1:
            return {**tree, path[0]: value}
        return {**tree, path[0]: put(tree[path[0]], path[1:], value)}

    merged = params
    for path_str, ab in lora_params.items():
        path = tuple(path_str.split("/"))
        kernel = _get_path(merged, path)
        delta = (ab["lora_a"] @ ab["lora_b"]) * spec.scaling
        merged = put(merged, path, kernel + delta.to(kernel.dtype))
    return merged


def _merge_site(module, path_str: str):
    path = path_str.split("/")
    site = module.get_submodule(".".join(path[:-1]))
    if path[-1] != "kernel" or not isinstance(site, FlexLinear):
        raise KeyError(f"{path_str!r} does not name a FlexLinear kernel")
    return site


@torch.no_grad()
def merge_lora_inplace(module, lora_params: dict, spec: LoraSpec):
    """``W + scaling * A @ B`` written into each adapted ``FlexLinear``'s ``kernel`` (the delta computed in f32 on
    the kernel's device and cast to its type first, as ``merge_lora`` does), leaving no factor on the module.
    Packing (``qlora.pack_module``) comes after. Returns ``module``."""
    for path_str, ab in lora_params.items():
        site = _merge_site(module, path_str)
        if site.kernel is None:
            raise ValueError(f"{path_str!r} is packed: merge an adapter before packing")
        if site.lora_a is not None or site.a is not None:
            raise ValueError(f"{path_str!r} carries LoRA factors: merge into a plain layer")
        dev = site.kernel.device
        delta = (ab["lora_a"].to(dev, torch.float32) @ ab["lora_b"].to(dev, torch.float32)) * spec.scaling
        site.kernel.add_(delta.to(site.kernel.dtype))
    return module


def attach_merge_lora(module, lora_params: dict, spec: LoraSpec):
    """Put a flat adapter dict onto ``module``'s layers as trainable merge-runtime
    factors (copies, on each layer's device; a layer that has factors of this
    rank keeps its parameters and gets new values). Returns ``module``."""
    for path_str, ab in lora_params.items():
        site = _merge_site(module, path_str)
        if site.lora_a is None or site.lora_a.shape[1] != spec.rank:
            site.add_merge_lora(spec.rank, spec.scaling)
        site.merge_scaling = float(spec.scaling)  # factors a layer has already are overwritten in place
        with torch.no_grad():
            site.lora_a.copy_(ab["lora_a"])
            site.lora_b.copy_(ab["lora_b"])
    return module


def set_merge_dropout(module, spec: LoraSpec, seed: Optional[int]) -> None:
    """Draw one step's dropout masks on ``A`` onto every merge-runtime layer of ``module`` (``dropout_keep`` of
    the site's kernel path and ``seed``); ``seed=None`` or a rate of 0 turns them off."""
    for name, site in module.named_modules():
        if not isinstance(site, FlexLinear) or site.lora_a is None:
            continue
        if seed is None or spec.dropout <= 0:
            site.lora_a_keep = None
            continue
        site.lora_dropout = float(spec.dropout)
        site.lora_a_keep = dropout_keep(name.replace(".", "/") + "/kernel", site.lora_a.shape, spec.dropout, seed,
                                        site.lora_a.device)


def merge_lora_params(module) -> dict:
    """The module's merge-runtime factors as a flat adapter dict (no copies)."""
    out = {}
    for name, p in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        if leaf in ("lora_a", "lora_b"):
            out.setdefault(owner.replace(".", "/") + "/kernel", {})[leaf] = p
    return out


def save_adapter(output_dir: str, lora_params: dict, spec: LoraSpec) -> None:
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "adapter_config.json"), "w") as f:
        json.dump(
            {"r": spec.rank, "lora_alpha": spec.alpha, "lora_dropout": spec.dropout,
             "target_modules": list(spec.target_modules)},
            f, indent=2,
        )
    flat = {path: {k: v.detach().cpu() for k, v in ab.items()} for path, ab in lora_params.items()}
    torch.save(flat, os.path.join(output_dir, ADAPTER_FILE))


def load_adapter(path: str) -> tuple:
    with open(os.path.join(path, "adapter_config.json")) as f:
        cfg = json.load(f)
    spec = LoraSpec(
        rank=cfg["r"], alpha=cfg["lora_alpha"], dropout=cfg.get("lora_dropout", 0.0),
        target_modules=tuple(cfg["target_modules"]),
    )
    lora_params = torch.load(os.path.join(path, ADAPTER_FILE), map_location="cpu", weights_only=True)
    return lora_params, spec
