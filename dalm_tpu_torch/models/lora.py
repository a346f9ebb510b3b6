"""LoRA specs and adapter files (counterpart of ``dalm_tpu/models/lora.py:41-96,139-171``).

r = 8, alpha = 16, dropout 0.05, targets ``query/key/value`` for encoders
and ``q_proj/v_proj`` for causal LMs; generator SFT uses r = 256,
alpha = 512. Adapters are flat dicts ``{"path/to/kernel": {"lora_a",
"lora_b"}}`` (scaling not folded in), saved as ``adapter_config.json`` in
the reference's schema plus a ``torch.save`` file. ``merge_lora`` waits
with the merge runtime.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Tuple

import torch

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
