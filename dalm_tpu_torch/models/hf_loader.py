"""PEFT-layout adapter export (counterpart of ``dalm_tpu/models/hf_loader.py:557-636``, its export part;
reading Hugging Face checkpoints is not ported yet).

``export_peft_adapter`` writes ``adapter_model.bin`` (a ``torch.save`` dict) and ``adapter_config.json`` in the
layout torch-PEFT loads: the merge math is PEFT's (``W + alpha / r * A @ B``), PEFT keeps ``lora_A.weight`` as
(r, in) and ``lora_B.weight`` as (out, r), so both factors are transposed on the way out, and the flat adapter's
``layer_i/<module>/kernel`` paths become the Hugging Face module paths of a Llama decoder or a BERT encoder.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)


def peft_arch_for_config(cfg) -> Optional[str]:
    """Config type -> PEFT module-path layout ("llama" / "bert"), or None where there is none."""
    from dalm_tpu_torch.models.decoder import DecoderConfig
    from dalm_tpu_torch.models.encoder import EncoderConfig

    if isinstance(cfg, EncoderConfig):
        return "bert"
    if isinstance(cfg, DecoderConfig):
        return "llama"
    return None


def export_peft_if_supported(output_dir: str, flat_adapter: Dict[str, dict], spec, model_cfg,
                             base_model_name_or_path: str = "") -> bool:
    """Export when the config has a PEFT layout; returns whether it did."""
    arch = peft_arch_for_config(model_cfg)
    if arch is None:
        logger.warning("PEFT adapter export is not supported for %s; skipping", type(model_cfg).__name__)
        return False
    export_peft_adapter(output_dir, flat_adapter, spec, arch=arch, base_model_name_or_path=base_model_name_or_path)
    return True


def export_peft_adapter(output_dir: str, lora_params: Dict[str, dict], spec, arch: str = "llama",
                        base_model_name_or_path: str = "") -> None:
    """Write ``adapter_model.bin`` + ``adapter_config.json`` in PEFT layout; ``lora_params`` is the flat
    ``{"layer_i/.../<module>/kernel": {"lora_a", "lora_b"}}`` dict (scaling not folded in)."""
    tensors = {}
    for path_str, ab in lora_params.items():
        parts = path_str.split("/")
        module = parts[-2]
        hf_idx = parts[0].split("_")[1] if parts[0].startswith("layer_") else "0"
        if arch == "llama":
            prefix = f"base_model.model.model.layers.{hf_idx}.self_attn.{module}"
        else:
            prefix = f"base_model.model.encoder.layer.{hf_idx}.attention.self.{module}"
        tensors[f"{prefix}.lora_A.weight"] = ab["lora_a"].detach().float().cpu().T.contiguous()
        tensors[f"{prefix}.lora_B.weight"] = ab["lora_b"].detach().float().cpu().T.contiguous()
    os.makedirs(output_dir, exist_ok=True)
    torch.save(tensors, os.path.join(output_dir, "adapter_model.bin"))
    with open(os.path.join(output_dir, "adapter_config.json"), "w") as f:
        json.dump({
            "peft_type": "LORA",
            "task_type": "CAUSAL_LM" if arch == "llama" else "FEATURE_EXTRACTION",
            "r": spec.rank,
            "lora_alpha": spec.alpha,
            "lora_dropout": spec.dropout,
            "target_modules": list(spec.target_modules),
            "base_model_name_or_path": base_model_name_or_path,
            "bias": "none",
        }, f, indent=2)
