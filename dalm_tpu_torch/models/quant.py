"""Weight-only int8 quantisation of frozen base kernels (counterpart of
``dalm_tpu/models/quant.py:40-56,200-264``; the int4 / nf4 / per-column int4
formats wait for the quantised-serving slice).

Symmetric per-output-channel int8: ``w ~= q * scale`` with ``q`` in
[-127, 127] and one f32 scale per column; an all-zero column gets scale 1.
Trees are nested dicts of tensors shaped like the reference's parameter
trees; a quantised kernel is the dict ``{"__int8__": q, "scale": scale}``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

QUANT_KEY = "__int8__"


def quantize_tensor(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    w = w.float()
    absmax = w.abs().amax(dim=0, keepdim=True)
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0), torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {QUANT_KEY: q, "scale": scale}


def dequantize_tensor(q: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    return (q[QUANT_KEY].float() * q["scale"]).to(dtype)


def _is_quantized(node) -> bool:
    return isinstance(node, dict) and QUANT_KEY in node


def quantize_params(params: Any, min_size: int = 1024) -> Any:
    """Quantise every 2-D float ``kernel`` leaf with >= ``min_size`` elements;
    embeddings, norms, biases and small kernels stay as they are."""

    def visit(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            big = (k == "kernel" and isinstance(v, torch.Tensor) and v.dim() == 2
                   and v.numel() >= min_size and v.is_floating_point())
            out[k] = quantize_tensor(v) if big else visit(v)
        return out

    return visit(params)


def dequantize_params(params: Any, dtype=torch.float32) -> Any:
    """Inverse of :func:`quantize_params`."""

    def visit(node):
        if _is_quantized(node):
            return dequantize_tensor(node, dtype)
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        return node

    return visit(params)


def quantization_error(quantized: Any, original: Any) -> float:
    """Largest per-kernel reconstruction error of ``quantized`` against the
    tree it was made from, relative to that kernel's absmax."""
    errs = []

    def visit(node, orig):
        if _is_quantized(node):
            denom = orig.float().abs().max().clamp(min=1e-9)
            errs.append(float((dequantize_tensor(node) - orig.float()).abs().max() / denom))
        elif isinstance(node, dict):
            for k in node:
                visit(node[k], orig[k])

    visit(quantized, original)
    return max(errs) if errs else 0.0
