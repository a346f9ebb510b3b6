"""Weight-only quantisation of frozen base kernels (counterpart of
``dalm_tpu/models/quant.py``).

- int8: symmetric per-output-channel, ``w ~= q * scale`` with ``q`` in
  [-127, 127] and one f32 scale per column; an all-zero column gets scale 1.
  Trees are nested dicts of tensors shaped like the reference's parameter
  trees; a quantised kernel is the dict ``{"__int8__": q, "scale": scale}``.
- int4 (``quantize_tensor_int4``): symmetric per-(K-group, column), ``q`` in
  [-7, 7] stored ``+ 8`` as nibbles in the HALF-SPLIT layout: packed row
  ``r`` holds K-row ``r`` in its low nibble and K-row ``K/2 + r`` in its high
  nibble; ``q4 (K/2, N)`` uint8 + ``scale4 (K/group, N)`` f32.
- int4pc (``quantize_tensor_int4pc``): the same packing with one scale per
  column, ``scale4 (1, N)``, and a ``"pcol"`` marker.
- nf4 (``quantize_tensor_nf4``): the same packing, nibbles index the
  NormalFloat4 codebook, scales are the group absmax, and a ``"nf4"`` marker.

Every quantiser gives the reference's bytes and scales bit for bit on the
same f32 weights; divisions are by tensors (a division by a Python scalar may
become a multiply by its reciprocal on the card).
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


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as a true division on every backend."""
    return a / torch.full_like(a, b)


def _int4_group(half: int, want: int = 64) -> int:
    """Largest group <= ``want`` with ``half % (8 * group) == 0`` (the
    reference's Pallas scale tiles need 8 rows), else the largest power-of-two
    divisor of ``half`` below ``want``. Llama-2-7B's down-projection (K/2 =
    5504 = 128 * 43) gets 16."""
    g = want
    while g > 1 and half % (8 * g):
        g //= 2
    if half % (8 * g) == 0:
        return g
    g = want
    while g > 1 and half % g:
        g //= 2
    return max(g, 1)


def _pack_halves(stored: torch.Tensor) -> torch.Tensor:
    """(K, N) values in [0, 15] -> (K/2, N) uint8, row r | row K/2 + r << 4."""
    half = stored.shape[0] // 2
    stored = stored.to(torch.uint8)
    return stored[:half] | (stored[half:] << 4)


def quantize_tensor_int4(w: torch.Tensor, group: int = 64) -> Dict[str, torch.Tensor]:
    """Per-(K-group, column) int4 in the half-split layout: ``{"q4", "scale4"}``."""
    w = w.float()
    K, N = w.shape
    if K % 2:
        raise ValueError(f"int4 packing needs even K (got {K})")
    group = _int4_group(K // 2, group)
    wg = w.reshape(K // group, group, N)
    absmax = wg.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, _div(absmax, 7.0), torch.ones_like(absmax))
    q = torch.clamp(torch.round(wg / scale), -7, 7).reshape(K, N)
    return {"q4": _pack_halves(q + 8), "scale4": scale[:, 0, :].contiguous()}


def quantize_tensor_int4pc(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-column int4, one f32 scale per output channel: ``{"q4", "scale4" (1, N), "pcol"}``."""
    w = w.float()
    K, N = w.shape
    if K % 2:
        raise ValueError(f"int4 packing needs even K (got {K})")
    absmax = w.abs().amax(dim=0, keepdim=True)
    scale = torch.where(absmax > 0, _div(absmax, 7.0), torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale), -7, 7)
    return {"q4": _pack_halves(q + 8), "scale4": scale,
            "pcol": torch.ones((), dtype=torch.int8, device=w.device)}


# bitsandbytes' NormalFloat4 codebook (QLoRA, Dettmers et al. 2023): the 16
# quantiles of N(0, 1) normalised to [-1, 1], with an exact zero. The same f32
# values as the reference's ``NF4_CODEBOOK``.
NF4_CODEBOOK = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)

# Elements of the (groups, group, N, 16) distance tensor built at once (128 MiB in f32).
_NF4_CHUNK = 1 << 25


def nf4_codebook(device=None) -> torch.Tensor:
    return torch.tensor(NF4_CODEBOOK, dtype=torch.float32, device=device)


def quantize_tensor_nf4(w: torch.Tensor, group: int = 64) -> Dict[str, torch.Tensor]:
    """NormalFloat4: ``w ~= codebook[idx] * absmax`` per (K-group, column), the
    nearest entry (first on ties), half-split packing: ``{"q4", "scale4", "nf4"}``.
    The 16-way distance tensor is built a few groups at a time."""
    w = w.float()
    K, N = w.shape
    if K % 2:
        raise ValueError(f"nf4 packing needs even K (got {K})")
    group = _int4_group(K // 2, group)
    wg = w.reshape(K // group, group, N)
    absmax = wg.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    wn = wg / scale
    cb = nf4_codebook(w.device)
    idx = torch.empty(wg.shape, dtype=torch.uint8, device=w.device)
    step = max(_NF4_CHUNK // (group * N * 16), 1)
    for g0 in range(0, wg.shape[0], step):
        part = wn[g0:g0 + step]
        idx[g0:g0 + step] = torch.argmin((part[..., None] - cb).abs(), dim=-1).to(torch.uint8)
    return {"q4": _pack_halves(idx.reshape(K, N)), "scale4": scale[:, 0, :].contiguous(),
            "nf4": torch.ones((), dtype=torch.uint8, device=w.device)}


def dequantize_tensor_int4(d: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    """(K, N) weights of an int4 / int4pc / nf4 dict, formed in f32 and cast to ``dtype``."""
    packed, scale = d["q4"], d["scale4"]
    lo, hi = (packed & 0xF).long(), (packed >> 4).long()
    if "nf4" in d:
        cb = nf4_codebook(packed.device)
        q = torch.cat([cb[lo], cb[hi]], dim=0)
    else:
        q = torch.cat([lo - 8, hi - 8], dim=0).float()
    group = q.shape[0] // scale.shape[0]
    return (q * torch.repeat_interleave(scale.float(), group, dim=0)).to(dtype)


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
