"""Decoder-only causal LM, Llama-2 subset (counterpart of ``dalm_tpu/models/decoder.py``).

RMSNorm pre-norm, rotate-half RoPE at the default theta, MHA or grouped
GQA attention, SwiGLU MLP. Attention runs on plain matmuls (the reference's
einsum path, ``decoder.py:762-776``) or, with ``attention_impl="flash"``,
through ``kernels.flash_attention`` (K4) whenever there is no cache and the
sequence is at least 256 long and a multiple of 128 (the reference's rule,
``decoder.py:738-744``, decided by the config alone: the kernel's wrapper
looks at the tensor's device). Padding then goes in as segment ids (pads are
segment 0, real tokens segment 1) under a slot-causal mask, where the matmul
path masks by rope position: the two agree at every real token, and differ at
pad rows, which feed no real token and carry no loss. The reference's modes:

- full sequence: ``forward(ids, mask)`` → logits (B, S, V);
- training: ``train_forward(ids, mask)`` → the same logits with gradients,
  each layer recomputed in the backward when ``cfg.remat`` is set (the flash
  forward kernel then runs twice per layer and step), optionally with NEFTune
  noise on the embeddings;
- cached: ``forward(ids, slot_mask, positions, kv_cache, cache_index)``
  with a scalar ``cache_index``; the new keys/values are written into the
  cache buffers IN PLACE (the JAX version returns an updated copy) and
  attention runs over the whole buffer under a slot-causal mask
  (``decoder.py:961-977``). Returns ``(logits, kv_cache)``. With
  ``cfg.kv_quant`` the cache holds int8 keys and values with one f32 scale per
  (token, kv head) (``decoder.py:555-571,856-870``): the new entries are
  quantised on write and attention reads the dequantised buffers.

Parameter names mirror the flax tree so JAX weights carry across leaf
for leaf (``dalm_tpu_torch/interop.py``). Every other family knob of the
reference config is rejected with ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dalm_tpu_torch.kernels.flash_attention import flash_attention
from dalm_tpu_torch.models.encoder import Embed
from dalm_tpu_torch.models.layers import FlexLinear

ATTENTION_IMPLS = ("einsum", "flash")

# Reference config fields this slice does not port, with the value at
# which each is inert. A saved config carrying any other value raises.
UNPORTED_KNOBS = {
    "tie_embeddings": False,
    "ring_axis": "model",
    "ring_layout": "contiguous",
    "attention_bias": False,
    "head_dim_override": None,
    "hidden_act": "silu",
    "scale_embeddings": False,
    "rmsnorm_unit_offset": False,
    "query_pre_attn_scalar": None,
    "attn_logit_softcap": None,
    "final_logit_softcap": None,
    "post_norms": False,
    "sliding_layers": "all",
    "qk_norm": False,
    "rope_local_theta": None,
    "rope_scaling_factor": None,
    "rope_llama3": None,
    "num_experts": None,
    "num_experts_per_tok": 2,
    "moe_intermediate_size": None,
    "norm_topk_prob": True,
    "moe_router": "softmax",
    "moe_n_group": None,
    "moe_topk_group": None,
    "moe_routed_scaling_factor": 1.0,
    "moe_n_shared_experts": 0,
    "moe_layer_start": 0,
    "moe_impl": "auto",
    "moe_capacity_factor": None,
    "moe_group_size": 2048,
    "q_lora_rank": None,
    "kv_lora_rank": None,
    "qk_nope_head_dim": None,
    "qk_rope_head_dim": None,
    "v_head_dim": None,
    "rope_interleave": False,
    "rope_yarn": None,
    "attn_scale_mult": 1.0,
}


def check_unported(fields: dict) -> None:
    """Raise on a reference config field set to a non-inert value."""
    for name, inert in UNPORTED_KNOBS.items():
        if name in fields and fields[name] != inert:
            raise NotImplementedError(f"decoder knob {name}={fields[name]!r} is not ported yet")


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32000
    hidden_size: int = 512
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: Optional[int] = None  # None → MHA
    intermediate_size: int = 1408
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    remat: bool = False  # recompute each layer in the backward (train_forward only)
    attention_impl: str = "einsum"
    sliding_window: Optional[int] = None
    # "fwd" | "all": int8 kernels for layers with int8 storage (models/layers.py).
    int8_compute: str = "none"
    kv_quant: bool = False
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @staticmethod
    def tiny(vocab_size: int = 512) -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=vocab_size, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128, max_position_embeddings=512,
        )

    @staticmethod
    def llama2_7b() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
            intermediate_size=11008, max_position_embeddings=4096,
            remat=True, param_dtype=torch.bfloat16,
        )


def _check_supported(cfg: DecoderConfig) -> None:
    if cfg.attention_impl not in ATTENTION_IMPLS:
        raise NotImplementedError(f"attention_impl={cfg.attention_impl!r} is not ported yet")
    if cfg.sliding_window:
        raise NotImplementedError("sliding-window attention is not ported yet")
    if cfg.num_heads % cfg.kv_heads:
        raise ValueError("num_heads must be a multiple of num_kv_heads")


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float, dtype) -> tuple:
    """positions (B, S) → cos/sin (B, S, head_dim), default rope only."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    freqs = positions[..., None].float() * inv_freq[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D)."""
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return x * cos + rotate_half(x) * sin


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float, dtype, param_dtype, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, dtype=param_dtype, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.scale.float()).to(self.dtype)


def _proj(cfg: DecoderConfig, n_in: int, n_out: int, device) -> FlexLinear:
    return FlexLinear(n_in, n_out, use_bias=False, dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device,
                      int8_compute=cfg.int8_compute)


def _kv_quantize(x: torch.Tensor) -> tuple:
    """(B, S, H, D) float -> (int8 values, (B, S, H) f32 scales): per (token,
    head) absmax over D, ``scale = max(amax, 1e-6) / 127``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-6) / torch.full_like(amax, 127.0)
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """f32 product (int8 * f32 promotes exactly), cast to the compute type."""
    return (q * scale[..., None]).to(dtype)


class DecoderAttention(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, nh, kvh, hd = cfg.hidden_size, cfg.num_heads, cfg.kv_heads, cfg.head_dim
        self.q_proj = _proj(cfg, h, nh * hd, device)
        self.k_proj = _proj(cfg, h, kvh * hd, device)
        self.v_proj = _proj(cfg, h, kvh * hd, device)
        self.o_proj = _proj(cfg, nh * hd, h, device)

    def forward(self, hidden, mask, cos, sin, kv_cache=None, cache_index=None, segment_mask=None):
        """mask: (B, 1, S_q, S_k) bool (True = attend), or None on the flash
        path, which takes ``segment_mask`` (B, S) int32 (None: all valid)."""
        cfg = self.cfg
        B, S, _ = hidden.shape
        nh, kvh, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        q = apply_rope(self.q_proj(hidden).view(B, S, nh, hd), cos, sin)
        k = apply_rope(self.k_proj(hidden).view(B, S, kvh, hd), cos, sin)
        v = self.v_proj(hidden).view(B, S, kvh, hd)
        if mask is None:
            # K4: never builds the (S, S) scores; K/V go in at the kv head count.
            ctx = flash_attention(q, k, v, segment_mask, segment_mask, causal=True, scale=1.0 / math.sqrt(hd))
            return self.o_proj(ctx.reshape(B, S, nh * hd).to(cfg.dtype))
        if kv_cache is not None:
            # Scalar-index write, in place (the reference's
            # dynamic_update_slice mode, decoder.py:624-628).
            at = slice(cache_index, cache_index + S)
            if "k_scale" in kv_cache:  # int8 cache: quantise on write, read dequantised
                (kv_cache["k"][:, at], kv_cache["k_scale"][:, at]) = _kv_quantize(k)
                (kv_cache["v"][:, at], kv_cache["v_scale"][:, at]) = _kv_quantize(v)
                k = _kv_dequantize(kv_cache["k"], kv_cache["k_scale"], cfg.dtype)
                v = _kv_dequantize(kv_cache["v"], kv_cache["v_scale"], cfg.dtype)
            else:
                kv_cache["k"][:, at] = k.to(kv_cache["k"].dtype)
                kv_cache["v"][:, at] = v.to(kv_cache["v"].dtype)
                k, v = kv_cache["k"], kv_cache["v"]
        rep = nh // kvh
        # Grouped attention without repeating K/V: query head j·rep+g reads
        # kv head j (MHA is rep == 1). Layouts: (B, kvh, rep, S, hd) and
        # (B, kvh, 1, L, hd).
        qg = q.view(B, S, kvh, rep, hd).permute(0, 2, 3, 1, 4)
        kt = k.permute(0, 2, 3, 1)[:, :, None]  # (B, kvh, 1, hd, L)
        vg = v.permute(0, 2, 1, 3)[:, :, None]  # (B, kvh, 1, L, hd)
        scale = torch.tensor(1.0 / math.sqrt(hd), dtype=cfg.dtype)
        scores = (qg @ kt) * scale
        scores = torch.where(
            mask[:, :, None], scores.float(),
            torch.tensor(torch.finfo(torch.float32).min, device=scores.device),
        )
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        ctx = (probs @ vg).permute(0, 3, 1, 2, 4).reshape(B, S, nh * hd)
        return self.o_proj(ctx)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.input_norm = RMSNorm(h, cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype, device)
        self.attention = DecoderAttention(cfg, device)
        self.post_attention_norm = RMSNorm(h, cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype, device)
        self.gate_proj = _proj(cfg, h, cfg.intermediate_size, device)
        self.up_proj = _proj(cfg, h, cfg.intermediate_size, device)
        self.down_proj = _proj(cfg, cfg.intermediate_size, h, device)

    def forward(self, hidden, mask, cos, sin, kv_cache=None, cache_index=None, segment_mask=None):
        hidden = hidden + self.attention(self.input_norm(hidden), mask, cos, sin, kv_cache, cache_index,
                                         segment_mask)
        normed = self.post_attention_norm(hidden)
        return hidden + self.down_proj(F.silu(self.gate_proj(normed)) * self.up_proj(normed))


class Decoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype, cfg.param_dtype, device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(cfg, device))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype, device)
        self.lm_head = _proj(cfg, cfg.hidden_size, cfg.vocab_size, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def init_kv_cache(self, batch_size: int, max_len: int, dtype=None, device=None) -> dict:
        cfg = self.cfg
        dtype = dtype or cfg.dtype
        device = device or self.final_norm.scale.device
        shape = (batch_size, max_len, cfg.kv_heads, cfg.head_dim)
        if cfg.kv_quant:
            # Zero scales dequantise unwritten slots to 0, which the masks exclude anyway.
            return {
                f"layer_{i}": {
                    "k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
                }
                for i in range(cfg.num_layers)
            }
        return {
            f"layer_{i}": {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
            }
            for i in range(cfg.num_layers)
        }

    @torch.no_grad()
    def forward(self, input_ids, attention_mask=None, positions=None, kv_cache=None,
                cache_index: Optional[int] = None, return_hidden: bool = False,
                logits_last_only: bool = False):
        """Inference (no gradient). Full-sequence: logits (B, S, V). With
        ``kv_cache``: (logits, kv_cache).

        ``attention_mask``: (B, S) for full-sequence; (B, max_len) over the
        cache slots when decoding with a cache."""
        return self._run(input_ids, attention_mask, positions, kv_cache, cache_index, return_hidden,
                         logits_last_only, remat=False)

    def train_forward(self, input_ids, attention_mask=None, neftune_alpha: float = 0.0,
                      noise_generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None):
        """Training: full-sequence logits (B, S, V) with gradients and no
        cache. With ``cfg.remat`` every layer is checkpointed: its
        activations are recomputed in the backward instead of kept.

        NEFTune (``decoder.py:927-937`` of the reference): with
        ``neftune_alpha > 0``, uniform(-1, 1) noise times
        ``alpha / sqrt(S * hidden)``, drawn in f32 from ``noise_generator`` (on
        the inputs' device) or given ready as ``noise`` (B, S, hidden) in
        [-1, 1], is cast to the hidden type and added after the embedding."""
        if neftune_alpha > 0.0 and noise is None and noise_generator is not None:
            B, S = input_ids.shape
            noise = torch.rand((B, S, self.cfg.hidden_size), generator=noise_generator, device=input_ids.device,
                               dtype=torch.float32) * 2.0 - 1.0
        if not neftune_alpha > 0.0:
            noise = None
        return self._run(input_ids, attention_mask, None, None, None, False, False, remat=self.cfg.remat,
                         neftune_alpha=neftune_alpha, noise=noise)

    def uses_flash(self, seq_len: int, cached: bool = False) -> bool:
        """Whether a full-sequence call of this length takes the flash kernel."""
        return self.cfg.attention_impl == "flash" and not cached and seq_len >= 256 and seq_len % 128 == 0

    def _run(self, input_ids, attention_mask, positions, kv_cache, cache_index, return_hidden,
             logits_last_only, remat, neftune_alpha=0.0, noise=None):
        cfg = self.cfg
        B, S = input_ids.shape
        dev = input_ids.device
        if kv_cache is not None and not isinstance(cache_index, int):
            raise NotImplementedError("only a scalar (int) cache_index is ported")
        if positions is None:
            if kv_cache is not None:
                positions = (cache_index + torch.arange(S, device=dev))[None, :].expand(B, S)
            elif attention_mask is not None:
                positions = torch.clamp(torch.cumsum(attention_mask, dim=1) - 1, min=0)
            else:
                positions = torch.arange(S, device=dev)[None, :].expand(B, S)

        hidden = self.embed_tokens(input_ids)
        if noise is not None:
            scale = neftune_alpha / math.sqrt(S * cfg.hidden_size)
            hidden = hidden + (noise.to(device=dev, dtype=torch.float32) * scale).to(hidden.dtype)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)

        segment_mask = None
        if self.uses_flash(S, cached=kv_cache is not None):
            mask = None
            if attention_mask is not None:
                segment_mask = attention_mask.to(torch.int32)
        elif kv_cache is not None:
            # Causality over cache SLOTS: with left padding the rope
            # position lags the slot index by a per-row constant.
            key_len = kv_cache["layer_0"]["k"].shape[1]
            key_slot = torch.arange(key_len, device=dev)[None, None, None, :]
            q_slot = (cache_index + torch.arange(S, device=dev))[None, None, :, None]
            mask = key_slot <= q_slot
        else:
            mask = positions[:, None, None, :] <= positions[:, None, :, None]
        if mask is not None and attention_mask is not None:
            mask = mask & (attention_mask[:, None, None, :] > 0)

        for i in range(cfg.num_layers):
            layer_cache = kv_cache[f"layer_{i}"] if kv_cache is not None else None
            layer = getattr(self, f"layer_{i}")
            if remat and torch.is_grad_enabled():
                hidden = checkpoint(layer, hidden, mask, cos, sin, None, None, segment_mask, use_reentrant=False)
            else:
                hidden = layer(hidden, mask, cos, sin, layer_cache, cache_index, segment_mask)
        hidden = self.final_norm(hidden)
        if return_hidden:
            return hidden
        if logits_last_only:
            hidden = hidden[:, -1:, :]
        logits = self.lm_head(hidden)
        if kv_cache is not None:
            return logits, kv_cache
        return logits
