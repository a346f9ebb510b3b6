"""Decoder-only causal LM, every family but GPT-2 (counterpart of ``dalm_tpu/models/decoder.py``).

Llama-2 / 3 / 3.1, Mistral, Phi-3, Qwen2.5 / 3 and Gemma / 2 / 3 on one
module, as in the reference: RMSNorm pre-norm (``(1 + w)`` with
``rmsnorm_unit_offset``), rotate-half RoPE (default, ``rope_llama3`` frequency
bands, ``rope_scaling_factor`` linear positions on the global rope only, and
Gemma3's local table at ``rope_local_theta`` for the sliding layers), MHA or
grouped GQA attention with optional q/k/v bias and per-head QK-norm before
rope, the query scale ``1 / sqrt(query_pre_attn_scalar or head_dim)``, the
logit softcap before the mask, a sliding window on the layers
``layer_window`` names, SwiGLU / GeGLU / erf-GELU MLPs, Gemma2's sandwich
norms, the ``sqrt(hidden)`` embedding scale, the tied head
(``hidden @ embed.T``, no ``lm_head``) and the final-logit softcap.
Attention runs on plain matmuls (the reference's einsum path,
``decoder.py:762-776``) or, with ``attention_impl="flash"``, through
``kernels.flash_attention`` (K4; each layer's window, the softcap and the
query scale go to the kernel) whenever there is no cache and the sequence is
at least 256 long and a multiple of 128 (the reference's rule,
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
  with an ``int`` ``cache_index`` (every row writes slots from it) or a (B,)
  tensor (row ``b`` writes from ``cache_index[b]``: the continuous-batching
  engine's slots, ``decoder.py:596-625,907,967``); the new keys/values are
  written into the cache buffers IN PLACE (the JAX version returns an updated
  copy) and attention runs over the whole buffer under a slot-causal mask
  (``decoder.py:961-977``), banded by the layer's window in slot space. Returns
  ``(logits, kv_cache)``. With ``cfg.kv_quant`` the cache holds int8 keys and
  values with one f32 scale per (token, kv head) (``decoder.py:555-571,856-870``):
  the new entries are quantised on write and attention reads the dequantised
  buffers.

The MoE families (``num_experts``: Mixtral, Qwen3-MoE, DeepSeek-V3's noaux-tc
router with shared experts from ``moe_layer_start``) run ``models/moe.py``'s
block in place of the MLP, and ``return_moe_aux`` returns its load-balancing
value; MLA (``kv_lora_rank``: DeepSeek-V3) runs ``models/mla.py`` in place of
the attention, with the YaRN rope (``rope_yarn``) on its rope slice and a
latent cache ``{"k": (B, L, r), "pe": (B, L, d_rope)}``.

Parameter names mirror the flax tree so JAX weights carry across leaf
for leaf (``dalm_tpu_torch/interop.py``). The ring-attention knobs of the
reference config are rejected with ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dalm_tpu_torch.kernels.flash_attention import flash_attention
from dalm_tpu_torch.models.encoder import Embed
from dalm_tpu_torch.models.layers import FlexLinear

ATTENTION_IMPLS = ("einsum", "flash")
# the MLP's activation by the config's hidden_act
_ACTS = {
    "silu": F.silu,
    "gelu_tanh": lambda z: F.gelu(z, approximate="tanh"),
    "gelu": F.gelu,
}

# Reference config fields the port does not run yet, with the value at which
# each is inert, and the module that brings them. A saved config carrying any
# other value raises.
UNPORTED_KNOBS = {
    "kernels/ring_attention.py (multi-GPU)": {"ring_axis": "model", "ring_layout": "contiguous"},
}


def check_unported(fields: dict) -> None:
    """Raise on a reference config field set to a non-inert value."""
    for module, knobs in UNPORTED_KNOBS.items():
        for name, inert in knobs.items():
            if name in fields and fields[name] != inert:
                raise NotImplementedError(
                    f"decoder knob {name}={fields[name]!r} needs {module}, which is not ported yet")


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
    tie_embeddings: bool = False  # logits = hidden @ embed.T, no lm_head
    remat: bool = False  # recompute each layer in the backward (train_forward only)
    attention_impl: str = "einsum"
    # keys ``sliding_window`` or more positions behind the query are masked, on the layers of ``layer_window``
    sliding_window: Optional[int] = None
    attention_bias: bool = False  # q/k/v projection bias (Qwen2); o_proj and the MLP stay bias-free
    head_dim_override: Optional[int] = None  # Gemma: head_dim decoupled from hidden / heads
    hidden_act: str = "silu"  # "gelu_tanh" (Gemma's GeGLU) or "gelu" (exact erf)
    scale_embeddings: bool = False  # embeddings times sqrt(hidden), the factor cast to the compute type first
    rmsnorm_unit_offset: bool = False  # RMSNorm scale is 1 + w (HF Gemma's zero-centred weights)
    query_pre_attn_scalar: Optional[float] = None  # scores scaled by 1 / sqrt(this) instead of 1 / sqrt(head_dim)
    attn_logit_softcap: Optional[float] = None  # scores <- cap * tanh(scores / cap) before the mask
    final_logit_softcap: Optional[float] = None  # the same on the logits
    post_norms: bool = False  # Gemma2 sandwich norms: 4 a layer
    # "all" (every layer windows), "even" (even layers, Gemma2) or a per-layer tuple of bools (Gemma3)
    sliding_layers: Any = "all"
    qk_norm: bool = False  # per-head RMSNorm on q and k over head_dim, before rope (Gemma3, Qwen3)
    rope_local_theta: Optional[float] = None  # Gemma3: the sliding layers' rope base (unscaled positions)
    rope_scaling_factor: Optional[float] = None  # linear position scaling of the global rope only
    # Llama-3.1's frequency bands: (factor, low_freq_factor, high_freq_factor, original_max_position_embeddings)
    rope_llama3: Optional[tuple] = None
    # Sparse MoE (models/moe.py): num_experts set -> the layers from moe_layer_start on have an MoE MLP.
    num_experts: Optional[int] = None
    num_experts_per_tok: int = 2
    moe_intermediate_size: Optional[int] = None
    norm_topk_prob: bool = True
    moe_router: str = "softmax"  # or "noaux_tc" (DeepSeek-V3: sigmoid scores, group-limited top-k)
    moe_n_group: Optional[int] = None  # noaux_tc: expert groups
    moe_topk_group: Optional[int] = None  # noaux_tc: groups kept
    moe_routed_scaling_factor: float = 1.0  # noaux_tc: weight scale
    moe_n_shared_experts: int = 0  # DeepSeek-V3's always-on experts
    moe_layer_start: int = 0  # DeepSeek-V3's first_k_dense_replace: the layers before it keep a dense MLP
    moe_impl: str = "auto"  # "dense", "dispatch" or "auto" (dense with a KV cache)
    moe_capacity_factor: Optional[float] = None  # dispatch capacity ceil(g·K·cf / E); None -> dropless
    moe_group_size: Optional[int] = 2048  # dispatch groups of this many tokens, each with its own capacity
    # "fwd" | "all": int8 kernels for layers with int8 storage (models/layers.py).
    int8_compute: str = "none"
    kv_quant: bool = False
    # Multi-head latent attention (models/mla.py): kv_lora_rank set -> every layer's attention is MLA, and the
    # KV cache holds the normed latent "k" (B, L, kv_lora_rank) and the rope key "pe" (B, L, qk_rope_head_dim).
    q_lora_rank: Optional[int] = None  # None -> a direct q_proj
    kv_lora_rank: Optional[int] = None
    qk_nope_head_dim: Optional[int] = None
    qk_rope_head_dim: Optional[int] = None
    v_head_dim: Optional[int] = None
    rope_interleave: bool = False  # DeepSeek checkpoints' pair-interleaved rope lanes
    # YaRN: (factor, beta_fast, beta_slow, original_max_position_embeddings, attention_factor); see rope_cos_sin
    rope_yarn: Optional[tuple] = None
    attn_scale_mult: float = 1.0  # times the softmax scale (DeepSeek's yarn mscale_all_dim, squared)
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank is not None

    @property
    def qk_head_dim(self) -> int:
        return (self.qk_nope_head_dim or 0) + (self.qk_rope_head_dim or 0)

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    def layer_window(self, layer_idx: int) -> Optional[int]:
        """The sliding window of one layer, None for global attention (``decoder.py:204-217``): every layer
        ("all"), even layers ("even", Gemma2), or the layers a per-layer tuple marks (Gemma3)."""
        if not self.sliding_window:
            return None
        if isinstance(self.sliding_layers, (tuple, list)):
            return self.sliding_window if self.sliding_layers[layer_idx] else None
        if self.sliding_layers == "even" and layer_idx % 2 == 1:
            return None
        return self.sliding_window

    @staticmethod
    def tiny(vocab_size: int = 512) -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=vocab_size, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128, max_position_embeddings=512,
        )

    @staticmethod
    def tiny_moe(vocab_size: int = 512) -> "DecoderConfig":
        return dataclasses.replace(DecoderConfig.tiny(vocab_size), num_experts=4, num_experts_per_tok=2,
                                   moe_intermediate_size=64)

    @staticmethod
    def tiny_mla(vocab_size: int = 512) -> "DecoderConfig":
        return dataclasses.replace(DecoderConfig.tiny(vocab_size), q_lora_rank=24, kv_lora_rank=16,
                                   qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, rope_interleave=True)

    # The presets below carry the reference's numbers (``decoder.py:219-452``), each its published HF config.
    @staticmethod
    def llama2_7b() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
            intermediate_size=11008, max_position_embeddings=4096,
            remat=True, param_dtype=torch.bfloat16,
        )

    @staticmethod
    def llama2_13b() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=32000, hidden_size=5120, num_layers=40, num_heads=40,
            intermediate_size=13824, max_position_embeddings=4096,
            remat=True, param_dtype=torch.bfloat16,
        )

    @staticmethod
    def llama3_8b() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=128256, hidden_size=4096, num_layers=32, num_heads=32,
            num_kv_heads=8, intermediate_size=14336,
            max_position_embeddings=8192, rope_theta=500000.0,
            remat=True, param_dtype=torch.bfloat16,
        )

    @staticmethod
    def llama31_8b() -> "DecoderConfig":
        return dataclasses.replace(DecoderConfig.llama3_8b(), max_position_embeddings=131072,
                                   rope_llama3=(8.0, 1.0, 4.0, 8192))

    @staticmethod
    def mistral_7b() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
            num_kv_heads=8, intermediate_size=14336,
            max_position_embeddings=32768, rope_theta=10000.0,
            sliding_window=4096, remat=True, param_dtype=torch.bfloat16,
        )

    @staticmethod
    def qwen25_7b() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=152064, hidden_size=3584, num_layers=28, num_heads=28,
            num_kv_heads=4, intermediate_size=18944,
            max_position_embeddings=32768, rope_theta=1000000.0,
            attention_bias=True, remat=True, param_dtype=torch.bfloat16,
        )

    @staticmethod
    def qwen3_8b() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=151936, hidden_size=4096, num_layers=36, num_heads=32,
            num_kv_heads=8, head_dim_override=128, intermediate_size=12288,
            max_position_embeddings=40960, rope_theta=1000000.0,
            rms_norm_eps=1e-6, qk_norm=True,
            remat=True, param_dtype=torch.bfloat16,
        )

    @staticmethod
    def phi3_mini() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=32064, hidden_size=3072, num_layers=32, num_heads=32,
            num_kv_heads=32, intermediate_size=8192,
            max_position_embeddings=4096, rope_theta=10000.0,
            sliding_window=2047, remat=True, param_dtype=torch.bfloat16,
        )

    @staticmethod
    def gemma_2b() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=256000, hidden_size=2048, num_layers=18, num_heads=8,
            num_kv_heads=1, head_dim_override=256, intermediate_size=16384,
            max_position_embeddings=8192, rms_norm_eps=1e-6,
            tie_embeddings=True, hidden_act="gelu_tanh",
            scale_embeddings=True, rmsnorm_unit_offset=True,
            remat=True, param_dtype=torch.bfloat16,
        )

    @staticmethod
    def gemma2_2b() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=256000, hidden_size=2304, num_layers=26, num_heads=8,
            num_kv_heads=4, head_dim_override=256, intermediate_size=9216,
            max_position_embeddings=8192, rms_norm_eps=1e-6,
            tie_embeddings=True, hidden_act="gelu_tanh",
            scale_embeddings=True, rmsnorm_unit_offset=True,
            query_pre_attn_scalar=256.0, attn_logit_softcap=50.0,
            final_logit_softcap=30.0, sliding_window=4096,
            sliding_layers="even", post_norms=True,
            remat=True, param_dtype=torch.bfloat16,
        )

    @staticmethod
    def gemma3_1b() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=262144, hidden_size=1152, num_layers=26, num_heads=4,
            num_kv_heads=1, head_dim_override=256, intermediate_size=6912,
            max_position_embeddings=32768, rope_theta=1000000.0,
            rms_norm_eps=1e-6, tie_embeddings=True, hidden_act="gelu_tanh",
            scale_embeddings=True, rmsnorm_unit_offset=True,
            query_pre_attn_scalar=256.0, post_norms=True,
            sliding_window=512,
            sliding_layers=tuple(bool((i + 1) % 6) for i in range(26)),
            qk_norm=True, rope_local_theta=10000.0,
            remat=True, param_dtype=torch.bfloat16,
        )


    @staticmethod
    def mixtral_8x7b() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
            num_kv_heads=8, intermediate_size=14336,
            max_position_embeddings=32768, rope_theta=1000000.0,
            num_experts=8, num_experts_per_tok=2,
            remat=True, param_dtype=torch.bfloat16,
        )

    @staticmethod
    def mixtral_mini_4b() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=32000, hidden_size=2048, num_layers=16, num_heads=32,
            num_kv_heads=8, head_dim_override=64, intermediate_size=4096,
            num_experts=8, num_experts_per_tok=2,
            max_position_embeddings=4096, rope_theta=1000000.0,
            remat=True, param_dtype=torch.bfloat16,
        )

    @staticmethod
    def qwen3_moe_30b() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=151936, hidden_size=2048, num_layers=48, num_heads=32,
            num_kv_heads=4, head_dim_override=128, intermediate_size=6144,
            moe_intermediate_size=768, num_experts=128, num_experts_per_tok=8,
            norm_topk_prob=True, qk_norm=True,
            max_position_embeddings=40960, rope_theta=1000000.0,
            rms_norm_eps=1e-6, remat=True, param_dtype=torch.bfloat16,
        )

    @staticmethod
    def deepseek_v3_mid_7b() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=32000, hidden_size=4096, num_layers=32,
            num_heads=32, num_kv_heads=32, intermediate_size=11008,
            max_position_embeddings=4096, rope_theta=10000.0,
            q_lora_rank=1536, kv_lora_rank=512,
            qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
            rope_interleave=True, remat=True,
            dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        )

    @staticmethod
    def deepseek_v3_mini() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=32000, hidden_size=2560, num_layers=28,
            num_heads=20, num_kv_heads=20, intermediate_size=8960,
            max_position_embeddings=4096, rope_theta=10000.0,
            q_lora_rank=1024, kv_lora_rank=512,
            qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
            rope_interleave=True, remat=True,
            dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        )


def _check_supported(cfg: DecoderConfig) -> None:
    if cfg.attention_impl not in ATTENTION_IMPLS:
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} needs kernels/ring_attention.py (multi-GPU), not ported yet")
    if cfg.hidden_act not in _ACTS:
        raise ValueError(f"hidden_act must be one of {tuple(_ACTS)}, not {cfg.hidden_act!r}")
    layers = cfg.sliding_layers
    if not (layers in ("all", "even") or (isinstance(layers, (tuple, list)) and len(layers) >= cfg.num_layers)):
        raise ValueError(f"sliding_layers must be 'all', 'even' or a bool for every layer, not {layers!r}")
    if cfg.num_heads % cfg.kv_heads:
        raise ValueError("num_heads must be a multiple of num_kv_heads")
    if cfg.mla and cfg.sliding_window:  # the reference asserts it (mla.py:81)
        raise ValueError("MLA has no sliding-window support")


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float, dtype,
                 llama3_scaling: Optional[tuple] = None, yarn: Optional[tuple] = None) -> tuple:
    """positions (B, S) → cos/sin (B, S, head_dim). ``llama3_scaling`` =
    (factor, low_freq_factor, high_freq_factor, original_max_position_embeddings)
    rewrites the inverse frequencies as Llama-3.1 does (``decoder.py:502-509``):
    wavelengths above original / low are divided by ``factor``, those below
    original / high kept, the band between interpolated. ``yarn`` = (factor,
    beta_fast, beta_slow, original_max_position_embeddings, attention_factor)
    is YaRN (HF ``_compute_yarn_parameters``, truncated; ``decoder.py:482-501``):
    each frequency a linear blend of ``inv_freq / factor`` and ``inv_freq`` over
    the beta correction range, cos and sin times ``attention_factor``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    if yarn is not None:
        factor, beta_fast, beta_slow, old_len, _ = (float(v) for v in yarn)

        def corr_dim(rot):
            return (head_dim * math.log(old_len / (rot * 2 * math.pi))) / (2 * math.log(theta))

        low = max(math.floor(corr_dim(beta_fast)), 0)
        high = min(math.ceil(corr_dim(beta_slow)), head_dim - 1)
        ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32, device=positions.device) - low)
                           / max(high - low, 1e-3), 0.0, 1.0)
        extrapolation = 1.0 - ramp
        inv_freq = (inv_freq / factor) * (1.0 - extrapolation) + inv_freq * extrapolation
    if llama3_scaling is not None:
        factor, low, high, old_len = (float(v) for v in llama3_scaling)
        wavelen = 2.0 * math.pi / inv_freq
        scaled = torch.where(wavelen > old_len / low, inv_freq / factor, inv_freq)
        smooth = (old_len / wavelen - low) / (high - low)
        smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        medium = (wavelen >= old_len / high) & (wavelen <= old_len / low)
        inv_freq = torch.where(medium, smoothed, scaled)
    freqs = positions[..., None].float() * inv_freq[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    if yarn is not None:
        af = float(yarn[4])
        return (torch.cos(emb) * af).to(dtype), (torch.sin(emb) * af).to(dtype)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D)."""
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return x * cos + rotate_half(x) * sin


class RMSNorm(nn.Module):
    """RMSNorm over the last axis in f32; with ``unit_offset`` the effective scale is ``1 + scale`` (Gemma's
    parameterisation: a fresh layer holds zeros)."""

    def __init__(self, features: int, eps: float, dtype, param_dtype, device=None, unit_offset: bool = False):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.unit_offset = unit_offset
        self.scale = nn.Parameter(torch.full((features,), 0.0 if unit_offset else 1.0, dtype=param_dtype,
                                             device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(0.0 if self.unit_offset else 1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        s = self.scale.float() + 1.0 if self.unit_offset else self.scale.float()
        return (x32 * torch.rsqrt(var + self.eps) * s).to(self.dtype)


def _norm(cfg: DecoderConfig, features: int, device) -> RMSNorm:
    return RMSNorm(features, cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype, device, cfg.rmsnorm_unit_offset)


def _proj(cfg: DecoderConfig, n_in: int, n_out: int, device, use_bias: bool = False) -> FlexLinear:
    return FlexLinear(n_in, n_out, use_bias=use_bias, dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device,
                      int8_compute=cfg.int8_compute)


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap


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


def _cache_write(cache: dict, new_vals: dict, cache_index, S: int) -> None:
    """Write (B, S, ...) entries into the cache buffers (B, L, H, D) / (B, L, H)
    in place (the reference's ``_cache_write``, ``decoder.py:574-630``, returns
    an updated copy). Two modes:

    - an ``int`` index: every row's slots ``[cache_index, cache_index + S)``,
      one slice write (the reference's ``dynamic_update_slice``);
    - a (B,) tensor: row ``b``'s slots from ``cache_index[b]``, written by
      advanced indexing where the reference selects with one-hot masks. A slot
      at or past the end ``L`` is dropped, as there (a one-hot over ``L`` has
      no such column): the engine's host loop lets a finished slot run to the
      end of its chunk, past ``L``. With ``S == 1`` the row's slot is clamped
      and its old entry written back instead, so nothing waits on the host;
      with ``S > 1`` the slots in range are selected, which reads the mask.
    """
    if not torch.is_tensor(cache_index):
        at = slice(cache_index, cache_index + S)
        for name, val in new_vals.items():
            cache[name][:, at] = val.to(cache[name].dtype)
        return
    first = cache[next(iter(new_vals))]
    B, L = first.shape[:2]
    rows = torch.arange(B, device=first.device)
    if S == 1:
        slot = cache_index.clamp(max=L - 1)
        keep = cache_index < L
        for name, val in new_vals.items():
            buf = cache[name]
            new = val[:, 0].to(buf.dtype)
            buf[rows, slot] = torch.where(keep.view((B,) + (1,) * (new.dim() - 1)), new, buf[rows, slot])
        return
    slots = cache_index[:, None] + torch.arange(S, device=first.device)
    keep = slots < L
    rows, slots = rows[:, None].expand(B, S)[keep], slots[keep]
    for name, val in new_vals.items():
        cache[name][rows, slots] = val[keep].to(cache[name].dtype)


class DecoderAttention(nn.Module):
    def __init__(self, cfg: DecoderConfig, layer_idx: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        self.layer_idx = layer_idx
        h, nh, kvh, hd = cfg.hidden_size, cfg.num_heads, cfg.kv_heads, cfg.head_dim
        ab = cfg.attention_bias
        self.q_proj = _proj(cfg, h, nh * hd, device, ab)
        self.k_proj = _proj(cfg, h, kvh * hd, device, ab)
        self.v_proj = _proj(cfg, h, kvh * hd, device, ab)
        self.o_proj = _proj(cfg, nh * hd, h, device)
        if cfg.qk_norm:
            self.q_norm = _norm(cfg, hd, device)
            self.k_norm = _norm(cfg, hd, device)

    def forward(self, hidden, mask, cos, sin, kv_cache=None, cache_index=None, segment_mask=None):
        """mask: (B, 1, S_q, S_k) bool (True = attend), this layer's (banded
        where it slides), or None on the flash path, which takes
        ``segment_mask`` (B, S) int32 (None: all valid) and the layer's window."""
        cfg = self.cfg
        B, S, _ = hidden.shape
        nh, kvh, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        q = self.q_proj(hidden).view(B, S, nh, hd)
        k = self.k_proj(hidden).view(B, S, kvh, hd)
        if cfg.qk_norm:  # per head over head_dim, before rope (decoder.py:653-663)
            q, k = self.q_norm(q), self.k_norm(k)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        v = self.v_proj(hidden).view(B, S, kvh, hd)
        scale = 1.0 / float(cfg.query_pre_attn_scalar or hd) ** 0.5
        if mask is None:
            # K4: never builds the (S, S) scores; K/V go in at the kv head count.
            ctx = flash_attention(q, k, v, segment_mask, segment_mask, causal=True, scale=scale,
                                  window=cfg.layer_window(self.layer_idx), softcap=cfg.attn_logit_softcap)
            return self.o_proj(ctx.reshape(B, S, nh * hd).to(cfg.dtype))
        if kv_cache is not None:
            if "k_scale" in kv_cache:  # int8 cache: quantise on write, read dequantised
                (qk, ks), (qv, vs) = _kv_quantize(k), _kv_quantize(v)
                _cache_write(kv_cache, {"k": qk, "k_scale": ks, "v": qv, "v_scale": vs}, cache_index, S)
                k = _kv_dequantize(kv_cache["k"], kv_cache["k_scale"], cfg.dtype)
                v = _kv_dequantize(kv_cache["v"], kv_cache["v_scale"], cfg.dtype)
            else:
                _cache_write(kv_cache, {"k": k, "v": v}, cache_index, S)
                k, v = kv_cache["k"], kv_cache["v"]
        rep = nh // kvh
        # Grouped attention without repeating K/V: query head j·rep+g reads
        # kv head j (MHA is rep == 1). Layouts: (B, kvh, rep, S, hd) and
        # (B, kvh, 1, L, hd).
        qg = q.view(B, S, kvh, rep, hd).permute(0, 2, 3, 1, 4)
        kt = k.permute(0, 2, 3, 1)[:, :, None]  # (B, kvh, 1, hd, L)
        vg = v.permute(0, 2, 1, 3)[:, :, None]  # (B, kvh, 1, L, hd)
        scores = ((qg @ kt) * torch.tensor(scale, dtype=cfg.dtype)).float()
        if cfg.attn_logit_softcap is not None:  # cap, then mask (decoder.py:730-736)
            scores = _softcap(scores, cfg.attn_logit_softcap)
        scores = torch.where(mask[:, :, None], scores,
                             torch.tensor(torch.finfo(torch.float32).min, device=scores.device))
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        ctx = (probs @ vg).permute(0, 3, 1, 2, 4).reshape(B, S, nh * hd)
        return self.o_proj(ctx)


class DecoderLayer(nn.Module):
    """Pre-norm attention and MLP; with ``post_norms`` Gemma2's sandwich: the
    attention output normed by ``post_attention_norm`` before the residual add,
    the MLP between ``pre_feedforward_norm`` and ``post_feedforward_norm``
    (without it ``post_attention_norm`` is the MLP's pre-norm, Llama's name).
    The attention is MLA (``models/mla.py``) when the config sets
    ``kv_lora_rank``; the MLP an MoE block (``models/moe.py``, named ``moe``)
    from ``moe_layer_start`` on when it sets ``num_experts``. Returns (hidden,
    the MoE block's aux value or None)."""

    def __init__(self, cfg: DecoderConfig, layer_idx: int = 0, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.post_norms = cfg.post_norms
        self.act = _ACTS[cfg.hidden_act]
        self.input_norm = _norm(cfg, h, device)
        if cfg.mla:
            from dalm_tpu_torch.models.mla import MLAAttention

            self.attention = MLAAttention(cfg, layer_idx, device)
        else:
            self.attention = DecoderAttention(cfg, layer_idx, device)
        self.post_attention_norm = _norm(cfg, h, device)
        if cfg.post_norms:
            self.pre_feedforward_norm = _norm(cfg, h, device)
            self.post_feedforward_norm = _norm(cfg, h, device)
        if cfg.num_experts and layer_idx >= cfg.moe_layer_start:
            from dalm_tpu_torch.models.moe import MoEBlock

            self.moe = MoEBlock(cfg, device)
        else:
            self.gate_proj = _proj(cfg, h, cfg.intermediate_size, device)
            self.up_proj = _proj(cfg, h, cfg.intermediate_size, device)
            self.down_proj = _proj(cfg, cfg.intermediate_size, h, device)

    def forward(self, hidden, mask, cos, sin, kv_cache=None, cache_index=None, segment_mask=None):
        attn = self.attention(self.input_norm(hidden), mask, cos, sin, kv_cache, cache_index, segment_mask)
        if self.post_norms:
            attn = self.post_attention_norm(attn)
        hidden = hidden + attn
        normed = (self.pre_feedforward_norm if self.post_norms else self.post_attention_norm)(hidden)
        aux = None
        if hasattr(self, "moe"):
            down, aux = self.moe(normed, decode=kv_cache is not None)
        else:
            down = self.down_proj(self.act(self.gate_proj(normed)) * self.up_proj(normed))
        if self.post_norms:
            down = self.post_feedforward_norm(down)
        return hidden + down, aux


class Decoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype, cfg.param_dtype, device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(cfg, i, device))
        self.final_norm = _norm(cfg, cfg.hidden_size, device)
        if not cfg.tie_embeddings:
            self.lm_head = _proj(cfg, cfg.hidden_size, cfg.vocab_size, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def init_kv_cache(self, batch_size: int, max_len: int, dtype=None, device=None) -> dict:
        cfg = self.cfg
        dtype = dtype or cfg.dtype
        device = device or self.final_norm.scale.device
        if cfg.mla:
            # the latent cache: the normed latent and the shared rope key a token (decoder.py:836-854)
            if cfg.kv_quant:
                raise ValueError(
                    "kv_quant is not supported with MLA: the latent cache is already the compressed tier "
                    "(kv_lora_rank + qk_rope_head_dim floats/token)")
            return {
                f"layer_{i}": {
                    "k": torch.zeros((batch_size, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
                    "pe": torch.zeros((batch_size, max_len, cfg.qk_rope_head_dim), dtype=dtype, device=device),
                }
                for i in range(cfg.num_layers)
            }
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
                cache_index: "int | torch.Tensor | None" = None, return_hidden: bool = False,
                logits_last_only: bool = False, return_moe_aux: bool = False):
        """Inference (no gradient). Full-sequence: logits (B, S, V). With
        ``kv_cache``: (logits, kv_cache). ``return_moe_aux`` appends the MoE
        blocks' aux values summed over layers and divided by ``num_layers``
        (0 for a dense model; ``decoder.py:998-1013``).

        ``attention_mask``: (B, S) for full-sequence; (B, max_len) over the
        cache slots when decoding with a cache."""
        return self._run(input_ids, attention_mask, positions, kv_cache, cache_index, return_hidden,
                         logits_last_only, remat=False, return_moe_aux=return_moe_aux)

    def train_forward(self, input_ids, attention_mask=None, neftune_alpha: float = 0.0,
                      noise_generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None,
                      return_hidden: bool = False, return_moe_aux: bool = False):
        """Training: full-sequence logits (B, S, V) with gradients and no
        cache, or with ``return_hidden`` the final-normed hidden states
        (B, S, hidden) (the autoregressive retriever's). With ``cfg.remat``
        every layer is checkpointed: its activations are recomputed in the
        backward instead of kept.

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
        return self._run(input_ids, attention_mask, None, None, None, return_hidden, False, remat=self.cfg.remat,
                         neftune_alpha=neftune_alpha, noise=noise, return_moe_aux=return_moe_aux)

    def uses_flash(self, seq_len: int, cached: bool = False) -> bool:
        """Whether a full-sequence call of this length takes the flash kernel. MLA attends by matmuls on both of
        its paths, as the reference's does (``mla.py:134-156``)."""
        return (self.cfg.attention_impl == "flash" and not self.cfg.mla and not cached and seq_len >= 256
                and seq_len % 128 == 0)

    def _run(self, input_ids, attention_mask, positions, kv_cache, cache_index, return_hidden,
             logits_last_only, remat, neftune_alpha=0.0, noise=None, return_moe_aux=False):
        cfg = self.cfg
        B, S = input_ids.shape
        dev = input_ids.device
        if kv_cache is not None:
            # An int, or a (B,) tensor: each row's own first slot.
            if torch.is_tensor(cache_index):
                if cache_index.shape != (B,) or cache_index.device != dev or cache_index.is_floating_point():
                    raise ValueError(f"a per-row cache_index must be a ({B},) integer tensor on {dev}; got "
                                     f"{tuple(cache_index.shape)} {cache_index.dtype} on {cache_index.device}")
                q_slot = cache_index.long()[:, None] + torch.arange(S, device=dev)  # (B, S)
                cache_index = q_slot[:, 0]
            elif isinstance(cache_index, int):
                q_slot = (cache_index + torch.arange(S, device=dev))[None, :]  # (1, S)
            else:
                raise TypeError(f"cache_index must be an int or a ({B},) tensor; got {type(cache_index).__name__}")
        if positions is None:
            if kv_cache is not None:
                positions = q_slot.expand(B, S)
            elif attention_mask is not None:
                positions = torch.clamp(torch.cumsum(attention_mask, dim=1) - 1, min=0)
            else:
                positions = torch.arange(S, device=dev)[None, :].expand(B, S)

        hidden = self.embed_tokens(input_ids)
        if cfg.scale_embeddings:  # the factor cast to the compute type first, as HF Gemma does
            hidden = hidden * torch.tensor(cfg.hidden_size ** 0.5, dtype=cfg.dtype)
        if noise is not None:
            scale = neftune_alpha / math.sqrt(S * cfg.hidden_size)
            hidden = hidden + (noise.to(device=dev, dtype=torch.float32) * scale).to(hidden.dtype)
        # The global rope (Llama-3.1's bands, linear scaling of its positions only) and Gemma3's local one
        # for the sliding layers, at unscaled positions (decoder.py:939-959).
        pos_global = positions.float() / cfg.rope_scaling_factor if cfg.rope_scaling_factor else positions
        # MLA rotates only its decoupled rope slice (decoder.py:945-952)
        cos, sin = rope_cos_sin(pos_global, cfg.qk_rope_head_dim if cfg.mla else cfg.head_dim, cfg.rope_theta,
                                cfg.dtype, cfg.rope_llama3, cfg.rope_yarn)
        local = None
        if cfg.rope_local_theta is not None:
            local = rope_cos_sin(positions, cfg.head_dim, cfg.rope_local_theta, cfg.dtype)

        segment_mask = mask = mask_win = None
        if self.uses_flash(S, cached=kv_cache is not None):
            if attention_mask is not None:
                segment_mask = attention_mask.to(torch.int32)
        else:
            if kv_cache is not None:
                # Causality over cache SLOTS: with left padding the rope position lags the slot index by a
                # per-row constant, so the window band in slots is the band in positions.
                key_len = kv_cache["layer_0"]["k"].shape[1]
                k_at = torch.arange(key_len, device=dev)[None, None, None, :]
                q_at = q_slot[:, None, :, None]
            else:
                k_at, q_at = positions[:, None, None, :], positions[:, None, :, None]
            mask = k_at <= q_at
            if attention_mask is not None:
                mask = mask & (attention_mask[:, None, None, :] > 0)
            mask_win = mask & (k_at > q_at - cfg.sliding_window) if cfg.sliding_window else mask

        moe_aux = torch.zeros((), dtype=torch.float32, device=dev) if return_moe_aux else None
        for i in range(cfg.num_layers):
            layer_cache = kv_cache[f"layer_{i}"] if kv_cache is not None else None
            layer = getattr(self, f"layer_{i}")
            windowed = cfg.layer_window(i) is not None
            layer_mask = mask_win if windowed else mask
            lcos, lsin = local if windowed and local is not None else (cos, sin)
            if remat and torch.is_grad_enabled():
                hidden, aux = checkpoint(layer, hidden, layer_mask, lcos, lsin, None, None, segment_mask,
                                         use_reentrant=False)
            else:
                hidden, aux = layer(hidden, layer_mask, lcos, lsin, layer_cache, cache_index, segment_mask)
            if moe_aux is not None and aux is not None:
                moe_aux = moe_aux + aux
        if moe_aux is not None:
            moe_aux = moe_aux / cfg.num_layers  # over every layer, dense ones included (decoder.py:1013)
        hidden = self.final_norm(hidden)
        if return_hidden:
            return hidden
        if logits_last_only:
            hidden = hidden[:, -1:, :]
        if cfg.tie_embeddings:
            logits = hidden @ self.embed_tokens.embedding.to(cfg.dtype).T
        else:
            logits = self.lm_head(hidden)
        if cfg.final_logit_softcap is not None:
            logits = _softcap(logits.float(), cfg.final_logit_softcap).to(cfg.dtype)
        if kv_cache is not None:
            return (logits, kv_cache, moe_aux) if return_moe_aux else (logits, kv_cache)
        return (logits, moe_aux) if return_moe_aux else logits
