"""GPT-2-family decoder (counterpart of ``dalm_tpu/models/gpt2.py``).

Learned absolute positions (``wpe``), pre-LN blocks with biases (``ln_1`` -> ``attn.c_attn`` / ``attn.c_proj``,
``ln_2`` -> ``c_fc`` -> GELU-tanh -> ``mlp_proj``), a final ``ln_f`` and the head tied to ``wte``. The call contract
is ``Decoder``'s (``models/decoder.py``): ``forward(ids, mask)`` -> logits, ``forward(ids, slot_mask, positions,
kv_cache, cache_index)`` -> (logits, kv_cache) with the cache written in place (an ``int`` index or a (B,) tensor,
the engine's slots) under a slot-causal mask, ``train_forward`` with NEFTune noise, ``init_kv_cache`` (``{"k", "v"}``
of (B, L, heads, head_dim)), ``return_hidden`` and ``logits_last_only``; so generation, serving, the engine,
evaluation and SFT take either family. Attention runs on plain matmuls, as the reference's einsums; there is no
flash path, no MoE and no int8 KV cache for this family (the reference has none).

``load_hf_gpt2`` reads an HF GPT-2 checkpoint: its ``Conv1D`` weights are already (in, out), the flax layout, so
they are not transposed (``gpt2.py:240``). Parameter names follow flax's, so ``interop.load_params`` carries a JAX
tree across.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch
from torch import nn

from dalm_tpu_torch.models.encoder import Embed, LayerNorm
from dalm_tpu_torch.models.layers import FlexLinear


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny(vocab_size: int = 512) -> "GPT2Config":
        return GPT2Config(vocab_size=vocab_size, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
                          max_position_embeddings=128)

    @staticmethod
    def gpt2_124m() -> "GPT2Config":
        return GPT2Config()


def _dense(cfg: GPT2Config, n_in: int, n_out: int, device) -> FlexLinear:
    return FlexLinear(n_in, n_out, use_bias=True, dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)


class GPT2Attention(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.c_attn = _dense(cfg, cfg.hidden_size, 3 * cfg.hidden_size, device)
        self.c_proj = _dense(cfg, cfg.hidden_size, cfg.hidden_size, device)

    def forward(self, hidden, mask, kv_cache=None, cache_index=None):
        from dalm_tpu_torch.models.decoder import _cache_write

        cfg = self.cfg
        B, S, _ = hidden.shape
        nh, hd = cfg.num_heads, cfg.head_dim
        q, k, v = (t.reshape(B, S, nh, hd) for t in torch.chunk(self.c_attn(hidden), 3, dim=-1))
        if kv_cache is not None:
            _cache_write(kv_cache, {"k": k, "v": v}, cache_index, S)
            k, v = kv_cache["k"].to(cfg.dtype), kv_cache["v"].to(cfg.dtype)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(math.sqrt(hd), dtype=cfg.dtype)
        scores = torch.where(mask, scores.float(), torch.tensor(torch.finfo(torch.float32).min, device=q.device))
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        return self.c_proj(torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, nh * hd))


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ln_1 = LayerNorm(h, eps, cfg.dtype, cfg.param_dtype, device)
        self.attn = GPT2Attention(cfg, device)
        self.ln_2 = LayerNorm(h, eps, cfg.dtype, cfg.param_dtype, device)
        self.c_fc = _dense(cfg, h, cfg.intermediate_size, device)
        self.mlp_proj = _dense(cfg, cfg.intermediate_size, h, device)

    def forward(self, hidden, mask, kv_cache=None, cache_index=None):
        hidden = hidden + self.attn(self.ln_1(hidden), mask, kv_cache, cache_index)
        mlp = torch.nn.functional.gelu(self.c_fc(self.ln_2(hidden)), approximate="tanh")  # GPT-2's gelu_new
        return hidden + self.mlp_proj(mlp)


class GPT2Decoder(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.wte = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype, cfg.param_dtype, device)
        self.wpe = Embed(cfg.max_position_embeddings, cfg.hidden_size, cfg.dtype, cfg.param_dtype, device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", GPT2Block(cfg, device))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, cfg.param_dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal(0.02) kernels and embeddings, zero biases, unit LayerNorms (the reference's initialisers)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def init_kv_cache(self, batch_size: int, max_len: int, dtype=None, device=None) -> dict:
        cfg = self.cfg
        dtype = dtype or cfg.dtype
        device = device or self.ln_f.scale.device
        shape = (batch_size, max_len, cfg.num_heads, cfg.head_dim)
        return {f"layer_{i}": {"k": torch.zeros(shape, dtype=dtype, device=device),
                               "v": torch.zeros(shape, dtype=dtype, device=device)}
                for i in range(cfg.num_layers)}

    def uses_flash(self, seq_len: int, cached: bool = False) -> bool:
        return False

    @torch.no_grad()
    def forward(self, input_ids, attention_mask=None, positions=None, kv_cache=None, cache_index=None,
                return_hidden: bool = False, logits_last_only: bool = False):
        """Inference (no gradient): logits (B, S, V), or (logits, kv_cache) with a cache."""
        return self._run(input_ids, attention_mask, positions, kv_cache, cache_index, return_hidden,
                         logits_last_only)

    def train_forward(self, input_ids, attention_mask=None, neftune_alpha: float = 0.0,
                      noise_generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None,
                      return_hidden: bool = False):
        """Training: full-sequence logits with gradients, NEFTune as ``Decoder.train_forward``."""
        if neftune_alpha > 0.0 and noise is None and noise_generator is not None:
            B, S = input_ids.shape
            noise = torch.rand((B, S, self.cfg.hidden_size), generator=noise_generator, device=input_ids.device,
                               dtype=torch.float32) * 2.0 - 1.0
        if not neftune_alpha > 0.0:
            noise = None
        return self._run(input_ids, attention_mask, None, None, None, return_hidden, False, neftune_alpha, noise)

    def _run(self, input_ids, attention_mask, positions, kv_cache, cache_index, return_hidden, logits_last_only,
             neftune_alpha=0.0, noise=None):
        cfg = self.cfg
        B, S = input_ids.shape
        dev = input_ids.device
        if kv_cache is not None:
            base = cache_index.long()[:, None] if torch.is_tensor(cache_index) else torch.tensor([[cache_index]],
                                                                                                 device=dev)
            q_slot = (base + torch.arange(S, device=dev)).expand(B, S)
            if torch.is_tensor(cache_index):
                cache_index = q_slot[:, 0]
        if positions is None:
            if kv_cache is not None:
                positions = q_slot
            elif attention_mask is not None:
                positions = torch.clamp(torch.cumsum(attention_mask, dim=1) - 1, min=0)
            else:
                positions = torch.arange(S, device=dev)[None, :].expand(B, S)
        hidden = self.wte(input_ids) + self.wpe(positions)
        if noise is not None:
            scale = neftune_alpha / math.sqrt(S * cfg.hidden_size)
            hidden = hidden + (noise.to(device=dev, dtype=torch.float32) * scale).to(hidden.dtype)
        if kv_cache is not None:
            k_at = torch.arange(kv_cache["layer_0"]["k"].shape[1], device=dev)[None, None, None, :]
            q_at = q_slot[:, None, :, None]
        else:
            k_at, q_at = positions[:, None, None, :], positions[:, None, :, None]
        mask = k_at <= q_at
        if attention_mask is not None:
            mask = mask & (attention_mask[:, None, None, :] > 0)
        for i in range(cfg.num_layers):
            hidden = getattr(self, f"layer_{i}")(hidden, mask, kv_cache[f"layer_{i}"] if kv_cache is not None
                                                 else None, cache_index)
        hidden = self.ln_f(hidden)
        if return_hidden:
            return hidden
        if logits_last_only:
            hidden = hidden[:, -1:, :]
        logits = hidden @ self.wte.embedding.to(cfg.dtype).T  # the head is tied to wte
        return (logits, kv_cache) if kv_cache is not None else logits


def load_hf_gpt2(path: str, dtype=None):
    """An HF GPT-2 directory -> (``GPT2Config``, flax-named parameter tree of f32 tensors). ``Conv1D`` weights are
    (in, out) already: no transpose. An optional ``transformer.`` prefix (``GPT2LMHeadModel``) is dropped."""
    from dalm_tpu_torch.core.dtypes import parse_dtype
    from dalm_tpu_torch.models.hf_loader import open_hf_state, read_hf_config

    hf = read_hf_config(path)
    cfg = GPT2Config(vocab_size=hf["vocab_size"], hidden_size=hf["n_embd"], num_layers=hf["n_layer"],
                     num_heads=hf["n_head"], intermediate_size=hf.get("n_inner") or 4 * hf["n_embd"],
                     max_position_embeddings=hf["n_positions"], layer_norm_eps=hf.get("layer_norm_epsilon", 1e-5))
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=parse_dtype(dtype))
    state = open_hf_state(path)
    try:
        pre = "transformer." if any(k.startswith("transformer.") for k in state.keys()) else ""

        def arr(name):
            return state[pre + name].to(torch.float32).contiguous()

        def dense(name):
            return {"kernel": arr(f"{name}.weight"), "bias": arr(f"{name}.bias")}

        def norm(name):
            return {"scale": arr(f"{name}.weight"), "bias": arr(f"{name}.bias")}

        params = {"wte": {"embedding": arr("wte.weight")}, "wpe": {"embedding": arr("wpe.weight")},
                  "ln_f": norm("ln_f")}
        for i in range(cfg.num_layers):
            h = f"h.{i}"
            params[f"layer_{i}"] = {
                "ln_1": norm(f"{h}.ln_1"), "ln_2": norm(f"{h}.ln_2"),
                "attn": {"c_attn": dense(f"{h}.attn.c_attn"), "c_proj": dense(f"{h}.attn.c_proj")},
                "c_fc": dense(f"{h}.mlp.c_fc"), "mlp_proj": dense(f"{h}.mlp.c_proj"),
            }
    finally:
        if hasattr(state, "close"):
            state.close()
    return cfg, params


def is_hf_gpt2(path: str) -> bool:
    """Whether ``path`` holds an HF checkpoint whose ``config.json`` names ``model_type`` gpt2."""
    from dalm_tpu_torch.models.hf_loader import read_hf_config

    return os.path.exists(os.path.join(path, "config.json")) and read_hf_config(path).get("model_type") == "gpt2"
