"""BERT-class bidirectional encoder (counterpart of ``dalm_tpu/models/encoder.py``).

Post-LN BERT: word + position (``arange``) + token-type (zeros)
embeddings, LayerNorm (eps 1e-12), then layers of self-attention and an
exact-GELU MLP, each followed by a residual LayerNorm. Parameter names
mirror the flax tree (``layer_0.attention.query.kernel`` …) so the JAX
weights carry across through ``dalm_tpu_torch/interop.py`` leaf for leaf.

Dropout (``hidden_dropout`` after the embeddings' norm, the attention
output and the MLP; ``attention_dropout`` on the attention probabilities,
as ``dalm_tpu/models/encoder.py:113-114,129-140,191-192`` place it) runs
only when ``forward`` is handed a ``dropout_generator``: each value is kept
with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, flax's
``nn.Dropout``. Without one the encoder is deterministic, as the reference's
``embed`` is. The draws come from the port's generator, not JAX's keys: the
masks differ between the packages, their rates and scaling do not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dalm_tpu_torch.models.layers import FlexLinear, _normal_


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 4
    intermediate_size: int = 1024
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    # "fwd" | "all": int8 kernels for layers with int8 storage (models/layers.py).
    int8_compute: str = "none"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny(vocab_size: int = 512) -> "EncoderConfig":
        return EncoderConfig(
            vocab_size=vocab_size, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128, max_position_embeddings=128,
        )

    @staticmethod
    def bge_small() -> "EncoderConfig":
        return EncoderConfig(
            vocab_size=30522, hidden_size=384, num_layers=12, num_heads=12,
            intermediate_size=1536, max_position_embeddings=512,
        )

    @staticmethod
    def bge_large() -> "EncoderConfig":
        return EncoderConfig(
            vocab_size=30522, hidden_size=1024, num_layers=24, num_heads=16,
            intermediate_size=4096, max_position_embeddings=512,
        )


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keep each value with probability ``1 - rate``, scaled by ``1 / (1 - rate)``; the identity without a
    generator or at rate 0. The mask is drawn from ``generator`` (on ``x``'s device)."""
    if generator is None or rate <= 0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Embed(nn.Module):
    """Lookup table with the flax parameter name ``embedding``."""

    def __init__(self, num: int, features: int, dtype, param_dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, features, dtype=param_dtype, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.embedding, 0.02, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding).to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` twin: statistics in f32, ``scale``/``bias``."""

    def __init__(self, features: int, eps: float, dtype, param_dtype, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.scale.float(), self.bias.float(), self.eps)
        return y.to(self.dtype)


def _dense(cfg: EncoderConfig, n_in: int, n_out: int, device) -> FlexLinear:
    return FlexLinear(n_in, n_out, use_bias=True, dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device,
                      int8_compute=cfg.int8_compute)


class EncoderSelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.query = _dense(cfg, h, h, device)
        self.key = _dense(cfg, h, h, device)
        self.value = _dense(cfg, h, h, device)
        self.output = _dense(cfg, h, h, device)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """hidden (B, S, H); bias (B, 1, 1, S) f32 additive mask."""
        cfg = self.cfg
        B, S, _ = hidden.shape
        nh, hd = cfg.num_heads, cfg.head_dim
        # (B, S, nh, hd) → (B, nh, S, hd) for batched matmuls.
        q = self.query(hidden).view(B, S, nh, hd).transpose(1, 2)
        k = self.key(hidden).view(B, S, nh, hd).transpose(1, 2)
        v = self.value(hidden).view(B, S, nh, hd).transpose(1, 2)
        scores = (q @ k.transpose(-1, -2)) / torch.tensor(math.sqrt(hd), dtype=cfg.dtype)
        probs = torch.softmax(scores.float() + bias, dim=-1).to(cfg.dtype)
        probs = dropout(probs, cfg.attention_dropout, dropout_generator)
        ctx = (probs @ v).transpose(1, 2).reshape(B, S, nh * hd)
        return self.output(ctx)


class EncoderLayer(nn.Module):
    """Post-LN transformer block (BERT layout)."""

    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.attention = EncoderSelfAttention(cfg, device)
        self.attention_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, cfg.param_dtype, device)
        self.intermediate = _dense(cfg, cfg.hidden_size, cfg.intermediate_size, device)
        self.mlp_output = _dense(cfg, cfg.intermediate_size, cfg.hidden_size, device)
        self.mlp_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, cfg.param_dtype, device)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.attention.cfg.hidden_dropout
        attn = dropout(self.attention(hidden, bias, dropout_generator), rate, dropout_generator)
        hidden = self.attention_norm(hidden + attn)
        mlp = self.mlp_output(F.gelu(self.intermediate(hidden), approximate="none"))
        return self.mlp_norm(hidden + dropout(mlp, rate, dropout_generator))


class Encoder(nn.Module):
    """Returns final hidden states (B, L, H); pool with models/pooling.py."""

    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = Embed(cfg.vocab_size, h, cfg.dtype, cfg.param_dtype, device)
        self.position_embeddings = Embed(cfg.max_position_embeddings, h, cfg.dtype, cfg.param_dtype, device)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, h, cfg.dtype, cfg.param_dtype, device)
        self.embeddings_norm = LayerNorm(h, cfg.layer_norm_eps, cfg.dtype, cfg.param_dtype, device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg, device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        hidden = self.embeddings_norm(
            self.word_embeddings(input_ids)
            + self.position_embeddings(pos_ids)
            + self.token_type_embeddings(token_type_ids)
        )
        hidden = dropout(hidden, cfg.hidden_dropout, dropout_generator)
        # Additive mask bias in f32: 0 where attended, finfo(f32).min elsewhere.
        bias = torch.where(
            attention_mask[:, None, None, :] > 0,
            torch.zeros((), dtype=torch.float32, device=hidden.device),
            torch.tensor(torch.finfo(torch.float32).min, device=hidden.device),
        )
        for i in range(cfg.num_layers):
            hidden = getattr(self, f"layer_{i}")(hidden, bias, dropout_generator)
        return hidden
