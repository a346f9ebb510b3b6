"""Multi-head latent attention, DeepSeek-V2 / V3 (counterpart of ``dalm_tpu/models/mla.py``).

Every token keeps one shared compressed latent ``c`` (``kv_lora_rank`` wide, RMS-normed) and one shared rope key
``k_pe`` (``qk_rope_head_dim`` wide); per-head keys and values are linear in the latent through ``kv_b_proj``, a
raw ``(r, nh·(dn + dv))`` parameter (HF's weight after the loader's transpose). Queries come from a direct
``q_proj`` or, with ``q_lora_rank``, from ``q_a_proj`` -> ``q_a_norm`` -> ``q_b_proj``. The rope slices are
de-interleaved first when the checkpoint stores them pair-interleaved (``rope_interleave``). The scale is
``qk_head_dim ** -0.5 · attn_scale_mult`` (YaRN's mscale squared lands there).

Two paths, equal by the linearity of ``kv_b``, both on plain matmuls as the reference's einsums (``mla.py:134-156``;
MLA takes no K4 instance):

- without a cache (training, a full forward): the latent is decompressed to per-head keys and values, and
  attention runs over them (``:144-156``);
- with a cache (``{"k": (B, L, r), "pe": (B, L, d_rope)}``, written in place by the decoder's ``_cache_write``):
  the absorbed form (``:134-143``): ``kv_b``'s key half folds into the query, scores run against the latent cache
  directly, and its value half folds into the output after the probability-weighted latent sum.

No ring attention and no sliding window, as the reference asserts (``:80-81``; the decoder rejects both).
Attribute names follow flax's (``q_proj`` / ``q_a_proj``, ``q_a_norm``, ``q_b_proj``, ``kv_a_proj``,
``kv_a_norm``, ``kv_b_proj``, ``o_proj``).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn


def deinterleave_rope(x: torch.Tensor) -> torch.Tensor:
    """Pair-interleaved lanes [re0, im0, re1, im1, ...] -> [re..., im...] (``mla.py:49``)."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


class MLAAttention(nn.Module):
    """The decoder's attention when ``cfg.kv_lora_rank`` is set; the same call contract as ``DecoderAttention``:
    (hidden, mask (B, 1, Sq, Sk), cos, sin, kv_cache, cache_index, segment_mask) -> out."""

    def __init__(self, cfg: Any, layer_idx: int = 0, device=None):
        super().__init__()
        from dalm_tpu_torch.models.decoder import RMSNorm, _proj

        self.cfg = cfg
        self.layer_idx = layer_idx
        h, nh, r = cfg.hidden_size, cfg.num_heads, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        ab = cfg.attention_bias
        if cfg.q_lora_rank:
            self.q_a_proj = _proj(cfg, h, cfg.q_lora_rank, device, ab)
            self.q_a_norm = RMSNorm(cfg.q_lora_rank, cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype, device)
            self.q_b_proj = _proj(cfg, cfg.q_lora_rank, nh * (dn + dr), device)
        else:
            self.q_proj = _proj(cfg, h, nh * (dn + dr), device)
        self.kv_a_proj = _proj(cfg, h, r + dr, device, ab)
        self.kv_a_norm = RMSNorm(r, cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype, device)
        self.kv_b_proj = nn.Parameter(torch.empty((r, nh * (dn + dv)), dtype=cfg.param_dtype, device=device))
        self.o_proj = _proj(cfg, nh * dv, h, device, ab)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """``kv_b_proj`` by lecun-normal (std ``r ** -0.5``, the reference's initialiser untruncated); the
        projections and norms reset themselves."""
        p = self.kv_b_proj
        with torch.no_grad():
            draw = torch.randn(p.shape, generator=generator, device=generator.device, dtype=torch.float32)
            p.copy_((draw * p.shape[0] ** -0.5).to(device=p.device, dtype=p.dtype))

    def forward(self, hidden, mask, cos, sin, kv_cache=None, cache_index=None, segment_mask=None):
        from dalm_tpu_torch.models.decoder import _cache_write, apply_rope

        cfg = self.cfg
        B, S, _ = hidden.shape
        nh, r = cfg.num_heads, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        scale = torch.tensor((dn + dr) ** -0.5 * cfg.attn_scale_mult, dtype=cfg.dtype)

        if cfg.q_lora_rank:
            q = self.q_b_proj(self.q_a_norm(self.q_a_proj(hidden)))
        else:
            q = self.q_proj(hidden)
        q = q.view(B, S, nh, dn + dr)
        q_nope, q_pe = q[..., :dn], q[..., dn:]
        if cfg.rope_interleave:
            q_pe = deinterleave_rope(q_pe)
        q_pe = apply_rope(q_pe, cos, sin)

        ckv = self.kv_a_proj(hidden)
        c, k_pe = self.kv_a_norm(ckv[..., :r]), ckv[..., r:]  # the normed latent is what the cache holds
        if cfg.rope_interleave:
            k_pe = deinterleave_rope(k_pe)
        k_pe = apply_rope(k_pe[:, :, None, :], cos, sin)[:, :, 0, :]  # (B, S, dr)

        w_kv_b = self.kv_b_proj.to(cfg.dtype).view(r, nh, dn + dv)
        w_k, w_v = w_kv_b[..., :dn], w_kv_b[..., dn:]
        neg = torch.tensor(torch.finfo(torch.float32).min, device=hidden.device)
        if kv_cache is not None:
            _cache_write(kv_cache, {"k": c, "pe": k_pe}, cache_index, S)
            c_all, pe_all = kv_cache["k"].to(cfg.dtype), kv_cache["pe"].to(cfg.dtype)
            # absorbed: q through kv_b's key half, scores against the latent cache
            q_lat = torch.einsum("bqnd,rnd->bqnr", q_nope, w_k)
            scores = (torch.einsum("bqnr,btr->bnqt", q_lat, c_all)
                      + torch.einsum("bqnd,btd->bnqt", q_pe, pe_all)) * scale
            probs = torch.softmax(torch.where(mask, scores.float(), neg), dim=-1).to(cfg.dtype)
            ctx_lat = torch.einsum("bnqt,btr->bqnr", probs, c_all)
            ctx = torch.einsum("bqnr,rnd->bqnd", ctx_lat, w_v).reshape(B, S, nh * dv)
        else:
            kv = torch.einsum("btr,rnd->btnd", c, w_kv_b)  # (B, S, nh, dn + dv)
            k = torch.cat([kv[..., :dn], k_pe[:, :, None, :].expand(B, S, nh, dr)], dim=-1)
            qq = torch.cat([q_nope, q_pe], dim=-1)
            scores = torch.einsum("bqhd,bkhd->bhqk", qq, k) * scale
            probs = torch.softmax(torch.where(mask, scores.float(), neg), dim=-1).to(cfg.dtype)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, kv[..., dn:]).reshape(B, S, nh * dv)
        return self.o_proj(ctx)
