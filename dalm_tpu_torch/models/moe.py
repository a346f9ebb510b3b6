"""Sparse Mixture-of-Experts MLP (counterpart of ``dalm_tpu/models/moe.py``): Mixtral, Qwen3-MoE, DeepSeek-V3.

- **Routers.** ``route_topk`` (Mixtral / Qwen3-MoE, ``moe.py:56``): an f32 softmax over every expert, the top-k
  of the probabilities, renormalised over the k when ``norm_topk``. ``route_noaux_tc`` (DeepSeek-V3, ``:69``):
  sigmoid scores; the ``e_score_correction_bias`` is added for the choice only; experts fall into ``n_group``
  groups scored by the sum of their top-2, the ``topk_group`` best groups stay eligible, then top-k; the weights
  are the raw sigmoid scores, normalised with ``+1e-20`` when ``norm_topk`` and times ``scaling``.
- **The block** (``MoEBlock``, ``:100``): the router in the model dtype, or in f32 for ``noaux_tc``; SwiGLU (or the
  config's activation) experts as stacked raw parameters ``w_gate`` / ``w_up`` (E, H, M) and ``w_down`` (E, M, H);
  DeepSeek-V3's shared experts ``shared_gate`` / ``shared_up`` (H, n·M) and ``shared_down`` (n·M, H), added to the
  routed sum; the Switch load-balancing value ``E · Σ_e frac_e · mean_prob_e`` over all B·S tokens, pads included,
  returned beside the output (0 for ``noaux_tc``, which is aux-free).
- **Two computations of the routed sum**, ``moe_impl`` "dense", "dispatch" or "auto" (dense with a KV cache, so a
  prefill with a cache too, else dispatch; ``:195-208``):

  * dense (``:210-222``): every expert on every token, combined by the (T, E) gate matrix whose untouched entries
    are exact zeros. Up to ``DENSE_ALL_TOKENS`` tokens (decode, a verify pass) it is the reference's formula, three
    batched matmuls over all E experts. Above it, the same sum is taken over the touched experts only
    (``_by_index`` without capacity): at an admission prefill of 8,192 tokens the all-expert form would hold
    (E, T, H) = 4.3 GB at Qwen3-30B-A3B's width;
  * dispatch (``:224-271``): GShard groups of ``moe_group_size`` tokens, capacity
    ``C = min(g, max(1, ceil(g·K·cf / E)))`` per expert and group (``C = g``, dropless, when ``moe_capacity_factor``
    is None). The reference builds a one-hot (G, g·K, E, C) dispatch tensor (34 GB at Qwen3-30B-A3B over 8,192
    tokens); here the same function is computed by index: an assignment's slot is the number of earlier
    assignments (token-major order, the k-th choice of token t is assignment t·K + k) to the same expert in its
    group; it is kept when its slot is below C; a dropped assignment adds nothing, pads (the last group's tail)
    take no capacity. The kept assignments are sorted by expert, each expert runs once on its rows, and the
    outputs go back to their (token, k) rows, summed over k in the model dtype as the reference sums them.

Attribute names follow flax's (``router``, ``w_gate``, ``w_up``, ``w_down``, ``e_score_correction_bias``,
``shared_*``), so ``interop.state_dict_for`` carries a JAX tree across by name. The experts and the router are raw
parameters: they take no LoRA (``lora.py`` adapts ``kernel`` leaves only) and no 4-bit packing, as in the
reference (``quant.py:204-227`` packs 2-D ``kernel`` leaves).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

MOE_IMPLS = ("auto", "dense", "dispatch")
MOE_ROUTERS = ("softmax", "noaux_tc")
# The dense path's all-expert form holds (E, T, max(H, M)) at once: up to this many tokens it runs as the reference
# writes it; above, over the touched experts only (the same sum). Chosen for memory, not speed: (E, T, H) is 268 MB
# at Qwen3-30B-A3B's width and 512 tokens. chip_smoke.py's serve-moe times both forms at 32 to 2,048 tokens.
DENSE_ALL_TOKENS = 512

_ACTS = {
    "silu": F.silu,
    "gelu_tanh": lambda z: F.gelu(z, approximate="tanh"),
    "gelu": F.gelu,
}


def route_topk(router_logits: torch.Tensor, k: int, norm_topk: bool):
    """(T, E) logits -> (weights (T, k) f32, indices (T, k) int64): f32 softmax over every expert, top-k, renormalised
    over the k when ``norm_topk``."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    weights, idx = torch.topk(probs, k, dim=-1)
    if norm_topk:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, idx


def route_noaux_tc(router_logits: torch.Tensor, bias: torch.Tensor, k: int, n_group: int, topk_group: int,
                   norm_topk: bool, scaling: float):
    """DeepSeek-V3's group-limited routing (HF ``DeepseekV3TopkRouter``). (T, E) f32 logits -> (weights (T, k) f32,
    indices (T, k) int64)."""
    T, E = router_logits.shape
    scores = torch.sigmoid(router_logits)
    choice = scores + bias[None, :]
    group_scores = torch.topk(choice.view(T, n_group, E // n_group), 2, dim=-1).values.sum(dim=-1)  # (T, G)
    gidx = torch.topk(group_scores, topk_group, dim=-1).indices
    group_mask = torch.zeros_like(group_scores).scatter_(1, gidx, 1.0)
    score_mask = group_mask.repeat_interleave(E // n_group, dim=-1)  # (T, E)
    masked = torch.where(score_mask > 0, choice, torch.zeros_like(choice))
    idx = torch.topk(masked, k, dim=-1).indices
    weights = torch.gather(scores, 1, idx)
    if norm_topk:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return weights * scaling, idx


def capacity(cfg: Any, T: int) -> tuple:
    """(group size, capacity per expert and group) of the dispatch path over T tokens (``moe.py:233-240``)."""
    g_size = min(cfg.moe_group_size or T, T)
    cf = cfg.moe_capacity_factor
    if cf is None:
        return g_size, g_size
    return g_size, min(g_size, max(1, math.ceil(g_size * cfg.num_experts_per_tok * float(cf) / cfg.num_experts)))


def dispatch_slots(idx: torch.Tensor, num_experts: int, g_size: int) -> torch.Tensor:
    """(T, K) expert indices -> (T, K) slots: assignment t·K + k's rank among the earlier assignments of its group
    (tokens ``[g·g_size, (g + 1)·g_size)``) to the same expert, in token-major order."""
    T, K = idx.shape
    group = torch.arange(T, device=idx.device).div(g_size, rounding_mode="floor")[:, None].expand(T, K)
    key = (group * num_experts + idx).reshape(-1)
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    start = torch.ones_like(sk, dtype=torch.bool)
    start[1:] = sk[1:] != sk[:-1]
    pos = torch.arange(sk.numel(), device=idx.device)
    first = torch.cummax(torch.where(start, pos, torch.zeros_like(pos)), dim=0).values
    slots = torch.empty_like(key)
    slots[order] = pos - first
    return slots.view(T, K)


class MoEBlock(nn.Module):
    """Sparse MoE MLP with stacked raw expert parameters; ``forward(x, decode)`` -> (out, aux)."""

    def __init__(self, cfg: Any, device=None):
        super().__init__()
        if cfg.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl must be one of {MOE_IMPLS}, not {cfg.moe_impl!r}")
        if cfg.moe_router not in MOE_ROUTERS:
            raise ValueError(f"moe_router must be one of {MOE_ROUTERS}, not {cfg.moe_router!r}")
        self.cfg = cfg
        self.act = _ACTS[cfg.hidden_act]
        E, H = cfg.num_experts, cfg.hidden_size
        M = cfg.moe_intermediate_size or cfg.intermediate_size
        pd = cfg.param_dtype

        def param(*shape, dtype=pd):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))

        self.router = param(H, E)
        if cfg.moe_router == "noaux_tc":
            # a checkpoint buffer in HF; a parameter here as in the reference (choice only: no gradient reaches it)
            self.e_score_correction_bias = nn.Parameter(torch.zeros(E, dtype=torch.float32, device=device))
        self.w_gate = param(E, H, M)
        self.w_up = param(E, H, M)
        self.w_down = param(E, M, H)
        if cfg.moe_n_shared_experts:
            Ms = M * cfg.moe_n_shared_experts
            self.shared_gate = param(H, Ms)
            self.shared_up = param(H, Ms)
            self.shared_down = param(Ms, H)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun-normal draws (std ``fan_in ** -0.5``, the reference's initialiser without its truncation) for the
        router and the experts, zeros for the correction bias. A stacked parameter is drawn one expert at a time,
        so the f32 draw never holds more than one expert's matrix."""
        for name, p in self.named_parameters(recurse=False):
            with torch.no_grad():
                if name == "e_score_correction_bias":
                    p.zero_()
                    continue
                for part in (p if p.dim() == 3 else p[None]):
                    draw = torch.randn(part.shape, generator=generator, device=generator.device, dtype=torch.float32)
                    part.copy_((draw * part.shape[0] ** -0.5).to(device=p.device, dtype=p.dtype))

    def forward(self, x: torch.Tensor, decode: bool = False) -> tuple:
        cfg = self.cfg
        B, S, H = x.shape
        E, K = cfg.num_experts, cfg.num_experts_per_tok
        T = B * S
        x2 = x.reshape(T, H)
        if cfg.moe_router == "noaux_tc":
            router_logits = x2.float() @ self.router.float()
            gate_w, idx = route_noaux_tc(router_logits, self.e_score_correction_bias.float(), K,
                                         cfg.moe_n_group or 1, cfg.moe_topk_group or 1, cfg.norm_topk_prob,
                                         cfg.moe_routed_scaling_factor)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            router_logits = x2 @ self.router.to(cfg.dtype)
            gate_w, idx = route_topk(router_logits, K, cfg.norm_topk_prob)
            # f_e from the pre-capacity assignments (no gradient), mean_prob with one
            assign_frac = torch.bincount(idx.reshape(-1), minlength=E).float() / idx.numel()
            mean_prob = torch.softmax(router_logits.float(), dim=-1).mean(dim=0)
            aux = float(E) * torch.sum(assign_frac * mean_prob)

        impl = cfg.moe_impl
        if impl == "auto":
            impl = "dense" if decode else "dispatch"
        if impl == "dense" and T <= DENSE_ALL_TOKENS:
            out = self._dense_all(x2, gate_w, idx)
        elif impl == "dense":
            out = self._by_index(x2, gate_w, idx, None)
        else:
            g_size, C = capacity(cfg, T)
            keep = dispatch_slots(idx, E, g_size) < C
            out = self._by_index(x2, gate_w, idx, keep)
        if cfg.moe_n_shared_experts:
            d = cfg.dtype
            shared = (self.act(x2 @ self.shared_gate.to(d)) * (x2 @ self.shared_up.to(d))) @ self.shared_down.to(d)
            out = out + shared
        return out.reshape(B, S, H).to(x.dtype), aux

    def _dense_all(self, x2: torch.Tensor, gate_w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The reference's dense formula: every expert on every token, combined by the (T, E) gate matrix."""
        d = self.cfg.dtype
        full_gate = torch.zeros((x2.shape[0], self.cfg.num_experts), dtype=torch.float32, device=x2.device)
        full_gate = full_gate.scatter(1, idx, gate_w)
        g = x2 @ self.w_gate.to(d)  # (E, T, M)
        u = x2 @ self.w_up.to(d)
        y = (self.act(g) * u) @ self.w_down.to(d)  # (E, T, H)
        return torch.einsum("eth,te->th", y, full_gate.to(d))

    def _by_index(self, x2: torch.Tensor, gate_w: torch.Tensor, idx: torch.Tensor, keep) -> torch.Tensor:
        """sum_k keep[t, k] · gate_w[t, k] · expert_{idx[t, k]}(x[t]), each expert run once on its kept rows;
        ``keep`` None keeps every assignment."""
        d = self.cfg.dtype
        T, K = idx.shape
        flat = idx.reshape(-1)
        rows = torch.arange(T * K, device=x2.device)
        if keep is not None:
            kept = keep.reshape(-1)
            flat, rows = flat[kept], rows[kept]
        order = torch.sort(flat, stable=True).indices
        flat, rows = flat[order], rows[order]
        counts = torch.bincount(flat, minlength=self.cfg.num_experts).tolist()
        xs = x2.index_select(0, rows.div(K, rounding_mode="floor"))
        outs, at = [], 0
        for e, n in enumerate(counts):
            if n:
                xe = xs[at:at + n]
                h = self.act(xe @ self.w_gate[e].to(d)) * (xe @ self.w_up[e].to(d))
                outs.append(h @ self.w_down[e].to(d))
            at += n
        y_rep = torch.zeros((T * K, x2.shape[1]), dtype=d, device=x2.device)
        if outs:
            y_rep = y_rep.index_put((rows,), torch.cat(outs).to(d))
        return torch.sum(y_rep.view(T, K, -1) * gate_w.to(d)[:, :, None], dim=1)
