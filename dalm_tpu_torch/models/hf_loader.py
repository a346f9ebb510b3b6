"""Hugging Face checkpoints in, PEFT adapters out (counterpart of ``dalm_tpu/models/hf_loader.py``).

Reading: a local HF directory (``config.json`` + ``model.safetensors`` or ``pytorch_model.bin``) becomes the
port's config and a parameter tree named as the flax one, so ``interop.load_params`` (or, flattened,
``load_state_dict``) takes it: ``load_hf_encoder`` for BERT-family encoders (bge), ``load_hf_decoder`` for the dense
decoder families (Llama-2 / 3 / 3.1, Mistral, Phi-3 with its fused ``qkv_proj`` / ``gate_up_proj`` split, Qwen2 /
2.5 / 3, Gemma / 2 / 3-text), with every rejection of the reference (``hf_loader.py:135-230``, ``:390``). torch
``nn.Linear`` stores (out, in); the kernels come out transposed to the flax (in, out) layout, every leaf in f32.
The MoE families stack their per-expert tensors into the block's (E, H, M) / (E, M, H) parameters
(``hf_loader.py:495-530``): ``mixtral`` (``block_sparse_moe``, ``w1`` / ``w3`` / ``w2``), ``qwen3_moe`` (``mlp``,
QK-norm; interleaved dense layers rejected) and ``deepseek_v3`` (MLA attention with q-LoRA or a direct ``q_proj``,
the noaux-tc router and its ``e_score_correction_bias``, shared experts, ``first_k_dense_replace`` dense layers,
YaRN with mscale / ``mscale_all_dim``; ``:221-270``). GPT-2 checkpoints load through ``models/gpt2.py``.

``safetensors`` files are read by this module's own reader, :class:`SafetensorsFile` (an 8-byte little-endian
header length, a JSON header, raw little-endian tensors; BF16 through ``torch.frombuffer``), over a private
memory map, one tensor at a time; ``.bin`` files through ``torch.load(weights_only=True, mmap=True)``.

Export: ``export_peft_adapter`` writes ``adapter_model.bin`` (a ``torch.save`` dict) and ``adapter_config.json`` in
the layout torch-PEFT loads: the merge math is PEFT's (``W + alpha / r * A @ B``), PEFT keeps ``lora_A.weight`` as
(r, in) and ``lora_B.weight`` as (out, r), so both factors are transposed on the way out, and the flat adapter's
``layer_i/<module>/kernel`` paths become the Hugging Face module paths of a decoder (``model.layers.<i>.self_attn.
<module>``, every dense family alike, as the reference writes them) or of a BERT encoder.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import mmap
import os
import struct
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
              "BOOL": torch.bool}


class SafetensorsFile:
    """A ``.safetensors`` file, read one tensor at a time: ``keys()``, ``[name]`` (a CPU tensor of the stored
    type, copied out of the map), ``metadata``. Use as a context manager or call ``close()``."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        try:
            head = self._f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
            n = struct.unpack("<Q", head)[0]
            header = json.loads(self._f.read(n))
            self.metadata = header.pop("__metadata__", None)
            self.entries = header
            self._base = 8 + n
            size = os.fstat(self._f.fileno()).st_size
            for name, e in header.items():
                lo, hi = e["data_offsets"]
                if e["dtype"] not in _ST_DTYPES:
                    raise ValueError(f"{path}: {name} has dtype {e['dtype']}, which is not read")
                numel = 1
                for d in e["shape"]:
                    numel *= d
                if hi - lo != numel * _ST_DTYPES[e["dtype"]].itemsize or self._base + hi > size:
                    raise ValueError(f"{path}: {name}'s byte range does not fit its shape or the file")
            # ACCESS_COPY: a private, writable view (torch.frombuffer wants one); nothing is written back
            self._map = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_COPY) if size > self._base else None
        except BaseException:
            self._f.close()
            raise

    def keys(self):
        return self.entries.keys()

    def __getitem__(self, name: str) -> torch.Tensor:
        e = self.entries[name]
        dtype, shape = _ST_DTYPES[e["dtype"]], tuple(e["shape"])
        lo, hi = e["data_offsets"]
        if hi == lo:
            return torch.empty(shape, dtype=dtype)
        flat = torch.frombuffer(self._map, dtype=dtype, count=(hi - lo) // dtype.itemsize, offset=self._base + lo)
        return flat.reshape(shape).clone()

    def close(self) -> None:
        if self._map is not None:
            self._map.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_hf_state(path: str):
    """The checkpoint of an HF directory as a mapping that reads a tensor when it is asked for one:
    ``model.safetensors`` (a :class:`SafetensorsFile`) or ``pytorch_model.bin`` (memory-mapped)."""
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(st_path):
        return SafetensorsFile(st_path)
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True, mmap=True)
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in {path}")


def read_hf_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _kernel(t: torch.Tensor) -> torch.Tensor:
    """A torch Linear weight (out, in) as a flax kernel (in, out), f32 (one pass: the cast writes the transpose)."""
    return t.T.to(torch.float32, memory_format=torch.contiguous_format)


def _stacked_kernels(state, names) -> torch.Tensor:
    """Per-expert Linear weights (out, in) as one (E, in, out) f32 tensor, each cast and transposed into its slot."""
    out = None
    for j, name in enumerate(names):
        t = state[name]
        if out is None:
            out = torch.empty((len(names), t.shape[1], t.shape[0]), dtype=torch.float32)
        out[j].copy_(t.T)
    return out


def _set(tree: dict, path: tuple, value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


# --------------------------------------------------------------------------
# BERT-family encoder (bge)
# --------------------------------------------------------------------------

def load_hf_encoder(path: str, dtype=None):
    """A BERT-family HF directory → (``EncoderConfig``, flax-named parameter tree of f32 tensors)."""
    from dalm_tpu_torch.core.dtypes import parse_dtype
    from dalm_tpu_torch.models.encoder import EncoderConfig

    hf = read_hf_config(path)
    cfg = EncoderConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"], num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"], intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf["max_position_embeddings"], type_vocab_size=hf.get("type_vocab_size", 2),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12), hidden_dropout=hf.get("hidden_dropout_prob", 0.1),
        attention_dropout=hf.get("attention_probs_dropout_prob", 0.1),
    )
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=parse_dtype(dtype))
    state = open_hf_state(path)
    # An optional "bert." wrapper prefix (BertModel vs BertFor*).
    pre = "bert." if any(k.startswith("bert.") for k in state.keys()) else ""

    def W(name):
        return _kernel(state[pre + name])

    def arr(name):
        return _f32(state[pre + name])

    def dense(name):
        return {"kernel": W(f"{name}.weight"), "bias": arr(f"{name}.bias")}

    def norm(name):
        return {"scale": arr(f"{name}.weight"), "bias": arr(f"{name}.bias")}

    params = {
        "word_embeddings": {"embedding": arr("embeddings.word_embeddings.weight")},
        "position_embeddings": {"embedding": arr("embeddings.position_embeddings.weight")},
        "token_type_embeddings": {"embedding": arr("embeddings.token_type_embeddings.weight")},
        "embeddings_norm": norm("embeddings.LayerNorm"),
    }
    for i in range(cfg.num_layers):
        hl = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "attention": {
                "query": dense(f"{hl}.attention.self.query"), "key": dense(f"{hl}.attention.self.key"),
                "value": dense(f"{hl}.attention.self.value"), "output": dense(f"{hl}.attention.output.dense"),
            },
            "attention_norm": norm(f"{hl}.attention.output.LayerNorm"),
            "intermediate": dense(f"{hl}.intermediate.dense"),
            "mlp_output": dense(f"{hl}.output.dense"),
            "mlp_norm": norm(f"{hl}.output.LayerNorm"),
        }
    if hasattr(state, "close"):
        state.close()
    logger.info("loaded HF encoder from %s (%d layers, hidden %d)", path, cfg.num_layers, cfg.hidden_size)
    return cfg, params


# --------------------------------------------------------------------------
# the dense decoder families
# --------------------------------------------------------------------------

def hf_decoder_config(hf: dict, dtype=None):
    """An HF decoder ``config.json`` → the port's ``DecoderConfig``, with the reference's rejections."""
    from dalm_tpu_torch.core.dtypes import parse_dtype
    from dalm_tpu_torch.models.decoder import DecoderConfig

    model_type = hf.get("model_type") or ""
    # A bare "gemma3" config is the multimodal wrapper (a vision tower, language_model.* weights).
    if model_type.startswith("gemma") and model_type not in ("gemma", "gemma2", "gemma3_text"):
        raise ValueError(
            f"unsupported gemma-family model_type {model_type!r}: 'gemma' (v1), 'gemma2', and 'gemma3_text' are "
            "implemented (multimodal 'gemma3' wraps a vision tower; extract the text checkpoint / text_config)")
    gemma_family = model_type in ("gemma", "gemma2", "gemma3_text")
    gemma3 = model_type == "gemma3_text"
    # Qwen3 gates all four attention projections (o_proj too) on attention_bias; this decoder biases q/k/v only.
    if model_type in ("qwen3", "qwen3_moe") and hf.get("attention_bias"):
        raise ValueError(f"{model_type} with attention_bias=true puts a bias on o_proj too, which this loader does "
                         "not map; no shipped checkpoint sets it")
    # Qwen3-MoE can interleave dense MLP layers; this decoder makes every layer sparse when num_experts is set
    if model_type == "qwen3_moe" and (hf.get("decoder_sparse_step", 1) != 1 or hf.get("mlp_only_layers")):
        raise ValueError("qwen3_moe with decoder_sparse_step != 1 or non-empty mlp_only_layers interleaves dense MLP "
                         "layers, which this decoder does not implement")
    # deepseek_v3's experts count only when some layer is MoE (first_k_dense_replace below the depth)
    ds_moe = (model_type == "deepseek_v3" and bool(hf.get("n_routed_experts"))
              and hf.get("first_k_dense_replace", 0) < hf["num_hidden_layers"])
    num_experts = {"mixtral": hf.get("num_local_experts"), "qwen3_moe": hf.get("num_experts"),
                   "deepseek_v3": hf.get("n_routed_experts") if ds_moe else None}.get(model_type)
    if model_type == "phi3" and float(hf.get("partial_rotary_factor") or 1.0) != 1.0:
        raise ValueError("phi3 with partial_rotary_factor != 1.0 is not implemented (this decoder rotates the full "
                         "head_dim)")
    rope_scaling_factor = rope_llama3 = rope_yarn = None
    attn_scale_mult = 1.0
    mla = model_type == "deepseek_v3"
    if mla:
        rope_yarn, attn_scale_mult = _deepseek_yarn(hf.get("rope_scaling"), hf)
        hf = dict(hf, rope_scaling=None)  # consumed here, not by the generic branch
    if isinstance(hf.get("rope_scaling"), dict):
        rs = hf["rope_scaling"]
        rs_type = rs.get("rope_type", rs.get("type"))
        if rs_type == "linear":
            rope_scaling_factor = float(rs["factor"])
        elif rs_type == "llama3":
            rope_llama3 = (float(rs["factor"]), float(rs["low_freq_factor"]), float(rs["high_freq_factor"]),
                           float(rs["original_max_position_embeddings"]))
        elif rs_type != "default":
            raise ValueError(f"unsupported rope_scaling type {rs_type!r} for {model_type!r}: only 'linear' and "
                             "'llama3' are implemented (refusing to ignore it silently)")
    sliding = None
    if gemma3:
        layer_types = hf.get("layer_types") or [
            "sliding_attention" if bool((i + 1) % hf.get("sliding_window_pattern", 6)) else "full_attention"
            for i in range(hf["num_hidden_layers"])]
        sliding = tuple(t == "sliding_attention" for t in layer_types)
    # An absent hidden_act means the family default (silu); an explicit null or unknown one raises.
    act_present = "hidden_act" in hf or "hidden_activation" in hf
    act = hf.get("hidden_act", hf.get("hidden_activation"))
    if act_present and act not in ("silu", "gelu", "gelu_pytorch_tanh"):
        raise ValueError(f"unrecognized hidden_act {act!r}; supported: silu, gelu, gelu_pytorch_tanh (refusing to "
                         "default to silu silently)")
    # Gemma's config-level "gelu" means the tanh approximation (HF remaps it); elsewhere "gelu" is the erf form.
    if act == "gelu_pytorch_tanh" or (model_type == "gemma" and act == "gelu"):
        hidden_act = "gelu_tanh"
    else:
        hidden_act = {"silu": "silu", "gelu": "gelu"}.get(hf.get("hidden_act", "silu"), "silu")
    cfg = DecoderConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"], num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"], num_kv_heads=hf.get("num_key_value_heads"),
        intermediate_size=hf["intermediate_size"], max_position_embeddings=hf.get("max_position_embeddings", 4096),
        rope_theta=hf.get("rope_theta", 10000.0), rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        tie_embeddings=hf.get("tie_word_embeddings", gemma_family),  # Gemma writes no key: always tied
        # Qwen2-family configs gate the window on use_sliding_window; Mistral's have no gate
        sliding_window=(hf.get("sliding_window") or None) if hf.get("use_sliding_window", True) else None,
        attention_bias=bool(hf.get("attention_bias", False) or model_type == "qwen2"),
        head_dim_override=hf.get("head_dim"),
        hidden_act=hidden_act,
        scale_embeddings=gemma_family,
        rmsnorm_unit_offset=gemma_family,
        query_pre_attn_scalar=hf.get("query_pre_attn_scalar") if model_type in ("gemma2", "gemma3_text") else None,
        attn_logit_softcap=hf.get("attn_logit_softcapping") if model_type == "gemma2" else None,
        final_logit_softcap=hf.get("final_logit_softcapping") if model_type == "gemma2" else None,
        post_norms=model_type in ("gemma2", "gemma3_text"),
        sliding_layers=sliding if gemma3 else ("even" if model_type == "gemma2" else "all"),
        qk_norm=gemma3 or model_type in ("qwen3", "qwen3_moe"),
        rope_local_theta=hf.get("rope_local_base_freq") if gemma3 else None,
        rope_scaling_factor=rope_scaling_factor,
        rope_llama3=rope_llama3,
        # MoE: Mixtral always renormalises the top-k weights (no config key); Qwen3-MoE gates it on norm_topk_prob
        num_experts=num_experts,
        num_experts_per_tok=hf.get("num_experts_per_tok") or 2,
        moe_intermediate_size=hf.get("moe_intermediate_size"),
        norm_topk_prob=bool(hf.get("norm_topk_prob", True)),
        q_lora_rank=hf.get("q_lora_rank") if mla else None,
        kv_lora_rank=hf.get("kv_lora_rank") if mla else None,
        qk_nope_head_dim=hf.get("qk_nope_head_dim") if mla else None,
        qk_rope_head_dim=hf.get("qk_rope_head_dim") if mla else None,
        v_head_dim=hf.get("v_head_dim") if mla else None,
        rope_interleave=bool(hf.get("rope_interleave", True)) if mla else False,
        rope_yarn=rope_yarn,
        attn_scale_mult=attn_scale_mult,
        moe_router="noaux_tc" if ds_moe else "softmax",
        moe_n_group=hf.get("n_group") if ds_moe else None,
        moe_topk_group=hf.get("topk_group") if ds_moe else None,
        moe_routed_scaling_factor=float(hf.get("routed_scaling_factor", 1.0)) if ds_moe else 1.0,
        moe_n_shared_experts=int(hf.get("n_shared_experts") or 0) if ds_moe else 0,
        moe_layer_start=int(hf.get("first_k_dense_replace", 0)) if ds_moe else 0,
    )
    if model_type == "gemma2" and hf.get("layer_types"):
        expected = ["sliding_attention" if i % 2 == 0 else "full_attention" for i in range(hf["num_hidden_layers"])]
        if list(hf["layer_types"]) != expected:
            raise ValueError(f"gemma2 layer_types deviates from the even-sliding alternation this loader implements: "
                             f"{hf['layer_types']!r}")
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=parse_dtype(dtype))
    return cfg


def _deepseek_yarn(rs, hf: dict) -> tuple:
    """deepseek_v3's ``rope_scaling`` -> (``rope_yarn`` or None, ``attn_scale_mult``) (``hf_loader.py:221-270``):
    YaRN's attention factor is ``mscale / mscale_all_dim`` by DeepSeek's ``get_mscale`` unless given, and
    ``mscale_all_dim`` also multiplies the softmax scale by ``get_mscale(factor, mscale_all_dim) ** 2``; other
    types raise."""
    if rs is None:
        return None, 1.0
    rs_type = rs.get("rope_type", rs.get("type")) if isinstance(rs, dict) else None
    if rs_type != "yarn":
        raise ValueError(f"deepseek_v3 rope_scaling type {rs_type!r} is not implemented (yarn and null are)")

    def get_mscale(scale, ms=1.0):
        return 1.0 if scale <= 1 else 0.1 * ms * math.log(scale) + 1.0

    factor = float(rs["factor"])
    af = rs.get("attention_factor")
    msc, msc_all = rs.get("mscale"), rs.get("mscale_all_dim")
    if af is None:
        af = get_mscale(factor, msc) / get_mscale(factor, msc_all) if msc and msc_all else get_mscale(factor)
    if not rs.get("truncate", True):
        raise ValueError("yarn with truncate=false is not implemented")
    yarn = (factor, float(rs.get("beta_fast") or 32), float(rs.get("beta_slow") or 1),
            float(rs.get("original_max_position_embeddings") or hf.get("max_position_embeddings", 4096)), float(af))
    mult = get_mscale(factor, float(msc_all)) ** 2 if msc_all else 1.0
    return yarn, mult


def _mla_leaves(cfg, hl: str, at: tuple, state):
    """DeepSeek-V3's attention leaves; ``kv_b_proj`` is the raw (r, nh·(dn + dv)) parameter, no ``kernel`` node."""
    sa = f"{hl}.self_attn"
    names = [("kv_a_proj", "kv_a_proj_with_mqa", cfg.attention_bias), ("o_proj", "o_proj", cfg.attention_bias)]
    if cfg.q_lora_rank:
        names += [("q_a_proj", "q_a_proj", cfg.attention_bias), ("q_b_proj", "q_b_proj", False)]
        yield at + ("q_a_norm", "scale"), lambda: _f32(state[f"{sa}.q_a_layernorm.weight"])
    else:
        names.append(("q_proj", "q_proj", False))
    for ours, theirs, bias in names:
        yield at + (ours, "kernel"), lambda theirs=theirs: _kernel(state[f"{sa}.{theirs}.weight"])
        if bias:
            yield at + (ours, "bias"), lambda theirs=theirs: _f32(state[f"{sa}.{theirs}.bias"])
    yield at + ("kv_a_norm", "scale"), lambda: _f32(state[f"{sa}.kv_a_layernorm.weight"])
    yield at + ("kv_b_proj",), lambda: _kernel(state[f"{sa}.kv_b_proj.weight"])


def _moe_leaves(cfg, model_type: str, hl: str, state):
    """An MoE layer's leaves: the router (H, E), the per-expert tensors stacked to (E, H, M) / (E, M, H), the
    noaux-tc correction bias and the shared experts."""
    base, names = (f"{hl}.block_sparse_moe", ("w1", "w3", "w2")) if model_type == "mixtral" else \
        (f"{hl}.mlp", ("gate_proj", "up_proj", "down_proj"))
    at = (hl.replace("model.layers.", "layer_"), "moe")
    yield at + ("router",), lambda: _kernel(state[f"{base}.gate.weight"])
    for ours, theirs in zip(("w_gate", "w_up", "w_down"), names):
        yield at + (ours,), lambda theirs=theirs: _stacked_kernels(
            state, [f"{base}.experts.{j}.{theirs}.weight" for j in range(cfg.num_experts)])
    if cfg.moe_router == "noaux_tc":
        yield at + ("e_score_correction_bias",), lambda: _f32(state[f"{base}.gate.e_score_correction_bias"])
    if cfg.moe_n_shared_experts:
        for ours, theirs in (("shared_gate", "gate_proj"), ("shared_up", "up_proj"), ("shared_down", "down_proj")):
            yield at + (ours,), lambda theirs=theirs: _kernel(state[f"{base}.shared_experts.{theirs}.weight"])


def _attention_leaves(cfg, model_type: str, hl: str, at: tuple, state):
    """The dense families' attention leaves: q / k / v (Phi-3's fused ``qkv_proj`` split), o, the QK-norms."""
    if model_type == "phi3":
        # qkv_proj stacks [q; k; v] rows, gate_up_proj [gate; up] (HF Phi3Attention / Phi3MLP)
        q_rows, kv_rows = cfg.num_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
        cuts = {"q_proj": (0, q_rows), "k_proj": (q_rows, q_rows + kv_rows),
                "v_proj": (q_rows + kv_rows, q_rows + 2 * kv_rows)}
        for name, (lo, hi) in cuts.items():
            yield at + (name, "kernel"), lambda lo=lo, hi=hi: _kernel(state[f"{hl}.self_attn.qkv_proj.weight"][lo:hi])
    else:
        for name in ("q_proj", "k_proj", "v_proj"):
            yield at + (name, "kernel"), lambda name=name: _kernel(state[f"{hl}.self_attn.{name}.weight"])
            if cfg.attention_bias:
                yield at + (name, "bias"), lambda name=name: _f32(state[f"{hl}.self_attn.{name}.bias"])
    yield at + ("o_proj", "kernel"), lambda: _kernel(state[f"{hl}.self_attn.o_proj.weight"])
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            yield at + (name, "scale"), lambda name=name: _f32(state[f"{hl}.self_attn.{name}.weight"])


def decoder_leaves(cfg, model_type: str, state) -> Iterator[Tuple[tuple, Callable[[], torch.Tensor]]]:
    """(flax path, reader) for every leaf of a decoder checkpoint: each reader returns that leaf as an f32 tensor
    when called, so a caller can hold one at a time."""
    yield ("embed_tokens", "embedding"), lambda: _f32(state["model.embed_tokens.weight"])
    for i in range(cfg.num_layers):
        hl, at = f"model.layers.{i}", (f"layer_{i}", "attention")
        if cfg.mla:
            yield from _mla_leaves(cfg, hl, at, state)
        else:
            yield from _attention_leaves(cfg, model_type, hl, at, state)
        yield (f"layer_{i}", "input_norm", "scale"), lambda: _f32(state[f"{hl}.input_layernorm.weight"])
        if cfg.num_experts and i >= cfg.moe_layer_start:
            yield from _moe_leaves(cfg, model_type, hl, state)
        else:
            if model_type == "phi3":
                m = cfg.intermediate_size
                yield (f"layer_{i}", "gate_proj", "kernel"), lambda: _kernel(state[f"{hl}.mlp.gate_up_proj.weight"][:m])
                yield (f"layer_{i}", "up_proj", "kernel"), lambda: _kernel(state[f"{hl}.mlp.gate_up_proj.weight"][m:])
            else:
                for name in ("gate_proj", "up_proj"):
                    yield (f"layer_{i}", name, "kernel"), lambda name=name: _kernel(state[f"{hl}.mlp.{name}.weight"])
            yield (f"layer_{i}", "down_proj", "kernel"), lambda: _kernel(state[f"{hl}.mlp.down_proj.weight"])
        # Gemma2 / 3 sandwich norms: HF's post_attention_layernorm is the post-attention norm there, Llama's
        # pre-MLP norm elsewhere; the names in the tree follow the reference's.
        norms = ["post_attention_norm"] + (["pre_feedforward_norm", "post_feedforward_norm"] if cfg.post_norms else [])
        hf_names = {"post_attention_norm": "post_attention_layernorm", "pre_feedforward_norm":
                    "pre_feedforward_layernorm", "post_feedforward_norm": "post_feedforward_layernorm"}
        for name in norms:
            yield (f"layer_{i}", name, "scale"), lambda name=name: _f32(state[f"{hl}.{hf_names[name]}.weight"])
    yield ("final_norm", "scale"), lambda: _f32(state["model.norm.weight"])
    if not cfg.tie_embeddings:
        yield ("lm_head", "kernel"), lambda: _kernel(state["lm_head.weight"])


def load_hf_decoder(path: str, dtype=None):
    """An HF decoder directory (every family but GPT-2) → (``DecoderConfig``, flax-named parameter tree of f32
    tensors)."""
    hf = read_hf_config(path)
    cfg = hf_decoder_config(hf, dtype)
    state = open_hf_state(path)
    params: dict = {}
    try:
        for leaf_path, read in decoder_leaves(cfg, hf.get("model_type") or "", state):
            _set(params, leaf_path, read())
    finally:
        if hasattr(state, "close"):
            state.close()
    logger.info("loaded HF decoder from %s (%d layers, hidden %d)", path, cfg.num_layers, cfg.hidden_size)
    return cfg, params


# --------------------------------------------------------------------------
# PEFT-compatible adapter export
# --------------------------------------------------------------------------

def peft_arch_for_config(cfg) -> Optional[str]:
    """Config type -> PEFT module-path layout: "bert" for an encoder, "llama" for every dense decoder family
    (Llama, Mistral, Phi-3, Qwen, Gemma: the reference writes them all under ``model.layers.<i>.self_attn``),
    or None where there is none."""
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
