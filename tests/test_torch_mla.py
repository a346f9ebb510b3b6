"""The port's multi-head latent attention (``dalm_tpu_torch/models/mla.py``, the decoder's MLA layers, the YaRN rope
and the latent cache) against the JAX package's (``dalm_tpu/models/mla.py``, ``decoder.py``) on the CPU, in f32, at
the tiny preset and variants of it, weights carried across with ``interop``, inputs drawn from a seed with numpy.

Covered: ``deinterleave_rope``; the decompressed path (full forward) with q-LoRA and with a direct ``q_proj``, with
YaRN and ``attn_scale_mult``; the absorbed path (cached decode) against the JAX decoder's cached decode and against
the full forward; the latent cache's layout and ``kv_quant`` raising the reference's ``ValueError``; the
rank-aware cache write on 3-D buffers against the reference's ``_cache_write``; YaRN ``rope_cos_sin``; the engine
and speculative decoding against the JAX lockstep; the three MLA presets; ``deepseek_v3`` checkpoints written here
(safetensors, no ``transformers``: q-LoRA or not, noaux-tc MoE with shared experts and a leading dense layer, YaRN)
through both packages' loaders and packed loaders; an unknown V3 rope type rejected; LoRA SFT on an MLA preset
with q-LoRA raising the reference's ``ValueError``.

Tolerances: logits within 1e-5 (f32, sums in another order), the cached decode against the full forward within
2e-5 (the reference's own bound, ``tests/models/test_mla.py:50``); rope tables within 2e-6; cache writes and
loaded trees equal; greedy tokens equal.
"""

import dataclasses
import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.core.mesh import unbox
from dalm_tpu.models import decoder as jdec
from dalm_tpu.models import hf_loader as jhf
from dalm_tpu.models import mla as jmla
from dalm_tpu.models import qlora as jqlora
from dalm_tpu.models import registry as jreg
from dalm_tpu_torch import interop
from dalm_tpu_torch.models import hf_loader as thf
from dalm_tpu_torch.models import qlora as tqlora
from dalm_tpu_torch.models import registry as treg
from dalm_tpu_torch.models.decode_engine import DecodeEngine
from dalm_tpu_torch.models.decoder import Decoder, _cache_write, rope_cos_sin
from dalm_tpu_torch.models.generate import build_greedy_generate
from dalm_tpu_torch.models.mla import deinterleave_rope
from dalm_tpu_torch.models.speculative import build_speculative_generate
from test_torch_moe import assert_trees_equal, tcfg_of, write_hf

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores

MLA_PRESETS = ("tiny-mla", "deepseek-v3-mini", "deepseek-v3-mid-7b")
YARN = (4.0, 32.0, 1.0, 32.0, 1.07)
VARIANTS = {
    "qlora": dict(),
    "direct_q": dict(q_lora_rank=None, attention_bias=True, rope_interleave=False, num_heads=4),
    "yarn": dict(rope_yarn=YARN, attn_scale_mult=1.3),
    "v3_moe": dict(rope_yarn=YARN, num_experts=8, moe_router="noaux_tc", moe_n_group=4, moe_topk_group=2,
                   moe_routed_scaling_factor=2.5, moe_n_shared_experts=1, moe_layer_start=1,
                   moe_intermediate_size=32),
}


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


@functools.lru_cache(maxsize=None)
def _pair(variant, seed=0):
    jcfg = dataclasses.replace(jdec.DecoderConfig.tiny_mla(vocab_size=128), **VARIANTS[variant])
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.tree.map(np.asarray, unbox(jdec.Decoder(jcfg).init(jax.random.PRNGKey(seed), ids,
                                                                     jnp.ones_like(ids))["params"]))
    if "attention_bias" in VARIANTS[variant]:  # biases that are not 0
        rng = np.random.default_rng(seed)
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: (0.3 * rng.standard_normal(x.shape)).astype(np.float32) if p[-1].key == "bias" else x,
            params)
    return jdec.Decoder(jcfg), params, interop.load_params(Decoder(tcfg_of(jcfg)), params).eval()


def _left_padded(rng, B, S, vocab=128):
    ids = rng.integers(5, vocab, size=(B, S)).astype(np.int32)
    lens = rng.integers(S // 2, S + 1, size=B)
    lens[0] = S
    mask = (np.arange(S)[None, :] >= S - lens[:, None]).astype(np.int32)
    return np.where(mask > 0, ids, 0).astype(np.int32), mask


def test_deinterleave_rope_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 8)).astype(np.float32)
    np.testing.assert_array_equal(deinterleave_rope(torch.from_numpy(x)).numpy(),
                                  np.asarray(jmla.deinterleave_rope(jnp.asarray(x))))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mla_decoder_logits_match_jax(variant):
    """The decompressed path: q-LoRA or a direct (biased) q_proj, interleaved rope lanes, YaRN and the scale
    multiplier, the noaux-tc MoE after a dense first layer."""
    jmod, params, tmod = _pair(variant, seed=1)
    ids, mask = _left_padded(np.random.default_rng(2), 3, 13)
    want = jax.jit(jmod.apply)({"params": params}, ids, mask)
    got = tmod(_t(ids), _t(mask))
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    attn = tmod.layer_0.attention
    assert hasattr(attn, "q_a_proj") == (tmod.cfg.q_lora_rank is not None) and tuple(attn.kv_b_proj.shape) == (
        16, tmod.cfg.num_heads * 32)


@pytest.mark.parametrize("variant", ["qlora", "direct_q", "v3_moe"])
def test_absorbed_decode_matches_jax_and_the_full_forward(variant):
    """A left-padded prefill into the latent cache at slot 0, then single-token steps at a per-row index (the
    engine's): each step's logits against the JAX decoder's cached decode on the same cache, and against the
    port's own full forward at the same position."""
    jmod, params, tmod = _pair(variant, seed=3)
    B, P, steps = 2, 9, 4
    ids, mask = _left_padded(np.random.default_rng(4), B, P + steps)
    mask[:, P:] = 1
    L = P + steps
    full = tmod(_t(ids), _t(mask)).numpy()
    pos = np.clip(np.cumsum(mask, axis=1) - 1, 0, None)
    cache = tmod.init_kv_cache(B, L)
    jcache = jmod.init_kv_cache(B, L, jnp.float32)
    out, cache = tmod(_t(ids[:, :P]), _t(mask), positions=_t(pos[:, :P]), kv_cache=cache, cache_index=0)
    jout, jcache = jmod.apply({"params": params}, ids[:, :P], mask, positions=pos[:, :P], kv_cache=jcache,
                              cache_index=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.numpy()[:, -1], full[:, P - 1], rtol=0, atol=2e-5)
    for t in range(P, L):
        out, cache = tmod(_t(ids[:, t:t + 1]), _t(mask), positions=_t(pos[:, t:t + 1]), kv_cache=cache,
                          cache_index=torch.full((B,), t, dtype=torch.long))
        jout, jcache = jmod.apply({"params": params}, ids[:, t:t + 1], mask, positions=pos[:, t:t + 1],
                                  kv_cache=jcache, cache_index=jnp.full((B,), t, jnp.int32))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
        np.testing.assert_allclose(out.numpy()[:, 0], full[:, t], rtol=0, atol=2e-5)
    for name in cache:
        for key in ("k", "pe"):
            np.testing.assert_allclose(cache[name][key].numpy(), np.asarray(jcache[name][key]), rtol=0, atol=1e-5)


def test_latent_cache_layout_and_kv_quant_raises():
    _, _, tmod = _pair("qlora")
    jcfg = jdec.DecoderConfig.tiny_mla()
    cache = tmod.init_kv_cache(3, 32)
    assert set(cache) == {"layer_0", "layer_1"} and set(cache["layer_0"]) == {"k", "pe"}
    assert tuple(cache["layer_0"]["k"].shape) == (3, 32, 16) and tuple(cache["layer_0"]["pe"].shape) == (3, 32, 8)
    with pytest.raises(ValueError) as want:
        jdec.Decoder(dataclasses.replace(jcfg, kv_quant=True)).init_kv_cache(1, 8)
    with pytest.raises(ValueError) as got:
        Decoder(dataclasses.replace(tmod.cfg, kv_quant=True)).init_kv_cache(1, 8)
    assert str(got.value) == str(want.value)
    # no ring, no sliding window (the reference asserts both)
    with pytest.raises(ValueError, match="sliding-window"):
        Decoder(dataclasses.replace(tmod.cfg, sliding_window=4))
    with pytest.raises(NotImplementedError):
        Decoder(dataclasses.replace(tmod.cfg, attention_impl="ring"))
    # MLA attends by matmuls: a flash config keeps the matmul path
    assert not Decoder(dataclasses.replace(tmod.cfg, attention_impl="flash")).uses_flash(256)


@pytest.mark.parametrize("S,index", [(1, "rows"), (3, "rows"), (3, "scalar")])
def test_cache_write_on_latent_buffers_equals_the_reference(S, index):
    """The per-row (S = 1 and S > 1, one row running past the end) and scalar writes into (B, L, r) buffers."""
    from dalm_tpu.models.decoder import _cache_write as jax_cache_write

    rng = np.random.default_rng(S)
    B, L = 3, 10
    cache = {"k": rng.standard_normal((B, L, 16)).astype(np.float32),
             "pe": rng.standard_normal((B, L, 8)).astype(np.float32)}
    new = {"k": rng.standard_normal((B, S, 16)).astype(np.float32),
           "pe": rng.standard_normal((B, S, 8)).astype(np.float32)}
    at = np.array([0, 4, L - 2], np.int32) if index == "rows" else 5
    want = jax_cache_write({n: jnp.asarray(v) for n, v in cache.items()}, {n: jnp.asarray(v) for n, v in new.items()},
                           jnp.asarray(at) if index == "rows" else at, S)
    got = {n: torch.from_numpy(v.copy()) for n, v in cache.items()}
    _cache_write(got, {n: torch.from_numpy(v) for n, v in new.items()},
                 torch.from_numpy(at).long() if index == "rows" else at, S)
    for n in cache:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


@pytest.mark.parametrize("yarn,theta,dim", [(YARN, 10000.0, 8), ((40.0, 32.0, 1.0, 4096.0, 1.0), 10000.0, 64),
                                            ((8.0, 16.0, 2.0, 2048.0, 1.2), 50000.0, 32)])
def test_yarn_rope_matches_jax(yarn, theta, dim):
    pos = np.arange(0, 6000, 7)[None, :].repeat(2, axis=0)
    jc, js = jdec.rope_cos_sin(jnp.asarray(pos), dim, theta, jnp.float32, yarn=yarn)
    tc, ts = rope_cos_sin(torch.from_numpy(pos), dim, theta, torch.float32, yarn=yarn)
    # the tables' arguments reach 6000 radians: 2e-6 relative to that, as for the llama3 bands
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-6 * 6000 / 300)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-6 * 6000 / 300)
    assert abs(float(tc.abs().max()) - yarn[4]) < 1e-3  # attention_factor scales the tables


def _prompts(n, seed, p=10):
    rng = np.random.default_rng(seed)
    ids, mask = np.zeros((n, p), np.int32), np.zeros((n, p), np.int32)
    for i in range(n):
        real = int(rng.integers(3, p))
        ids[i, p - real:] = rng.integers(5, 120, size=real)
        mask[i, p - real:] = 1
    return ids, mask


@pytest.mark.parametrize("variant", ["qlora", "v3_moe"])
def test_engine_and_speculative_lockstep_for_mla(variant):
    """The engine's host loop and fused schedule copy the latent layer dicts ({"k", "pe"}) into the pool, and the
    speculative verify pass writes multi-token latent rows: every request's tokens equal the JAX package's
    greedy lockstep (``tests/models/test_mla.py:268``, ``:302``)."""
    from dalm_tpu.models.generate import build_greedy_generate as jax_greedy

    jmod, params, tmod = _pair(variant, seed=5)
    ids, mask = _prompts(5, 6)
    max_new = 6
    want = np.asarray(jax_greedy(jmod, max_new, eos_token_id=None, pad_token_id=0)(params, jnp.asarray(ids),
                                                                                    jnp.asarray(mask)))
    rows = [list(map(int, r)) for r in want]
    np.testing.assert_array_equal(build_greedy_generate(tmod, max_new)(_t(ids), _t(mask)).numpy(), want)
    eng = DecodeEngine(tmod, num_slots=3, max_prompt_len=10, max_new_tokens=max_new, pad_token_id=0)
    assert eng.generate(ids, mask) == rows and eng.generate_fused(ids, mask) == rows
    spec = build_speculative_generate(tmod, max_new, pad_token_id=0, gamma=4)(_t(ids), _t(mask)).numpy()
    np.testing.assert_array_equal(spec, want)
    speng = DecodeEngine(tmod, num_slots=2, max_prompt_len=10, max_new_tokens=max_new, pad_token_id=0,
                         speculative_gamma=4)
    assert speng.generate_fused(ids, mask) == rows


@pytest.mark.parametrize("name", MLA_PRESETS)
def test_mla_presets_match_jax(name):
    jcfg, cfg = jreg.DECODER_PRESETS[name](), treg.DECODER_PRESETS[name]()
    assert treg.config_from_json(jreg._config_to_json(jcfg)) == cfg
    assert jreg._config_from_json(treg.config_to_json(cfg)) == jcfg
    assert cfg.mla and treg.resolve_decoder(name)[0] == cfg


HF = dict(model_type="deepseek_v3", vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=4, intermediate_size=48, max_position_embeddings=64, rms_norm_eps=1e-6,
          kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, tie_word_embeddings=False,
          rope_theta=10000.0)
CHECKPOINTS = {
    "qlora_dense": dict(q_lora_rank=24, first_k_dense_replace=2, n_routed_experts=4),
    "no_qlora": dict(q_lora_rank=None, first_k_dense_replace=2),
    "moe_yarn": dict(q_lora_rank=24, first_k_dense_replace=1, n_routed_experts=4, num_experts_per_tok=2, n_group=2,
                     topk_group=1, moe_intermediate_size=16, n_shared_experts=1, routed_scaling_factor=2.5,
                     norm_topk_prob=True, rope_scaling={"rope_type": "yarn", "factor": 4.0, "beta_fast": 32.0,
                                                        "beta_slow": 1.0, "mscale": 1.0, "mscale_all_dim": 0.707,
                                                        "original_max_position_embeddings": 32}),
}


def deepseek_checkpoint(path, kw, seed=0):
    cfg = dict(HF, **kw)
    H, V, nh, r = cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv, qr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg.get("q_lora_rank")
    shapes = {"model.embed_tokens.weight": (V, H), "model.norm.weight": (H,), "lm_head.weight": (V, H)}
    for i in range(cfg["num_hidden_layers"]):
        sa, mlp = f"model.layers.{i}.self_attn", f"model.layers.{i}.mlp"
        shapes.update({f"{sa}.kv_a_proj_with_mqa.weight": (r + dr, H), f"{sa}.kv_a_layernorm.weight": (r,),
                       f"{sa}.kv_b_proj.weight": (nh * (dn + dv), r), f"{sa}.o_proj.weight": (H, nh * dv),
                       f"model.layers.{i}.input_layernorm.weight": (H,),
                       f"model.layers.{i}.post_attention_layernorm.weight": (H,)})
        if qr:
            shapes.update({f"{sa}.q_a_proj.weight": (qr, H), f"{sa}.q_a_layernorm.weight": (qr,),
                           f"{sa}.q_b_proj.weight": (nh * (dn + dr), qr)})
        else:
            shapes[f"{sa}.q_proj.weight"] = (nh * (dn + dr), H)
        if i < cfg["first_k_dense_replace"]:
            M = cfg["intermediate_size"]
            shapes.update({f"{mlp}.gate_proj.weight": (M, H), f"{mlp}.up_proj.weight": (M, H),
                           f"{mlp}.down_proj.weight": (H, M)})
        else:
            E, M, ns = cfg["n_routed_experts"], cfg["moe_intermediate_size"], cfg["n_shared_experts"]
            shapes.update({f"{mlp}.gate.weight": (E, H), f"{mlp}.gate.e_score_correction_bias": (E,),
                           f"{mlp}.shared_experts.gate_proj.weight": (ns * M, H),
                           f"{mlp}.shared_experts.up_proj.weight": (ns * M, H),
                           f"{mlp}.shared_experts.down_proj.weight": (H, ns * M)})
            for j in range(E):
                for n, shape in (("gate_proj", (M, H)), ("up_proj", (M, H)), ("down_proj", (H, M))):
                    shapes[f"{mlp}.experts.{j}.{n}.weight"] = shape
    return write_hf(path, cfg, shapes, seed)


@pytest.mark.parametrize("name", sorted(CHECKPOINTS))
def test_hf_deepseek_v3_checkpoints_load_as_the_jax_loader_does(tmp_path, name):
    """Config, tree (``kv_b_proj`` a raw transposed leaf, experts stacked, the correction bias, shared experts,
    ``first_k_dense_replace`` dense layers) and logits equal to the JAX loader's and decoder's; the packed
    loader's trees equal the reference's."""
    path = deepseek_checkpoint(str(tmp_path / name), CHECKPOINTS[name])
    jcfg, jtree = jhf.load_hf_decoder(path)
    cfg, tree = thf.load_hf_decoder(path)
    assert cfg == tcfg_of(jcfg) and cfg.mla
    assert_trees_equal(tree, jtree)
    if name == "moe_yarn":
        m = 0.1 * 0.707 * math.log(4.0) + 1.0
        assert cfg.moe_router == "noaux_tc" and cfg.moe_layer_start == 1 and cfg.moe_n_shared_experts == 1
        assert abs(cfg.attn_scale_mult - m * m) < 1e-12 and cfg.rope_yarn[4] == jcfg.rope_yarn[4] != 1.0
    else:
        assert cfg.num_experts is None  # all layers dense: loads as plain MLA
    ids = np.random.default_rng(7).integers(1, 96, size=(2, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    want = jdec.Decoder(jcfg).apply({"params": jtree}, ids, mask)
    got = interop.load_params(Decoder(cfg), tree)(_t(ids), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    _, jres, jquant, _ = jqlora.load_hf_decoder_packed(path, quantize=True, min_size=256)
    _, res, quant, _ = tqlora.load_hf_decoder_packed(path, quantize=True, min_size=256)
    assert_trees_equal(res, jres)
    assert_trees_equal(quant, jquant)


def test_unknown_v3_rope_type_is_rejected(tmp_path):
    path = str(tmp_path / "dyn")
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(HF, q_lora_rank=24, first_k_dense_replace=2,
                       rope_scaling={"rope_type": "dynamic", "factor": 4.0}), f)
    open(os.path.join(path, "model.safetensors"), "wb").close()
    with pytest.raises(ValueError) as want:
        jhf.load_hf_decoder(path)
    with pytest.raises(ValueError) as got:
        thf.load_hf_decoder(path)
    assert str(got.value) == str(want.value) and "not implemented" in str(got.value)


def test_lora_sft_on_a_q_lora_mla_preset_raises_the_references_error(tmp_path):
    """q_proj / v_proj are LoRA's targets; an MLA model with q-LoRA has neither, so both packages raise "no kernels
    matched LoRA targets" and invent none. A direct q_proj takes LoRA on it alone."""
    from dalm_tpu.models import lora as jlora
    from dalm_tpu_torch.models import lora as tlora
    from dalm_tpu_torch.train import train_generator

    _, params, tmod = _pair("qlora")
    spec = jlora.LoraSpec.for_sft(rank=4, alpha=8)
    with pytest.raises(ValueError) as want:
        jlora.init_lora_params(jax.random.PRNGKey(0), params, spec)
    jsonl = tmp_path / "chat.jsonl"
    jsonl.write_text("".join(json.dumps({"messages": [{"role": "user", "content": f"a b c {i}"},
                                                      {"role": "assistant", "content": "d e f " * 20}]}) + "\n"
                             for i in range(10)))
    with pytest.raises(ValueError) as got:
        train_generator("tiny-mla", str(jsonl), device="cpu", output_dir=None, seq_length=64, lora_r=4,
                        lora_alpha=8, validation_split=0.2)
    assert str(got.value) == str(want.value)
    _, dparams, dmod = _pair("direct_q")
    flat = tlora.init_lora_params(torch.Generator().manual_seed(0), interop.unflatten(dict(dmod.state_dict())),
                                  tlora.LoraSpec.for_sft(rank=4, alpha=8))
    assert sorted(flat) == sorted(jlora.init_lora_params(jax.random.PRNGKey(0), dparams, spec)) == [
        "layer_0/attention/q_proj/kernel", "layer_1/attention/q_proj/kernel"]
