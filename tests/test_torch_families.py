"""The dense decoder families of the port (``dalm_tpu_torch/models/decoder.py``) against the JAX package's
(``dalm_tpu/models/decoder.py``) on the CPU: each of the ten presets' families at a tiny width, with the family's
knobs as the preset sets them, the same weights carried across with ``interop`` and the same numpy inputs, f32.

The weights are drawn here (std 0.15 kernels, N(0, 0.3) norms and biases) rather than by flax's init, so that
every knob is load-bearing: ``(1 + w)`` norms are not the identity, biases are not 0, and scores are large enough
for a softcap of 2 to bend them.

Tolerances: logits within 1e-4 (f32 through a few 64-wide layers, sums in another order); the cached decode
against the full forward within 1e-4; greedy tokens equal; K4's plain version at head dim 256 against the Pallas
kernels in interpret mode within 2e-5 forward and 3e-4 gradients (as ``tests/test_torch_flash_attention.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.core.mesh import unbox
from dalm_tpu.kernels import flash_attention as J
from dalm_tpu.models import decoder as jdec
from dalm_tpu.models import registry as jreg
from dalm_tpu_torch.interop import load_params
from dalm_tpu_torch.kernels import flash_attention as T
from dalm_tpu_torch.models import registry as treg
from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig, rope_cos_sin

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores

BASE = dict(vocab_size=320, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=96,
            max_position_embeddings=512)
GEMMA = dict(head_dim_override=32, tie_embeddings=True, hidden_act="gelu_tanh", scale_embeddings=True,
             rmsnorm_unit_offset=True, rms_norm_eps=1e-6)
# each preset's family at a tiny width: its own knobs, windows short enough to cut the test sequences
FAMILIES = {
    "llama3-8b": dict(num_kv_heads=2, rope_theta=500000.0),
    "llama3.1-8b": dict(num_kv_heads=2, rope_theta=100.0, rope_llama3=(8.0, 1.0, 4.0, 32)),
    "llama2-13b": dict(num_heads=8),
    "mistral-7b": dict(num_kv_heads=2, sliding_window=5),
    "qwen2.5-7b": dict(num_kv_heads=2, rope_theta=1000000.0, attention_bias=True),
    "qwen3-8b": dict(num_kv_heads=2, head_dim_override=32, rope_theta=1000000.0, rms_norm_eps=1e-6, qk_norm=True),
    "phi3-mini": dict(sliding_window=4),
    "gemma-2b": dict(num_kv_heads=1, **GEMMA),
    "gemma2-2b": dict(num_kv_heads=2, query_pre_attn_scalar=24.0, attn_logit_softcap=2.0,
                      final_logit_softcap=1.5, sliding_window=5, sliding_layers="even", post_norms=True, **GEMMA),
    "gemma3-1b": dict(num_layers=3, num_kv_heads=1, rope_theta=1000000.0, query_pre_attn_scalar=24.0,
                      post_norms=True, sliding_window=5, sliding_layers=(True, True, False), qk_norm=True,
                      rope_local_theta=10000.0, rope_scaling_factor=2.0, **GEMMA),
}


def _configs(family, **extra):
    kw = {**BASE, **FAMILIES[family], **extra}
    return jdec.DecoderConfig(**kw), DecoderConfig(**kw)


def _weights(jcfg, seed):
    """Flax's tree for the config, every leaf redrawn from a seed."""
    ids = jnp.zeros((1, 8), jnp.int32)
    tree = jax.tree.map(np.asarray, unbox(jdec.Decoder(jcfg).init(jax.random.PRNGKey(0), ids, jnp.ones_like(ids))))
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = path[-1].key
        if name == "scale":  # norms: (1 + w) or w
            base = 0.0 if jcfg.rmsnorm_unit_offset else 1.0
            return (base + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
        std = {"bias": 0.3, "embedding": 1.0}.get(name, 0.15)
        return (std * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree["params"])


def _pair(family, seed=0, **extra):
    jcfg, tcfg = _configs(family, **extra)
    params = _weights(jcfg, seed)
    return jdec.Decoder(jcfg), params, load_params(Decoder(tcfg), params)


def _left_padded(rng, B, S, vocab):
    ids = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    lens = rng.integers(S // 2, S + 1, size=B)
    lens[0] = S
    mask = (np.arange(S)[None, :] >= S - lens[:, None]).astype(np.int32)
    return np.where(mask > 0, ids, 0).astype(np.int32), mask


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_logits_match_jax(family):
    jmod, params, tmod = _pair(family, seed=sorted(FAMILIES).index(family))
    ids, mask = _left_padded(np.random.default_rng(1), 3, 14, BASE["vocab_size"])
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, ids, mask))
    got = tmod(_t(ids), _t(mask)).numpy()
    assert got.shape == want.shape and np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if tmod.cfg.tie_embeddings:
        assert not hasattr(tmod, "lm_head") and "lm_head" not in params


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_cached_decode_matches_full_forward(family):
    """A left-padded prefill into the cache at slot 0, then single-token steps (one slot per row, the engine's
    per-row index), each step's logits against the full forward's at the same position (which
    ``test_family_logits_match_jax`` holds to the JAX package's)."""
    _, _, tmod = _pair(family, seed=7)
    rng = np.random.default_rng(2)
    B, P, steps = 2, 9, 4
    ids, mask = _left_padded(rng, B, P + steps, BASE["vocab_size"])
    mask[:, P:] = 1
    full = tmod(_t(ids), _t(mask)).numpy()
    L = P + steps
    cache = tmod.init_kv_cache(B, L)
    pos = np.clip(np.cumsum(mask, axis=1) - 1, 0, None)
    out, cache = tmod(_t(ids[:, :P]), _t(mask), positions=_t(pos[:, :P]), kv_cache=cache, cache_index=0)
    np.testing.assert_allclose(out.numpy()[:, -1], full[:, P - 1], rtol=0, atol=1e-4)
    for t in range(steps):
        at = P + t
        out, cache = tmod(_t(ids[:, at:at + 1]), _t(mask), positions=_t(pos[:, at:at + 1]), kv_cache=cache,
                          cache_index=torch.full((B,), at, dtype=torch.long))
        np.testing.assert_allclose(out.numpy()[:, 0], full[:, at], rtol=0, atol=1e-4)


@pytest.mark.parametrize("family", ["gemma2-2b", "gemma3-1b"])
def test_flash_path_at_head_dim_256_matches_jax(family):
    """``attention_impl="flash"`` at S 256 (K4's plain version on the CPU) with each layer's window, the softcap,
    the query scale and GQA, against the JAX decoder's matmul path (through the port's, which
    ``test_family_logits_match_jax`` holds to it on the same family), forward and the full-sequence training
    forward's gradient; head dim 256 as Gemma's."""
    _, params, tmod = _pair(family, seed=3, attention_impl="flash", head_dim_override=256, sliding_window=100)
    assert tmod.uses_flash(256)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, BASE["vocab_size"], size=(2, 256)).astype(np.int32)
    mask = np.ones((2, 256), np.int32)
    mask[1, 200:] = 0  # right padding: pads are segment 0 on the flash path
    plain = load_params(Decoder(dataclasses.replace(tmod.cfg, attention_impl="einsum")), params)
    with torch.no_grad():
        want = plain(_t(ids), _t(mask)).numpy()
    before = dict(T.flash_attention.launches)
    got = tmod.train_forward(_t(ids), _t(mask))
    assert T.flash_attention.launches == before
    real = mask.astype(bool)
    np.testing.assert_allclose(got.detach().numpy()[real], want[real], rtol=0, atol=1e-4)
    # gradients through K4's plain backward equal the matmul path's
    grads = []
    for model, out in ((tmod, got), (plain, None)):
        out = model.train_forward(_t(ids), _t(mask)) if out is None else out
        (out[torch.from_numpy(real)] ** 2).mean().backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k in grads[0]:
        np.testing.assert_allclose(grads[0][k].numpy(), grads[1][k].numpy(), atol=2e-5, err_msg=k)


def test_rope_rewrites_match_jax():
    """llama3 frequency bands (every regime: kept, smoothed, divided) and plain rope against the JAX
    ``rope_cos_sin``; linear scaling as the decoder applies it, positions divided."""
    pos = np.arange(300)[None, :].repeat(2, axis=0)
    for theta, hd, scaling in ((100.0, 8, (2.0, 1.0, 4.0, 32)), (500000.0, 128, (8.0, 1.0, 4.0, 8192)),
                               (10000.0, 64, None)):
        jc, js = jdec.rope_cos_sin(jnp.asarray(pos), hd, theta, jnp.float32, llama3_scaling=scaling)
        tc, ts = rope_cos_sin(torch.from_numpy(pos), hd, theta, torch.float32, scaling)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-6)
    jc, _ = jdec.rope_cos_sin(jnp.asarray(pos, jnp.float32) / 8.0, 64, 1e6, jnp.float32)
    tc, _ = rope_cos_sin(torch.from_numpy(pos).float() / 8.0, 64, 1e6, torch.float32)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-6)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_preset_numbers_and_windows_match_jax(name):
    """Each preset's config equals the reference's field for field, through the reference's config.json (the
    port reads what the reference writes and writes what it reads), and ``layer_window`` agrees layer by layer."""
    jcfg = jreg.DECODER_PRESETS[name]()
    tcfg = treg.DECODER_PRESETS[name]()
    assert treg.config_from_json(jreg._config_to_json(jcfg)) == tcfg
    assert jreg._config_from_json(treg.config_to_json(tcfg)) == jcfg
    assert [tcfg.layer_window(i) for i in range(tcfg.num_layers)] == \
        [jcfg.layer_window(i) for i in range(jcfg.num_layers)]
    assert tcfg.head_dim == jcfg.head_dim and tcfg.kv_heads == jcfg.kv_heads


def test_unported_presets_and_knobs_raise_naming_their_module():
    """Every preset of the reference's registry resolves in the port to the reference's config (GPT-2's through
    ``config_from_json``), the MoE and MLA knobs are taken, and only the ring's knobs still raise."""
    from dalm_tpu_torch.models.decoder import UNPORTED_KNOBS, check_unported

    assert set(jreg.DECODER_PRESETS) == set(treg.DECODER_PRESETS) and not hasattr(treg, "UNPORTED_PRESETS")
    for name, make in jreg.DECODER_PRESETS.items():
        assert treg.resolve_decoder(name)[0] == treg.config_from_json(jreg._config_to_json(make())), name
    check_unported({"num_experts": 8, "kv_lora_rank": 512, "moe_router": "noaux_tc", "rope_yarn": [4, 32, 1, 64, 1]})
    assert list(UNPORTED_KNOBS.values()) == [{"ring_axis": "model", "ring_layout": "contiguous"}]
    for knob, value in (("ring_axis", "data"), ("ring_layout", "zigzag")):
        with pytest.raises(NotImplementedError, match="ring_attention"):
            check_unported({knob: value})


def test_windowed_preset_through_the_decode_engine():
    """A windowed family (Gemma2: windows on even layers, softcaps) through ``DecodeEngine.generate`` (and its
    fused schedule) token for token against the JAX engine; the engine needs nothing beyond the decoder's own
    masks."""
    from dalm_tpu.models.decode_engine import DecodeEngine as JaxDecodeEngine
    from dalm_tpu_torch.models.decode_engine import DecodeEngine

    # the real final cap (30): the tiny one (1.5) saturates the logits into ties that greedy picks would split
    jmod, params, tmod = _pair("gemma2-2b", seed=11, final_logit_softcap=30.0)
    rng = np.random.default_rng(6)
    ids, mask = _left_padded(rng, 5, 10, BASE["vocab_size"])
    kw = dict(max_prompt_len=10, max_new_tokens=12, eos_token_id=BASE["vocab_size"] - 1, pad_token_id=0)
    want = JaxDecodeEngine(jmod, params, num_slots=3, **kw).generate(ids, mask)
    engine = DecodeEngine(tmod, num_slots=3, **kw)
    assert [list(r) for r in engine.generate(ids, mask)] == [list(r) for r in want]
    assert [list(r) for r in engine.generate_fused(ids, mask)] == [list(r) for r in want]


D256 = {  # name -> (B, H, Hk, Sq, Sk, seg kind, options): Gemma2's knobs together
    "gemma2": (1, 8, 4, 384, 384, "packed", dict(window=100, softcap=50.0, scale=1.0 / 16)),
}


@pytest.mark.parametrize("name", sorted(D256))
def test_k4_plain_version_at_head_dim_256_matches_pallas(name):
    """K4's plain forward and backward (what a CPU tensor takes, and the card kernels' oracle) at D 256 with
    window, softcap, query scale, GQA and segments, against the JAX kernels in interpret mode."""
    B, H, Hk, Sq, Sk, seg, opts = D256[name]
    rng = np.random.default_rng(sorted(D256).index(name))
    mk = lambda S, h: rng.standard_normal((B, h, S, 256)).astype(np.float32)  # noqa: E731
    q, k, v, do = mk(Sq, H), mk(Sk, Hk), mk(Sk, Hk), mk(Sq, H)
    if seg == "pad":
        ids = (np.arange(Sq)[None, :] < rng.integers(Sq // 3, Sq - 8, size=(B, 1))).astype(np.int32)
    else:
        ids = np.sort(rng.integers(0, 3, size=(B, Sq)), axis=1).astype(np.int32)
    blk = dict(block_q=128, block_k=128, interpret=True)
    jq, jk, jv, jdo, js = (jnp.asarray(x) for x in (q, k, v, do, ids))
    jo, jl = J._flash_fwd(jq, jk, jv, js, js, **opts, **blk)
    jg = J._flash_bwd(jq, jk, jv, jo, jl, jdo, js, js, **opts, **blk)
    tq, tk, tv, tdo, ts = (torch.from_numpy(np.array(x)) for x in (q, k, v, do, ids))
    to, tl = T.flash_fwd(tq, tk, tv, ts, ts, causal=True, **opts)
    tg = T.flash_bwd(tq, tk, tv, torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jl)), tdo, ts, ts,
                     causal=True, **opts)
    for got, want, tol in ((to, jo, 2e-5), (tl, jl, 2e-5), *((g, w, 3e-4) for g, w in zip(tg, jg))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("storage", ["bf16", "int8", "int4"])
def test_biased_projections_through_every_storage(storage):
    """Qwen2.5's biased q/k/v projections with the base packed (``pack_qlora_frozen``; bf16 ``w``, int8, int4)
    against the JAX packed decoder on the same trees: the bias is added after the product. The int4 branch keeps
    the known difference: the reference adds only a bias held in the ``quant`` collection and drops the layer's
    own (``dalm_tpu/models/layers.py:70-71``), the port adds the layer's bias; so the port equals the reference
    with the bias moved into ``quant``, and not the reference as it packs it."""
    from dalm_tpu.models import qlora as jqlora
    from dalm_tpu_torch.interop import load_packed

    quantize = {"bf16": False, "int8": True, "int4": "int4"}[storage]
    jmod, params, _ = _pair("qwen2.5-7b", seed=4)
    residual, quant = jqlora.pack_qlora_frozen(params, quantize=quantize, min_size=1024)
    residual, quant = jax.tree.map(np.asarray, (residual, quant))
    tmod = load_packed(Decoder(_configs("qwen2.5-7b")[1]), residual, quant)
    assert tmod.layer_0.attention.q_proj.bias is not None
    ids, mask = _left_padded(np.random.default_rng(3), 2, 12, BASE["vocab_size"])
    got = tmod(_t(ids), _t(mask)).numpy()
    apply = jax.jit(jmod.apply)
    if storage != "int4":
        want = np.asarray(apply({"params": residual, "quant": quant}, ids, mask))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        return
    moved_res = jax.tree.map(lambda x: x, residual)
    moved_quant = jax.tree.map(lambda x: x, quant)
    for i in range(2):
        for name in ("q_proj", "k_proj", "v_proj"):
            moved_quant[f"layer_{i}"]["attention"][name]["bias"] = moved_res[f"layer_{i}"]["attention"][name].pop("bias")
    want = np.asarray(apply({"params": moved_res, "quant": moved_quant}, ids, mask))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    dropped = np.asarray(apply({"params": residual, "quant": quant}, ids, mask))
    assert np.abs(dropped - want).max() > 1e-2  # the reference's own packing loses the bias


@pytest.mark.parametrize("family", ["qwen2.5-7b", "gemma2-2b"])
def test_lora_on_biased_and_tied_models_matches_jax(family):
    """LoRA targets on a biased (Qwen2.5) and on a tied (Gemma2) model: the same kernel paths as the reference's
    (the biases and the tied embedding are no targets), and the merge runtime's forward on the same factors equals
    the JAX forward on ``merge_lora``'s tree; the fused runtime's factors go on the same layers."""
    from dalm_tpu.models import lora as jlora
    from dalm_tpu_torch.interop import load_merge_lora
    from dalm_tpu_torch.models import lora as tlora
    from dalm_tpu_torch.models.qlora import init_module_factors

    spec_args = dict(rank=4, alpha=8.0, dropout=0.0, target_modules=("q_proj", "v_proj", "down_proj"))
    jspec, tspec = jlora.LoraSpec(**spec_args), tlora.LoraSpec(**spec_args)
    jmod, params, tmod = _pair(family, seed=5)
    jl = jlora.init_lora_params(jax.random.PRNGKey(2), params, jspec)
    rng = np.random.default_rng(9)
    jl = {k: {"lora_a": np.asarray(v["lora_a"]), "lora_b": (0.1 * rng.standard_normal(v["lora_b"].shape))
              .astype(np.float32)} for k, v in jl.items()}
    assert sorted(jl) == sorted("/".join(p) for p in tlora._target_kernel_paths(
        {k: v for k, v in params.items()}, tspec))
    assert all(p.endswith("/kernel") for p in jl) and not any("embed" in p or "bias" in p for p in jl)
    ids, mask = _left_padded(np.random.default_rng(4), 2, 12, BASE["vocab_size"])
    want = np.asarray(jax.jit(jmod.apply)({"params": jlora.merge_lora(params, jl, jspec)}, ids, mask))
    got = load_merge_lora(tmod, jl, tspec)(_t(ids), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    fresh = _pair(family, seed=5)[2]
    assert init_module_factors(fresh, tspec, torch.Generator().manual_seed(0)) == len(jl)


def test_entry_points_take_the_new_presets():
    """The entry points resolve every new preset name (configs only: no weights are drawn here)."""
    from dalm_tpu_torch.models.registry import resolve_decoder

    for name in FAMILIES:
        cfg, state = resolve_decoder(name, dtype="bfloat16", vocab_size=384)
        assert state is None and cfg.vocab_size == 384 and cfg.dtype == torch.bfloat16
        assert Decoder(dataclasses.replace(cfg, num_layers=1), device="meta").cfg.head_dim == cfg.head_dim
