"""The port's sparse MoE (``dalm_tpu_torch/models/moe.py`` and the decoder's MoE layers) against the JAX package's
(``dalm_tpu/models/moe.py``) on the CPU, in f32, at the tiny presets: the weights carried across with ``interop``,
the inputs drawn from a seed with numpy.

Covered: ``route_topk`` / ``route_noaux_tc``; ``MoEBlock`` on the dense path and on the dispatch path, dropless and
with capacity drops per group over a padded last group; the slot rule against the reference's cumsum; the
load-balancing aux and the gradient of ``loss + w · aux``; ``moe_layer_start`` with DeepSeek-V3's shared experts;
cached decode; the continuous-batching engine and speculative decoding against the JAX lockstep; ``train_generator``
with ``moe_aux_weight`` against the JAX trainer; the four MoE presets; ``mixtral`` / ``qwen3_moe`` checkpoints
written here (safetensors, no ``transformers``) through both packages' loaders and packed loaders.

Tolerances: indices equal; router weights within 1e-6; block outputs and logits within 1e-5 (f32, sums in another
order); aux within 1e-6; gradients within 1e-5; SFT losses within 5e-6 (as ``test_torch_sft.py``); greedy tokens
and loaded trees equal.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.core.mesh import unbox
from dalm_tpu.losses.causal import causal_lm_loss as jax_causal_lm_loss
from dalm_tpu.models import decoder as jdec
from dalm_tpu.models import hf_loader as jhf
from dalm_tpu.models import moe as jmoe
from dalm_tpu.models import qlora as jqlora
from dalm_tpu.models import registry as jreg
from dalm_tpu_torch import interop
from dalm_tpu_torch.core.tree import flatten
from dalm_tpu_torch.losses.causal import causal_lm_loss
from dalm_tpu_torch.models import hf_loader as thf
from dalm_tpu_torch.models import moe as tmoe
from dalm_tpu_torch.models import qlora as tqlora
from dalm_tpu_torch.models import registry as treg
from dalm_tpu_torch.models.decode_engine import DecodeEngine
from dalm_tpu_torch.models.decoder import Decoder
from dalm_tpu_torch.models.generate import build_greedy_generate
from dalm_tpu_torch.models.speculative import build_speculative_generate

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores

MOE_PRESETS = ("mixtral-8x7b", "mixtral-mini-4b", "qwen3-moe-30b", "tiny-moe")
# decoder variants: the fields set on the reference's tiny_moe (vocab 128)
VARIANTS = {
    "dense": dict(moe_impl="dense"),
    "dropless": dict(moe_impl="dispatch"),
    "capacity": dict(moe_impl="dispatch", moe_capacity_factor=1.0, moe_group_size=7),
    "v3_shared": dict(num_experts=8, moe_router="noaux_tc", moe_n_group=4, moe_topk_group=2,
                      moe_routed_scaling_factor=2.5, moe_n_shared_experts=1, moe_layer_start=1, norm_topk_prob=True),
    "softmax_start1": dict(num_experts=6, num_experts_per_tok=3, moe_layer_start=1, norm_topk_prob=False,
                           hidden_act="gelu_tanh"),
}


def tcfg_of(jcfg):
    """The port's config of a JAX config, through the reference's config.json schema."""
    return treg.config_from_json(jreg._config_to_json(jcfg))


def _jcfg(variant, **extra):
    return dataclasses.replace(jdec.DecoderConfig.tiny_moe(vocab_size=128), **VARIANTS[variant], **extra)


@functools.lru_cache(maxsize=None)
def _pair(variant, seed=0):
    """(JAX decoder, params, port decoder) with the same weights (flax's init, redrawn router so routes spread)."""
    jcfg = _jcfg(variant)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.tree.map(np.asarray, unbox(jdec.Decoder(jcfg).init(jax.random.PRNGKey(seed), ids,
                                                                     jnp.ones_like(ids))["params"]))
    return jdec.Decoder(jcfg), params, interop.load_params(Decoder(tcfg_of(jcfg)), params).eval()


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _left_padded(rng, B, S, vocab=128):
    ids = rng.integers(5, vocab, size=(B, S)).astype(np.int32)
    lens = rng.integers(S // 2, S + 1, size=B)
    lens[0] = S
    mask = (np.arange(S)[None, :] >= S - lens[:, None]).astype(np.int32)
    return np.where(mask > 0, ids, 0).astype(np.int32), mask


# ---- routers ---------------------------------------------------------------------------------------

@pytest.mark.parametrize("norm", [True, False])
def test_route_topk_matches_jax(norm):
    logits = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32) * 3
    jw, ji = jmoe.route_topk(jnp.asarray(logits), 4, norm)
    tw, ti = tmoe.route_topk(torch.from_numpy(logits), 4, norm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)


@pytest.mark.parametrize("norm", [True, False])
def test_route_noaux_tc_matches_jax(norm):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((64, 32)).astype(np.float32) * 2
    bias = rng.standard_normal(32).astype(np.float32) * 0.5
    jw, ji = jmoe.route_noaux_tc(jnp.asarray(logits), jnp.asarray(bias), 4, 8, 3, norm, 2.5)
    tw, ti = tmoe.route_noaux_tc(torch.from_numpy(logits), torch.from_numpy(bias), 4, 8, 3, norm, 2.5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    # the bias chooses but does not weigh: the weights are the raw sigmoid scores of the chosen experts
    raw = 1 / (1 + np.exp(-logits))
    chosen = np.take_along_axis(raw, ti.numpy(), axis=1)
    if not norm:
        np.testing.assert_allclose(tw.numpy(), chosen * 2.5, rtol=1e-6)


# ---- the block ----------------------------------------------------------------------------------------

def _block_pair(variant, seed):
    jcfg = dataclasses.replace(_jcfg(variant), moe_layer_start=0)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 9, jcfg.hidden_size)).astype(np.float32)
    block = jmoe.MoEBlock(jcfg)
    params = jax.tree.map(np.asarray, unbox(block.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]))
    params["router"] = (rng.standard_normal(params["router"].shape) * 0.5).astype(np.float32)  # spread the routes
    tblock = tmoe.MoEBlock(tcfg_of(jcfg))
    tblock.load_state_dict(interop.state_dict_for(tblock, params))
    return jcfg, block, params, tblock, x


@pytest.mark.parametrize("variant", ["dense", "dropless", "capacity", "v3_shared"])
def test_moe_block_matches_jax(variant):
    """The block's output and aux on both paths; with capacity 1.0 over groups of 7 tokens (27 tokens: the last
    group padded) some assignments are dropped, and their rows carry only the other choices."""
    jcfg, block, params, tblock, x = _block_pair(variant, seed=3)
    want, waux = block.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got, gaux = tblock(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=0, atol=1e-6)
    if variant == "capacity":
        x2 = torch.from_numpy(x).reshape(-1, jcfg.hidden_size)
        _, idx = tmoe.route_topk(x2 @ tblock.router, jcfg.num_experts_per_tok, jcfg.norm_topk_prob)
        g, C = tmoe.capacity(jcfg, x2.shape[0])
        assert (g, C) == (7, 4) and int((tmoe.dispatch_slots(idx, jcfg.num_experts, g) >= C).sum()) > 0
        # the dense path keeps every assignment: it differs from the capacity-limited output
        tblock.cfg = dataclasses.replace(tblock.cfg, moe_impl="dense")
        with torch.no_grad():
            dense, _ = tblock(torch.from_numpy(x))
        assert np.abs(dense.numpy() - got.numpy()).max() > 1e-3


def test_dispatch_slots_equal_the_reference_cumsum():
    """Slot of each assignment = earlier assignments to its expert in its group (token-major), as the
    reference's ``cumsum(assign) - assign`` over the padded one-hot (``moe.py:247-252``)."""
    rng = np.random.default_rng(4)
    T, K, E, g = 37, 3, 5, 8
    idx = np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
    T_pad = -(-T // g) * g
    flat = np.pad(idx, ((0, T_pad - T), (0, 0))).reshape(-1)
    assign = np.eye(E, dtype=np.int64)[flat] * np.repeat(np.arange(T_pad) < T, K)[:, None]
    assign = assign.reshape(T_pad // g, g * K, E)
    pos = np.sum(assign * (np.cumsum(assign, axis=1) - assign), axis=-1).reshape(T_pad, K)[:T]
    np.testing.assert_array_equal(tmoe.dispatch_slots(torch.from_numpy(idx), E, g).numpy(), pos)


def test_dense_and_dispatch_agree_and_the_dense_path_has_two_forms(monkeypatch):
    """Dropless dispatch equals the dense formula; above ``DENSE_ALL_TOKENS`` the dense path sums over the
    touched experts only, which equals the all-expert form."""
    _, _, _, tblock, x = _block_pair("dropless", seed=5)
    tblock.cfg = dataclasses.replace(tblock.cfg, moe_impl="auto")  # dense with a cache, else dispatch
    with torch.no_grad():
        disp, _ = tblock(torch.from_numpy(x))
        dense, _ = tblock(torch.from_numpy(x), decode=True)
        monkeypatch.setattr(tmoe, "DENSE_ALL_TOKENS", 4)
        touched, _ = tblock(torch.from_numpy(x), decode=True)
    np.testing.assert_allclose(disp.numpy(), dense.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(touched.numpy(), dense.numpy(), rtol=0, atol=1e-5)


# ---- the decoder ------------------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["dense", "capacity", "v3_shared", "softmax_start1"])
def test_moe_decoder_logits_and_aux_match_jax(variant):
    jmod, params, tmod = _pair(variant, seed=2)
    ids, mask = _left_padded(np.random.default_rng(6), 3, 14)
    want, waux = jax.jit(functools.partial(jmod.apply, return_moe_aux=True))({"params": params}, ids, mask)
    got, gaux = tmod(_t(ids), _t(mask), return_moe_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=0, atol=1e-6)
    cfg = tmod.cfg
    moe_layers = [i for i in range(cfg.num_layers) if hasattr(getattr(tmod, f"layer_{i}"), "moe")]
    assert moe_layers == list(range(cfg.moe_layer_start, cfg.num_layers))
    if cfg.moe_n_shared_experts:
        assert tuple(tmod.layer_1.moe.shared_gate.shape) == (64, 64)
        assert not hasattr(tmod.layer_0, "moe") and hasattr(tmod.layer_0, "gate_proj")


def test_moe_aux_and_its_gradient_match_jax():
    """``causal loss + w · aux`` and its gradient in every parameter, the aux the layer mean of each MoE layer's
    value over all tokens, pads included (``decoder.py:1013``)."""
    jmod, params, tmod = _pair("dropless", seed=8)
    ids, mask = _left_padded(np.random.default_rng(9), 2, 12)
    w = 0.5

    def jloss(p):
        logits, aux = jmod.apply({"params": p}, ids, mask, return_moe_aux=True)
        return jax_causal_lm_loss(logits, ids, mask) + w * aux

    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(params)
    tmod.zero_grad()
    logits, aux = tmod.train_forward(_t(ids), _t(mask), return_moe_aux=True)
    loss = causal_lm_loss(logits, _t(ids), _t(mask)) + w * aux
    loss.backward()
    assert abs(float(loss.detach()) - float(jval)) <= 1e-5
    jflat = flatten(jax.tree.map(np.asarray, jgrad))
    router_grads = 0.0
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jflat[name], rtol=0, atol=1e-5, err_msg=name)
        if name.endswith("moe.router"):
            router_grads += float(np.abs(jflat[name]).max())
    assert router_grads > 0  # the aux reaches the router


@pytest.mark.parametrize("variant", ["dropless", "v3_shared"])
def test_moe_cached_decode_matches_full_forward(variant):
    """Prefill into the cache and single-token steps (the dense path, ``moe_impl`` auto) against the full
    forward (the dispatch path) at the same positions."""
    _, _, tmod = _pair(variant, seed=4)
    B, P, steps = 2, 9, 4
    ids, mask = _left_padded(np.random.default_rng(10), B, P + steps)
    mask[:, P:] = 1
    full = tmod(_t(ids), _t(mask)).numpy()
    cache = tmod.init_kv_cache(B, P + steps)
    pos = np.clip(np.cumsum(mask, axis=1) - 1, 0, None)
    out, cache = tmod(_t(ids[:, :P]), _t(mask), positions=_t(pos[:, :P]), kv_cache=cache, cache_index=0)
    np.testing.assert_allclose(out.numpy()[:, -1], full[:, P - 1], rtol=0, atol=1e-5)
    for t in range(P, P + steps):
        out, cache = tmod(_t(ids[:, t:t + 1]), _t(mask), positions=_t(pos[:, t:t + 1]), kv_cache=cache,
                          cache_index=torch.full((B,), t, dtype=torch.long))
        np.testing.assert_allclose(out.numpy()[:, 0], full[:, t], rtol=0, atol=1e-5)


def _prompts(n, seed, p=10):
    rng = np.random.default_rng(seed)
    ids, mask = np.zeros((n, p), np.int32), np.zeros((n, p), np.int32)
    for i in range(n):
        real = int(rng.integers(3, p))
        ids[i, p - real:] = rng.integers(5, 120, size=real)
        mask[i, p - real:] = 1
    return ids, mask


def test_engine_and_speculative_lockstep_for_moe():
    """The engine (host loop and fused schedule) and prompt-lookup speculation (lockstep and in the engine)
    over the MoE decoder: every request's tokens equal the JAX package's greedy lockstep (``tests/models/
    test_mla.py:268-330``'s cases, on MoE)."""
    from dalm_tpu.models.generate import build_greedy_generate as jax_greedy

    jmod, params, tmod = _pair("v3_shared", seed=12)
    ids, mask = _prompts(5, 13)
    max_new = 6
    want = np.asarray(jax_greedy(jmod, max_new, eos_token_id=None, pad_token_id=0)(params, jnp.asarray(ids),
                                                                                    jnp.asarray(mask)))
    np.testing.assert_array_equal(build_greedy_generate(tmod, max_new)(_t(ids), _t(mask)).numpy(), want)
    eng = DecodeEngine(tmod, num_slots=3, max_prompt_len=10, max_new_tokens=max_new, pad_token_id=0)
    assert eng.generate(ids, mask) == eng.generate_fused(ids, mask) == [list(map(int, r)) for r in want]
    spec = build_speculative_generate(tmod, max_new, pad_token_id=0, gamma=3)(_t(ids), _t(mask)).numpy()
    np.testing.assert_array_equal(spec, want)
    speng = DecodeEngine(tmod, num_slots=2, max_prompt_len=10, max_new_tokens=max_new, pad_token_id=0,
                         speculative_gamma=3)
    assert speng.generate(ids, mask) == [list(map(int, r)) for r in want]


# ---- train_generator -------------------------------------------------------------------------------------

def _rows(n, seed=0, words=30):
    rng = np.random.default_rng(seed)
    vocab = ["alpha", "beta", "gamma", "delta", "retrieval", "generator", "topic", "answer", "question"]
    rows = []
    for i in range(n):
        user = " ".join(rng.choice(vocab, size=int(rng.integers(3, words)))) + f" {i}?"
        reply = " ".join(rng.choice(vocab, size=int(rng.integers(3, words)))) + f" {i * 7}."
        rows.append({"messages": [{"role": "user", "content": user}, {"role": "assistant", "content": reply}]})
    return rows


def _step_losses(out_dir):
    with open(os.path.join(out_dir, "generator_finetuning_metrics.jsonl")) as f:
        return [x["train/loss"] for x in map(json.loads, f) if "train/loss" in x]


def test_train_generator_moe_aux_weight_follows_the_jax_trainer(tmp_path, monkeypatch):
    """``train_generator(tiny-moe, moe_aux_weight=0.5)``: every step's loss (``loss + w · aux``), the validation
    loss and the trained factors against the JAX trainer from the same saved model and LoRA factors."""
    from dalm_tpu.data.tokenizer import resolve_tokenizer as jax_tokenizer  # noqa: F401  (the JAX trainer's)
    from dalm_tpu.models import lora as jlora
    from dalm_tpu.train import generator_only as jgen
    from dalm_tpu_torch.data import sft as tsft
    from dalm_tpu_torch.train import train_generator

    jsonl = tmp_path / "chat.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in _rows(40)))
    jcfg = jdec.DecoderConfig.tiny_moe()
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.tree.map(np.asarray, unbox(jdec.Decoder(jcfg).init(jax.random.PRNGKey(11), ids,
                                                                     jnp.ones_like(ids))["params"]))
    jdir, tdir = str(tmp_path / "jax_generator"), str(tmp_path / "torch_generator")
    jreg.save_pretrained(jdir, jcfg, params)
    tmod = Decoder(tcfg_of(jcfg))
    treg.save_pretrained(tdir, tmod.cfg, interop.state_dict_for(tmod, params))
    seed = 5
    split = tsft.create_datasets(str(jsonl), validation_split=0.3, seed=seed)
    monkeypatch.setattr(jgen, "create_datasets", lambda *a, **k: split)
    common = dict(seq_length=128, num_train_epochs=1, eval_steps=0, logging_steps=1, validation_split=0.3,
                  lora_r=8, lora_alpha=16, learning_rate=1e-2, num_warmup_steps=0, neftune_noise_alpha=0,
                  max_train_blocks=16, packing=True, seed=seed, gradient_checkpointing=True, moe_aux_weight=0.5)
    jout, tout = str(tmp_path / "jax_out"), str(tmp_path / "out")
    j = jgen.train_generator(jdir, "unused", output_dir=jout, per_device_train_batch_size=1,
                             per_device_eval_batch_size=1, **common)
    spec = jlora.LoraSpec(rank=8, alpha=16, dropout=0.05, target_modules=jlora.CAUSAL_LM_TARGETS)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    factors = jax.tree.map(np.asarray, jlora.init_lora_params(jax.random.fold_in(init_rng, 3), params, spec))
    seen = {}

    def hook(setup):
        interop.load_merge_lora(setup.model, factors, setup.lora_spec)
        seen["model"] = setup.model

    t = train_generator(tdir, str(jsonl), output_dir=tout, per_device_train_batch_size=8,
                        per_device_eval_batch_size=8, device="cpu", setup_hook=hook, **common)
    t_steps, j_steps = _step_losses(tout), _step_losses(jout)
    assert t["steps"] == j["steps"] == 2 and len(t_steps) == len(j_steps) == 2
    np.testing.assert_allclose(t_steps, j_steps, rtol=0, atol=5e-6)
    assert abs(t["eval_loss"] - j["eval_loss"]) <= 5e-6
    j_factors, _ = jlora.load_adapter(os.path.join(jout, "final_checkpoint"))
    for path, ab in interop.merge_lora_tree(seen["model"]).items():
        for leaf in ("lora_a", "lora_b"):
            np.testing.assert_allclose(ab[leaf], np.asarray(j_factors[path][leaf]), atol=3e-4)
    # the aux is in the loss: without it the first step's loss is lower by w · aux
    plain = train_generator(tdir, str(jsonl), output_dir=None, per_device_train_batch_size=8,
                            device="cpu", setup_hook=hook, **dict(common, moe_aux_weight=0.0))
    assert plain["final_loss"] != t["final_loss"]


# ---- presets and checkpoints ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE_PRESETS)
def test_moe_presets_match_jax(name):
    jcfg, cfg = jreg.DECODER_PRESETS[name](), treg.DECODER_PRESETS[name]()
    assert treg.config_from_json(jreg._config_to_json(jcfg)) == cfg
    assert jreg._config_from_json(treg.config_to_json(cfg)) == jcfg
    assert treg.resolve_decoder(name)[0] == cfg


HF_BASE = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=64, rms_norm_eps=1e-6, tie_word_embeddings=False)


def write_hf(path, config, shapes, seed):
    """A checkpoint directory: ``config.json`` and ``model.safetensors`` of seeded f32 tensors (norm weights
    around 1), written with ``safetensors`` alone."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    tensors = {}
    for name, shape in shapes.items():
        base = 1.0 if name.endswith(("norm.weight", "layernorm.weight")) else 0.0
        tensors[name] = (base + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    save_file(tensors, os.path.join(path, "model.safetensors"))
    return path


def moe_checkpoint(path, model_type, seed=0):
    E, H, V = 4, HF_BASE["hidden_size"], HF_BASE["vocab_size"]
    hd = 8
    if model_type == "mixtral":
        cfg = dict(HF_BASE, model_type="mixtral", intermediate_size=24, num_local_experts=E, num_experts_per_tok=2)
        M, moe, names = 24, "block_sparse_moe", ("w1", "w3", "w2")
    else:
        cfg = dict(HF_BASE, model_type="qwen3_moe", intermediate_size=40, moe_intermediate_size=16, num_experts=E,
                   num_experts_per_tok=2, norm_topk_prob=False, head_dim=hd)
        M, moe, names = 16, "mlp", ("gate_proj", "up_proj", "down_proj")
    qd = cfg["num_attention_heads"] * (hd if model_type == "qwen3_moe" else H // 4)
    kvd = cfg["num_key_value_heads"] * (hd if model_type == "qwen3_moe" else H // 4)
    shapes = {"model.embed_tokens.weight": (V, H), "model.norm.weight": (H,), "lm_head.weight": (V, H)}
    for i in range(HF_BASE["num_hidden_layers"]):
        hl = f"model.layers.{i}"
        shapes.update({f"{hl}.self_attn.q_proj.weight": (qd, H), f"{hl}.self_attn.k_proj.weight": (kvd, H),
                       f"{hl}.self_attn.v_proj.weight": (kvd, H), f"{hl}.self_attn.o_proj.weight": (H, qd),
                       f"{hl}.input_layernorm.weight": (H,), f"{hl}.post_attention_layernorm.weight": (H,),
                       f"{hl}.{moe}.gate.weight": (E, H)})
        if model_type == "qwen3_moe":
            shapes.update({f"{hl}.self_attn.q_norm.weight": (hd,), f"{hl}.self_attn.k_norm.weight": (hd,)})
        for j in range(E):
            for n, shape in zip(names, ((M, H), (M, H), (H, M))):
                shapes[f"{hl}.{moe}.experts.{j}.{n}.weight"] = shape
    return write_hf(path, cfg, shapes, seed)


def np_tree(tree):
    """Flat numpy leaves; bfloat16 as its 16 bits, from either side."""
    out = {}
    for k, v in flatten(tree).items():
        if isinstance(v, torch.Tensor):
            v = v.view(torch.int16).numpy() if v.dtype == torch.bfloat16 else v.numpy()
        else:
            v = np.asarray(v)
            v = v.view(np.int16) if v.dtype.name == "bfloat16" else v
        out[k] = v
    return out


def assert_trees_equal(t_tree, j_tree):
    ft, fj = np_tree(t_tree), np_tree(jax.tree.map(np.asarray, j_tree))
    assert sorted(ft) == sorted(fj)
    for k in ft:
        assert ft[k].dtype == fj[k].dtype and ft[k].shape == fj[k].shape, k
        assert np.array_equal(ft[k], fj[k]), k


@pytest.mark.parametrize("model_type", ["mixtral", "qwen3_moe"])
def test_hf_moe_checkpoints_load_as_the_jax_loader_does(tmp_path, model_type):
    """The config and the tree (per-expert tensors stacked, router transposed) equal the JAX loader's bit for bit;
    the logits equal the JAX decoder's on that tree; the packed loader's trees equal the reference's (experts and
    router stay unpacked, bf16)."""
    path = moe_checkpoint(str(tmp_path / model_type), model_type)
    jcfg, jtree = jhf.load_hf_decoder(path)
    cfg, tree = thf.load_hf_decoder(path)
    assert cfg == tcfg_of(jcfg) and cfg.num_experts == 4 and cfg.qk_norm == (model_type == "qwen3_moe")
    assert cfg.norm_topk_prob == (model_type == "mixtral")
    assert_trees_equal(tree, jtree)
    ids, mask = _left_padded(np.random.default_rng(3), 2, 10, vocab=96)
    want = jdec.Decoder(jcfg).apply({"params": jtree}, ids, mask)
    got = interop.load_params(Decoder(cfg), tree)(_t(ids), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert treg.resolve_decoder(path)[0] == cfg
    _, jres, jquant, _ = jqlora.load_hf_decoder_packed(path, quantize=True, min_size=256)
    _, res, quant, _ = tqlora.load_hf_decoder_packed(path, quantize=True, min_size=256)
    assert_trees_equal(res, jres)
    assert_trees_equal(quant, jquant)
    assert res["layer_0"]["moe"]["w_gate"].dtype == torch.bfloat16 and "moe" not in quant["layer_0"]


def test_interleaved_qwen3_moe_is_rejected_with_the_references_message(tmp_path):
    for extra in ({"decoder_sparse_step": 2}, {"mlp_only_layers": [0]}):
        path = str(tmp_path / str(len(extra) + len(str(extra))))
        os.makedirs(path)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(dict(HF_BASE, model_type="qwen3_moe", intermediate_size=40, num_experts=4, **extra), f)
        open(os.path.join(path, "model.safetensors"), "wb").close()
        with pytest.raises(ValueError) as want:
            jhf.load_hf_decoder(path)
        with pytest.raises(ValueError) as got:
            thf.load_hf_decoder(path)
        assert str(got.value) == str(want.value) and "interleaves dense MLP" in str(got.value)
