"""The port's GPT-2 family (``dalm_tpu_torch/models/gpt2.py``, its registry entries and the entry points that take
it) against the JAX package's (``dalm_tpu/models/gpt2.py``) on the CPU, in f32, at the tiny preset, weights carried
across with ``interop``, inputs drawn from a seed with numpy.

Covered: ``GPT2Decoder``'s logits (left padding, learned positions, tied head) and its cached decode (an int index
and the engine's per-row index); ``load_hf_gpt2`` on checkpoints written here with ``safetensors`` (``Conv1D``
(in, out) weights, with and without the ``transformer.`` prefix) against the JAX loader; the registry:
``GPT2Config`` through ``config_from_json`` (a ``params.msgpack`` directory the JAX package saved), the presets,
``model_type`` gpt2 dispatch; the entry points the JAX package runs GPT-2 on: ``RagPipeline`` (``answer`` against
the JAX pipeline, ``answer_continuous``; ``kv_quant`` raising its error), the engine, speculative decoding,
``evaluate_rag``'s generator loader; ``train_generator``, which the port runs on GPT-2 in full-parameter mode and
the JAX trainer does not (``use_peft`` raising the reference's "no kernels matched LoRA targets").

Tolerances: logits within 1e-5 (f32, sums in another order); loaded trees and greedy tokens equal; the first SFT
loss within 5e-6 of the JAX model's (as ``test_torch_sft.py``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.core.mesh import unbox
from dalm_tpu.models import gpt2 as jgpt2
from dalm_tpu.models import registry as jreg
from dalm_tpu_torch import interop
from dalm_tpu_torch.models import registry as treg
from dalm_tpu_torch.models.decode_engine import DecodeEngine
from dalm_tpu_torch.models.generate import build_greedy_generate
from dalm_tpu_torch.models.gpt2 import GPT2Config, GPT2Decoder, load_hf_gpt2
from dalm_tpu_torch.models.speculative import build_speculative_generate
from test_torch_moe import assert_trees_equal

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _jax_params(seed=0, vocab=512):
    jcfg = jgpt2.GPT2Config.tiny(vocab)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.tree.map(np.asarray, unbox(jgpt2.GPT2Decoder(jcfg).init(jax.random.PRNGKey(seed), ids,
                                                                         jnp.ones_like(ids))["params"]))
    rng = np.random.default_rng(seed)  # load-bearing LayerNorms and biases
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
        if p[-1].key in ("bias", "scale") else x, params)
    return jgpt2.GPT2Decoder(jcfg), params


def _pair(seed=0, vocab=512):
    jmod, params = _jax_params(seed, vocab)
    return jmod, params, interop.load_params(GPT2Decoder(GPT2Config.tiny(vocab)), params).eval()


def _left_padded(rng, B, S, vocab=512):
    ids = rng.integers(5, vocab, size=(B, S)).astype(np.int32)
    lens = rng.integers(S // 2, S + 1, size=B)
    lens[0] = S
    mask = (np.arange(S)[None, :] >= S - lens[:, None]).astype(np.int32)
    return np.where(mask > 0, ids, 0).astype(np.int32), mask


def test_gpt2_logits_match_jax():
    jmod, params, tmod = _pair(seed=1)
    ids, mask = _left_padded(np.random.default_rng(2), 3, 17)
    want = jax.jit(jmod.apply)({"params": params}, ids, mask)
    got = tmod(_t(ids), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tmod(_t(ids), _t(mask), return_hidden=True).numpy(),
                               np.asarray(jmod.apply({"params": params}, ids, mask, return_hidden=True)), atol=1e-5)
    assert sorted(dict(tmod.named_parameters())) == sorted(interop.flatten(params))  # no lm_head: tied to wte


@pytest.mark.parametrize("index", ["int", "rows"])
def test_gpt2_cache_matches_jax_and_the_full_forward(index):
    jmod, params, tmod = _pair(seed=3)
    B, P, steps = 2, 8, 4
    ids, mask = _left_padded(np.random.default_rng(4), B, P + steps)
    mask[:, P:] = 1
    L = P + steps
    full = tmod(_t(ids), _t(mask)).numpy()
    pos = np.clip(np.cumsum(mask, axis=1) - 1, 0, None)
    cache, jcache = tmod.init_kv_cache(B, L), jmod.init_kv_cache(B, L)
    out, cache = tmod(_t(ids[:, :P]), _t(mask), positions=_t(pos[:, :P]), kv_cache=cache, cache_index=0)
    jout, jcache = jmod.apply({"params": params}, ids[:, :P], mask, positions=pos[:, :P], kv_cache=jcache,
                              cache_index=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    for t in range(P, L):
        at = torch.full((B,), t, dtype=torch.long) if index == "rows" else t
        jat = jnp.full((B,), t, jnp.int32) if index == "rows" else t
        out, cache = tmod(_t(ids[:, t:t + 1]), _t(mask), positions=_t(pos[:, t:t + 1]), kv_cache=cache,
                          cache_index=at)
        jout, jcache = jmod.apply({"params": params}, ids[:, t:t + 1], mask, positions=pos[:, t:t + 1],
                                  kv_cache=jcache, cache_index=jat)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
        np.testing.assert_allclose(out.numpy()[:, 0], full[:, t], rtol=0, atol=1e-5)


def gpt2_checkpoint(path, prefix="", n_layer=2, n_embd=32, n_head=4, vocab=96, n_pos=64, seed=0):
    """An HF GPT-2 directory written with ``safetensors`` alone: ``Conv1D`` weights (in, out)."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    shapes = {"wte.weight": (vocab, n_embd), "wpe.weight": (n_pos, n_embd), "ln_f.weight": (n_embd,),
              "ln_f.bias": (n_embd,)}
    for i in range(n_layer):
        h = f"h.{i}"
        shapes.update({f"{h}.ln_1.weight": (n_embd,), f"{h}.ln_1.bias": (n_embd,), f"{h}.ln_2.weight": (n_embd,),
                       f"{h}.ln_2.bias": (n_embd,), f"{h}.attn.c_attn.weight": (n_embd, 3 * n_embd),
                       f"{h}.attn.c_attn.bias": (3 * n_embd,), f"{h}.attn.c_proj.weight": (n_embd, n_embd),
                       f"{h}.attn.c_proj.bias": (n_embd,), f"{h}.mlp.c_fc.weight": (n_embd, 4 * n_embd),
                       f"{h}.mlp.c_fc.bias": (4 * n_embd,), f"{h}.mlp.c_proj.weight": (4 * n_embd, n_embd),
                       f"{h}.mlp.c_proj.bias": (n_embd,)})
    tensors = {prefix + k: ((1.0 if k.endswith("weight") and len(s) == 1 else 0.0) + 0.2 * rng.standard_normal(s))
               .astype(np.float32) for k, s in shapes.items()}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "gpt2", "vocab_size": vocab, "n_embd": n_embd, "n_layer": n_layer, "n_head": n_head,
                   "n_positions": n_pos, "layer_norm_epsilon": 1e-5}, f)
    save_file(tensors, os.path.join(path, "model.safetensors"))
    return path


@pytest.mark.parametrize("prefix", ["", "transformer."], ids=["bare", "lm_head_model"])
def test_load_hf_gpt2_matches_the_jax_loader(tmp_path, prefix):
    """The tree equal to the JAX loader's bit for bit (no transpose), the config too, the logits equal the JAX
    decoder's; ``resolve_decoder`` dispatches on ``model_type`` gpt2."""
    path = gpt2_checkpoint(str(tmp_path / "hf"), prefix)
    jcfg, jtree = jgpt2.load_hf_gpt2(path)
    cfg, tree = load_hf_gpt2(path)
    assert treg.config_from_json(jreg._config_to_json(jcfg)) == cfg and cfg.intermediate_size == 128
    assert_trees_equal(tree, jtree)
    rcfg, state = treg.resolve_decoder(path)
    assert rcfg == cfg and isinstance(treg.build_decoder(rcfg), GPT2Decoder)
    model = treg.build_decoder(rcfg)
    model.load_state_dict(state)
    ids, mask = _left_padded(np.random.default_rng(5), 2, 11, vocab=96)
    want = jgpt2.GPT2Decoder(jcfg).apply({"params": jtree}, ids, mask)
    np.testing.assert_allclose(model(_t(ids), _t(mask)).numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["gpt2", "tiny-gpt2"])
def test_gpt2_presets_and_saved_configs_match_jax(tmp_path, name):
    """The presets, and a directory the JAX package saved (``GPT2Config`` through ``config_from_json``,
    ``params.msgpack``) resolving to a module with the same logits."""
    jcfg, cfg = jreg.DECODER_PRESETS[name](), treg.DECODER_PRESETS[name]()
    assert treg.config_from_json(jreg._config_to_json(jcfg)) == cfg == treg.resolve_decoder(name)[0]
    assert jreg._config_from_json(treg.config_to_json(cfg)) == jcfg
    if name == "tiny-gpt2":
        jmod, params = _jax_params(seed=6)
        jreg.save_pretrained(str(tmp_path / "g"), jmod.cfg, params)
        rcfg, state = treg.resolve_decoder(str(tmp_path / "g"))
        model = treg.build_decoder(rcfg)
        model.load_state_dict(state)
        ids, mask = _left_padded(np.random.default_rng(7), 2, 9)
        np.testing.assert_allclose(model(_t(ids), _t(mask)).numpy(),
                                   np.asarray(jmod.apply({"params": params}, ids, mask)), rtol=0, atol=1e-5)


def test_gpt2_generation_engine_and_speculation_match_jax():
    from dalm_tpu.models.generate import build_greedy_generate as jax_greedy

    jmod, params, tmod = _pair(seed=8, vocab=128)
    rng = np.random.default_rng(9)
    ids, mask = np.zeros((5, 10), np.int32), np.zeros((5, 10), np.int32)
    for i in range(5):
        real = int(rng.integers(3, 10))
        ids[i, 10 - real:] = rng.integers(5, 120, size=real)
        mask[i, 10 - real:] = 1
    want = np.asarray(jax_greedy(jmod, 6, eos_token_id=None, pad_token_id=0)(params, jnp.asarray(ids),
                                                                              jnp.asarray(mask)))
    rows = [list(map(int, r)) for r in want]
    np.testing.assert_array_equal(build_greedy_generate(tmod, 6)(_t(ids), _t(mask)).numpy(), want)
    eng = DecodeEngine(tmod, num_slots=3, max_prompt_len=10, max_new_tokens=6, pad_token_id=0)
    assert eng.generate(ids, mask) == rows and eng.generate_fused(ids, mask) == rows
    np.testing.assert_array_equal(build_speculative_generate(tmod, 6, pad_token_id=0, gamma=3)(_t(ids),
                                                                                                 _t(mask)).numpy(), want)


def test_gpt2_serving_and_eval_entry_points(tmp_path):
    """``RagPipeline`` with a GPT-2 generator: ``answer()`` equal to the JAX pipeline's on the same weights,
    ``answer_continuous()`` equal to ``answer()``; ``kv_quant`` raises the reference's error; a saved GPT-2
    directory loads through ``evaluate_rag``'s generator loader."""
    from dalm_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
    from dalm_tpu.models import encoder as jenc
    from dalm_tpu.models.embedder import SentenceEmbedder as JaxEmbedder
    from dalm_tpu.serve import RagPipeline as JaxRagPipeline
    from dalm_tpu_torch.data.tokenizer import ByteTokenizer
    from dalm_tpu_torch.eval.rag import load_generator_for_eval
    from dalm_tpu_torch.models.embedder import SentenceEmbedder
    from dalm_tpu_torch.models.encoder import EncoderConfig
    from dalm_tpu_torch.serve import RagPipeline

    passages = [f"passage about topic {i} with unique content {i}" for i in range(12)]
    queries = ["what is topic 3", "tell me about 7"]
    opts = dict(max_passage_len=32, max_prompt_len=64, max_new_tokens=4, embed_batch=8)
    retriever = JaxEmbedder(jenc.EncoderConfig.tiny())
    r_params = jax.tree.map(np.asarray, unbox(retriever.init_params(jax.random.PRNGKey(0))))
    jgen, g_params = _jax_params(seed=10)
    ref = JaxRagPipeline(retriever, r_params, JaxByteTokenizer(), jgen, g_params, JaxByteTokenizer(), passages,
                         **opts)

    def port(**kw):
        return RagPipeline(interop.load_params(SentenceEmbedder(EncoderConfig.tiny()), r_params), ByteTokenizer(),
                           interop.load_params(GPT2Decoder(GPT2Config.tiny()), g_params), ByteTokenizer(),
                           passages, device="cpu", **dict(opts, **kw))

    pipe = port()
    want = [a.answer for a in ref.answer(queries, top_k=4)]
    assert [a.answer for a in pipe.answer(queries, top_k=4)] == want
    assert [a.answer for a in pipe.answer_continuous(queries, top_k=4, num_slots=2)] == want
    with pytest.raises(ValueError) as got:
        port(kv_quant=True)
    with pytest.raises(ValueError) as ref_err:
        JaxRagPipeline(retriever, r_params, JaxByteTokenizer(), jgen, g_params, JaxByteTokenizer(), passages,
                       kv_quant=True, **opts)
    assert str(got.value) == str(ref_err.value)
    treg.save_pretrained(str(tmp_path / "g"), GPT2Config.tiny(), interop.state_dict_for(GPT2Decoder(
        GPT2Config.tiny()), g_params))
    loaded = load_generator_for_eval(str(tmp_path / "g"), device="cpu")
    assert isinstance(loaded, GPT2Decoder)
    ids, mask = _left_padded(np.random.default_rng(11), 2, 9)
    np.testing.assert_allclose(loaded(_t(ids), _t(mask)).numpy(),
                               np.asarray(jgen.apply({"params": g_params}, ids, mask)), rtol=0, atol=1e-5)


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    vocab = ["alpha", "beta", "gamma", "delta", "retrieval", "generator", "topic", "answer"]
    return [{"messages": [{"role": "user", "content": " ".join(rng.choice(vocab, size=12)) + f" {i}?"},
                          {"role": "assistant", "content": " ".join(rng.choice(vocab, size=14)) + "."}]}
            for i in range(n)]


def test_train_generator_on_gpt2_trains_every_parameter(tmp_path, monkeypatch):
    """Full-parameter SFT of tiny-gpt2 runs in the port: the first step's loss is the JAX GPT-2's causal loss on
    the first batch, the loss falls, every parameter moves, the saved directory resolves to a ``GPT2Config``. The
    JAX trainer does not run GPT-2 (it passes ``return_moe_aux`` to every decoder, ``generator_only.py:339``,
    which ``GPT2Decoder`` does not take); LoRA raises the reference's error (GPT-2 has no q_proj / v_proj)."""
    from dalm_tpu.losses.causal import causal_lm_loss as jax_causal_lm_loss
    from dalm_tpu.train import generator_only as jgen
    from dalm_tpu_torch.data import sft as tsft
    from dalm_tpu_torch.train import train_generator

    jsonl = tmp_path / "chat.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in _rows(40)))
    jmod, params = _jax_params(seed=12)
    jdir, tdir = str(tmp_path / "jax_generator"), str(tmp_path / "torch_generator")
    jreg.save_pretrained(jdir, jmod.cfg, params)
    treg.save_pretrained(tdir, GPT2Config.tiny(), interop.state_dict_for(GPT2Decoder(GPT2Config.tiny()), params))
    seed = 5
    split = tsft.create_datasets(str(jsonl), validation_split=0.3, seed=seed)
    monkeypatch.setattr(jgen, "create_datasets", lambda *a, **k: split)
    common = dict(seq_length=64, num_train_epochs=1, eval_steps=0, logging_steps=1, validation_split=0.3,
                  learning_rate=1e-3, num_warmup_steps=0, neftune_noise_alpha=0, max_train_blocks=16, packing=True,
                  seed=seed, use_peft=False)
    with pytest.raises(TypeError, match="return_moe_aux"):
        jgen.train_generator(jdir, "unused", output_dir=None, per_device_train_batch_size=1, **common)
    seen = {}

    def hook(setup):
        seen["before"] = {k: p.detach().clone() for k, p in setup.model.named_parameters()}
        seen["setup"] = setup

    tout = str(tmp_path / "out")
    t = train_generator(tdir, str(jsonl), output_dir=tout, per_device_train_batch_size=8,
                        per_device_eval_batch_size=8, device="cpu", setup_hook=hook, **common)
    with open(os.path.join(tout, "generator_finetuning_metrics.jsonl")) as f:
        losses = [x["train/loss"] for x in map(json.loads, f) if "train/loss" in x]
    setup = seen["setup"]
    order = np.random.default_rng([seed, 0]).permutation(len(setup.train_blocks))
    ids = np.asarray(setup.train_blocks[order[:8]], np.int32)
    want = float(jax_causal_lm_loss(jmod.apply({"params": params}, ids, np.ones_like(ids)), ids, np.ones_like(ids)))
    assert t["steps"] == 2 and abs(losses[0] - want) <= 5e-6 and losses[1] < losses[0]
    moved = [k for k, p in setup.model.named_parameters() if not torch.equal(p.detach(), seen["before"][k])]
    assert sorted(moved) == sorted(seen["before"])
    assert isinstance(treg.resolve_decoder(os.path.join(tout, "final_checkpoint"))[0], GPT2Config)
    with pytest.raises(ValueError, match="no kernels matched LoRA targets"):
        train_generator(tdir, str(jsonl), device="cpu", output_dir=None, **dict(common, use_peft=True))
