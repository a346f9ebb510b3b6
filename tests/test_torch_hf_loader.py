"""The port's readers of Hugging Face checkpoints and tokenizers (``dalm_tpu_torch/models/hf_loader.py``,
``models/qlora.py:load_hf_decoder_packed``, ``data/tokenizer.py``, ``models/registry.py``) against the JAX
package's and against ``transformers``' own models, on tiny checkpoints written here with the installed
``transformers``, ``safetensors`` and ``tokenizers`` (nothing is downloaded).

Tolerances: the parameter trees equal the JAX loader's bit for bit; logits within 1e-4 of HF's (f32 on both sides,
sums in another order); the safetensors reader equals ``safetensors``' own; packed trees equal; token ids equal.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores

transformers = pytest.importorskip("transformers")

import jax  # noqa: E402

from dalm_tpu.models import hf_loader as jhf  # noqa: E402
from dalm_tpu.models import qlora as jqlora  # noqa: E402
from dalm_tpu_torch.core.tree import flatten  # noqa: E402
from dalm_tpu_torch.interop import load_params  # noqa: E402
from dalm_tpu_torch.models import hf_loader as thf  # noqa: E402
from dalm_tpu_torch.models import qlora as tqlora  # noqa: E402
from dalm_tpu_torch.models import registry  # noqa: E402
from dalm_tpu_torch.models.decoder import Decoder  # noqa: E402
from dalm_tpu_torch.models.encoder import Encoder  # noqa: E402

SMALL = dict(vocab_size=256, hidden_size=48, num_hidden_layers=2, num_attention_heads=4, intermediate_size=96,
             max_position_embeddings=64)


def _perturb(model, names, mean):
    """Draw the named parameters (norms that init to an identity, biases that init to 0) around ``mean`` so they
    are load-bearing."""
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if any(k in n for k in names):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5 + mean)


# family -> (config class, model class, config kwargs, parameters to draw)
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(num_key_value_heads=2, tie_word_embeddings=False), ()),
    "llama31": ("LlamaConfig", "LlamaForCausalLM", dict(
        num_key_value_heads=2, rope_theta=100.0, tie_word_embeddings=False, rope_scaling={
            "rope_type": "llama3", "factor": 2.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
            "original_max_position_embeddings": 32}), ()),
    "mistral": ("MistralConfig", "MistralForCausalLM", dict(num_key_value_heads=2, sliding_window=6,
                                                           tie_word_embeddings=False), ()),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", dict(num_key_value_heads=2, tie_word_embeddings=False),
              ("proj.bias",)),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM", dict(num_key_value_heads=2, head_dim=16, tie_word_embeddings=False,
                                                     attn_implementation="eager"), ("q_norm", "k_norm")),
    "phi3": ("Phi3Config", "Phi3ForCausalLM", dict(num_key_value_heads=2, sliding_window=6, tie_word_embeddings=False,
                                                  pad_token_id=0, bos_token_id=1, eos_token_id=2,
                                                  attn_implementation="eager"), ()),
    "gemma": ("GemmaConfig", "GemmaForCausalLM", dict(num_key_value_heads=1, head_dim=16, rms_norm_eps=1e-6,
                                                     hidden_act="gelu_pytorch_tanh"), ("norm",)),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM", dict(
        num_hidden_layers=4, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-6, sliding_window=6,
        query_pre_attn_scalar=8, attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        attn_implementation="eager"), ("norm",)),
    "gemma3": ("Gemma3TextConfig", "Gemma3ForCausalLM", dict(
        num_hidden_layers=6, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-6, sliding_window=6,
        sliding_window_pattern=3, query_pre_attn_scalar=8, rope_theta=1_000_000.0, rope_local_base_freq=10_000.0,
        rope_scaling={"rope_type": "linear", "factor": 2.0}, attn_implementation="eager"), ("norm",)),
}


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """family -> (checkpoint directory, the HF model); "llama-bin" is the llama checkpoint as pytorch_model.bin."""
    out = {}
    for name, (cfg_cls, model_cls, kw, drawn) in FAMILIES.items():
        torch.manual_seed(len(name))
        model = getattr(transformers, model_cls)(getattr(transformers, cfg_cls)(**{**SMALL, **kw}))
        _perturb(model, drawn, 1.0 if name == "qwen3" else 0.0)
        model.eval()
        d = tmp_path_factory.mktemp(f"hf_{name}")
        model.save_pretrained(d, safe_serialization=True)
        out[name] = (str(d), model)
        if name == "llama":
            d = tmp_path_factory.mktemp("hf_llama_bin")
            model.save_pretrained(d, safe_serialization=False)
            out["llama-bin"] = (str(d), model)
    return out


def _np(tree):
    """Flat numpy leaves; bfloat16 (which numpy lacks) as its 16 bits, from either side."""
    out = {}
    for k, v in flatten(tree).items():
        if isinstance(v, torch.Tensor):
            v = v.view(torch.int16).numpy() if v.dtype == torch.bfloat16 else v.numpy()
        else:
            v = np.asarray(v)
            v = v.view(np.int16) if v.dtype.name == "bfloat16" else v
        out[k] = v
    return out


def _assert_trees_equal(t_tree, j_tree):
    ft, fj = _np(t_tree), _np(jax.tree.map(np.asarray, j_tree))
    assert sorted(ft) == sorted(fj)
    for k in ft:
        assert ft[k].dtype == fj[k].dtype == np.float32 and ft[k].shape == fj[k].shape, k
        assert np.array_equal(ft[k], fj[k]), k


def _hf_logits(model, ids):
    with torch.no_grad():
        return model(torch.from_numpy(ids)).logits.numpy()


@pytest.mark.parametrize("family", sorted(FAMILIES) + ["llama-bin"])
def test_decoder_checkpoint_equals_jax_loader_and_hf_logits(hf_dirs, family):
    path, hf_model = hf_dirs[family]
    tcfg, t_tree = thf.load_hf_decoder(path)
    jcfg, j_tree = jhf.load_hf_decoder(path)
    _assert_trees_equal(t_tree, j_tree)
    for f in dataclasses.fields(tcfg):
        want = getattr(jcfg, f.name)
        got = getattr(tcfg, f.name)
        if f.name not in ("dtype", "param_dtype"):
            assert got == want, f.name
    model = load_params(Decoder(tcfg), t_tree)
    ids = np.random.default_rng(0).integers(1, 250, size=(2, 14)).astype(np.int64)
    got = model(torch.from_numpy(ids), torch.ones((2, 14), dtype=torch.long)).numpy()
    np.testing.assert_allclose(got, _hf_logits(hf_model, ids), rtol=0, atol=1e-4)


def test_registry_resolves_hf_directories(hf_dirs):
    """``resolve_decoder`` on an HF directory gives a state dict the entry points' ``load_state_dict`` takes."""
    path, hf_model = hf_dirs["gemma2"]
    cfg, state = registry.resolve_decoder(path)
    model = Decoder(cfg)
    model.load_state_dict(state)
    ids = np.random.default_rng(1).integers(1, 250, size=(1, 12)).astype(np.int64)
    np.testing.assert_allclose(model(torch.from_numpy(ids)).numpy(), _hf_logits(hf_model, ids), rtol=0, atol=1e-4)


def test_bert_encoder_equals_jax_loader_and_hf(tmp_path):
    cfg = transformers.BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                  intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf_model = transformers.BertModel(cfg).eval()
    hf_model.save_pretrained(tmp_path, safe_serialization=True)
    tcfg, t_tree = thf.load_hf_encoder(str(tmp_path))
    _, j_tree = jhf.load_hf_encoder(str(tmp_path))
    _assert_trees_equal(t_tree, j_tree)
    rcfg, state = registry.resolve_encoder(str(tmp_path))
    assert rcfg == tcfg
    enc = load_params(Encoder(tcfg), t_tree)
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 120, size=(2, 10))
    mask = np.ones((2, 10), np.int64)
    mask[1, 7:] = 0
    with torch.no_grad():
        want = hf_model(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
    got = enc(torch.from_numpy(ids), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1, :7], want[1, :7], rtol=0, atol=1e-4)


def _write(tmp_path, config, weights=True):
    (tmp_path / "config.json").write_text(json.dumps(config))
    if weights:
        (tmp_path / "model.safetensors").write_bytes(b"")
    return str(tmp_path)


BASE_HF = {"vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 4,
           "intermediate_size": 64}
REJECTED = {
    "multimodal_gemma3": ({"model_type": "gemma3"}, "gemma3"),
    "qwen3_with_bias": ({"model_type": "qwen3", "attention_bias": True, **BASE_HF}, "o_proj"),
    "phi3_partial_rotary": ({"model_type": "phi3", "partial_rotary_factor": 0.5, **BASE_HF}, "partial_rotary_factor"),
    "yarn_rope": ({"model_type": "qwen2", "rope_scaling": {"rope_type": "yarn", "factor": 4.0}, **BASE_HF},
                  "rope_scaling"),
    "dynamic_rope": ({"model_type": "llama", "rope_scaling": {"type": "dynamic", "factor": 2.0}, **BASE_HF},
                     "rope_scaling"),
    "gemma2_layer_types": ({"model_type": "gemma2", "layer_types": ["full_attention"], **BASE_HF}, "layer_types"),
    "unknown_hidden_act": ({"model_type": "llama", "hidden_act": "relu", **BASE_HF}, "hidden_act"),
}


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_rejections_raise_as_the_jax_loader_does(tmp_path, name):
    config, match = REJECTED[name]
    path = _write(tmp_path, config)
    with pytest.raises(ValueError, match=match) as want:
        jhf.load_hf_decoder(path)
    with pytest.raises(ValueError, match=match) as got:
        thf.load_hf_decoder(path)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("model_type,module", [("mixtral", "models/moe.py"), ("qwen3_moe", "models/moe.py"),
                                               ("deepseek_v3", "models/mla.py"), ("gpt2", "models/gpt2.py")])
def test_unported_model_types_raise_naming_their_module(tmp_path, model_type, module):
    """These model types raised until their modules were ported; now ``resolve_decoder`` reads each, with the JAX
    loader's config and tree (the families' own files hold the rest: ``test_torch_moe.py``, ``test_torch_mla.py``,
    ``test_torch_gpt2.py``)."""
    import os

    from test_torch_gpt2 import gpt2_checkpoint
    from test_torch_mla import CHECKPOINTS, deepseek_checkpoint
    from test_torch_moe import assert_trees_equal, moe_checkpoint

    from dalm_tpu.models import gpt2 as jgpt2
    from dalm_tpu.models import registry as jreg

    assert os.path.exists(os.path.join(os.path.dirname(thf.__file__), os.path.basename(module)))
    path = str(tmp_path / model_type)
    if model_type == "gpt2":
        jcfg, jtree = jgpt2.load_hf_gpt2(gpt2_checkpoint(path))
    elif model_type == "deepseek_v3":
        jcfg, jtree = jhf.load_hf_decoder(deepseek_checkpoint(path, CHECKPOINTS["moe_yarn"]))
    else:
        jcfg, jtree = jhf.load_hf_decoder(moe_checkpoint(path, model_type))
    cfg, state = registry.resolve_decoder(path)
    assert cfg == registry.config_from_json(jreg._config_to_json(jcfg))
    assert_trees_equal(registry.tree_to_state(jax.tree.map(np.asarray, jtree)), state)


def _read_all(path):
    with thf.SafetensorsFile(path) as f:
        return {k: f[k] for k in f.keys()}


def test_safetensors_reader_equals_the_safetensors_package(tmp_path):
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import load_file as torch_load_file
    from safetensors.torch import save_file as torch_save_file

    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((33, 17)).astype(np.float32), "h": rng.standard_normal(9).astype(np.float16),
              "i": np.arange(24, dtype=np.int64).reshape(2, 3, 4), "b": np.array([True, False, True]),
              "u": rng.integers(0, 255, size=(5,)).astype(np.uint8), "empty": np.zeros((0, 3), np.float32),
              "s": np.array(3.5, dtype=np.float32)}
    save_file(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    want = load_file(str(tmp_path / "a.safetensors"))
    got = _read_all(str(tmp_path / "a.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype and np.array_equal(got[k].numpy(), want[k]), k
    bf = {"x": torch.randn(7, 5, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)}
    torch_save_file(bf, str(tmp_path / "b.safetensors"))
    got = _read_all(str(tmp_path / "b.safetensors"))
    assert got["x"].dtype == torch.bfloat16 and torch.equal(got["x"], torch_load_file(str(tmp_path / "b.safetensors"))["x"])
    (tmp_path / "bad.safetensors").write_bytes(b"\x01")
    with pytest.raises(ValueError, match="not a safetensors file"):
        _read_all(str(tmp_path / "bad.safetensors"))


@pytest.mark.parametrize("quantize", [True, False])
def test_load_hf_decoder_packed_equals_jax(hf_dirs, quantize):
    """The streamed packed load: residual and quant trees equal the JAX loader's (int8 per column, or bf16 ``w``),
    and the packed module's logits equal the JAX packed decoder's."""
    from dalm_tpu.models import decoder as jdec
    from dalm_tpu_torch.interop import load_packed
    from dalm_tpu_torch.models.lora import LoraSpec

    path, _ = hf_dirs["qwen2"]
    spec = LoraSpec(rank=4, alpha=8.0, target_modules=("q_proj", "v_proj"))
    tcfg, t_res, t_quant, t_lora = tqlora.load_hf_decoder_packed(path, spec=spec, quantize=quantize, min_size=1024,
                                                                 dtype=torch.float32)
    jcfg, j_res, j_quant, j_lora = jqlora.load_hf_decoder_packed(path, spec=spec, quantize=quantize, min_size=1024,
                                                                 dtype=np.float32)
    for tt, jt in ((t_res, j_res), (t_quant, j_quant)):
        ft, fj = _np(tt), _np(jax.tree.map(np.asarray, jt))
        assert sorted(ft) == sorted(fj)
        for k in ft:
            assert ft[k].dtype == fj[k].dtype and np.array_equal(ft[k], fj[k]), k
    assert {k: v.shape for k, v in flatten(t_lora).items()} == \
        {k: tuple(v.shape) for k, v in flatten(jax.tree.map(np.asarray, j_lora)).items()}
    model = load_packed(Decoder(tcfg), t_res, t_quant)
    ids = np.random.default_rng(3).integers(1, 250, size=(2, 10))
    want = np.asarray(jax.jit(jdec.Decoder(jcfg).apply)({"params": j_res, "quant": j_quant}, ids))
    np.testing.assert_allclose(model(torch.from_numpy(ids)).numpy(), want, rtol=0, atol=1e-4)


def test_hf_tokenizer_adapter_equals_jax(tmp_path):
    from tokenizers import Tokenizer, models, pre_tokenizers

    from dalm_tpu.data.tokenizer import resolve_tokenizer as j_resolve
    from dalm_tpu_torch.data.tokenizer import HFTokenizerAdapter
    from dalm_tpu_torch.data.tokenizer import resolve_tokenizer as t_resolve

    words = ["<unk>", "<pad>", "</s>", "the", "cat", "sat", "on", "mat", "a", "dog"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", eos_token="</s>")
    fast.save_pretrained(tmp_path)
    texts = ["the cat sat on the mat", "a dog", "the unknown zebra sat"]
    for add_eos in (False, True):
        t, j = t_resolve(str(tmp_path), add_eos_token=add_eos), j_resolve(str(tmp_path), add_eos_token=add_eos)
        assert isinstance(t, HFTokenizerAdapter)
        assert (t.vocab_size, t.pad_token_id, t.eos_token_id) == (j.vocab_size, j.pad_token_id, j.eos_token_id)
        for side in ("right", "left"):
            t.padding_side = j.padding_side = side
            assert t(texts, max_length=8) == j(texts, max_length=8)
            assert t.encode_batch(texts, padding="longest") == j.encode_batch(texts, padding="longest")
        ids = t(texts[0], max_length=8)["input_ids"][0]
        assert t.decode(ids) == j.decode(ids)


def test_hf_tokenizer_without_transformers_raises(monkeypatch):
    import sys

    from dalm_tpu_torch.data.tokenizer import ByteTokenizer, resolve_tokenizer

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        resolve_tokenizer("/some/tokenizer/dir")
    assert isinstance(resolve_tokenizer("byte"), ByteTokenizer)


@pytest.mark.parametrize("family", ["phi3", "gemma2"])
def test_peft_export_of_phi3_and_gemma_equals_the_reference(tmp_path, hf_dirs, family):
    """An adapter on a Phi-3 or Gemma decoder exports under the module paths and values the reference writes
    (``dalm_tpu/models/hf_loader.py:557-636``: ``model.layers.<i>.self_attn.<module>`` for every dense family)."""
    from dalm_tpu_torch.models.lora import LoraSpec

    path, _ = hf_dirs[family]
    tcfg, _ = thf.load_hf_decoder(path)
    jcfg, _ = jhf.load_hf_decoder(path)
    assert thf.peft_arch_for_config(tcfg) == jhf.peft_arch_for_config(jcfg) == "llama"
    rng = np.random.default_rng(0)
    spec = LoraSpec(rank=2, alpha=4.0, target_modules=("q_proj", "v_proj", "gate_proj"))
    flat = {f"layer_{i}/{m}/kernel": {"lora_a": rng.standard_normal((48, 2)).astype(np.float32),
                                      "lora_b": rng.standard_normal((2, 16)).astype(np.float32)}
            for i in range(2) for m in spec.target_modules}
    assert thf.export_peft_if_supported(str(tmp_path / "t"), {k: {n: torch.from_numpy(a) for n, a in ab.items()}
                                                            for k, ab in flat.items()}, spec, tcfg)
    assert jhf.export_peft_if_supported(str(tmp_path / "j"), flat, spec, jcfg)
    t = torch.load(tmp_path / "t" / "adapter_model.bin", weights_only=True)
    j = torch.load(tmp_path / "j" / "adapter_model.bin", weights_only=True)
    assert sorted(t) == sorted(j) and "base_model.model.model.layers.1.self_attn.gate_proj.lora_A.weight" in t
    for k in t:
        assert torch.equal(t[k], j[k]), k
    assert json.loads((tmp_path / "t" / "adapter_config.json").read_text()) == \
        json.loads((tmp_path / "j" / "adapter_config.json").read_text())


def _word_tokenizer(path):
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = ["<unk>", "<pad>", "</s>"] + [f"w{i}" for i in range(60)] + ["#query#", "#passage#", "#answer#"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", eos_token="</s>",
                                         pad_token="<pad>").save_pretrained(path)
    return str(path)


def test_entry_points_read_hf_checkpoints_and_tokenizers(tmp_path, hf_dirs):
    """``RagPipeline.from_pretrained`` on a BERT and a Qwen2 HF directory with a local HF tokenizer answers on the
    CPU, and ``train_generator`` fine-tunes the Gemma2 HF directory with it."""
    from dalm_tpu_torch.serve import RagPipeline
    from dalm_tpu_torch.train import train_generator

    tok = _word_tokenizer(tmp_path / "tok")
    bert = transformers.BertModel(transformers.BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=1,
                                                          num_attention_heads=2, intermediate_size=64))
    bert.save_pretrained(tmp_path / "bert", safe_serialization=True)
    passages = [" ".join(f"w{(i * 7 + j) % 60}" for j in range(12)) for i in range(16)]
    pipe = RagPipeline.from_pretrained(str(tmp_path / "bert"), hf_dirs["qwen2"][0], passages, device="cpu",
                                       retriever_tokenizer=tok, generator_tokenizer=tok, max_new_tokens=4,
                                       max_passage_len=16, max_prompt_len=32)
    answers = pipe.answer(["w1 w2 w3", "w40 w41"], top_k=2)
    assert len(answers) == 2 and all(len(a.passages) == 2 for a in answers)
    data = tmp_path / "chat.jsonl"
    with open(data, "w") as f:
        for i in range(8):
            f.write(json.dumps({"messages": [{"role": "user", "content": " ".join(f"w{(i + j) % 60}" for j in range(40))},
                                             {"role": "assistant", "content": "w5 w6 w7"}]}) + "\n")
    out = train_generator(hf_dirs["gemma2"][0], str(data), tokenizer=tok, device="cpu", seq_length=32,
                          per_device_train_batch_size=2, max_train_blocks=2, num_warmup_steps=0, output_dir=None,
                          lora_r=4, lora_alpha=8, eval_steps=0, validation_split=0.25)
    assert out["steps"] >= 1 and np.isfinite(out["final_loss"])
