"""The port's serving slice as a whole against the JAX package: the same
tiny retriever and generator weights, ByteTokenizer, 12 passages and 2
queries through ``RagPipeline.answer`` on both sides. Retrieved ids are
equal, scores within 1e-5 (unit-norm embeddings, f32) and answer strings
equal, with the float generator and with each serving tier (an int8 or 4-bit
generator packed by the pipeline, the int8 KV cache). Also round-trips the
port's ``save_pretrained`` / ``from_pretrained``, and loads PEFT adapters of
both towers through it against the JAX pipeline built from JAX-merged trees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.core.mesh import unbox
from dalm_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from dalm_tpu.models import decoder as jdec
from dalm_tpu.models import encoder as jenc
from dalm_tpu.models.embedder import SentenceEmbedder as JaxEmbedder
from dalm_tpu.serve import RagPipeline as JaxRagPipeline
from dalm_tpu_torch.data.tokenizer import ByteTokenizer
from dalm_tpu_torch.interop import load_params
from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
from dalm_tpu_torch.models.embedder import SentenceEmbedder
from dalm_tpu_torch.models.encoder import EncoderConfig
from dalm_tpu_torch.models.registry import save_pretrained
from dalm_tpu_torch.serve import RagPipeline

PASSAGES = [f"passage about topic {i} with unique content {i}" for i in range(12)]
QUERIES = ["what is topic 3", "tell me about 7"]
OPTS = dict(max_passage_len=32, max_prompt_len=64, max_new_tokens=4, embed_batch=8)


@pytest.fixture(scope="module")
def jax_weights():
    retriever = JaxEmbedder(jenc.EncoderConfig.tiny())
    r_params = jax.tree.map(np.asarray, unbox(retriever.init_params(jax.random.PRNGKey(0))))
    generator = jdec.Decoder(jdec.DecoderConfig.tiny())
    ids = jnp.zeros((1, 8), jnp.int32)
    g_params = jax.tree.map(np.asarray, unbox(generator.init(jax.random.PRNGKey(1), ids, jnp.ones_like(ids))["params"]))
    return retriever, r_params, generator, g_params


def _port_pipeline(r_params, g_params, **kw):
    retriever = load_params(SentenceEmbedder(EncoderConfig.tiny()), r_params)
    generator = load_params(Decoder(DecoderConfig.tiny()), g_params)
    return RagPipeline(retriever, ByteTokenizer(), generator, ByteTokenizer(), PASSAGES, device="cpu",
                       **dict(OPTS, **kw))


@pytest.mark.parametrize("quantize", [False, "int8", "int4"])
def test_pipeline_matches_jax(jax_weights, quantize):
    retriever, r_params, generator, g_params = jax_weights
    ref = JaxRagPipeline(retriever, r_params, JaxByteTokenizer(), generator, g_params, JaxByteTokenizer(),
                         PASSAGES, index_quantize=quantize, **OPTS)
    pipe = _port_pipeline(r_params, g_params, index_quantize=quantize)

    js, ji = ref.retrieve(QUERIES, top_k=4)
    ts, ti = pipe.retrieve(QUERIES, top_k=4)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)

    j_ans = ref.answer(QUERIES, top_k=4)
    t_ans = pipe.answer(QUERIES, top_k=4)
    assert [a.answer for a in t_ans] == [a.answer for a in j_ans]
    assert [a.passages for a in t_ans] == [a.passages for a in j_ans]
    for a in t_ans:
        assert len(a.passages) == 4 and a.scores == sorted(a.scores, reverse=True)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float-cache", "int8-cache"])
@pytest.mark.parametrize("quantize_generator", [True, "int4", "nf4", "int4pc"])
def test_quantized_pipeline_matches_jax(jax_weights, quantize_generator, kv_quant):
    """The generator packed in place by the pipeline, as the reference packs its tree."""
    retriever, r_params, generator, g_params = jax_weights
    ref = JaxRagPipeline(retriever, r_params, JaxByteTokenizer(), generator, g_params, JaxByteTokenizer(),
                         PASSAGES, quantize_generator=quantize_generator, kv_quant=kv_quant, **OPTS)
    pipe = _port_pipeline(r_params, g_params, quantize_generator=quantize_generator, kv_quant=kv_quant)
    leaves = dict(pipe.generator.named_buffers())
    assert ("layer_0.attention.q_proj.q4" in leaves) == (quantize_generator is not True)
    assert pipe.generator.cfg.kv_quant == kv_quant
    j_ans, t_ans = ref.answer(QUERIES, top_k=4), pipe.answer(QUERIES, top_k=4)
    assert [a.answer for a in t_ans] == [a.answer for a in j_ans]
    assert [a.passages for a in t_ans] == [a.passages for a in j_ans]


def test_save_and_from_pretrained_round_trip(jax_weights, tmp_path):
    _, r_params, _, g_params = jax_weights
    pipe = _port_pipeline(r_params, g_params)
    save_pretrained(str(tmp_path / "retriever"), pipe.retriever.config, pipe.retriever.module.state_dict())
    save_pretrained(str(tmp_path / "generator"), pipe.generator.cfg, pipe.generator.state_dict())
    loaded = RagPipeline.from_pretrained(str(tmp_path / "retriever"), str(tmp_path / "generator"), PASSAGES,
                                         device="cpu", **OPTS)
    for a, b in zip(loaded.generator.state_dict().values(), pipe.generator.state_dict().values()):
        assert torch.equal(a, b)
    assert [a.answer for a in loaded.answer(QUERIES)] == [a.answer for a in pipe.answer(QUERIES)]
    np.testing.assert_array_equal(loaded.retrieve(QUERIES)[1], pipe.retrieve(QUERIES)[1])


def test_jax_registry_reads_the_ports_config_json(jax_weights, tmp_path):
    """config.json keeps the reference schema: the JAX loader parses it."""
    import json

    from dalm_tpu.models.registry import _config_from_json

    _, _, _, g_params = jax_weights
    gen = load_params(Decoder(DecoderConfig.tiny()), g_params)
    save_pretrained(str(tmp_path), gen.cfg, gen.state_dict())
    with open(tmp_path / "config.json") as f:
        cfg = _config_from_json(json.load(f))
    assert cfg == jdec.DecoderConfig.tiny()


def test_from_pretrained_presets_random_init_on_cpu():
    pipe = RagPipeline.from_pretrained("tiny", "tiny", PASSAGES, device="cpu", **OPTS)
    answers = pipe.answer(QUERIES, top_k=3)
    assert len(answers) == 2 and all(len(a.passages) == 3 for a in answers)
    spec = RagPipeline.from_pretrained("tiny", "tiny", PASSAGES, device="cpu", speculative=True, **OPTS)
    assert [a.answer for a in spec.answer(QUERIES, top_k=3)] == [a.answer for a in answers]


def _adapter(params, spec, seed):
    """Seeded nonzero factors for every target kernel of ``params`` (B is drawn too: a fresh adapter's zero B would
    merge to nothing): numpy, and the same as torch tensors."""
    from dalm_tpu_torch.models.lora import _get_path, _target_kernel_paths

    rng = np.random.default_rng(seed)
    factors = {}
    for path in _target_kernel_paths(params, spec):
        d_in, d_out = _get_path(params, path).shape
        factors["/".join(path)] = {"lora_a": rng.normal(0, 0.05, (d_in, spec.rank)).astype(np.float32),
                                   "lora_b": rng.normal(0, 0.05, (spec.rank, d_out)).astype(np.float32)}
    return factors, {p: {k: torch.from_numpy(v) for k, v in ab.items()} for p, ab in factors.items()}


def _jax_merge(params, factors, spec):
    from dalm_tpu.models.lora import LoraSpec as JaxLoraSpec
    from dalm_tpu.models.lora import merge_lora as jax_merge_lora

    jspec = JaxLoraSpec(rank=spec.rank, alpha=spec.alpha, target_modules=spec.target_modules)
    merged = jax_merge_lora(params, {p: {k: jnp.asarray(v) for k, v in ab.items()} for p, ab in factors.items()},
                            jspec)
    return jax.tree.map(np.asarray, merged)


@pytest.mark.parametrize("quantize_generator", [False, "int4"])
def test_from_pretrained_with_adapters_matches_jax(jax_weights, tmp_path, quantize_generator):
    """Both towers' adapters, written by the port's ``save_adapter`` with seeded nonzero factors, merged by
    ``from_pretrained`` before the pipeline packs the generator: the JAX pipeline built from the JAX-merged
    trees retrieves the same ids (scores within 1e-5) and answers the same; no layer keeps a factor."""
    from dalm_tpu_torch.models.layers import FlexLinear
    from dalm_tpu_torch.models.lora import LoraSpec, save_adapter

    retriever, r_params, generator, g_params = jax_weights
    r_spec, g_spec = LoraSpec.for_encoder(), LoraSpec.for_causal_lm()
    r_np, r_lora = _adapter(r_params, r_spec, 3)
    g_np, g_lora = _adapter(g_params, g_spec, 4)
    save_adapter(str(tmp_path / "r_adapter"), r_lora, r_spec)
    save_adapter(str(tmp_path / "g_adapter"), g_lora, g_spec)
    base = _port_pipeline(r_params, g_params)
    save_pretrained(str(tmp_path / "retriever"), base.retriever.config, base.retriever.module.state_dict())
    save_pretrained(str(tmp_path / "generator"), base.generator.cfg, base.generator.state_dict())
    pipe = RagPipeline.from_pretrained(str(tmp_path / "retriever"), str(tmp_path / "generator"), PASSAGES,
                                       retriever_peft_path=str(tmp_path / "r_adapter"),
                                       generator_peft_path=str(tmp_path / "g_adapter"), device="cpu",
                                       quantize_generator=quantize_generator, **OPTS)
    j_r, j_g = _jax_merge(r_params, r_np, r_spec), _jax_merge(g_params, g_np, g_spec)
    ref = JaxRagPipeline(retriever, j_r, JaxByteTokenizer(), generator, j_g, JaxByteTokenizer(), PASSAGES,
                         quantize_generator=quantize_generator, **OPTS)
    for m in (*pipe.retriever.modules(), *pipe.generator.modules()):
        if isinstance(m, FlexLinear):
            assert m.lora_a is None and m.lora_b is None and m.a is None and m.b is None
    q_kernel = pipe.retriever.module.get_submodule("layer_0.attention.query").kernel.detach().numpy()
    np.testing.assert_allclose(q_kernel, j_r["layer_0"]["attention"]["query"]["kernel"], rtol=0, atol=1e-6)
    assert not np.allclose(q_kernel, r_params["layer_0"]["attention"]["query"]["kernel"], rtol=0, atol=1e-3)
    if not quantize_generator:
        v_kernel = pipe.generator.get_submodule("layer_1.attention.v_proj").kernel.detach().numpy()
        np.testing.assert_allclose(v_kernel, j_g["layer_1"]["attention"]["v_proj"]["kernel"], rtol=0, atol=1e-6)
    js, ji = ref.retrieve(QUERIES, top_k=4)
    ts, ti = pipe.retrieve(QUERIES, top_k=4)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    assert [a.answer for a in pipe.answer(QUERIES, top_k=4)] == [a.answer for a in ref.answer(QUERIES, top_k=4)]


def test_adapter_merge_in_bf16_matches_jax(jax_weights):
    """A bf16 decoder: the delta is cast to the kernel's type before the add, as the reference merges; the merged
    kernels equal the JAX merge within one bf16 rounding."""
    import dataclasses

    import ml_dtypes

    from dalm_tpu_torch.models.lora import LoraSpec, merge_lora_inplace

    _, _, _, g_params = jax_weights
    spec = LoraSpec.for_causal_lm()
    bf16_params = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), g_params)
    g_np, g_lora = _adapter(g_params, spec, 5)
    cfg = dataclasses.replace(DecoderConfig.tiny(), param_dtype=torch.bfloat16, dtype=torch.bfloat16)
    dec = merge_lora_inplace(load_params(Decoder(cfg), bf16_params), g_lora, spec)
    want = _jax_merge(bf16_params, g_np, spec)
    for path in g_np:
        site = dec.get_submodule(".".join(path.split("/")[:-1]))
        got = site.kernel.detach().float().numpy()
        ref = _get(want, path).astype(np.float32)
        assert site.kernel.dtype == torch.bfloat16
        np.testing.assert_allclose(got, ref, rtol=2 ** -8, atol=0)
        assert not np.array_equal(got, _get(bf16_params, path).astype(np.float32))


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_merge_lora_inplace_refuses_packed_or_factored_layers(jax_weights):
    from dalm_tpu_torch.models.lora import LoraSpec, attach_merge_lora, merge_lora_inplace
    from dalm_tpu_torch.models.qlora import pack_module

    _, _, _, g_params = jax_weights
    spec = LoraSpec.for_causal_lm()
    _, g_lora = _adapter(g_params, spec, 6)
    packed = pack_module(load_params(Decoder(DecoderConfig.tiny()), g_params), quantize="int4")
    with pytest.raises(ValueError, match="before packing"):
        merge_lora_inplace(packed, g_lora, spec)
    factored = attach_merge_lora(load_params(Decoder(DecoderConfig.tiny()), g_params), g_lora, spec)
    with pytest.raises(ValueError, match="carries LoRA factors"):
        merge_lora_inplace(factored, g_lora, spec)


@pytest.mark.parametrize("sampled", [False, True])
def test_speculative_pipeline_matches_jax(jax_weights, sampled):
    """RagPipeline(speculative=True): answer() and answer_continuous() equal the reference pipeline's
    speculative answers (greedy), or the port's plain greedy answers under a top_k=1 sampler."""
    from dalm_tpu.models.sampling import SamplerConfig as JaxSamplerConfig
    from dalm_tpu_torch.models.sampling import SamplerConfig

    retriever, r_params, generator, g_params = jax_weights
    queries = [f"what is topic {i}" for i in range(4)]
    opts = dict(OPTS, max_new_tokens=6)
    if sampled:
        pipe = _port_pipeline(r_params, g_params, speculative=True, speculative_gamma=4,
                              sampler=SamplerConfig(temperature=1.0, top_k=1, seed=3), max_new_tokens=6)
        ref = JaxRagPipeline(retriever, r_params, JaxByteTokenizer(), generator, g_params, JaxByteTokenizer(),
                             PASSAGES, speculative=True, speculative_gamma=4,
                             sampler=JaxSamplerConfig(temperature=1.0, top_k=1, seed=3), **opts)
    else:
        pipe = _port_pipeline(r_params, g_params, speculative=True, speculative_gamma=4, max_new_tokens=6)
        ref = JaxRagPipeline(retriever, r_params, JaxByteTokenizer(), generator, g_params, JaxByteTokenizer(),
                             PASSAGES, speculative=True, speculative_gamma=4, **opts)
    want = [a.answer for a in ref.answer(queries, top_k=2)]
    assert [a.answer for a in pipe.answer(queries, top_k=2)] == want
    assert [a.answer for a in pipe.answer_continuous(queries, top_k=2, num_slots=2)] == want
