"""The port's serving slice as a whole against the JAX package: the same
tiny retriever and generator weights, ByteTokenizer, 12 passages and 2
queries through ``RagPipeline.answer`` on both sides. Retrieved ids are
equal, scores within 1e-5 (unit-norm embeddings, f32) and answer strings
equal, with the float generator and with each serving tier (an int8 or 4-bit
generator packed by the pipeline, the int8 KV cache). Also round-trips the
port's ``save_pretrained`` / ``from_pretrained``.
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


def test_refresh_and_generator_adapters_still_raise():
    """The two serving pieces not ported yet raise and name their ROADMAP.md items."""
    pipe = RagPipeline.from_pretrained("tiny", "tiny", PASSAGES, device="cpu", **OPTS)
    with pytest.raises(NotImplementedError, match="queue item 2.3"):
        pipe.refresh(None)
    with pytest.raises(NotImplementedError, match="queue item 2.4"):
        RagPipeline.from_pretrained("tiny", "tiny", PASSAGES, device="cpu", generator_peft_path="adapter", **OPTS)


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
