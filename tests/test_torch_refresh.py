"""The port's index refresh against the JAX package, on the CPU, in f32.

``AsyncIndexRefresher`` (``dalm_tpu_torch/index/refresh.py``) against
``dalm_tpu.index.refresh`` on the reference's three cases
(``tests/index/test_refresh.py``): a search in the middle of a sweep returns
the rows before it, a full sweep swaps in the new rows, two sweeps
alternate the buffers. Every tick's progress equals the reference's, with a
corpus that no slice size divides; quantised indexes are refused. Then
``DenseIndex.refresh`` (float, int8; int4 raises) against
``ShardedDenseIndex.refresh``, and ``RagPipeline.refresh`` for float, int8
and int4 indexes against ``dalm_tpu.serve.RagPipeline.refresh`` with the
same new retriever weights. Ids are equal; scores within 1e-4 relative on
the synthetic rows (sums of up to 32 products of integers times weights),
within 1e-5 on the pipeline's unit-norm embeddings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.core.mesh import MeshConfig, make_mesh, unbox
from dalm_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from dalm_tpu.index.dense import ShardedDenseIndex
from dalm_tpu.index.refresh import AsyncIndexRefresher as JaxRefresher
from dalm_tpu.models import decoder as jdec
from dalm_tpu.models import encoder as jenc
from dalm_tpu.models.embedder import SentenceEmbedder as JaxEmbedder
from dalm_tpu.serve import RagPipeline as JaxRagPipeline
from dalm_tpu_torch.data.tokenizer import ByteTokenizer
from dalm_tpu_torch.index.dense import DenseIndex
from dalm_tpu_torch.index.refresh import AsyncIndexRefresher
from dalm_tpu_torch.interop import load_params
from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
from dalm_tpu_torch.models.embedder import SentenceEmbedder
from dalm_tpu_torch.models.encoder import EncoderConfig
from dalm_tpu_torch.serve import RagPipeline

N, D = 100, 32


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshConfig(data=4, model=2))


def _data():
    rng = np.random.default_rng(0)
    return rng.normal(size=(N, D)).astype(np.float32), rng.integers(-5, 6, size=(N, D)).astype(np.int32)


def _pair(mesh, slice_size):
    """The same refresher on both sides: old rows, token rows, embedding = float(ids) @ weight. The port's
    ``embed_fn`` closes over ``weight`` (one element list), which the test swaps between sweeps."""
    old, tokens = _data()
    j_index = ShardedDenseIndex.build(mesh, old)
    j_ref = JaxRefresher(j_index, jax.jit(lambda p, i, m: i.astype(jnp.float32) @ p), tokens, np.ones_like(tokens),
                         slice_size=slice_size)
    weight, seen = [torch.eye(D)], []

    def embed_fn(ids, mask):
        seen.append(len(ids))
        return torch.as_tensor(ids).float() @ weight[0]

    index = DenseIndex.build(old, device="cpu")
    port = AsyncIndexRefresher(index, embed_fn, tokens, np.ones_like(tokens), slice_size=slice_size)
    return (j_index, j_ref), (index, port, weight, seen), tokens.astype(np.float32)


def _same_search(j_index, index, queries, k):
    js, ji = j_index.search(queries, k)
    ts, ti = index.search(queries, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-5)
    return ts, ti


def _oracle_ids(queries, rows, k):
    return np.argsort(-(queries @ rows.T), axis=1, kind="stable")[:, :k]


def test_search_consistent_until_swap(mesh):
    (j_index, j_ref), (index, port, weight, _), _ = _pair(mesh, 16)
    queries = np.random.default_rng(1).normal(size=(3, D)).astype(np.float32)
    before_s, before_i = _same_search(j_index, index, queries, 5)
    active = index.embeddings
    stats, j_stats = port.tick(), j_ref.tick(jnp.eye(D))
    assert stats == j_stats and not stats["swapped"]
    assert index.embeddings is active and port._staging.data_ptr() != active.data_ptr()
    mid_s, mid_i = _same_search(j_index, index, queries, 5)
    np.testing.assert_array_equal(mid_i, before_i)
    np.testing.assert_array_equal(mid_s, before_s)


def test_full_sweep_swaps_to_new_embeddings(mesh):
    (j_index, j_ref), (index, port, weight, _), tokens = _pair(mesh, 16)
    weight[0] = torch.eye(D) * 2.0
    assert port.refresh_fully() == j_ref.refresh_fully(jnp.eye(D) * 2.0) == 1
    queries = np.random.default_rng(2).normal(size=(4, D)).astype(np.float32)
    _, ids = _same_search(j_index, index, queries, 5)
    np.testing.assert_array_equal(ids, _oracle_ids(queries, tokens * 2.0, 5))


def test_two_sweeps_alternate_buffers(mesh):
    (j_index, j_ref), (index, port, weight, _), tokens = _pair(mesh, 40)
    first = index.embeddings
    port.refresh_fully()
    j_ref.refresh_fully(jnp.eye(D))
    assert port._staging is first  # the old active rows are the next sweep's staging
    weight[0] = torch.eye(D) * 3.0
    port.refresh_fully()
    j_ref.refresh_fully(jnp.eye(D) * 3.0)
    assert port.version == j_ref.version == 2 and port.sweeps_started == j_ref.sweeps_started == 2
    assert index.embeddings is first
    queries = np.random.default_rng(3).normal(size=(2, D)).astype(np.float32)
    _, ids = _same_search(j_index, index, queries, 3)
    np.testing.assert_array_equal(ids, _oracle_ids(queries, tokens * 3.0, 3))


@pytest.mark.parametrize("slice_size", [7, 30, 100, 128])
def test_ragged_tail_ticks_match_reference(mesh, slice_size):
    """No slice size here divides 100 but 100 itself: every tick's stats equal the reference's, the last slice is
    embedded at its own size (the reference pads it), and the swapped rows equal the reference's."""
    (j_index, j_ref), (index, port, weight, seen), tokens = _pair(mesh, slice_size)
    weight[0] = torch.eye(D) * 0.5
    ticks, j_ticks = [], []
    while not (ticks and ticks[-1]["swapped"]):
        ticks.append(port.tick())
        j_ticks.append(j_ref.tick(jnp.eye(D) * 0.5))
    assert ticks == j_ticks and len(ticks) == -(-N // slice_size)
    assert seen == [min(slice_size, N - s) for s in range(0, N, slice_size)]
    np.testing.assert_array_equal(index.embeddings.numpy(), tokens * 0.5)
    np.testing.assert_array_equal(np.asarray(j_index.embeddings)[:N], tokens * 0.5)


@pytest.mark.parametrize("quantize", [True, "int4"])
def test_refresher_refuses_quantized_index(quantize):
    old, tokens = _data()
    index = DenseIndex.build(old, quantize=quantize, device="cpu")
    with pytest.raises(ValueError, match="rebuilt"):
        AsyncIndexRefresher(index, lambda i, m: None, tokens, tokens)


@pytest.mark.parametrize("quantize", [False, True, "int4"])
def test_dense_index_refresh_matches_reference(mesh, quantize):
    old, _ = _data()
    new = np.random.default_rng(5).normal(size=(N, D)).astype(np.float32)
    j_index = ShardedDenseIndex.build(mesh, old, quantize=quantize)
    index = DenseIndex.build(old, quantize=quantize, device="cpu")
    if quantize == "int4":
        with pytest.raises(NotImplementedError, match="rebuilt"):
            j_index.refresh(new)
        with pytest.raises(NotImplementedError, match="rebuilt"):
            index.refresh(new)
        return
    j_index.refresh(new)
    index.refresh(torch.from_numpy(new))
    if quantize:
        np.testing.assert_array_equal(index.embeddings.numpy(), np.asarray(j_index.embeddings)[:N])
        np.testing.assert_array_equal(index.scales.numpy(), np.asarray(j_index.scales)[:N])
    else:
        np.testing.assert_array_equal(index.embeddings.numpy(), new)
    queries = np.random.default_rng(6).normal(size=(5, D)).astype(np.float32)
    _same_search(j_index, index, queries, 7)
    with pytest.raises(ValueError, match="rows"):
        index.refresh(new[:10])


PASSAGES = [f"passage about topic {i} with unique content {i}" for i in range(12)]
QUERIES = ["what is topic 3", "tell me about 7", "unique content 11"]
OPTS = dict(max_passage_len=32, max_prompt_len=64, max_new_tokens=4, embed_batch=8)


@pytest.fixture(scope="module")
def weights():
    retriever = JaxEmbedder(jenc.EncoderConfig.tiny())
    r_params = jax.tree.map(np.asarray, unbox(retriever.init_params(jax.random.PRNGKey(0))))
    generator = jdec.Decoder(jdec.DecoderConfig.tiny())
    ids = jnp.zeros((1, 8), jnp.int32)
    g_params = jax.tree.map(np.asarray, unbox(generator.init(jax.random.PRNGKey(1), ids, jnp.ones_like(ids))["params"]))
    rng = np.random.default_rng(7)  # new retriever weights: every leaf moved by 30% of its own scale
    new_params = jax.tree.map(lambda a: (a + 0.3 * (np.abs(a).mean() + 1e-3) * rng.standard_normal(a.shape))
                              .astype(a.dtype), r_params)
    return retriever, r_params, generator, g_params, new_params


@pytest.mark.parametrize("quantize", [False, "int8", "int4"])
def test_pipeline_refresh_matches_reference(weights, quantize):
    retriever, r_params, generator, g_params, new_params = weights
    ref = JaxRagPipeline(retriever, r_params, JaxByteTokenizer(), generator, g_params, JaxByteTokenizer(), PASSAGES,
                         index_quantize=quantize, **OPTS)
    pipe = RagPipeline(load_params(SentenceEmbedder(EncoderConfig.tiny()), r_params), ByteTokenizer(),
                       load_params(Decoder(DecoderConfig.tiny()), g_params), ByteTokenizer(), PASSAGES,
                       index_quantize=quantize, device="cpu", **OPTS)
    _, before = pipe.retrieve(QUERIES, top_k=5)
    new_state = load_params(SentenceEmbedder(EncoderConfig.tiny()), new_params).state_dict()
    ref.refresh(new_params, slice_size=5)
    pipe.refresh(new_state, slice_size=5)
    assert (pipe.index.int4, pipe.index.scales is not None) == (quantize == "int4", bool(quantize))
    js, ji = ref.retrieve(QUERIES, top_k=5)
    ts, ti = pipe.retrieve(QUERIES, top_k=5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    assert not np.array_equal(ti, before)  # the new weights rank the passages otherwise
    for name, t in pipe.retriever.state_dict().items():
        assert torch.equal(t, new_state[name])
    assert [a.answer for a in pipe.answer(QUERIES, top_k=5)] == [a.answer for a in ref.answer(QUERIES, top_k=5)]
