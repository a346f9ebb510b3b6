"""The port's continuous-batching engine against the JAX package's, on the CPU.

The same seeded numpy prompts go to ``dalm_tpu.models.decode_engine.DecodeEngine``
and to the port's ``DecodeEngine``, the tiny decoder's weights carried across
by ``interop``, in f32. Every comparison is EXACT token equality, as the
reference's own engine tests require: slot recycling, chunk boundaries,
admission waves (full width or ``admit_width``), blocked admission prefill,
budgets and EOS must not leak into any request's tokens. The JAX engines are
built once per configuration and their results cached (module scope), since
each one compiles its own programs. Also: the per-row cache write equal bit
for bit to the reference's ``_cache_write`` (f32 and int8 buffers), the port's
sampled engine equal to its own sampled lockstep (the draws come from
``torch.Generator``, not ``jax.random``), and ``answer_continuous`` against
the reference pipeline's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.core.mesh import unbox
from dalm_tpu.models import decoder as jdec
from dalm_tpu.models.decode_engine import DecodeEngine as JaxDecodeEngine
from dalm_tpu.models.qlora import pack_qlora_frozen as jax_pack_qlora_frozen
from dalm_tpu_torch.interop import load_packed, load_params
from dalm_tpu_torch.models.decode_engine import DecodeEngine
from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig, _cache_write
from dalm_tpu_torch.models.generate import build_greedy_generate
from dalm_tpu_torch.models.sampling import SamplerConfig

P = 16  # static prompt length (left-padded)

# name -> the fields both sides set on the tiny config; "gqa-kvq" is the decoder of the reference's test_kv_quant.py
CONFIGS = {
    "mha": dict(),
    "kvq": dict(kv_quant=True),
    "gqa-kvq": dict(num_heads=4, num_kv_heads=2, kv_quant=True),
}


@functools.lru_cache(maxsize=None)
def _models(name: str, packed: bool = False):
    """(JAX decoder, JAX variables, port decoder) with the same weights; the
    JAX weights are drawn for the float decoder of the same shape."""
    kw = CONFIGS[name]
    jcfg = dataclasses.replace(jdec.DecoderConfig.tiny(vocab_size=128), **kw)
    ids = jnp.zeros((1, P), jnp.int32)
    params = unbox(jdec.Decoder(dataclasses.replace(jcfg, kv_quant=False)).init(
        jax.random.PRNGKey(0), ids, jnp.ones_like(ids))["params"])
    params = jax.tree.map(np.asarray, params)
    port = Decoder(dataclasses.replace(DecoderConfig.tiny(vocab_size=128), **kw), device="cpu")
    if packed:
        residual, quant = jax_pack_qlora_frozen(params, quantize=True, min_size=1)
        residual, quant = jax.tree.map(np.asarray, residual), jax.tree.map(np.asarray, quant)
        load_packed(port, residual, quant)
        return jdec.Decoder(jcfg), (residual, {"quant": quant}), port.eval()
    return jdec.Decoder(jcfg), (params, {}), load_params(port, params).eval()


def _prompts(n, rng_seed=0):
    """Left-padded (n, P) prompts of varying real length."""
    rng = np.random.default_rng(rng_seed)
    ids = np.zeros((n, P), np.int32)
    mask = np.zeros((n, P), np.int32)
    for i in range(n):
        real = int(rng.integers(3, P))
        ids[i, P - real :] = rng.integers(5, 120, size=real)
        mask[i, P - real :] = 1
    return ids, mask


@functools.lru_cache(maxsize=None)
def _jax_engine(name, packed=False, **kw):
    decoder, (params, extra), _ = _models(name, packed)
    return JaxDecodeEngine(decoder, params, max_prompt_len=P, pad_token_id=0, extra_collections=extra, **kw)


def _engine_kw(kw: dict) -> tuple:
    return tuple(sorted(kw.items()))


@functools.lru_cache(maxsize=None)
def _jax_run(name, kw, method, n, seed, budgets=None, packed=False):
    ids, mask = _prompts(n, seed)
    eng = _jax_engine(name, packed, **dict(kw))
    return getattr(eng, method)(ids, mask, budgets=None if budgets is None else list(budgets))


def _run_both(name, method, n, seed, budgets=None, packed=False, **kw):
    """(port tokens, JAX tokens) of one engine configuration on the same prompts."""
    ids, mask = _prompts(n, seed)
    _, _, port = _models(name, packed)
    eng = DecodeEngine(port, max_prompt_len=P, pad_token_id=0, **kw)
    got = getattr(eng, method)(ids, mask, budgets=budgets)
    want = _jax_run(name, _engine_kw(kw), method, n, seed, None if budgets is None else tuple(budgets), packed)
    return got, want


def _lockstep(name, n, seed, max_new, sampler=None, packed=False):
    """The port's lockstep generate on the same prompts: (n, max_new) numpy."""
    ids, mask = _prompts(n, seed)
    gen = build_greedy_generate(_models(name, packed)[2], max_new, sampler=sampler)
    return gen(torch.as_tensor(ids, dtype=torch.long), torch.as_tensor(mask, dtype=torch.long)).numpy()


def _trim(row, eos, cap):
    out = []
    for t in row:
        if len(out) >= cap or (eos is not None and t == eos):
            break
        out.append(int(t))
    return out


def _common_eos(name, n, seed, max_new):
    """An EOS id that occurs in the lockstep outputs, so early stops happen."""
    vals, counts = np.unique(_lockstep(name, n, seed, max_new)[:, 1:], return_counts=True)
    return int(vals[np.argmax(counts)])


# ---- the per-row cache write -------------------------------------------------

@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_per_row_write_equals_reference_cache_write(storage, S):
    """Row b writes S slots from cache_index[b]; a slot at or past L is dropped (row 2 runs off the end, and
    with S = 1 row 1 starts at L). Equal bit for bit to the reference's one-hot writes."""
    from dalm_tpu.models.decoder import _cache_write as jax_cache_write

    rng = np.random.default_rng(S)
    B, L, H, D = 3, 10, 2, 4
    if storage == "f32":
        cache = {n: rng.standard_normal((B, L, H, D)).astype(np.float32) for n in ("k", "v")}
        new = {n: rng.standard_normal((B, S, H, D)).astype(np.float32) for n in ("k", "v")}
    else:
        cache = {"k": rng.integers(-127, 128, (B, L, H, D)).astype(np.int8),
                 "k_scale": rng.random((B, L, H)).astype(np.float32)}
        new = {"k": rng.integers(-127, 128, (B, S, H, D)).astype(np.int8),
               "k_scale": rng.random((B, S, H)).astype(np.float32)}
    index = np.array([0, L if S == 1 else 4, L - 2], np.int32)
    want = jax_cache_write({n: jnp.asarray(v) for n, v in cache.items()}, {n: jnp.asarray(v) for n, v in new.items()},
                           jnp.asarray(index), S)
    got = {n: torch.from_numpy(v.copy()) for n, v in cache.items()}
    _cache_write(got, {n: torch.from_numpy(v) for n, v in new.items()}, torch.from_numpy(index).long(), S)
    for n in cache:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]), err_msg=n)
    assert not np.array_equal(got["k"].numpy(), cache["k"])


@pytest.mark.parametrize("name", ["mha", "gqa-kvq"])
def test_write_paths_bit_identical(name):
    """A prefill at cache_index 0 (the slice write) and at a (B,) vector of zeros (the per-row write) leave
    the same cache bits and logits, float and int8 (the reference's test_kv_quant.py counterpart)."""
    dec = _models(name)[2]
    ids = torch.as_tensor(np.random.default_rng(1).integers(5, 120, (2, 6)))
    c_scalar, c_vec = dec.init_kv_cache(2, P), dec.init_kv_cache(2, P)
    l_scalar, _ = dec(ids, kv_cache=c_scalar, cache_index=0)
    l_vec, _ = dec(ids, kv_cache=c_vec, cache_index=torch.zeros(2, dtype=torch.long))
    assert torch.equal(l_scalar, l_vec)
    for layer in c_scalar:
        for n in c_scalar[layer]:
            assert torch.equal(c_scalar[layer][n], c_vec[layer][n]), (layer, n)


def test_per_row_cache_index_is_checked():
    dec = _models("mha")[2]
    cache = dec.init_kv_cache(2, P)
    with pytest.raises(ValueError, match="per-row cache_index"):
        dec(torch.ones((2, 1), dtype=torch.long), kv_cache=cache, cache_index=torch.zeros(3, dtype=torch.long))
    with pytest.raises(TypeError, match="cache_index"):
        dec(torch.ones((2, 1), dtype=torch.long), kv_cache=cache, cache_index=None)


# ---- tests/models/test_decode_engine.py counterparts ------------------------

@pytest.mark.parametrize("num_slots,n_req", [(4, 4), (2, 7), (3, 8)])
def test_matches_lockstep_greedy(num_slots, n_req):
    """More requests than slots: the host loop equals the JAX engine and the lockstep generate."""
    got, want = _run_both("mha", "generate", n_req, n_req, num_slots=num_slots, max_new_tokens=6,
                          decode_chunk=3)
    assert got == want
    assert got == [[int(t) for t in row] for row in _lockstep("mha", n_req, n_req, 6)]


@pytest.mark.parametrize("num_slots,n_req", [(4, 4), (2, 7), (3, 8)])
def test_fused_matches_lockstep_greedy(num_slots, n_req):
    """The fused schedule equals the JAX engine's single program and the lockstep generate."""
    got, want = _run_both("mha", "generate_fused", n_req, 100 + n_req, num_slots=num_slots, max_new_tokens=6)
    assert got == want
    assert got == [[int(t) for t in row] for row in _lockstep("mha", n_req, 100 + n_req, 6)]


def test_eos_recycles_slots():
    eos = _common_eos("mha", 9, 42, 8)
    got, want = _run_both("mha", "generate", 9, 42, num_slots=2, max_new_tokens=8, eos_token_id=eos,
                          decode_chunk=4)
    assert got == want
    assert sum(len(r) < 8 for r in got) > 0  # the trait under test occurred


def test_max_new_one():
    got, want = _run_both("mha", "generate", 3, 7, num_slots=2, max_new_tokens=1)
    assert got == want and all(len(r) == 1 for r in got)


def test_engine_reusable_across_calls():
    """A second generate() on the same engine (a dirty pool) is still exact."""
    _, _, port = _models("mha")
    eng = DecodeEngine(port, num_slots=3, max_prompt_len=P, max_new_tokens=5, pad_token_id=0, decode_chunk=2)
    jeng = _jax_engine("mha", num_slots=3, max_new_tokens=5, decode_chunk=2)
    for seed in (1, 2):
        ids, mask = _prompts(5, seed)
        assert eng.generate(ids, mask) == jeng.generate(ids, mask)
    assert eng.generate_fused(ids, mask) == eng.generate(ids, mask)


def test_per_request_budgets():
    budgets = [8, 3, 0, 5, 1, 8]
    got, want = _run_both("mha", "generate", 6, 11, budgets=budgets, num_slots=2, max_new_tokens=8,
                          decode_chunk=4)
    assert got == want
    assert [len(r) for r in got] == budgets


def test_fused_eos_and_budgets():
    eos = _common_eos("mha", 9, 142, 8)
    budgets = [8, 3, 0, 5, 1, 8, 2, 8, 4]
    got, want = _run_both("mha", "generate_fused", 9, 142, budgets=budgets, num_slots=3, max_new_tokens=8,
                          eos_token_id=eos)
    assert got == want
    assert sum(len(r) < b for r, b in zip(got, budgets)) > 0


def test_int8_packed_decode_matches_lockstep():
    """int8 weight storage (every kernel packed, the reference's min_size=1) on both sides."""
    got, want = _run_both("mha", "generate", 5, 3, packed=True, num_slots=2, max_new_tokens=5, decode_chunk=2)
    assert got == want
    assert got == [[int(t) for t in row] for row in _lockstep("mha", 5, 3, 5, packed=True)]


def test_answer_continuous_matches_answer():
    """RagPipeline.answer_continuous against the reference pipeline's and against the port's answer()."""
    from dalm_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
    from dalm_tpu.models import encoder as jenc
    from dalm_tpu.models.embedder import SentenceEmbedder as JaxEmbedder
    from dalm_tpu.serve import RagPipeline as JaxRagPipeline
    from dalm_tpu_torch.data.tokenizer import ByteTokenizer
    from dalm_tpu_torch.models.embedder import SentenceEmbedder
    from dalm_tpu_torch.models.encoder import EncoderConfig
    from dalm_tpu_torch.serve import RagPipeline

    passages = [f"passage about topic {i} with unique content {i}" for i in range(10)]
    queries = [f"what is topic {i}" for i in range(6)]
    opts = dict(max_passage_len=32, max_prompt_len=64, max_new_tokens=4, embed_batch=8)
    retriever = JaxEmbedder(jenc.EncoderConfig.tiny())
    r_params = jax.tree.map(np.asarray, unbox(retriever.init_params(jax.random.PRNGKey(0))))
    generator = jdec.Decoder(jdec.DecoderConfig.tiny())
    ids = jnp.zeros((1, 8), jnp.int32)
    g_params = jax.tree.map(np.asarray, unbox(generator.init(jax.random.PRNGKey(1), ids, jnp.ones_like(ids))["params"]))
    ref = JaxRagPipeline(retriever, r_params, JaxByteTokenizer(), generator, g_params, JaxByteTokenizer(),
                         passages, **opts)
    pipe = RagPipeline(load_params(SentenceEmbedder(EncoderConfig.tiny()), r_params), ByteTokenizer(),
                       load_params(Decoder(DecoderConfig.tiny()), g_params), ByteTokenizer(), passages,
                       device="cpu", **opts)
    want = ref.answer_continuous(queries, top_k=2, num_slots=2, decode_chunk=2)
    cont = pipe.answer_continuous(queries, top_k=2, num_slots=2, decode_chunk=2)
    assert [a.answer for a in cont] == [a.answer for a in want]
    assert [a.passages for a in cont] == [a.passages for a in want]
    lockstep = pipe.answer(queries, top_k=2)
    assert [a.answer for a in cont] == [a.answer for a in lockstep]
    engine = pipe._engine
    pipe.answer_continuous(queries[:3], top_k=2, num_slots=2, decode_chunk=2)
    assert pipe._engine is engine  # cached by (num_slots, max_new_tokens, decode_chunk)


# ---- tests/models/test_prefill_chunk.py counterparts ------------------------

@pytest.mark.parametrize("name", ["mha", "kvq"])
def test_chunked_prefill_matches_oneshot(name):
    """Host loop and fused schedule, admission in 4-column blocks, against the JAX one-shot engine."""
    kw = dict(num_slots=3, max_new_tokens=6, decode_chunk=2)
    ids, mask = _prompts(7, 3)
    eng = DecodeEngine(_models(name)[2], max_prompt_len=P, pad_token_id=0, prefill_chunk=4, **kw)
    assert eng.prefill_C == 4
    want = _jax_run(name, _engine_kw(kw), "generate", 7, 3)
    assert eng.generate(ids, mask) == want
    assert eng.generate_fused(ids, mask) == want


def test_chunk_rounds_to_divisor():
    """A request that does not divide P rounds DOWN to the largest divisor; C >= P is the one-shot prefill."""
    kw = dict(num_slots=3, max_new_tokens=6, decode_chunk=2)
    got, want = _run_both("mha", "generate", 4, 11, prefill_chunk=5, **kw)
    assert got == want
    port = _models("mha")[2]
    assert DecodeEngine(port, max_prompt_len=P, prefill_chunk=5, **kw).prefill_C == 4
    assert DecodeEngine(port, max_prompt_len=P, prefill_chunk=64, **kw).prefill_C == P


@pytest.mark.parametrize("width", [1, 2])
def test_compact_admission_matches_full_width(width):
    """admit_width=W admits in waves of W rows (with 4-column blocks): equal to the JAX full-width engine."""
    ids, mask = _prompts(8, 9)
    eng = DecodeEngine(_models("mha")[2], num_slots=4, max_prompt_len=P, max_new_tokens=6, pad_token_id=0,
                       decode_chunk=2, admit_width=width, prefill_chunk=4)
    want = _jax_run("mha", _engine_kw(dict(num_slots=4, max_new_tokens=6, decode_chunk=2)), "generate_fused", 8, 9)
    assert eng.generate_fused(ids, mask) == want
    assert eng.generate(ids, mask) == want  # host-loop waves are capped at W rows too


def test_admit_width_validation():
    port = _models("mha")[2]
    with pytest.raises(ValueError, match="admit_width"):
        DecodeEngine(port, num_slots=2, max_prompt_len=P, max_new_tokens=4, admit_width=5)
    with pytest.raises(ValueError, match="admit_width"):
        DecodeEngine(port, num_slots=2, max_prompt_len=P, max_new_tokens=4, admit_width=0)
    # a full-width request (W == B) is the default admission, not an error
    eng = DecodeEngine(port, num_slots=2, max_prompt_len=P, max_new_tokens=4, admit_width=2)
    assert eng.admit_W is None
    ids, mask = _prompts(3)
    with pytest.raises(ValueError, match="left-padded"):
        eng.generate(ids[:, 1:], mask[:, 1:])
    with pytest.raises(ValueError, match="left-padded"):
        eng.generate_fused(ids, mask[:2])


def test_chunked_prefill_eos_and_budgets():
    """Slot recycling mid-stream re-admits through the blocked prefill, with EOS and budgets."""
    eos = _common_eos("mha", 9, 42, 8)
    budgets = [8, 1, 3, 8, 2, 8, 5, 8, 4]
    kw = dict(num_slots=2, max_new_tokens=8, decode_chunk=2, eos_token_id=eos)
    ids, mask = _prompts(9, 42)
    eng = DecodeEngine(_models("mha")[2], max_prompt_len=P, pad_token_id=0, prefill_chunk=4, **kw)
    want = _jax_run("mha", _engine_kw(kw), "generate_fused", 9, 42, tuple(budgets))
    assert eng.generate_fused(ids, mask, budgets=budgets) == want
    assert eng.generate(ids, mask, budgets=budgets) == want


# ---- tests/models/test_kv_quant.py counterpart ------------------------------

def test_engine_kv_quant_matches_quant_lockstep():
    """The int8 KV cache (GQA 4 / 2): host loop and fused schedule equal the JAX engine and the lockstep."""
    got, want = _run_both("gqa-kvq", "generate", 7, 3, num_slots=3, max_new_tokens=6, decode_chunk=3)
    assert got == want
    assert got == [[int(t) for t in row] for row in _lockstep("gqa-kvq", 7, 3, 6)]
    ids, mask = _prompts(7, 3)
    eng = DecodeEngine(_models("gqa-kvq")[2], num_slots=3, max_prompt_len=P, max_new_tokens=6, decode_chunk=3)
    assert eng.generate_fused(ids, mask) == got


# ---- sampling and speculation ------------------------------------------------

@pytest.mark.parametrize("admit_width", [None, 2])
def test_sampled_engine_matches_sampled_lockstep(admit_width):
    """Draws are keyed by (request, token index): host loop and fused schedule equal the port's sampled
    lockstep, cut at each budget and at EOS."""
    samp = SamplerConfig(temperature=0.8, top_k=30, top_p=0.95, seed=7)
    n, max_new, eos = 9, 7, 2
    budgets = [7, 1, 4, 7, 2, 7, 3, 7, 5]
    lock = _lockstep("mha", n, 21, max_new, sampler=samp)
    greedy = _lockstep("mha", n, 21, max_new)
    assert not np.array_equal(lock, greedy)  # the sampler is really drawing
    want = [_trim(lock[i], eos, budgets[i]) for i in range(n)]
    ids, mask = _prompts(n, 21)
    eng = DecodeEngine(_models("mha")[2], num_slots=4, max_prompt_len=P, max_new_tokens=max_new, eos_token_id=eos,
                       decode_chunk=2, sampler=samp, admit_width=admit_width, prefill_chunk=8)
    assert eng.generate(ids, mask, budgets=budgets) == want
    assert eng.generate_fused(ids, mask, budgets=budgets) == want


def test_speculation_raises():
    """Speculation no longer raises: DecodeEngine(speculative_gamma=3) and RagPipeline(speculative=True)
    run and give the plain greedy tokens and answers (tests/test_torch_speculative.py holds them against the
    JAX package)."""
    from dalm_tpu_torch.data.tokenizer import ByteTokenizer
    from dalm_tpu_torch.models.embedder import SentenceEmbedder
    from dalm_tpu_torch.models.encoder import EncoderConfig
    from dalm_tpu_torch.serve import RagPipeline

    ids, mask = _prompts(5, 31)
    eng = DecodeEngine(_models("mha")[2], num_slots=2, max_prompt_len=P, max_new_tokens=4, speculative_gamma=3)
    want = [[int(t) for t in row] for row in _lockstep("mha", 5, 31, 4)]
    assert eng.generate(ids, mask) == want
    assert eng.generate_fused(ids, mask) == want
    kw = dict(max_passage_len=32, max_prompt_len=64, max_new_tokens=4, embed_batch=8, device="cpu")
    parts = (SentenceEmbedder(EncoderConfig.tiny(), device="cpu").eval(), ByteTokenizer(),
             Decoder(DecoderConfig.tiny(), device="cpu").eval(), ByteTokenizer(), ["a b", "c d", "e f"])
    spec = RagPipeline(*parts, speculative=True, speculative_gamma=4, **kw)
    plain = RagPipeline(*parts, **kw)
    assert [a.answer for a in spec.answer(["a?", "c?"], top_k=2)] == [a.answer for a in plain.answer(["a?", "c?"],
                                                                                                       top_k=2)]
