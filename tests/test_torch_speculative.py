"""The port's speculative decoding against the JAX package's, on the CPU, in f32.

The tiny decoder (vocabulary 128; MHA, and GQA 4 / 2) gets its weights from
the JAX side through ``interop``; prompts come from seeded numpy, repetitive
or not, as ``tests/models/test_speculative.py`` makes them. Greedy output is
compared with tolerance 0: ``prompt_lookup`` on the same buffers, the lockstep
``build_speculative_generate`` (tokens and the passes ``return_stats`` gives),
and ``DecodeEngine(speculative_gamma=...)`` on both schedules against the JAX
engine, with EOS and budgets. No verify pass writes at or past the cache's
end. Sampled speculation draws other numbers than JAX's by design
(``models/sampling.py``), so it is held within the port: ``top_k=1`` equals
greedy, the token marginals equal plain sampling's within a stated total
variation distance, drafts are accepted on repetitive prompts, and the
lockstep, host-loop, fused and streaming schedules give the same tokens.
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
from dalm_tpu.models.generate import build_greedy_generate as jax_greedy
from dalm_tpu.models.speculative import build_speculative_generate as jax_speculative
from dalm_tpu.models.speculative import prompt_lookup as jax_prompt_lookup
from dalm_tpu_torch.interop import load_params
from dalm_tpu_torch.models import decoder as decoder_module
from dalm_tpu_torch.models.decode_engine import DecodeEngine
from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
from dalm_tpu_torch.models.generate import build_greedy_generate
from dalm_tpu_torch.models.sampling import SamplerConfig, token_uniforms
from dalm_tpu_torch.models.speculative import build_speculative_generate, prompt_lookup
from dalm_tpu_torch.models.streaming import StreamingEngine

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores

P = 24  # lockstep prompts (tests/models/test_speculative.py)
PE = 16  # engine prompts (tests/models/test_decode_engine.py)
CONFIGS = {"mha": dict(), "gqa": dict(num_heads=4, num_kv_heads=2, hidden_size=64),
           "gqa-kvq": dict(num_heads=4, num_kv_heads=2, kv_quant=True)}
SEEDS = {"mha": 0, "gqa": 1, "gqa-kvq": 0}


@functools.lru_cache(maxsize=None)
def _models(name: str):
    """(JAX decoder, JAX params, port decoder) with the same weights."""
    kw = CONFIGS[name]
    jcfg = dataclasses.replace(jdec.DecoderConfig.tiny(vocab_size=128), **kw)
    ids = jnp.zeros((1, P), jnp.int32)
    params = unbox(jdec.Decoder(dataclasses.replace(jcfg, kv_quant=False)).init(
        jax.random.PRNGKey(SEEDS[name]), ids, jnp.ones_like(ids))["params"])
    params = jax.tree.map(np.asarray, params)
    port = Decoder(dataclasses.replace(DecoderConfig.tiny(vocab_size=128), **kw), device="cpu")
    return jdec.Decoder(jcfg), params, load_params(port, params).eval()


def _prompts(n, rng_seed=0, repetitive=False, p=P, low=8):
    rng = np.random.default_rng(rng_seed)
    ids = np.zeros((n, p), np.int32)
    mask = np.zeros((n, p), np.int32)
    for i in range(n):
        real = int(rng.integers(low, p))
        if repetitive:
            period = int(rng.integers(2, 5))
            row = np.tile(rng.integers(5, 120, size=period), p // period + 1)[:real]
        else:
            row = rng.integers(5, 120, size=real)
        ids[i, p - real:] = row
        mask[i, p - real:] = 1
    return ids, mask


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


@functools.lru_cache(maxsize=None)
def _jax_gen(name, max_new, eos, gamma, stats):
    decoder, params, _ = _models(name)
    if gamma is None:
        fn = jax_greedy(decoder, max_new, eos_token_id=eos, pad_token_id=0)
    else:
        fn = jax_speculative(decoder, max_new, eos_token_id=eos, pad_token_id=0, gamma=gamma, return_stats=stats)
    return functools.partial(fn, params)


def _both_spec(name, ids, mask, max_new, gamma, eos=None):
    """((port tokens, port passes), (JAX tokens, JAX passes)) of the lockstep speculative generate."""
    port = build_speculative_generate(_models(name)[2], max_new, eos_token_id=eos, pad_token_id=0, gamma=gamma,
                                      return_stats=True)(_t(ids), _t(mask))
    want = _jax_gen(name, max_new, eos, gamma, True)(jnp.asarray(ids), jnp.asarray(mask))
    return tuple(t.numpy() for t in port), tuple(np.asarray(t) for t in want)


def _greedy(name, ids, mask, max_new, eos=None):
    return build_greedy_generate(_models(name)[2], max_new, eos_token_id=eos)(_t(ids), _t(mask)).numpy()


def _common_token(rows):
    vals, counts = np.unique(rows[:, 1:], return_counts=True)
    return int(vals[np.argmax(counts)])


def _trim(row, eos, cap):
    out = []
    for t in row:
        if len(out) >= cap or (eos is not None and t == eos):
            break
        out.append(int(t))
    return out


# ---- prompt lookup --------------------------------------------------------------------------------

@pytest.mark.parametrize("ngram", [2, 3])
@pytest.mark.parametrize("repetitive", [False, True])
def test_prompt_lookup_matches_jax(ngram, repetitive):
    """The drafts of every row equal the JAX function's on the same buffers: matches near the pad edge, runs
    off the buffer's end, rows with no match (the last token repeated)."""
    rng = np.random.default_rng(ngram + 10 * repetitive)
    B, L, gamma = 16, 40, 5
    if repetitive:
        buf = np.stack([np.tile(rng.integers(1, 6, size=int(rng.integers(2, 5))), L)[:L] for _ in range(B)])
    else:
        buf = rng.integers(1, 6, size=(B, L))
    pad_lens = rng.integers(0, 12, size=B)
    q_end = rng.integers(pad_lens + 2 * ngram - 2, L)
    buf = np.where(np.arange(L)[None, :] < pad_lens[:, None], 0, buf).astype(np.int32)
    want = np.asarray(jax_prompt_lookup(jnp.asarray(buf), jnp.asarray(q_end, jnp.int32),
                                        jnp.asarray(pad_lens, jnp.int32), gamma, ngram))
    got = prompt_lookup(_t(buf), _t(q_end), _t(pad_lens), gamma, ngram).numpy()
    np.testing.assert_array_equal(got, want)


# ---- lockstep greedy: tests/models/test_speculative.py counterparts --------------------------------

@pytest.mark.parametrize("gamma,repetitive", [(4, False), (8, False), (4, True), (8, True)])
def test_matches_jax_exactly(gamma, repetitive):
    """Tokens and passes equal the JAX generator's, and the tokens equal the plain greedy generate's."""
    ids, mask = _prompts(6, rng_seed=gamma + (100 if repetitive else 0), repetitive=repetitive)
    (toks, passes), (want, want_passes) = _both_spec("mha", ids, mask, 12, gamma)
    np.testing.assert_array_equal(toks, want)
    np.testing.assert_array_equal(passes, want_passes)
    np.testing.assert_array_equal(toks, _greedy("mha", ids, mask, 12))
    if repetitive:
        assert passes.min() < 11  # drafts were accepted: fewer passes than tokens after the first


def test_eos_masking_matches_jax():
    ids, mask = _prompts(8, rng_seed=42)
    eos = _common_token(_greedy("mha", ids, mask, 10))
    (toks, passes), (want, want_passes) = _both_spec("mha", ids, mask, 10, 5, eos=eos)
    np.testing.assert_array_equal(toks, want)
    np.testing.assert_array_equal(passes, want_passes)
    np.testing.assert_array_equal(toks, _greedy("mha", ids, mask, 10, eos=eos))
    assert (toks == 0).any()  # some row ended at EOS and was padded


def test_single_token_budget():
    """max_new_tokens 1: the prefill's token alone, no verify pass."""
    ids, mask = _prompts(3, rng_seed=7)
    (toks, passes), (want, want_passes) = _both_spec("mha", ids, mask, 1, 4)
    np.testing.assert_array_equal(toks, want)
    np.testing.assert_array_equal(passes, want_passes)
    assert passes.max() == 0


def test_gqa_decoder():
    ids, mask = _prompts(4, rng_seed=9, repetitive=True)
    (toks, passes), (want, want_passes) = _both_spec("gqa", ids, mask, 10, 6)
    np.testing.assert_array_equal(toks, want)
    np.testing.assert_array_equal(passes, want_passes)
    np.testing.assert_array_equal(toks, _greedy("gqa", ids, mask, 10))


# ---- the engine: tests/models/test_decode_engine.py counterparts ------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_engine_run(name, method, num_slots, n_req, gamma, seed, eos, budgets, max_new, repetitive, low=3):
    decoder, params, _ = _models(name)
    ids, mask = _prompts(n_req, seed, repetitive, p=PE, low=low)
    eng = JaxDecodeEngine(decoder, params, num_slots=num_slots, max_prompt_len=PE, max_new_tokens=max_new,
                          eos_token_id=eos, pad_token_id=0, speculative_gamma=gamma)
    return getattr(eng, method)(ids, mask, budgets=None if budgets is None else list(budgets))


@pytest.mark.parametrize("method", ["generate", "generate_fused"])
@pytest.mark.parametrize("num_slots,n_req,gamma", [(2, 7, 4), (3, 8, 6)])
def test_engine_matches_jax(method, num_slots, n_req, gamma):
    """Both schedules with verify passes, slot recycling, EOS and budgets: equal to the JAX engine, and to
    the port's greedy lockstep cut at EOS and at each budget."""
    seed, max_new = 300 + n_req, 10
    ids, mask = _prompts(n_req, seed, p=PE, low=3)
    free = _greedy("mha", ids, mask, max_new)
    budgets = (max_new, 3, 0, 5, 1, max_new, 2, max_new)[:n_req]
    # the commonest token within the budgets, after the first: an EOS that ends some request early
    vals, counts = np.unique(np.concatenate([free[i, 1:b] for i, b in enumerate(budgets)]), return_counts=True)
    eos = int(vals[np.argmax(counts)])
    eng = DecodeEngine(_models("mha")[2], num_slots=num_slots, max_prompt_len=PE, max_new_tokens=max_new,
                       eos_token_id=eos, pad_token_id=0, speculative_gamma=gamma)
    assert eng.L == PE + max_new + gamma + 1
    got = getattr(eng, method)(ids, mask, budgets=list(budgets))
    assert got == _jax_engine_run("mha", method, num_slots, n_req, gamma, seed, eos, budgets, max_new, False)
    want = [_trim(free[i], eos, budgets[i]) for i in range(n_req)]
    assert got == want
    assert any(len(w) < b for w, b in zip(want, budgets))  # EOS ended some request early


@pytest.mark.parametrize("method", ["generate", "generate_fused"])
@pytest.mark.parametrize("name", ["mha", "gqa-kvq"])
def test_engine_repetitive_prompts_match_jax(method, name):
    """The copy regime, where drafts verify in spans, with the float and the int8 KV cache (GQA)."""
    ids, mask = _prompts(5, 77, True, p=PE, low=10)
    eng = DecodeEngine(_models(name)[2], num_slots=2, max_prompt_len=PE, max_new_tokens=12, pad_token_id=0,
                       speculative_gamma=6)
    got = getattr(eng, method)(ids, mask)
    assert got == _jax_engine_run(name, method, 2, 5, 6, 77, None, None, 12, True, 10)
    assert got == [[int(t) for t in row] for row in _greedy(name, ids, mask, 12)]


def test_verify_writes_stay_below_the_cache_end(monkeypatch):
    """With the G + 1 slack no verify pass writes at or past L, so the per-row write never clamps: the
    lockstep generator, the host loop and the fused schedule, budgets running to max_new_tokens."""
    seen = []
    write = decoder_module._cache_write

    def recording(cache, new_vals, cache_index, S):
        if torch.is_tensor(cache_index) and S > 1:
            seen.append((int(cache_index.max()) + S, cache[next(iter(new_vals))].shape[1]))
        return write(cache, new_vals, cache_index, S)

    monkeypatch.setattr(decoder_module, "_cache_write", recording)
    ids, mask = _prompts(5, 5, True, p=PE, low=10)
    port = _models("mha")[2]
    build_speculative_generate(port, 9, gamma=4)(_t(ids), _t(mask))
    eng = DecodeEngine(port, num_slots=2, max_prompt_len=PE, max_new_tokens=9, pad_token_id=0, speculative_gamma=4)
    eng.generate(ids, mask)
    eng.generate_fused(ids, mask, budgets=[9, 1, 9, 4, 9])
    assert len(seen) > 20
    assert all(end <= L for end, L in seen), max(end - L for end, L in seen)
    assert max(end for end, _ in seen) > PE + 9  # without the slack some window would have run off the end


# ---- sampled speculation (within the port) --------------------------------------------------------

def test_use_keys_leave_the_plain_draws_unchanged():
    """``use=None`` keys (seed, request, token) as before; uses 0 and 1 are other streams."""
    import hashlib

    key = hashlib.blake2b(b"7/3/5", digest_size=8).digest()
    plain = torch.rand((), generator=torch.Generator().manual_seed(int.from_bytes(key, "little") >> 1),
                       dtype=torch.float64)
    assert float(token_uniforms(7, [3], [5])[0]) == float(plain)
    u0, u1 = token_uniforms(7, [3], [5], use=0), token_uniforms(7, [3], [5], use=1)
    assert len({float(plain), float(u0[0]), float(u1[0])}) == 3


def test_sampled_topk1_matches_greedy_exactly():
    """top_k=1 is greedy: the rejection verifier accepts a draft iff it is the argmax, and the residual is
    the argmax (lockstep, and both engine schedules)."""
    samp = SamplerConfig(temperature=1.0, top_k=1, seed=5)
    ids, mask = _prompts(6, rng_seed=11, repetitive=True)
    got = build_speculative_generate(_models("mha")[2], 12, gamma=5, sampler=samp)(_t(ids), _t(mask)).numpy()
    np.testing.assert_array_equal(got, _greedy("mha", ids, mask, 12))
    ids, mask = _prompts(6, 913, p=PE, low=3)
    eng = DecodeEngine(_models("mha")[2], num_slots=2, max_prompt_len=PE, max_new_tokens=8, pad_token_id=0,
                       speculative_gamma=5, sampler=samp)
    want = [[int(t) for t in row] for row in _greedy("mha", ids, mask, 8)]
    assert eng.generate_fused(ids, mask) == want
    assert eng.generate(ids, mask) == want


# Distribution equality: the per-position token marginals of the speculative sampler against the plain
# sampler's over 2048 independent rows (one repetitive prompt replicated, each row its own request key).
# Sampling noise alone gives a total variation distance of about 0.02-0.05 here; a wrong residual (drawing
# from the full target after a rejection) biases the marginals by about E[p(draft)]. Tolerance: 0.08.
TV_TOL = 0.08


def test_sampled_distribution_matches_plain():
    n, max_new = 2048, 3
    rng = np.random.default_rng(3)
    row = np.tile(rng.integers(5, 120, size=3), P // 3 + 1)[:P]
    ids = np.tile(row[None, :], (n, 1))
    mask = np.ones_like(ids)
    samp = SamplerConfig(temperature=1.0, top_k=4, seed=9)
    port = _models("mha")[2]
    a = build_greedy_generate(port, max_new, sampler=samp)(_t(ids), _t(mask)).numpy()
    b = build_speculative_generate(port, max_new, gamma=4, sampler=samp)(_t(ids), _t(mask)).numpy()
    np.testing.assert_array_equal(a[:, 0], b[:, 0])  # token 0: the same (request, 0) keys in both
    for t in range(1, max_new):
        tv = 0.5 * np.abs(np.bincount(a[:, t], minlength=128) / n - np.bincount(b[:, t], minlength=128) / n).sum()
        assert tv < TV_TOL, (t, tv)
    assert not np.array_equal(a, b)  # the two samplers draw other numbers


def test_sampled_speculation_accepts_drafts():
    """On repetitive prompts with a peaked sampler the accept path runs: fewer passes than tokens."""
    ids, mask = _prompts(4, rng_seed=13, repetitive=True)
    toks, passes = build_speculative_generate(_models("mha")[2], 16, gamma=6, return_stats=True,
                                              sampler=SamplerConfig(temperature=0.2, seed=1))(_t(ids), _t(mask))
    assert toks.shape == (4, 16)
    assert int(passes.min()) < 15  # some row took fewer passes than its 15 tokens after the first


@pytest.mark.parametrize("repetitive", [False, True])
def test_sampled_schedules_agree(repetitive):
    """Drafts depend only on a request's own history and the draws on (request, token index, use): the
    lockstep generator, the host loop, the fused schedule and the stream give the same sampled tokens
    through slot recycling."""
    n, max_new, gamma = 7, 10, 4
    ids, mask = _prompts(n, 901, repetitive, p=PE, low=3)
    samp = SamplerConfig(temperature=0.8, top_k=8, seed=11)
    port = _models("mha")[2]
    want = build_speculative_generate(port, max_new, gamma=gamma, sampler=samp)(_t(ids), _t(mask)).numpy()
    assert not np.array_equal(want, _greedy("mha", ids, mask, max_new))
    want = [[int(t) for t in row] for row in want]
    eng = DecodeEngine(port, num_slots=3, max_prompt_len=PE, max_new_tokens=max_new, pad_token_id=0,
                       speculative_gamma=gamma, sampler=samp)
    assert eng.generate_fused(ids, mask) == want
    assert eng.generate(ids, mask) == want
    with StreamingEngine(eng) as srv:
        handles = [srv.submit(ids[i], mask[i]) for i in range(n)]
        assert [h.result(timeout=60) for h in handles] == want
