"""The port's streaming server against the JAX package's lockstep, on the CPU, in f32.

Every request's tokens must equal the JAX greedy lockstep output for its
prompt, whenever it arrived, whichever slot served it and whatever else was
in flight (``tests/models/test_streaming.py`` counterparts): upfront and
mid-flight submissions, EOS and budgets, the speculative scheduler, and
``RagStreamSession`` against ``answer()`` with and without speculation. Also
cancellation, a zero budget, ``stop`` refusing new work, the future awaited
from asyncio, and a scheduler that crashes failing every open handle. Every
wait has a timeout, so a hang fails in seconds.
"""

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dalm_tpu.core.mesh import unbox
from dalm_tpu.models import decoder as jdec
from dalm_tpu.models.generate import build_greedy_generate as jax_greedy
from dalm_tpu_torch.interop import load_params
from dalm_tpu_torch.models.decode_engine import DecodeEngine
from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
from dalm_tpu_torch.models.streaming import StreamingEngine

P = 16
WAIT = 60  # seconds any one result may take


@functools.lru_cache(maxsize=None)
def _models():
    jd = jdec.Decoder(jdec.DecoderConfig.tiny(vocab_size=128))
    ids = jnp.zeros((1, P), jnp.int32)
    params = jax.tree.map(np.asarray, unbox(jd.init(jax.random.PRNGKey(0), ids, jnp.ones_like(ids))["params"]))
    return jd, params, load_params(Decoder(DecoderConfig.tiny(vocab_size=128), device="cpu"), params).eval()


def _prompts(n, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    ids = np.zeros((n, P), np.int32)
    mask = np.zeros((n, P), np.int32)
    for i in range(n):
        real = int(rng.integers(3, P))
        ids[i, P - real:] = rng.integers(5, 120, size=real)
        mask[i, P - real:] = 1
    return ids, mask


@functools.lru_cache(maxsize=None)
def _jax_lockstep_fn(max_new):
    jd, params, _ = _models()
    return functools.partial(jax_greedy(jd, max_new, eos_token_id=None, pad_token_id=0), params)


def _lockstep(ids, mask, max_new):
    """The JAX package's greedy lockstep output (n, max_new)."""
    return np.asarray(_jax_lockstep_fn(max_new)(jnp.asarray(ids), jnp.asarray(mask)))


def _engine(num_slots=2, max_new=6, eos=None, chunk=3, gamma=0):
    return DecodeEngine(_models()[2], num_slots=num_slots, max_prompt_len=P, max_new_tokens=max_new,
                        eos_token_id=eos, pad_token_id=0, decode_chunk=chunk, speculative_gamma=gamma)


def _trim(row, eos, cap):
    out = []
    for t in row:
        if int(t) == eos or len(out) >= cap:
            break
        out.append(int(t))
    return out


@pytest.mark.parametrize("gamma", [0, 3])
def test_upfront_submissions_match_lockstep(gamma):
    ids, mask = _prompts(7, rng_seed=1)
    expected = _lockstep(ids, mask, 6)
    with StreamingEngine(_engine(num_slots=2, gamma=gamma)) as srv:
        handles = [srv.submit(ids[i], mask[i]) for i in range(7)]
        for i, h in enumerate(handles):
            assert h.result(timeout=WAIT) == [int(t) for t in expected[i]], f"req {i}"


@pytest.mark.parametrize("gamma", [0, 3])
def test_midflight_arrivals_match_lockstep(gamma):
    """Requests submitted while earlier ones decode still match, with and without speculation."""
    ids, mask = _prompts(9, rng_seed=2 if gamma == 0 else 11)
    expected = _lockstep(ids, mask, 8)
    with StreamingEngine(_engine(num_slots=2, max_new=8, gamma=gamma)) as srv:
        first = [srv.submit(ids[i], mask[i]) for i in range(3)]
        first[0].result(timeout=WAIT)  # wave 1 in flight or finishing
        second = [srv.submit(ids[i], mask[i]) for i in range(3, 9)]
        for i, h in enumerate(first + second):
            assert h.result(timeout=WAIT) == [int(t) for t in expected[i]], f"req {i}"


@pytest.mark.parametrize("gamma", [0, 2])
def test_token_streaming_is_incremental(gamma):
    """tokens() yields what the future resolves to, and tokens arrive before the request finishes
    (multi-token commits too)."""
    ids, mask = _prompts(1, rng_seed=3 if gamma == 0 else 13)
    max_new = 8 if gamma == 0 else 12
    expected = [int(t) for t in _lockstep(ids, mask, max_new)[0]]
    with StreamingEngine(_engine(num_slots=2, max_new=max_new, chunk=2, gamma=gamma)) as srv:
        h = srv.submit(ids[0], mask[0])
        streamed, saw_undone = [], False
        for tok in h.tokens():
            streamed.append(tok)
            saw_undone |= not h.done
        assert streamed == expected
        assert h.result(timeout=WAIT) == expected
        assert saw_undone
        assert h.t_submit <= h.t_first_token <= h.t_done


@pytest.mark.parametrize("gamma", [0, 4])
def test_eos_and_budgets(gamma):
    ids, mask = _prompts(8, rng_seed=42 if gamma == 0 else 12)
    max_new = 8
    ref = _lockstep(ids, mask, max_new)
    vals, counts = np.unique(ref[:, 1:], return_counts=True)
    eos = int(vals[np.argmax(counts)])
    budgets = [8, 3, 0, 5, 1, 8, 2, 8]
    with StreamingEngine(_engine(num_slots=3, max_new=max_new, eos=eos, gamma=gamma)) as srv:
        handles = [srv.submit(ids[i], mask[i], budget=budgets[i]) for i in range(8)]
        got = [h.result(timeout=WAIT) for h in handles]
    want = [_trim(ref[i], eos, budgets[i]) for i in range(8)]
    assert got == want
    assert sum(len(w) < b for w, b in zip(want, budgets)) > 0  # EOS ended some request early


def test_stop_rejects_new_submissions():
    ids, mask = _prompts(1, rng_seed=5)
    srv = StreamingEngine(_engine()).start()
    h = srv.submit(ids[0], mask[0])
    srv.stop(drain=True, timeout=WAIT)
    assert not srv._thread.is_alive()
    assert h.done  # drained the accepted work
    with pytest.raises(RuntimeError, match="stopping"):
        srv.submit(ids[0], mask[0])


def test_stop_without_drain_ends_pending_work():
    ids, mask = _prompts(6, rng_seed=5)
    expected = _lockstep(ids, mask, 6)
    srv = StreamingEngine(_engine(num_slots=1)).start()
    handles = [srv.submit(ids[i % 6], mask[i % 6]) for i in range(30)]
    srv.stop(drain=False, timeout=WAIT)
    assert not srv._thread.is_alive()
    got = [h.result(timeout=1) for h in handles]
    for i, toks in enumerate(got):
        assert toks == [int(t) for t in expected[i % 6]][: len(toks)]  # a prefix: what it had when stopped
    assert any(len(toks) < 6 for toks in got)


def test_cancel_pending_request():
    """A cancelled request not yet admitted resolves without tokens (or with a prefix, if admitted)."""
    ids, mask = _prompts(4, rng_seed=6)
    expected = _lockstep(ids, mask, 6)
    with StreamingEngine(_engine(num_slots=1, max_new=6)) as srv:
        handles = [srv.submit(ids[i], mask[i]) for i in range(3)]
        victim = srv.submit(ids[3], mask[3])
        victim.cancel()
        got = victim.result(timeout=WAIT)
        assert got == [int(t) for t in expected[3]][: len(got)]
        for i, h in enumerate(handles):
            assert h.result(timeout=WAIT) == [int(t) for t in expected[i]], f"req {i}"


def test_zero_budget_resolves_immediately():
    ids, mask = _prompts(1, rng_seed=7)
    with StreamingEngine(_engine()) as srv:
        h = srv.submit(ids[0], mask[0], budget=0)
        assert h.result(timeout=5) == []
        with pytest.raises(ValueError, match="left-padded"):
            srv.submit(ids[0, 1:], mask[0, 1:])


def test_future_is_asyncio_compatible():
    ids, mask = _prompts(1, rng_seed=8)
    expected = [int(t) for t in _lockstep(ids, mask, 4)[0]]
    with StreamingEngine(_engine(max_new=4)) as srv:
        h = srv.submit(ids[0], mask[0])

        async def wait():
            return await asyncio.wait_for(asyncio.wrap_future(h.future), WAIT)

        assert asyncio.run(wait()) == expected


@pytest.mark.parametrize("gamma", [0, 2])
def test_scheduler_crash_fails_every_handle(gamma, monkeypatch):
    """An exception on the scheduler thread resolves every open handle with it, later submissions raise,
    and the thread ends (no handle hangs, nothing carries on quietly)."""
    ids, mask = _prompts(4, rng_seed=9)
    eng = _engine(num_slots=2, gamma=gamma)
    boom = RuntimeError("device lost")

    def fail(*a, **k):
        raise boom

    monkeypatch.setattr(eng, "_verify" if gamma else "_decode_chunk", fail)
    monkeypatch.setattr("threading.excepthook", lambda args: None)  # the thread re-raises: keep the log quiet
    srv = StreamingEngine(eng).start()
    handles = [srv.submit(ids[i], mask[i]) for i in range(4)]
    for h in handles:
        with pytest.raises(RuntimeError, match="device lost"):
            h.result(timeout=WAIT)
    srv._thread.join(WAIT)
    assert not srv._thread.is_alive() and srv._crashed is boom
    with pytest.raises(RuntimeError, match="crashed"):
        srv.submit(ids[0], mask[0])
    srv.stop(timeout=WAIT)


# ---- RagStreamSession ---------------------------------------------------------------------------------

@pytest.mark.parametrize("speculative", [False, True])
def test_rag_stream_session_matches_answer(speculative):
    """pipe.stream() retrieves one query at a time and streams the answer ``answer()`` gives, with and
    without speculation (the greedy answers are the plain ones either way)."""
    from dalm_tpu_torch.data.tokenizer import ByteTokenizer
    from dalm_tpu_torch.models.embedder import SentenceEmbedder
    from dalm_tpu_torch.models.encoder import EncoderConfig
    from dalm_tpu_torch.serve import RagPipeline

    import torch

    passages = [f"passage about topic {i} with unique content {i}" for i in range(10)]
    queries = [f"what is topic {i}" for i in range(5)]
    kw = dict(max_passage_len=32, max_prompt_len=64, max_new_tokens=6, embed_batch=8, device="cpu")

    def pipeline(**extra):
        retriever = SentenceEmbedder(EncoderConfig.tiny(), device="cpu")
        retriever.reset_parameters(torch.Generator().manual_seed(0))
        generator = Decoder(DecoderConfig.tiny(), device="cpu")
        generator.reset_parameters(torch.Generator().manual_seed(1))
        return RagPipeline(retriever.eval(), ByteTokenizer(), generator.eval(), ByteTokenizer(), passages, **kw,
                           **extra)

    plain = pipeline().answer(queries, top_k=2)
    pipe = pipeline(speculative=speculative, speculative_gamma=3)
    with pytest.raises(RuntimeError, match="with pipe.stream"):
        pipe.stream(num_slots=2).submit(queries[0])
    with pipe.stream(num_slots=2, decode_chunk=2) as session:
        handles = [session.submit(q, top_k=2) for q in queries]
        answers = [h.answer(timeout=WAIT) for h in handles]
    assert answers == [a.answer for a in plain]
    assert [h.passages for h in handles] == [a.passages for a in plain]
    np.testing.assert_allclose([h.scores for h in handles], [a.scores for a in plain], rtol=0, atol=1e-5)
    assert all(h.done for h in handles)
    if speculative:
        assert [a.answer for a in pipe.answer(queries, top_k=2)] == answers
