"""The port's evaluation (``dalm_tpu_torch/eval``) against the JAX package's on the CPU, in f32.

Each side reads its own saved directory of the same tiny weights (the JAX save for JAX, ``save_pretrained`` of the
carried weights for the port) and its own adapter files of the same factors. Tolerances: every ``eval/common.py``
function equal to the JAX one (metrics, filtered rows, tokenised columns; embeddings of an exact embedding
function equal); ``EvalResults.model_dump_json()`` equal to pydantic's string; the retriever's embeddings within
1e-5 of JAX's and ``EvalResults`` equal, after asserting that on the JAX side every query's k-th and (k+1)-th
scores lie more than 1e-4 apart and no top-k score within 1e-4 of the threshold (a closer pair may order either
way under f32 rounding); ``evaluate_rag`` equal, exact match 0.5 on both sides with answers planted from the JAX
generator's output.
"""

import fcntl
import math
import os
import pickle
import string

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from datasets import Dataset

from dalm_tpu.core.mesh import MeshConfig, make_mesh
from dalm_tpu.data.tokenizer import resolve_tokenizer as jax_tokenizer
from dalm_tpu.eval import common as jcommon
from dalm_tpu.eval.results import EvalResults as JaxEvalResults
from dalm_tpu.index.dense import ShardedDenseIndex
from dalm_tpu.models import lora as jlora
from dalm_tpu_torch.data.loading import ColumnDataset
from dalm_tpu_torch.data.tokenizer import resolve_tokenizer
from dalm_tpu_torch.eval import EvalResults
from dalm_tpu_torch.eval import common as tcommon
from dalm_tpu_torch.eval.rag import evaluate_rag
from dalm_tpu_torch.eval.retriever import build_embed_fn, evaluate_retriever, load_retriever_for_eval
from dalm_tpu_torch.models import lora as tlora
from test_torch_train_e2e import _save_tiny_bases

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores

TOP_K = 4


def eval_columns(n_unique=14, n_dup=4, seed=4):
    """Question / Abstract / Answer columns: ``n_unique`` distinct passages, each of random characters from a set of
    8 of its own, asked by its first half, then ``n_dup`` rows that repeat earlier passages, asked by their second
    half (the deduplication's first-occurrence rule). Spans give random tiny models a gold to find, and the character
    sets spread the scores that random mean-pooled encoders crowd together. Seed 4 is one whose k-th / (k + 1)-th
    gaps exceed 1e-4 in every index mode on the JAX side, which each comparison asserts before it compares."""
    rng = np.random.default_rng(seed)
    letters = list(string.ascii_letters + string.digits + " .,;:!?-")
    passages = ["".join(rng.choice(rng.choice(letters, size=8, replace=False), size=int(rng.integers(6, 30))))
                for _ in range(n_unique)]
    rows = [(p[: max(3, len(p) // 2)], p) for p in passages]
    rows += [(passages[j][len(passages[j]) // 2:], passages[j]) for j in rng.choice(n_unique, n_dup)]
    return {"Question": [q for q, _ in rows], "Abstract": [p for _, p in rows],
            "Answer": [f"answer {i}" for i in range(len(rows))]}


def shared_bases(tmp_path_factory):
    """``_save_tiny_bases`` once per test run for the eval, autoregressive-retriever and CLI tests: the xdist
    workers of one run share ``PYTEST_XDIST_TESTRUNUID`` and a parent of their base directories, and the first
    worker to take the lock saves there; the others load its files."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = base.parent / f"tiny-bases-{run}" if run else base / "tiny-bases"
    with open(f"{root}.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (root / "bases.pkl").is_file():
            root.mkdir(parents=True, exist_ok=True)
            with open(root / "bases.pkl", "wb") as f:
                pickle.dump(_save_tiny_bases(str(root)), f)
        with open(root / "bases.pkl", "rb") as f:
            return pickle.load(f)


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    return shared_bases(tmp_path_factory)


def seeded_adapter(params, spec, seed, root):
    """Seeded nonzero factors (B too) for every target kernel of ``params``, saved once by each package →
    (JAX adapter dir, port adapter dir)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path in tlora._target_kernel_paths(params, spec):
        d_in, d_out = tlora._get_path(params, path).shape
        flat["/".join(path)] = {"lora_a": rng.normal(0, 0.05, (d_in, spec.rank)).astype(np.float32),
                                "lora_b": rng.normal(0, 0.05, (spec.rank, d_out)).astype(np.float32)}
    jdir, tdir = f"{root}/jax_adapter", f"{root}/torch_adapter"
    jspec = jlora.LoraSpec(rank=spec.rank, alpha=spec.alpha, dropout=spec.dropout, target_modules=spec.target_modules)
    jlora.save_adapter(jdir, {p: {k: jnp.asarray(v) for k, v in ab.items()} for p, ab in flat.items()}, jspec)
    tlora.save_adapter(tdir, {p: {k: torch.from_numpy(v) for k, v in ab.items()} for p, ab in flat.items()}, spec)
    return jdir, tdir


def jax_embeddings(retriever_dir, texts, is_autoregressive=False, max_length=32, peft=None):
    """The JAX retriever's f32 embeddings of ``texts`` (one batch)."""
    from dalm_tpu.eval.retriever import build_embed_fn as jax_build_embed_fn
    from dalm_tpu.eval.retriever import load_retriever_for_eval as jax_load

    model, params, tok = jax_load(retriever_dir, peft, is_autoregressive, "float32", "byte")
    t = tok(list(texts), padding="max_length", max_length=max_length, truncation=True)
    return np.asarray(jax_build_embed_fn(model, params)(np.asarray(t["input_ids"]), np.asarray(t["attention_mask"])))


def port_embeddings(retriever_dir, texts, is_autoregressive=False, max_length=32, peft=None):
    model, tok = load_retriever_for_eval(retriever_dir, peft, is_autoregressive, "float32", "byte", device="cpu")
    t = tok(list(texts), padding="max_length", max_length=max_length, truncation=True)
    return build_embed_fn(model)(t["input_ids"], t["attention_mask"]).numpy()


def unique_passages(cols):
    return list(dict.fromkeys(cols["Abstract"]))


def jax_search_margins(p_embs, q_embs, quantize, k):
    """The JAX index's top-(k + 1) scores for each query: (scores (Q, k + 1), ids)."""
    index = ShardedDenseIndex.build(make_mesh(MeshConfig()), p_embs, kernel="xla", quantize=quantize)
    return index.search(q_embs, k + 1)


def split_threshold(scores):
    """A threshold in the widest gap between the middle half of the distinct top-k scores."""
    vals = np.unique(scores[np.isfinite(scores)])
    mid = vals[len(vals) // 4: 3 * len(vals) // 4 + 1]
    i = int(np.argmax(np.diff(mid)))
    return float(mid[i] + mid[i + 1]) / 2


def assert_margins(scores, k, threshold):
    """The precondition of an exact comparison: no near tie at the k-th place, no top-k score near the threshold."""
    gap = scores[:, k - 1] - scores[:, k]
    assert (gap[np.isfinite(gap)] > 1e-4).all(), f"a near tie at the k-th place: {gap.min()}"
    assert (np.abs(scores[:, :k] - threshold) > 1e-4).all()


# ---- eval/common.py, case by case --------------------------------------------------------------------------


@pytest.mark.parametrize("n_dup", [0, 6], ids=["unique", "duplicates"])
def test_filter_unique_passages_equals_jax(n_dup):
    cols = eval_columns(n_dup=n_dup)
    j = jcommon.filter_unique_passages(Dataset.from_dict(cols), "Abstract")
    t = tcommon.filter_unique_passages(ColumnDataset(cols), "Abstract")
    assert t.column_names == j.column_names and len(t) == len(j) == 14
    for name in cols:
        assert t[name] == list(j[name])


PR_CASES = [(["a", "a", "b"], ["a"]), (["a", "b", "c"], ["d"]), (["x"], ["x"]), (["a", "b", "a", "b"], ["b", "c"])]


@pytest.mark.parametrize("retrieved,correct", PR_CASES)
def test_calculate_precision_recall_equals_jax(retrieved, correct):
    assert tcommon.calculate_precision_recall(retrieved, correct) == jcommon.calculate_precision_recall(retrieved,
                                                                                                          correct)


HIT_CASES = {
    "zero-threshold": (np.array([[0.9, -0.1, 0.05], [0.3, 0.2, -0.5]], np.float32), 0.0),
    "filters-everything": (np.array([[0.2, 0.1, 0.05], [0.3, 0.2, 0.1]], np.float32), 0.95),
    "padded-slots": (np.array([[0.7, -np.inf, -np.inf], [0.4, 0.3, -np.inf]], np.float32), -1.0),
}


@pytest.mark.parametrize("case", list(HIT_CASES))
def test_threshold_hits_and_score_batch_equal_jax(case):
    scores, threshold = HIT_CASES[case]
    ids = np.array([[0, 1, 2], [2, 0, 1]], np.int32)
    id_to_passage = {0: "a", 1: "b", 2: "c"}
    t = tcommon.threshold_hits(scores, ids, id_to_passage, threshold)
    j = jcommon.threshold_hits(scores, ids, id_to_passage, threshold)
    assert t == j
    for gold in (["a", "c"], ["b", "b"], ["c", "x"]):  # rank 1, rank 2 / 3, a miss
        assert tcommon.score_batch(t, gold) == jcommon.score_batch(j, gold)


@pytest.mark.parametrize("with_rrs", [True, False], ids=["mrr", "no-mrr"])
def test_aggregate_results_equals_jax(with_rrs):
    p, r, hit, _, rrs = jcommon.score_batch([[("g0", 0.9), ("x", 0.8)], [("x", 0.9), ("g1", 0.8)], [("x", 0.9)]],
                                            ["g0", "g1", "g2"])
    rr = rrs if with_rrs else None
    t, j = tcommon.aggregate_results(7, p, r, hit, rr), jcommon.aggregate_results(7, p, r, hit, rr)
    assert t.model_dump_json() == j.model_dump_json()
    assert (t.mrr is None) == (not with_rrs)


@pytest.mark.parametrize("n,batch", [(12, 4), (13, 4), (3, 8)], ids=["whole-batches", "short-last-batch", "one-short"])
def test_embed_dataset_equals_jax(n, batch):
    """An exact embedding function (integer-valued): the port's tensor equals the JAX array, the last batch embedded
    at its own size where the JAX package pads it."""
    rng = np.random.default_rng(n)
    cols = {"ids": rng.integers(0, 200, (n, 6)).tolist(), "mask": rng.integers(0, 2, (n, 6)).tolist()}
    w = rng.integers(-3, 4, (6, 5)).astype(np.float32)
    seen = []

    def jfn(ids, mask):
        return (ids * mask).astype(np.float32) @ w

    def tfn(ids, mask):
        seen.append(len(ids))
        return torch.from_numpy((np.asarray(ids) * np.asarray(mask)).astype(np.float32) @ w)

    j = jcommon.embed_dataset(jfn, Dataset.from_dict(cols), "ids", "mask", batch, 5)
    t = tcommon.embed_dataset(tfn, ColumnDataset(cols), "ids", "mask", batch, 5)
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), j)
    assert seen == [min(batch, n - s) for s in range(0, n, batch)]


@pytest.mark.parametrize("autoregressive", [False, True], ids=["right-padded", "left-padded-eos"])
def test_preprocess_eval_dataset_equals_jax(autoregressive):
    cols = eval_columns()
    jtok, ttok = jax_tokenizer("byte", add_eos_token=autoregressive), resolve_tokenizer("byte", autoregressive)
    if autoregressive:
        jtok.padding_side = ttok.padding_side = "left"
    j = jcommon.preprocess_eval_dataset(Dataset.from_dict(cols), jtok, "Question", "Abstract", 40)
    t = tcommon.preprocess_eval_dataset(ColumnDataset(cols), ttok, "Question", "Abstract", 40)
    assert t.column_names == j.column_names
    for name in j.column_names:
        assert t[name] == list(j[name]), name


JSON_VALUES = [0.0, 1.0, 0.5, 1 / 3, 2 / 3, 1e-4, 1.2e-4, 1e-5, 2.5e-5, 5e-6, 1.5e-7, 3e-10, 1e15, 1e16, 1.5e16,
               123456789012345.6, 0.45984, 0.73634, 7 / 200000, -0.0]


@pytest.mark.parametrize("value", JSON_VALUES)
def test_eval_results_json_equals_pydantics(value):
    kw = dict(total_examples=200000, recall=value, precision=value / 10, hit_rate=1 - value if value <= 1 else value)
    for extra in ({}, {"exact_match": value}, {"mrr": value, "exact_match": None}):
        t, j = EvalResults(**kw, **extra), JaxEvalResults(**kw, **extra)
        assert t.model_dump_json() == j.model_dump_json()
    t = EvalResults(**kw).model_copy(update={"exact_match": 0.5})
    assert t.model_dump_json() == JaxEvalResults(**kw).model_copy(update={"exact_match": 0.5}).model_dump_json()
    assert [f for f in t.__dataclass_fields__] == list(JaxEvalResults.model_fields)


def test_eval_results_json_on_random_floats():
    rng = np.random.default_rng(1)
    values = np.concatenate([rng.random(200), 10.0 ** rng.uniform(-12, 18, 200)])
    for v in values:
        t = EvalResults(total_examples=3, recall=float(v), precision=1.0, hit_rate=float(v) / 7, mrr=math.sqrt(v))
        j = JaxEvalResults(total_examples=3, recall=float(v), precision=1.0, hit_rate=float(v) / 7, mrr=math.sqrt(v))
        assert t.model_dump_json() == j.model_dump_json(), v


# ---- evaluate_retriever / evaluate_rag against the JAX package ------------------------------------------------


@pytest.fixture(scope="module")
def retriever_case(bases):
    """The JAX side's embeddings, after holding the port's to them."""
    cols = eval_columns()
    jdir, tdir = bases["retriever"][0], bases["retriever"][1]
    passages = unique_passages(cols)
    jp, tp = jax_embeddings(jdir, passages), port_embeddings(tdir, passages)
    jq, tq = jax_embeddings(jdir, cols["Question"]), port_embeddings(tdir, cols["Question"])
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-5)
    return cols, jp, jq


@pytest.mark.parametrize("quantize,threshold_on", [(False, False), ("int8", False), ("int4", False), (False, True)],
                         ids=["f32", "int8", "int4", "f32-threshold-mid"])
def test_evaluate_retriever_equals_jax(bases, retriever_case, quantize, threshold_on):
    from dalm_tpu.eval.retriever import evaluate_retriever as jax_evaluate_retriever

    cols, jp, jq = retriever_case
    scores, _ = jax_search_margins(jp, jq, quantize, TOP_K)
    threshold = split_threshold(scores[:, :TOP_K]) if threshold_on else 0.0
    assert_margins(scores, TOP_K, threshold)
    kw = dict(max_length=32, test_batch_size=8, query_batch_size=8, torch_dtype="float32", top_k=TOP_K,
              index_quantize=quantize, threshold=threshold)
    j = jax_evaluate_retriever(Dataset.from_dict(cols), bases["retriever"][0], **kw)
    t = evaluate_retriever(cols, bases["retriever"][1], device="cpu", **kw)
    assert t.model_dump_json() == j.model_dump_json()
    assert t.total_examples == 18 and 0 < t.hit_rate <= 1 and t.recall == t.hit_rate
    if threshold_on:
        assert t.precision != evaluate_retriever(cols, bases["retriever"][1], device="cpu",
                                                 **dict(kw, threshold=0.0)).precision


def test_evaluate_retriever_checks_embed_dim_and_defaults_to_the_card(bases):
    cols = eval_columns()
    with pytest.raises(ValueError, match="embed_dim"):
        evaluate_retriever(cols, bases["retriever"][1], device="cpu", embed_dim=32, max_length=32)
    assert evaluate_retriever(cols, bases["retriever"][1], device="cpu", embed_dim=64, max_length=32,
                              index_kernel="pallas").total_examples == 18
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate_retriever(cols, bases["retriever"][1], max_length=32)


def jax_planted_answers(cols, r_dir, g_dir, r_peft, g_peft, max_length, query_batch_size, max_new_tokens):
    """The JAX generator's text for each row, as JAX's ``evaluate_rag`` forms it (top-1 retrieved passage, the same
    batches, the last padded with its last prompt), split on ``#answer#``: segment [1], stripped."""
    from dalm_tpu.eval.retriever import build_embed_fn as jax_build_embed_fn
    from dalm_tpu.eval.retriever import load_retriever_for_eval as jax_load
    from dalm_tpu.models.generate import build_greedy_generate
    from dalm_tpu.models.registry import build_decoder, resolve_decoder

    model, params, tok = jax_load(r_dir, r_peft, False, "float32", "byte")
    embed = jax_build_embed_fn(model, params)
    passages = unique_passages(cols)
    tp = tok(passages, padding="max_length", max_length=max_length, truncation=True)
    tq = tok(cols["Question"], padding="max_length", max_length=max_length, truncation=True)
    p_embs = np.asarray(embed(np.asarray(tp["input_ids"]), np.asarray(tp["attention_mask"])))
    q_embs = np.asarray(embed(np.asarray(tq["input_ids"]), np.asarray(tq["attention_mask"])))
    scores, ids = jax_search_margins(p_embs, q_embs, False, TOP_K)
    assert_margins(scores, TOP_K, 0.0)
    prompts = [f"#query# {q} #passage# {passages[int(i)]} #answer# " for q, i in zip(cols["Question"], ids[:, 0])]
    g_cfg, g_params = resolve_decoder(g_dir)
    lora, spec = jlora.load_adapter(g_peft)
    g_params = jlora.merge_lora(g_params, lora, spec)
    g_tok = jax_tokenizer("byte")
    g_tok.padding_side = "left"
    generate = build_greedy_generate(build_decoder(g_cfg), max_new_tokens, eos_token_id=g_tok.eos_token_id,
                                     pad_token_id=g_tok.pad_token_id or 0)
    texts = []
    for s in range(0, len(prompts), query_batch_size):
        batch = prompts[s:s + query_batch_size]
        real = len(batch)
        batch += [batch[-1]] * (query_batch_size - real)
        t = g_tok(batch, padding="max_length", max_length=max_length, truncation=True)
        out = np.asarray(generate(g_params, np.asarray(t["input_ids"], np.int32), np.asarray(t["attention_mask"],
                                                                                              np.int32)))
        texts += [batch[i] + g_tok.decode(out[i], skip_special_tokens=True) for i in range(real)]
    return [t.split("#answer#")[1].strip() for t in texts]


def test_evaluate_rag_equals_jax_with_adapters_and_planted_answers(bases, tmp_path):
    """Adapters on both towers; half the rows' answers set to the JAX generator's own answer for them, so exact
    match reads 0.5 on both sides only if the port retrieves the same top-1 passages and generates the same text."""
    from dalm_tpu.eval.rag import evaluate_rag as jax_evaluate_rag

    cols = eval_columns(n_unique=10, n_dup=2)
    (jr, tr, r_params), (jg, tg, g_params) = bases["retriever"], bases["generator"]
    jr_peft, tr_peft = seeded_adapter(r_params, tlora.LoraSpec.for_encoder(), 3, f"{tmp_path}/r")
    jg_peft, tg_peft = seeded_adapter(g_params, tlora.LoraSpec.for_causal_lm(), 4, f"{tmp_path}/g")
    kw = dict(max_length=72, test_batch_size=8, query_batch_size=4, max_new_tokens=6, torch_dtype="float32",
              top_k=TOP_K)
    planted = jax_planted_answers(cols, jr, jg, jr_peft, jg_peft, kw["max_length"], kw["query_batch_size"],
                                  kw["max_new_tokens"])
    cols["Answer"] = [a if i % 2 == 0 else f"not {a}" for i, a in enumerate(planted)]
    j = jax_evaluate_rag(Dataset.from_dict(cols), jr, jg, retriever_peft_model_path=jr_peft,
                         generator_peft_model_path=jg_peft, **kw)
    t = evaluate_rag(cols, tr, tg, retriever_peft_model_path=tr_peft, generator_peft_model_path=tg_peft,
                     device="cpu", **kw)
    assert j.exact_match == t.exact_match == 0.5
    assert t.model_dump_json() == j.model_dump_json()
    off = evaluate_rag(cols, tr, tg, retriever_peft_model_path=tr_peft, generator_peft_model_path=tg_peft,
                       device="cpu", evaluate_generator=False, **kw)
    assert off.exact_match is None and off.model_copy(update={"exact_match": 0.5}) == t
