"""The autoregressive (EOS-pooled decoder) retriever against the JAX package on the CPU, in f32: the pooling, the
embedder, ``evaluate_retriever``, ``train_retriever``, ``train_e2e`` in both runtimes and on the calibrated W8A8
route, and ``RagPipeline``.

The retriever is the tiny decoder, saved once a test run by each package (``test_torch_eval.shared_bases``). Tolerances:
``eos_mask`` equal and ``eos_pool`` within 1e-6; embeddings within 1e-5; ``EvalResults`` equal after asserting
that the JAX side's k-th / (k + 1)-th scores lie more than 1e-4 apart; the trainers' loss at every step within 1e-4
(each run has one batch an epoch, so each epoch's logged loss is one step's) and the trained factors within 3e-4
(the tolerances of ``test_torch_retriever_train.py``); retrieved ids equal, scores within 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from datasets import Dataset

from dalm_tpu.models import lora as jlora
from dalm_tpu.models import qlora as jqlora
from dalm_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from dalm_tpu.models.embedder import SentenceEmbedder as JaxEmbedder
from dalm_tpu.models.pooling import eos_mask as jax_eos_mask
from dalm_tpu.models.pooling import eos_pool as jax_eos_pool
from dalm_tpu_torch import interop
from dalm_tpu_torch.eval.retriever import evaluate_retriever
from dalm_tpu_torch.models import lora as tlora
from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
from dalm_tpu_torch.models.embedder import SentenceEmbedder
from dalm_tpu_torch.models.layers import FlexLinear
from dalm_tpu_torch.models.pooling import eos_mask, eos_pool
from dalm_tpu_torch.models.rag import RagE2EModel
from dalm_tpu_torch.serve import RagPipeline
from dalm_tpu_torch.train import train_e2e, train_retriever
from test_torch_eval import (TOP_K, assert_margins, eval_columns, jax_embeddings, jax_search_margins,
                             port_embeddings, shared_bases, unique_passages)
from test_torch_train_e2e import SMALL

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    return shared_bases(tmp_path_factory)


@pytest.fixture(scope="module")
def csv8(tmp_path_factory, toy_csv):
    """The first 8 rows of the toy CSV: at batch 8, one step an epoch."""
    import csv

    with open(toy_csv, newline="") as f:
        rows = list(csv.reader(f))
    path = tmp_path_factory.mktemp("csv8") / "toy8.csv"
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows[:9])
    return str(path)


def epoch_losses(out_dir, project):
    with open(os.path.join(out_dir, f"{project}_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["train/epoch_loss"] for r in rows if "train/epoch_loss" in r]


@pytest.mark.parametrize("padding", ["left", "right"])
def test_eos_mask_and_pool_equal_jax(padding):
    rng = np.random.default_rng(0)
    lens = np.array([5, 1, 8, 3])
    mask = np.zeros((4, 8), np.int32)
    for i, n in enumerate(lens):
        if padding == "left":
            mask[i, 8 - n:] = 1
        else:
            mask[i, :n] = 1
    hidden = rng.standard_normal((4, 8, 16)).astype(np.float32)
    tm = eos_mask(torch.from_numpy(mask), padding)
    assert np.array_equal(tm.numpy(), np.asarray(jax_eos_mask(jnp.asarray(mask), padding)))
    assert tm.sum(1).tolist() == [1, 1, 1, 1]
    for normalize in (True, False):
        t = eos_pool(torch.from_numpy(hidden), torch.from_numpy(mask), padding, normalize)
        j = jax_eos_pool(jnp.asarray(hidden), jnp.asarray(mask), padding, normalize)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)
    pos = 7 if padding == "left" else lens - 1  # the EOS position's hidden state, normalised
    want = hidden[np.arange(4), pos]
    np.testing.assert_allclose(eos_pool(torch.from_numpy(hidden), torch.from_numpy(mask), padding).numpy(),
                               want / np.linalg.norm(want, axis=1, keepdims=True), rtol=0, atol=1e-6)


def test_ar_sentence_embedder_equals_jax(bases):
    """The saved tiny decoder's whole tree (the port's Decoder has an lm_head, unused here) in both embedders."""
    rng = np.random.default_rng(1)
    params = bases["generator"][2]
    jmodel = JaxEmbedder(JaxDecoderConfig.tiny(), is_autoregressive=True)
    tmodel = SentenceEmbedder(DecoderConfig.tiny(), is_autoregressive=True)
    assert isinstance(tmodel.module, Decoder) and tmodel.embedding_dim == 64
    interop.load_params(tmodel.module, params)
    ids = rng.integers(0, 259, (5, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :4] = 0  # left padding
    mask[3, :11] = 0
    j = np.asarray(jmodel.embed(params, jnp.asarray(ids), jnp.asarray(mask)))
    t = tmodel.embed(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(t.numpy(), axis=1), 1.0, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def ar_case(bases):
    """The JAX side's EOS-pooled embeddings of the eval data, after holding the port's to them."""
    cols = eval_columns()
    jdir, tdir = bases["generator"][0], bases["generator"][1]
    passages = unique_passages(cols)
    jp, jq = jax_embeddings(jdir, passages, True), jax_embeddings(jdir, cols["Question"], True)
    np.testing.assert_allclose(port_embeddings(tdir, passages, True), jp, rtol=0, atol=1e-5)
    np.testing.assert_allclose(port_embeddings(tdir, cols["Question"], True), jq, rtol=0, atol=1e-5)
    return cols, jp, jq


@pytest.mark.parametrize("quantize", [False, "int8"], ids=["f32", "int8"])
def test_ar_evaluate_retriever_equals_jax(bases, ar_case, quantize):
    from dalm_tpu.eval.retriever import evaluate_retriever as jax_evaluate_retriever

    cols, jp, jq = ar_case
    jdir, tdir = bases["generator"][0], bases["generator"][1]
    scores, _ = jax_search_margins(jp, jq, quantize, TOP_K)
    assert_margins(scores, TOP_K, 0.0)
    kw = dict(max_length=32, test_batch_size=8, torch_dtype="float32", top_k=TOP_K, is_autoregressive=True,
              index_quantize=quantize)
    j = jax_evaluate_retriever(Dataset.from_dict(cols), jdir, **kw)
    t = evaluate_retriever(cols, tdir, device="cpu", **kw)
    assert t.model_dump_json() == j.model_dump_json() and t.hit_rate > 0.5


KW = dict(query_max_len=24, passage_max_len=48, learning_rate=1e-3, with_tracking=True, report_to="none",
          use_dropout=False, num_train_epochs=2, seed=5, lr_scheduler_type="constant")


@pytest.mark.parametrize("peft,bnb", [(True, True), (True, False), (False, False)], ids=["lora-int8", "lora", "dense"])
def test_ar_train_retriever_equals_jax(tmp_path, csv8, bases, peft, bnb):
    from dalm_tpu.train.retriever_only import train_retriever as jax_train_retriever

    jdir, tdir, params = bases["generator"]
    common = dict(KW, use_peft=peft, use_bnb=bnb, is_autoregressive=True)
    jout, tout = str(tmp_path / "jax_out"), str(tmp_path / "out")
    j = jax_train_retriever(jdir, csv8, per_device_train_batch_size=1, local_negatives=False, output_dir=jout, **common)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(KW["seed"]))
    seen = {}

    def hook(setup):
        assert isinstance(setup.model, Decoder)
        if peft:
            f = jlora.init_lora_params(jax.random.fold_in(init_rng, 7), params, jlora.LoraSpec.for_causal_lm())
            interop.load_merge_lora(setup.model, jax.tree.map(np.asarray, f), setup.lora_spec)
        seen["trainable"] = sorted(setup.state.params)

    t = train_retriever(tdir, csv8, per_device_train_batch_size=8, device="cpu", setup_hook=hook, output_dir=tout,
                        **common)
    assert t["steps"] == j["steps"] == 2
    tl, jl = epoch_losses(tout, "peft_contrastive_training"), epoch_losses(jout, "peft_contrastive_training")
    assert len(tl) == len(jl) == 2 and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert abs(t["final_loss"] - j["final_loss"]) <= 1e-4
    if peft:  # A and B of q_proj / v_proj in both layers
        assert seen["trainable"] == sorted(f"layer_{i}.attention.{m}.{leaf}" for i in range(2)
                                           for m in ("q_proj", "v_proj") for leaf in ("lora_a", "lora_b"))
    with open(os.path.join(tout, "retriever", "config.json")) as f:
        meta = json.load(f)
    assert meta["is_autoregressive"] is True and meta["__class__"] == "DecoderConfig"
    if peft:
        tflat, spec = tlora.load_adapter(os.path.join(tout, "retriever"))
        jfl, _ = jlora.load_adapter(os.path.join(jout, "retriever"))
        assert sorted(tflat) == sorted(jfl) and spec.target_modules == ("q_proj", "v_proj")
        for path, ab in tflat.items():
            for leaf in ("lora_a", "lora_b"):
                np.testing.assert_allclose(ab[leaf].numpy(), np.asarray(jfl[path][leaf]), rtol=0, atol=3e-4)


E2E_CASES = {
    "merge": dict(lora_runtime="merge"),
    "fused": dict(lora_runtime="fused"),
    "fused-w8a8-calibrated": dict(lora_runtime="fused", int8_compute="all", a8_calibrate_every=1),
}


@pytest.mark.parametrize("case", list(E2E_CASES))
def test_ar_train_e2e_equals_jax(tmp_path, csv8, bases, case):
    """Both towers decoders, LoRA and int8 bases on both; the fused runtime packs the EOS-pooled tower as it packs
    the generator. ``fused-w8a8-calibrated`` runs both towers' int8 bases through the calibrated W8A8 route
    (``int8_compute="all"``) and recalibrates before each of the two steps: the retriever's query and passage
    forwards and the generator's forward record every site's amax once each a pass, and every int8 site of the
    EOS-pooled tower holds a finite ``a_scale`` > 0 that takes no gradient. Losses per step and per tower within
    1e-4 of the JAX trainer's."""
    from dalm_tpu.train.rag_e2e import train_e2e as jax_train_e2e

    (jr, tr, r_params), (jg, tg, g_params) = bases["generator"], bases["generator"]
    runtime = E2E_CASES[case]["lora_runtime"]
    common = dict(SMALL, num_train_epochs=2, seed=5, use_peft="both", use_bnb="both", retriever_is_autoregressive=True,
                  with_tracking=True, report_to="none", lr_scheduler_type="constant", **E2E_CASES[case])
    jout, tout = str(tmp_path / "jax_out"), str(tmp_path / "out")
    j = jax_train_e2e(csv8, jr, jg, per_device_train_batch_size=1, local_negatives=False, use_dropout=False,
                      output_dir=jout, **common)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(5))
    spec = jlora.LoraSpec.for_causal_lm()
    if runtime == "fused":
        factors = {sub: jqlora.init_qlora_factors(jax.random.fold_in(init_rng, n), p, spec)
                   for sub, n, p in (("retriever", 23, r_params), ("generator", 29, g_params))}
    else:
        factors = {sub: jlora.init_lora_params(jax.random.fold_in(init_rng, n), p, spec)
                   for sub, n, p in (("retriever", 13, r_params), ("generator", 17, g_params))}
    seen = {}

    def hook(setup):
        assert isinstance(setup.rag.retriever, Decoder) and setup.quantized_subs == {"retriever", "generator"}
        assert setup.lora_specs["retriever"].target_modules == ("q_proj", "v_proj")
        for sub in ("retriever", "generator"):
            f = jax.tree.map(np.asarray, factors[sub])
            if runtime == "fused":
                interop.load_factors(getattr(setup.rag, sub), f)
            else:
                interop.load_merge_lora(getattr(setup.rag, sub), f, setup.lora_specs[sub])
        seen["rag"] = setup.rag

    recorded = {"retriever": 0, "generator": 0}
    real = FlexLinear.forward

    def counting(self, x):
        if self.record_amax:
            recorded[seen["tower"][id(self)]] += 1
        return real(self, x)

    def tag(setup):
        hook(setup)
        seen["tower"] = {id(m): sub for sub in recorded for m in getattr(setup.rag, sub).modules()}

    FlexLinear.forward = counting
    try:
        t = train_e2e(csv8, tr, tg, per_device_train_batch_size=8, device="cpu", setup_hook=tag, output_dir=tout,
                      **common)
    finally:
        FlexLinear.forward = real
    assert t["steps"] == j["steps"] == 2
    tl, jl = epoch_losses(tout, "rag_e2e_training"), epoch_losses(jout, "rag_e2e_training")
    assert len(tl) == len(jl) == 2 and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    for key in ("final_loss", "final_retriever_loss", "final_generator_loss"):
        assert abs(t[key] - j[key]) <= 1e-4, (key, t[key], j[key])
    if runtime == "fused":  # the EOS-pooled tower packed int8, its factors on q_proj / v_proj only
        attn = seen["rag"].retriever.layer_1.attention
        assert attn.q_proj.q is not None and attn.q_proj.a is not None and attn.v_proj.b is not None
        assert attn.k_proj.q is not None and attn.k_proj.a is None
    sites = {sub: [m for m in getattr(seen["rag"], sub).modules() if getattr(m, "q", None) is not None]
             for sub in recorded}
    if case == "fused-w8a8-calibrated":
        # two passes: the retriever's query and passage forwards (its lm_head unused: it embeds the hidden states,
        # and keeps no a_scale, as in the JAX trainer), the generator's forward
        head = seen["rag"].retriever.lm_head
        pooled = [m for m in sites["retriever"] if m is not head]
        assert head in sites["retriever"] and head.a_scale is None
        assert recorded == {"retriever": 2 * 2 * len(pooled), "generator": 2 * len(sites["generator"])}
        for m in pooled + sites["generator"]:
            assert m.a_scale is not None and np.isfinite(float(m.a_scale)) and float(m.a_scale) > 0
            assert not m.a_scale.requires_grad and m.dy_scale is None
    else:
        assert recorded == {"retriever": 0, "generator": 0}
        assert all(getattr(m, "a_scale", None) is None for ms in sites.values() for m in ms)


def test_ar_rag_e2e_model_embeds_through_the_decoder():
    rag = RagE2EModel(DecoderConfig.tiny(), DecoderConfig.tiny(), retriever_is_autoregressive=True)
    assert isinstance(rag.retriever, Decoder)
    rag.retriever.reset_parameters(torch.Generator().manual_seed(0))
    ids = torch.randint(0, 259, (3, 10), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    emb = rag.embed_with(ids, mask)
    assert emb.shape == (3, 64) and emb.requires_grad
    want = eos_pool(rag.retriever(ids, mask, return_hidden=True), mask)
    assert torch.allclose(emb.detach(), want, atol=1e-6)


def test_ar_rag_pipeline_retrieves_as_jax(bases):
    from dalm_tpu.serve import RagPipeline as JaxRagPipeline

    cols = eval_columns()
    passages = unique_passages(cols)
    queries = cols["Question"][:6]
    opts = dict(max_passage_len=32, max_prompt_len=64, max_new_tokens=4, embed_batch=8)
    ref = JaxRagPipeline.from_pretrained(bases["generator"][0], bases["generator"][0], passages,
                                         retriever_is_autoregressive=True, **opts)
    pipe = RagPipeline.from_pretrained(bases["generator"][1], bases["generator"][1], passages, device="cpu",
                                       retriever_is_autoregressive=True, **opts)
    assert pipe.index.embeddings.shape == (len(passages), 64) and pipe.r_tok.padding_side == "left"
    js, ji = ref.retrieve(queries, top_k=TOP_K + 1)
    gap = js[:, TOP_K - 1] - js[:, TOP_K]
    assert (gap > 1e-4).all()
    ts, ti = pipe.retrieve(queries, top_k=TOP_K)
    np.testing.assert_array_equal(ti, ji[:, :TOP_K])
    np.testing.assert_allclose(ts, js[:, :TOP_K], rtol=0, atol=1e-5)
    assert [a.answer for a in pipe.answer(queries, TOP_K)] == [a.answer for a in ref.answer(queries, TOP_K)]
