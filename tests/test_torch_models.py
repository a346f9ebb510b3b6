"""The port's modules against the JAX package's on shared weights: flax
params from ``init`` carried across with ``dalm_tpu_torch.interop``, the
same numpy inputs, f32 on the CPU.

Tolerances: embeddings 1e-5 (unit-norm vectors, f32); decoder logits
1e-4 (f32 through two layers and a 512-wide head, sums in another order);
greedy tokens exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.core.mesh import unbox
from dalm_tpu.models import decoder as jdec
from dalm_tpu.models import encoder as jenc
from dalm_tpu.models.embedder import SentenceEmbedder as JaxEmbedder
from dalm_tpu.models.generate import build_greedy_generate as jax_build_greedy_generate
from dalm_tpu_torch.interop import load_params
from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
from dalm_tpu_torch.models.embedder import SentenceEmbedder
from dalm_tpu_torch.models.encoder import Encoder, EncoderConfig
from dalm_tpu_torch.models.generate import build_greedy_generate

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores


def _np_tree(params):
    return jax.tree.map(np.asarray, unbox(params))


def _padded_batch(rng, b, s, vocab, left):
    ids = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    lens = rng.integers(s // 2, s + 1, size=b)
    lens[0] = s
    cols = np.arange(s)[None, :]
    mask = (cols >= (s - lens[:, None])) if left else (cols < lens[:, None])
    mask = mask.astype(np.int32)
    return np.where(mask > 0, ids, 256).astype(np.int32), mask


def test_encoder_and_embedder_match_jax():
    rng = np.random.default_rng(0)
    jcfg = jenc.EncoderConfig.tiny()
    ids, mask = _padded_batch(rng, 3, 12, 259, left=False)
    params = _np_tree(jenc.Encoder(jcfg).init(jax.random.PRNGKey(0), ids, mask)["params"])

    j_hidden = jax.jit(jenc.Encoder(jcfg).apply)({"params": params}, ids, mask)
    enc = load_params(Encoder(EncoderConfig.tiny()), params)
    t_hidden = enc(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    np.testing.assert_allclose(t_hidden.detach().numpy(), np.asarray(j_hidden), rtol=0, atol=1e-5)

    j_emb = jax.jit(JaxEmbedder(jcfg).embed)(params, ids, mask)
    emb = load_params(SentenceEmbedder(EncoderConfig.tiny()), params)
    t_emb = emb.embed(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), rtol=0, atol=1e-5)


DECODER_CASES = {"mha": {}, "gqa": {"num_heads": 4, "num_kv_heads": 2}}


def _decoders(case, seed=0):
    jcfg = dataclasses.replace(jdec.DecoderConfig.tiny(), **DECODER_CASES[case])
    ids = jnp.zeros((1, 8), jnp.int32)
    params = _np_tree(jdec.Decoder(jcfg).init(jax.random.PRNGKey(seed), ids, jnp.ones_like(ids))["params"])
    tcfg = dataclasses.replace(DecoderConfig.tiny(), **DECODER_CASES[case])
    return jdec.Decoder(jcfg), params, load_params(Decoder(tcfg), params)


@pytest.mark.parametrize("case", sorted(DECODER_CASES))
def test_decoder_full_sequence_and_cached_match_jax(case):
    jmod, params, tmod = _decoders(case)
    apply = jax.jit(jmod.apply)
    rng = np.random.default_rng(1)
    B, P, steps = 3, 10, 3
    ids, mask = _padded_batch(rng, B, P, 259, left=True)

    j_logits = apply({"params": params}, ids, mask)
    t_logits = tmod(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=0, atol=1e-4)

    # cached: prefill at slot 0, then 3 single-token steps at slots P + t
    L = P + steps
    slot_mask = np.concatenate([mask, np.ones((B, steps), np.int32)], axis=1)
    pos = np.clip(np.cumsum(mask, axis=1) - 1, 0, None)
    j_cache = jmod.init_kv_cache(B, L)
    t_cache = tmod.init_kv_cache(B, L)
    j_out, j_cache = apply({"params": params}, ids, slot_mask, positions=pos, kv_cache=j_cache, cache_index=0)
    t_out, t_cache = tmod(torch.from_numpy(ids).long(), torch.from_numpy(slot_mask).long(),
                          positions=torch.from_numpy(pos).long(), kv_cache=t_cache, cache_index=0)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=1e-4)
    real = mask.sum(axis=1)
    for t in range(steps):
        tok = rng.integers(0, 259, size=(B, 1)).astype(np.int32)
        p = (real + t)[:, None]
        j_out, j_cache = apply({"params": params}, tok, slot_mask, positions=p, kv_cache=j_cache,
                               cache_index=P + t)
        t_out, t_cache = tmod(torch.from_numpy(tok).long(), torch.from_numpy(slot_mask).long(),
                              positions=torch.from_numpy(p).long(), kv_cache=t_cache, cache_index=P + t)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(t_cache["layer_1"][name].numpy(), np.asarray(j_cache["layer_1"][name]),
                                   rtol=0, atol=1e-5)


def test_greedy_generate_matches_jax_with_eos_mid_answer():
    jmod, params, tmod = _decoders("mha", seed=2)
    rng = np.random.default_rng(4)
    ids, mask = _padded_batch(rng, 4, 12, 259, left=True)
    new = 6
    # Make the EOS id a token the model emits mid-answer, so the post-EOS
    # pad replacement is exercised.
    free = np.asarray(jax_build_greedy_generate(jmod, new)(params, ids, mask))
    eos = int(free[0, 2])
    j_out = np.asarray(jax_build_greedy_generate(jmod, new, eos_token_id=eos, pad_token_id=256)(params, ids, mask))
    t_out = build_greedy_generate(tmod, new, eos_token_id=eos, pad_token_id=256)(
        torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
    ).numpy()
    np.testing.assert_array_equal(t_out, j_out)
    assert (t_out[0, 3:] == 256).all() and t_out[0, 2] == eos


def test_unported_decoder_knobs_raise():
    from dalm_tpu_torch.models.decoder import check_unported

    # sliding windows are ported (tests/test_torch_families.py); so are the MoE knobs (tests/test_torch_moe.py):
    # check_unported takes them and the decoder builds an MoE block
    assert Decoder(dataclasses.replace(DecoderConfig.tiny(), sliding_window=16)).cfg.layer_window(0) == 16
    check_unported({"num_experts": 8})
    moe = Decoder(dataclasses.replace(DecoderConfig.tiny(), num_experts=8)).layer_0.moe
    assert tuple(moe.w_gate.shape) == (8, 64, 128) and not hasattr(moe, "e_score_correction_bias")
    # the int8 KV cache is ported (tests/test_torch_quant_serve.py): its cache holds int8 and scales
    cache = Decoder(dataclasses.replace(DecoderConfig.tiny(), kv_quant=True)).init_kv_cache(1, 4)["layer_0"]
    assert cache["k"].dtype == torch.int8 and cache["k_scale"].shape == (1, 4, 2)
    with pytest.raises(NotImplementedError):
        Decoder(dataclasses.replace(DecoderConfig.tiny(), attention_impl="ring"))
    # "flash" is ported (kernels/flash_attention.py); the decoder takes it
    assert Decoder(dataclasses.replace(DecoderConfig.tiny(), attention_impl="flash")).uses_flash(256)
