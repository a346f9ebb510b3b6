"""The port's 4-bit serving tiers, int8 KV cache and sampler against the JAX
package's, on the CPU.

Tolerances: packed trees are EQUAL. Decoders in f32 carrying the same
``quant`` tree through ``interop``: at the tiny width (64) the reference's
rule rejects every projection and both sides dequantise: 1e-4 on the logits
(sums in another order); with the int8 KV cache 1e-3 (a key or value whose
quantisation rounds to the neighbouring step moves the logits by a few 1e-4),
layer 0's int8 caches equal except for such steps. At a width the rule admits (256, intermediate 512,
groups 16 and 32) the port runs its plain K5 (bf16 operands, f32 sums) where
the reference dequantises in f32: 2e-2 of the largest logit (bf16 rounding of
activations and weights through two layers), 5e-2 for int4pc (its kernel
quantises the activations to int8 per row). ``_filter_logits``: EQUAL.
Sampling frequencies over 20,000 draws: within 0.02 of ``softmax(logits / T)``
(5.6 standard deviations at p = 0.5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.core.mesh import unbox
from dalm_tpu.models import decoder as jdec
from dalm_tpu.models import qlora as jqlora
from dalm_tpu.models import quant as jquant
from dalm_tpu.models import sampling as jsampling
from dalm_tpu_torch import interop
from dalm_tpu_torch.core.tree import flatten, unflatten
from dalm_tpu_torch.kernels import int4_matmul as k5
from dalm_tpu_torch.models import qlora, sampling
from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
from dalm_tpu_torch.models.generate import build_greedy_generate

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores

WIDTHS = {"tiny": {}, "feasible": dict(hidden_size=256, num_heads=4, intermediate_size=512)}
FORMATS = ("int4", "nf4", "int4pc")


def _params(width, seed=0):
    jcfg = dataclasses.replace(jdec.DecoderConfig.tiny(), **WIDTHS[width])
    ids = jnp.zeros((1, 8), jnp.int32)
    return jcfg, jax.tree.map(np.asarray, unbox(jdec.Decoder(jcfg).init(jax.random.PRNGKey(seed), ids,
                                                                         jnp.ones_like(ids))["params"]))


@pytest.mark.parametrize("fmt", FORMATS)
def test_pack_qlora_frozen_4bit_equals_jax(fmt):
    _, params = _params("tiny")
    t_res, t_quant = qlora.pack_qlora_frozen(unflatten({k: torch.from_numpy(np.array(v)) for k, v in
                                                        flatten(params).items()}), quantize=fmt)
    j_res, j_quant = jqlora.pack_qlora_frozen(params, quantize=fmt)
    for tree_t, tree_j in ((t_res, j_res), (t_quant, j_quant)):
        ft, fj = flatten(tree_t), flatten(jax.tree.map(np.asarray, tree_j))
        assert sorted(ft) == sorted(fj)
        for k, v in ft.items():
            assert v.numpy().dtype == fj[k].dtype and (v.numpy() == fj[k]).all(), k
    node = t_quant["layer_0"]["mlp"] if "mlp" in t_quant["layer_0"] else t_quant["layer_0"]["gate_proj"]
    assert "q4" in node and ("nf4" in node) == (fmt == "nf4") and ("pcol" in node) == (fmt == "int4pc")
    full = qlora.unpack_to_params(t_res, t_quant, torch.float32)
    want = jquant.dequantize_tensor_int4(j_quant["layer_1"]["down_proj"])
    np.testing.assert_array_equal(full["layer_1"]["down_proj"]["kernel"].numpy(), np.asarray(want))


def _batch(rng, B, P):
    ids = rng.integers(0, 259, size=(B, P)).astype(np.int32)
    lens = rng.integers(P // 2, P + 1, size=B)
    lens[0] = P
    mask = (np.arange(P)[None, :] >= (P - lens[:, None])).astype(np.int32)
    return np.where(mask > 0, ids, 256).astype(np.int32), mask


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16-cache", "int8-cache"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("fmt", FORMATS)
def test_packed_decoder_matches_jax(fmt, width, kv_quant):
    """Full-sequence and cached decode logits of a 4-bit packed decoder, the same quant tree on both sides."""
    jcfg, params = _params(width)
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    residual, quant_tree = jqlora.pack_qlora_frozen(params, quantize=fmt)
    jmod, variables = jdec.Decoder(jcfg), {"params": residual, "quant": quant_tree}
    tmod = Decoder(dataclasses.replace(DecoderConfig.tiny(), kv_quant=kv_quant, **WIDTHS[width]))
    interop.load_packed(tmod, jax.tree.map(np.asarray, residual), jax.tree.map(np.asarray, quant_tree))
    if width == "feasible":  # every projection takes the plain K5 here
        assert k5._kernel_feasible(128, 16) and k5._kernel_feasible(256, 32) and k5._pcol_feasible(128, 512)
    apply = jax.jit(jmod.apply)
    atol = (1e-3 if kv_quant else 1e-4) if width == "tiny" else None

    def close(t, j):
        j = np.asarray(j)
        rel = 5e-2 if fmt == "int4pc" else 2e-2
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=atol or rel * np.abs(j).max())

    rng = np.random.default_rng(1)
    B, P, steps = 3, 10, 3
    ids, mask = _batch(rng, B, P)
    close(tmod(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()), apply(variables, ids, mask))

    L = P + steps
    slot_mask = np.concatenate([mask, np.ones((B, steps), np.int32)], axis=1)
    pos = np.clip(np.cumsum(mask, axis=1) - 1, 0, None)
    j_cache, t_cache = jmod.init_kv_cache(B, L), tmod.init_kv_cache(B, L)
    j_out, j_cache = apply(variables, ids, slot_mask, positions=pos, kv_cache=j_cache, cache_index=0)
    t_out, t_cache = tmod(torch.from_numpy(ids).long(), torch.from_numpy(slot_mask).long(),
                          positions=torch.from_numpy(pos).long(), kv_cache=t_cache, cache_index=0)
    close(t_out, j_out)
    real = mask.sum(axis=1)
    for t in range(steps):
        tok = rng.integers(0, 259, size=(B, 1)).astype(np.int32)
        p = (real + t)[:, None]
        j_out, j_cache = apply(variables, tok, slot_mask, positions=p, kv_cache=j_cache, cache_index=P + t)
        t_out, t_cache = tmod(torch.from_numpy(tok).long(), torch.from_numpy(slot_mask).long(),
                              positions=torch.from_numpy(p).long(), kv_cache=t_cache, cache_index=P + t)
        close(t_out, j_out)
    assert sorted(t_cache["layer_1"]) == sorted(j_cache["layer_1"])
    if kv_quant and width == "tiny":  # layer 0's cache: the same int8 values but for single steps
        for name in ("k", "v"):
            tq, jq = t_cache["layer_0"][name].numpy().astype(np.int32), np.asarray(j_cache["layer_0"][name], np.int32)
            assert np.abs(tq - jq).max() <= 1 and (tq != jq).mean() < 1e-2
            np.testing.assert_allclose(t_cache["layer_0"][f"{name}_scale"].numpy(),
                                       np.asarray(j_cache["layer_0"][f"{name}_scale"]), rtol=1e-5, atol=0)


def test_kv_quantize_equals_jax():
    x = (np.random.default_rng(2).standard_normal((2, 5, 3, 16)) * 3).astype(np.float32)
    x[0, 1, 2] = 0.0  # an all-zero row takes scale 1e-6 / 127
    from dalm_tpu_torch.models.decoder import _kv_dequantize, _kv_quantize

    tq, ts = _kv_quantize(torch.from_numpy(x))
    jq, js = jdec._kv_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_kv_dequantize(tq, ts, torch.float32).numpy(),
                                  np.asarray(jdec._kv_dequantize(jq, js, jnp.float32)))


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.9), (7, 0.8), (0, 1.0), (60, 0.5)])
def test_filter_logits_equals_jax(top_k, top_p):
    logits = (np.random.default_rng(3).standard_normal((4, 50)) * 2).astype(np.float32)
    tcfg = sampling.SamplerConfig(temperature=1.0, top_k=top_k, top_p=top_p)
    jcfg = jsampling.SamplerConfig(temperature=1.0, top_k=top_k, top_p=top_p)
    got = sampling._filter_logits(torch.from_numpy(logits), tcfg).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsampling._filter_logits(jnp.asarray(logits), jcfg)))


def test_sampling_repeats_per_request_and_token_and_follows_softmax():
    cfg = sampling.SamplerConfig(temperature=0.7, seed=11)
    logits = torch.tensor([[1.0, 0.5, -0.3, 2.0, 0.0, -1.0]])
    n = 20000
    rows, toks = torch.arange(n) // 100, torch.arange(n) % 100
    draws = sampling.select_token(logits.expand(n, -1), cfg, rows, toks)
    assert draws.dtype == torch.int32 and torch.equal(draws, sampling.select_token(logits.expand(n, -1), cfg, rows, toks))
    # a row's draw depends on (seed, request, token) only, not on the batch around it
    assert int(sampling.select_token(logits, cfg, rows[1234:1235], toks[1234:1235])[0]) == int(draws[1234])
    freq = torch.bincount(draws.long(), minlength=6).double() / n
    want = torch.softmax(logits[0].double() / 0.7, dim=0)
    assert float((freq - want).abs().max()) < 0.02
    other = sampling.select_token(logits.expand(n, -1), dataclasses.replace(cfg, seed=12), rows, toks)
    assert (other != draws).float().mean() > 0.3
    # filtered tokens are never drawn
    kept = sampling.select_token(logits.expand(2000, -1), dataclasses.replace(cfg, top_k=2), rows[:2000], toks[:2000])
    assert set(kept.tolist()) == {0, 3}
    with pytest.raises(ValueError, match="request_idx"):
        sampling.select_token(logits, cfg)


def test_sampled_generate_repeats_and_keys_rows_by_request():
    _, params = _params("tiny")
    tmod = interop.load_params(Decoder(DecoderConfig.tiny()), params)
    ids, mask = _batch(np.random.default_rng(4), 3, 10)
    cfg = sampling.SamplerConfig(temperature=0.9, top_k=40, top_p=0.95, seed=5)
    gen = build_greedy_generate(tmod, 6, sampler=cfg)
    a = gen(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    assert torch.equal(a, gen(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()))
    assert a.shape == (3, 6) and bool(((a >= 0) & (a < 512)).all())
    greedy = build_greedy_generate(tmod, 6)(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    hot = build_greedy_generate(tmod, 6, sampler=dataclasses.replace(cfg, temperature=50.0, top_k=0, top_p=1.0))
    assert not torch.equal(hot(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()), greedy)
