"""The port's quantisation, LoRA and fused-QLoRA modules against the JAX
package's, on the CPU, from the same numpy weights.

Tolerances: quantised trees are integer-exact and their scales one f32
division: EQUAL. Forwards of tiny 2-layer models in f32: 1e-4 on logits,
1e-5 on unit-norm embeddings (sums in another order); with the int8 compute
path 2e-3 of the largest logit (a rounding that flips moves one product by a
quantisation step).
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
from dalm_tpu.models import lora as jlora
from dalm_tpu.models import qlora as jqlora
from dalm_tpu.models import quant as jquant
from dalm_tpu.models.rag import RagE2EModel as JaxRag
from dalm_tpu_torch import interop
from dalm_tpu_torch.core.tree import flatten, unflatten
from dalm_tpu_torch.kernels import int8_matmul as T
from dalm_tpu_torch.models import lora, qlora, quant
from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
from dalm_tpu_torch.models.encoder import Encoder, EncoderConfig
from dalm_tpu_torch.models.rag import Mode, RagE2EModel

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores


def _np_tree(params):
    return jax.tree.map(np.asarray, unbox(params))


def _torch_tree(tree):
    return unflatten({k: torch.from_numpy(np.array(v)) for k, v in flatten(tree).items()})


def _assert_trees_equal(t_tree, j_tree):
    t_flat, j_flat = flatten(t_tree), flatten(jax.tree.map(np.asarray, j_tree))
    assert sorted(t_flat) == sorted(j_flat)
    for k, v in t_flat.items():
        np.testing.assert_array_equal(v.float().numpy(), np.asarray(j_flat[k], np.float32), err_msg=k)


def _decoder_params(seed=0):
    cfg = jdec.DecoderConfig.tiny()
    ids = jnp.zeros((1, 8), jnp.int32)
    return cfg, _np_tree(jdec.Decoder(cfg).init(jax.random.PRNGKey(seed), ids, jnp.ones_like(ids))["params"])


def _encoder_params(seed=0):
    cfg = jenc.EncoderConfig.tiny()
    ids = jnp.zeros((1, 8), jnp.int32)
    return cfg, _np_tree(jenc.Encoder(cfg).init(jax.random.PRNGKey(seed), ids, jnp.ones_like(ids))["params"])


def _batch(rng, b, s, vocab=259):
    ids = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    lens = rng.integers(s // 2, s + 1, size=b)
    lens[0] = s
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return np.where(mask > 0, ids, 256).astype(np.int32), mask


def test_quantize_tensor_and_params_equal_jax():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((96, 48)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # a zero column takes scale 1
    tq, jq = quant.quantize_tensor(torch.from_numpy(w)), jquant.quantize_tensor(jnp.asarray(w))
    np.testing.assert_array_equal(tq["__int8__"].numpy(), np.asarray(jq["__int8__"]))
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    np.testing.assert_array_equal(quant.dequantize_tensor(tq).numpy(), np.asarray(jquant.dequantize_tensor(jq)))

    _, params = _decoder_params()
    t_quantized = quant.quantize_params(_torch_tree(params))
    _assert_trees_equal(t_quantized, jquant.quantize_params(params))
    assert "__int8__" in t_quantized["layer_0"]["attention"]["q_proj"]["kernel"]
    assert isinstance(t_quantized["layer_0"]["input_norm"]["scale"], torch.Tensor)  # norms stay
    _assert_trees_equal(quant.dequantize_params(t_quantized), jquant.dequantize_params(jquant.quantize_params(params)))
    err = quant.quantization_error(t_quantized, _torch_tree(params))
    assert 0.0 < err <= 0.5 / 127 + 1e-6  # half a quantisation step of the column's absmax


def test_lora_spec_presets_and_target_paths_equal_jax():
    for name in ("for_encoder", "for_causal_lm", "for_sft"):
        assert dataclasses.asdict(getattr(lora.LoraSpec, name)()) == dataclasses.asdict(getattr(jlora.LoraSpec, name)())
    assert lora.LoraSpec.for_sft().scaling == 2.0
    _, dparams = _decoder_params()
    _, eparams = _encoder_params()
    for params, t_spec, j_spec in ((dparams, lora.LoraSpec.for_causal_lm(), jlora.LoraSpec.for_causal_lm()),
                                   (eparams, lora.LoraSpec.for_encoder(), jlora.LoraSpec.for_encoder())):
        assert lora._target_kernel_paths(_torch_tree(params), t_spec) == jlora._target_kernel_paths(params, j_spec)


def test_adapter_files_round_trip(tmp_path):
    spec = lora.LoraSpec.for_causal_lm(rank=4, alpha=8.0)
    flat = {"layer_0/attention/q_proj/kernel": {"lora_a": torch.randn(8, 4), "lora_b": torch.randn(4, 8)}}
    lora.save_adapter(str(tmp_path), flat, spec)
    got, got_spec = lora.load_adapter(str(tmp_path))
    assert got_spec == spec
    assert torch.equal(got["layer_0/attention/q_proj/kernel"]["lora_a"], flat["layer_0/attention/q_proj/kernel"]["lora_a"])
    import json

    with open(tmp_path / "adapter_config.json") as f:  # the reference's schema
        assert json.load(f) == {"r": 4, "lora_alpha": 8.0, "lora_dropout": 0.05, "target_modules": ["q_proj", "v_proj"]}


@pytest.mark.parametrize("quantize", [True, False])
def test_pack_qlora_frozen_trees_equal_jax(quantize):
    _, params = _decoder_params()
    t_res, t_quant = qlora.pack_qlora_frozen(_torch_tree(params), quantize=quantize)
    j_res, j_quant = jqlora.pack_qlora_frozen(params, quantize=quantize)
    _assert_trees_equal(t_res, j_res)
    _assert_trees_equal(t_quant, j_quant)
    leaf = t_quant["layer_0"]["attention"]["q_proj"]
    assert sorted(leaf) == (["q", "scale"] if quantize else ["w"])
    assert "embed_tokens" in t_res and "attention" not in t_res["layer_0"]  # bias-free projections leave nothing
    # back to a full tree
    _assert_trees_equal(qlora.unpack_to_params(t_res, t_quant, torch.float32),
                        jax.tree.map(lambda a: np.asarray(a, np.float32), jqlora.unpack_to_params(j_res, j_quant, np.float32)))
    with pytest.raises(ValueError, match="int3"):  # the 4-bit storages: tests/test_torch_quant_serve.py
        qlora.pack_qlora_frozen(_torch_tree(params), quantize="int3")


def test_factor_trees_round_trip_and_equal_jax():
    _, params = _decoder_params()
    spec, jspec = lora.LoraSpec.for_causal_lm(), jlora.LoraSpec.for_causal_lm()
    j_lora = jax.tree.map(np.asarray, jqlora.init_qlora_factors(jax.random.PRNGKey(1), params, jspec))
    t_lora = qlora.init_qlora_factors(torch.Generator().manual_seed(1), _torch_tree(params), spec)
    assert sorted(flatten(t_lora)) == sorted(flatten(j_lora))
    for k, v in flatten(t_lora).items():
        assert tuple(v.shape) == flatten(j_lora)[k].shape and v.dtype == torch.float32
    a = t_lora["layer_0"]["attention"]["q_proj"]["a"]
    assert not t_lora["layer_0"]["attention"]["q_proj"]["b"].any()
    assert abs(float(a.std()) - 0.02 * spec.scaling) < 0.01  # N(0, 0.02) * alpha/r
    # flat adapter format: the JAX tree through both packages' converters
    t_flat = qlora.factors_to_flat(_torch_tree(j_lora), spec)
    j_flat = jqlora.factors_to_flat(j_lora, jspec)
    assert sorted(t_flat) == sorted(j_flat)
    for k in t_flat:
        np.testing.assert_array_equal(t_flat[k]["lora_a"].numpy(), np.asarray(j_flat[k]["lora_a"]))
    _assert_trees_equal(qlora.flat_to_factors(t_flat, spec), j_lora)


INT8_TOL = {"none": 1e-4, "fwd": 2e-3, "all": 2e-3}


@pytest.mark.parametrize("int8_compute", ["none", "fwd", "all"])
@pytest.mark.parametrize("quantize", [True, False])
def test_packed_decoder_forward_and_grads_match_jax(quantize, int8_compute):
    """JAX ``pack_qlora_frozen`` + factors -> ``interop.load_packed`` -> the
    same logits, and the same gradients for the factors. The tiny widths
    (64, 128) are shapes the fused form rejects, so both sides run the row
    quantiser + int8 dot."""
    assert not any(T.w8a8_fused_feasible(30, k, n) for k, n in ((64, 64), (64, 128), (128, 64), (64, 512)))
    jcfg, params = _decoder_params()
    jcfg = dataclasses.replace(jcfg, int8_compute=int8_compute)
    residual, quant_tree = jqlora.pack_qlora_frozen(params, quantize=quantize)
    rng = np.random.default_rng(2)
    lora_tree = jax.tree.map(np.asarray, jqlora.init_qlora_factors(jax.random.PRNGKey(2), params, jlora.LoraSpec.for_causal_lm()))
    lora_tree = jax.tree.map(lambda a: a + rng.standard_normal(a.shape).astype(np.float32) * 0.02, lora_tree)  # b != 0
    ids, mask = _batch(rng, 3, 10)
    g = rng.standard_normal((3, 10, jcfg.vocab_size)).astype(np.float32)
    jmod = jdec.Decoder(jcfg)

    def f(lt):
        return jnp.sum(jmod.apply({"params": residual, "quant": quant_tree, "lora": lt}, ids, mask) * g)

    j_logits = jmod.apply({"params": residual, "quant": quant_tree, "lora": lora_tree}, ids, mask)
    j_grads = jax.grad(f)(lora_tree)

    tmod = Decoder(dataclasses.replace(DecoderConfig.tiny(), int8_compute=int8_compute))
    interop.load_packed(tmod, jax.tree.map(np.asarray, residual), jax.tree.map(np.asarray, quant_tree), lora_tree)
    assert tmod.layer_0.attention.q_proj.kernel is None
    t_logits = tmod.train_forward(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    (t_logits * torch.from_numpy(g)).sum().backward()
    tol = INT8_TOL[int8_compute if quantize else "none"] * np.abs(np.asarray(j_logits)).max()
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(j_logits), rtol=0, atol=max(tol, 1e-4))
    # inference forward (no gradient) agrees with the training forward
    assert torch.equal(tmod(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()), t_logits.detach())
    j_flat = flatten(jax.tree.map(np.asarray, j_grads))
    scale = max(np.abs(v).max() for v in j_flat.values())
    gtol = (2e-2 if (quantize and int8_compute != "none") else 1e-4) * scale
    for k, p in tmod.named_parameters():
        if k.rpartition(".")[2] in ("a", "b"):
            np.testing.assert_allclose(p.grad.numpy(), j_flat[k], rtol=0, atol=gtol, err_msg=k)
    # the factors read back as the tree that went in
    _assert_trees_equal(_torch_tree(interop.factors_tree(tmod)), lora_tree)


def test_packed_encoder_embeddings_match_jax():
    jcfg, params = _encoder_params()
    residual, quant_tree = jqlora.pack_qlora_frozen(params, quantize=True)
    lora_tree = jax.tree.map(np.asarray, jqlora.init_qlora_factors(jax.random.PRNGKey(3), params, jlora.LoraSpec.for_encoder()))
    rng = np.random.default_rng(3)
    ids, mask = _batch(rng, 4, 12)
    jrag = JaxRag(jcfg, jdec.DecoderConfig.tiny())
    j_emb = jrag.embed_with({"params": residual, "quant": quant_tree, "lora": lora_tree}, ids, mask)
    trag = RagE2EModel(EncoderConfig.tiny(), DecoderConfig.tiny())
    interop.load_packed(trag.retriever, jax.tree.map(np.asarray, residual), jax.tree.map(np.asarray, quant_tree), lora_tree)
    t_emb = trag.embed_with(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    assert t_emb.requires_grad
    np.testing.assert_allclose(t_emb.detach().numpy(), np.asarray(j_emb), rtol=0, atol=1e-5)
    assert trag.forward("retrieval", torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).shape == (4, 64)
    with pytest.raises(ValueError, match="unknown task"):
        trag.forward("rank", None, None)
    # an autoregressive retriever is a decoder (EOS-pooled; tests/test_torch_ar_retriever.py holds it to JAX)
    assert isinstance(RagE2EModel(DecoderConfig.tiny(), DecoderConfig.tiny(), retriever_is_autoregressive=True).retriever,
                      Decoder)
    assert Mode("both") is Mode.BOTH


def test_interop_rejects_unported_leaves_and_mismatched_factors():
    _, params = _decoder_params()
    residual, quant_tree = jqlora.pack_qlora_frozen(params, quantize=True)
    quant_tree = jax.tree.map(np.asarray, quant_tree)
    # calibrated scales beside an int8 base load as buffers; a leaf the layer does not know is refused
    quant_tree["layer_0"]["attention"]["q_proj"]["a_scale"] = np.float32(0.1)
    quant_tree["layer_0"]["attention"]["q_proj"]["dy_scale"] = np.float32(0.25)
    dec = interop.load_packed(Decoder(DecoderConfig.tiny()), jax.tree.map(np.asarray, residual), quant_tree)
    site = dec.layer_0.attention.q_proj
    assert float(site.a_scale) == np.float32(0.1) and float(site.dy_scale) == 0.25 and site.a_scale.dim() == 0
    assert dec.layer_0.attention.k_proj.a_scale is None
    quant_tree["layer_0"]["attention"]["q_proj"]["x_scale"] = np.float32(0.5)
    with pytest.raises(RuntimeError, match="x_scale"):
        interop.load_packed(Decoder(DecoderConfig.tiny()), jax.tree.map(np.asarray, residual), quant_tree)
    tmod = Decoder(DecoderConfig.tiny())
    tmod.reset_parameters(torch.Generator().manual_seed(0))
    qlora.pack_module(tmod)
    qlora.init_module_factors(tmod, lora.LoraSpec.for_causal_lm(), torch.Generator().manual_seed(0))
    with pytest.raises(KeyError, match="missing"):
        interop.load_factors(tmod, {"layer_0": {"attention": {"q_proj": {"a": np.zeros((64, 8), np.float32)}}}})


@pytest.mark.parametrize("quantize", [True, False, "int4", "nf4", "int4pc"])
def test_init_packed_on_device_has_the_reference_structure(quantize):
    """Same leaves, shapes and storage types as the JAX package's on-device
    packed init (values differ: other generators); nothing is left on meta."""
    jcfg = jdec.DecoderConfig.tiny()
    ids = jnp.zeros((1, 8), jnp.int32)
    j_res, j_quant, j_lora = jqlora.init_packed_on_device(
        jdec.Decoder(jcfg), jax.random.PRNGKey(0), (ids, jnp.ones_like(ids)), spec=jlora.LoraSpec.for_causal_lm(), quantize=quantize)
    tmod = Decoder(DecoderConfig.tiny(), device="meta")
    qlora.init_packed_on_device(tmod, torch.Generator().manual_seed(0), spec=lora.LoraSpec.for_causal_lm(), quantize=quantize)
    state = tmod.state_dict()
    want = {**flatten(jax.tree.map(np.asarray, j_res)), **flatten(jax.tree.map(np.asarray, j_quant)),
            **flatten(jax.tree.map(np.asarray, j_lora))}
    assert sorted(state) == sorted(want)
    for k, v in state.items():
        assert not v.is_meta and tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[-1] == want[k].dtype.name, k
    t_res, t_quant, t_lora = qlora.split_state(tmod)
    assert sorted(flatten(t_lora)) == sorted(flatten(jax.tree.map(np.asarray, j_lora)))
    assert float(state["layer_0.input_norm.scale"].float().mean()) == 1.0
    assert not state["layer_1.attention.v_proj.b"].any() and state["layer_1.attention.v_proj.a"].any()
    if quantize is True:
        deq = state["layer_0.gate_proj.q"].float() * state["layer_0.gate_proj.scale"]
        assert abs(float(deq.std()) - 0.02) < 0.005
    elif quantize:
        node = {k.rpartition(".")[2]: v for k, v in state.items() if k.startswith("layer_0.gate_proj.")}
        assert abs(float(quant.dequantize_tensor_int4(node).std()) - 0.02) < 0.005
    logits = tmod.train_forward(torch.zeros((2, 6), dtype=torch.long), torch.ones((2, 6), dtype=torch.long))
    assert logits.shape == (2, 6, 512) and bool(torch.isfinite(logits).all())


def test_pack_module_equals_tree_packing_and_remat_changes_nothing():
    tmod = Decoder(dataclasses.replace(DecoderConfig.tiny(), remat=True))
    tmod.reset_parameters(torch.Generator().manual_seed(4))
    full = unflatten({k: v.clone() for k, v in tmod.state_dict().items()})
    qlora.pack_module(tmod, quantize=True)
    assert qlora.init_module_factors(tmod, lora.LoraSpec.for_causal_lm(), torch.Generator().manual_seed(5)) == 4
    res, qt, lt = qlora.split_state(tmod)
    want_res, want_q = qlora.pack_qlora_frozen(full, quantize=True)
    for got, want in ((res, want_res), (qt, want_q)):
        assert sorted(flatten(got)) == sorted(flatten(want))
        for k, v in flatten(got).items():
            assert torch.equal(v, flatten(want)[k]), k
    with torch.no_grad():
        for m in tmod.modules():
            if getattr(m, "b", None) is not None:
                m.b.normal_(0, 0.02, generator=torch.Generator().manual_seed(6))
    ids = torch.randint(0, 259, (2, 9), generator=torch.Generator().manual_seed(7))
    mask = torch.ones_like(ids)
    grads = []
    for remat in (True, False):
        tmod.cfg = dataclasses.replace(tmod.cfg, remat=remat)
        tmod.zero_grad()
        tmod.train_forward(ids, mask).square().mean().backward()
        grads.append({k: p.grad.clone() for k, p in tmod.named_parameters() if p.grad is not None and k.endswith((".a", ".b"))})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) == 8
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k
