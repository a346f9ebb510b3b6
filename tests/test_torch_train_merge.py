"""The merge runtime (``lora_runtime="merge"``, the reference's default) against
the JAX package on the CPU: ``FlexLinear`` over a dense or an int8 base, the
trainer from the same saved tiny models and factors, its saved artifacts, and
the registry's round trip of an int8 base.

Tolerances: a layer's output and gradients within 1e-6 of the largest entry
(the same f32 products in another order); the trainers' final losses within
1e-4 after 3 steps (observed within 1e-6); the saved int8 base EQUAL to the
reference's ``quantize_params``; the trained factors within 3e-4 (Adam's
g / sqrt(v) amplifies rounding where g is near 0) of factors that moved.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.models import lora as jlora
from dalm_tpu.models import quant as jquant
from dalm_tpu.models import registry as jreg
from dalm_tpu_torch import interop
from dalm_tpu_torch.models import lora as tlora
from dalm_tpu_torch.models import registry as treg
from dalm_tpu_torch.models.encoder import Encoder, EncoderConfig
from dalm_tpu_torch.models.layers import FlexLinear
from dalm_tpu_torch.models.quant import quantize_tensor
from dalm_tpu_torch.train.rag_e2e import train_e2e
from test_torch_train_e2e import SMALL, _save_tiny_bases

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores


@pytest.mark.parametrize("base", ["dense", "int8"])
def test_flexlinear_merge_matches_jax(base):
    """``x @ (W + (A @ B) * scaling).to(dtype)``, W the kernel or ``q * scale`` in f32, with and without a
    dropout mask on A; output and the factors' gradients against the reference's dequantise + merge_lora."""
    rng = np.random.default_rng(0)
    K, N, r = 48, 40, 4
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    a = (rng.standard_normal((K, r)) * 0.02).astype(np.float32)
    b = (rng.standard_normal((r, N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((3, 5, K)).astype(np.float32)
    keep = rng.random((K, r)) < 0.95
    spec = jlora.LoraSpec(rank=r, alpha=8.0, dropout=0.05)
    qt = jquant.quantize_tensor(jnp.asarray(w))
    jbase = jquant.dequantize_tensor(qt) if base == "int8" else jnp.asarray(w)

    def jout(a_, b_, masked):
        a_eff = jnp.where(keep, a_ / (1.0 - spec.dropout), 0.0) if masked else a_
        kernel = jbase + ((a_eff @ b_) * spec.scaling).astype(jbase.dtype)
        return jnp.asarray(x) @ kernel

    m = FlexLinear(K, N)
    with torch.no_grad():
        m.kernel.copy_(torch.from_numpy(w))
    if base == "int8":
        m.to_packed("int8")
        tq = quantize_tensor(torch.from_numpy(w))
        with torch.no_grad():
            m.q.copy_(tq["__int8__"])
            m.scale.copy_(tq["scale"])
        assert np.array_equal(m.q.numpy(), np.asarray(qt["__int8__"]))
    m.add_merge_lora(r, spec.scaling)
    with torch.no_grad():
        m.lora_a.copy_(torch.from_numpy(a))
        m.lora_b.copy_(torch.from_numpy(b))
    for masked in (False, True):
        m.lora_a_keep, m.lora_dropout = (torch.from_numpy(keep), spec.dropout) if masked else (None, 0.0)
        m.lora_a.grad = m.lora_b.grad = None
        y = m(torch.from_numpy(x))
        g = rng.standard_normal(y.shape).astype(np.float32)
        y.backward(torch.from_numpy(g))
        jy, vjp = jax.vjp(lambda a_, b_: jout(a_, b_, masked), jnp.asarray(a), jnp.asarray(b))
        ja, jb = vjp(jnp.asarray(g))
        for got, want in ((y.detach(), jy), (m.lora_a.grad, ja), (m.lora_b.grad, jb)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("use_bnb", [None, "both"], ids=["dense", "int8"])
def test_train_e2e_merge_runtime_matches_jax(tmp_path, toy_csv, use_bnb):
    from dalm_tpu.train.rag_e2e import train_e2e as jax_train_e2e

    bases = _save_tiny_bases(str(tmp_path))
    seed = 5
    common = dict(SMALL, max_train_steps=3, seed=seed, use_peft="both", use_bnb=use_bnb, lora_runtime="merge",
                  export_peft=True)
    jout = str(tmp_path / "jax_out")
    j = jax_train_e2e(toy_csv, bases["retriever"][0], bases["generator"][0], per_device_train_batch_size=1,
                      local_negatives=False, use_dropout=False, output_dir=jout, **common)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    factors = {
        "retriever": jlora.init_lora_params(jax.random.fold_in(init_rng, 13), bases["retriever"][2], jlora.LoraSpec.for_encoder()),
        "generator": jlora.init_lora_params(jax.random.fold_in(init_rng, 17), bases["generator"][2], jlora.LoraSpec.for_causal_lm()),
    }
    seen = {}

    def hook(setup):
        assert setup.quantized_subs == ({"retriever", "generator"} if use_bnb else set())
        assert setup.rag.generator.layer_0.attention.q_proj.lora_a is not None  # the merge runtime's factors
        for sub in ("retriever", "generator"):
            interop.load_merge_lora(getattr(setup.rag, sub), jax.tree.map(np.asarray, factors[sub]), setup.lora_specs[sub])
        seen["trainable"] = sorted(setup.state.params)

    tout = str(tmp_path / "out")
    t = train_e2e(toy_csv, bases["retriever"][1], bases["generator"][1], per_device_train_batch_size=8,
                  device="cpu", setup_hook=hook, output_dir=tout, **common)
    assert t["steps"] == j["steps"] == 3
    for key in ("final_loss", "final_retriever_loss", "final_generator_loss"):
        assert abs(t[key] - j[key]) <= 1e-4, (key, t[key], j[key])
    assert all(k.rpartition(".")[2] in ("lora_a", "lora_b") for k in seen["trainable"])
    assert len(seen["trainable"]) == 2 * (6 + 4)
    for sub in ("retriever", "generator"):
        # the frozen base as it trained on it: int8 where quantised, exactly the reference's
        _, state = treg.load_pretrained(os.path.join(tout, sub))
        _, jparams = jreg.load_pretrained(os.path.join(jout, sub))
        jflat = {}

        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, dict) and "__int8__" in v:
                    jflat[".".join(path + (k,))[:-len(".kernel")] + ".q"] = np.asarray(v["__int8__"])
                    jflat[".".join(path + (k,))[:-len(".kernel")] + ".scale"] = np.asarray(v["scale"])
                elif isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    jflat[".".join(path + (k,))] = np.asarray(v)

        walk(jparams, ())
        assert sorted(state) == sorted(jflat), sub
        assert all(np.array_equal(state[k].float().numpy(), jflat[k].astype(np.float32)) for k in jflat), sub
        assert any(k.endswith(".q") for k in state) == bool(use_bnb)
        tflat, _ = tlora.load_adapter(os.path.join(tout, sub))
        jfl, _ = jlora.load_adapter(os.path.join(jout, sub))
        assert sorted(tflat) == sorted(jfl)
        for path, ab in tflat.items():
            for leaf in ("lora_a", "lora_b"):
                np.testing.assert_allclose(ab[leaf].numpy(), np.asarray(jfl[path][leaf]), rtol=0, atol=3e-4)
        # PEFT layout: the same keys and shapes, equal JSON but for the base model's path
        tp = torch.load(os.path.join(tout, sub, "adapter_model.bin"), weights_only=True)
        jp = torch.load(os.path.join(jout, sub, "adapter_model.bin"), weights_only=True)
        assert sorted(tp) == sorted(jp) and all(tp[k].shape == jp[k].shape for k in jp)
        with open(os.path.join(tout, sub, "adapter_config.json")) as f1, open(os.path.join(jout, sub, "adapter_config.json")) as f2:
            tc, jc = json.load(f1), json.load(f2)
        assert tc.pop("base_model_name_or_path") == bases[sub][1] and jc.pop("base_model_name_or_path") == bases[sub][0]
        assert tc == jc
    # the saved towers serve: the int8 base resolves to its dequantised kernels and each adapter merges into them
    from dalm_tpu_torch.serve import RagPipeline

    pipe = RagPipeline.from_pretrained(os.path.join(tout, "retriever"), os.path.join(tout, "generator"),
                                       ["Paris is the capital of France.", "Gold has the symbol Au."], device="cpu",
                                       retriever_peft_path=os.path.join(tout, "retriever"),
                                       generator_peft_path=os.path.join(tout, "generator"), max_new_tokens=3)
    assert len(pipe.answer(["Capital of France"], top_k=1)) == 1


def test_registry_round_trips_an_int8_base(tmp_path):
    """A base saved with q / scale leaves reads back as saved, and resolves to the dequantised kernel, so the
    saved directory loads into a model."""
    enc = Encoder(EncoderConfig.tiny())
    enc.reset_parameters(torch.Generator().manual_seed(0))
    dense = {k: v.clone() for k, v in enc.state_dict().items()}
    from dalm_tpu_torch.models import qlora

    qlora.pack_module(enc, quantize=True, min_size=1024)
    state = enc.state_dict()
    assert "layer_0.attention.query.q" in state and "layer_0.attention.query.kernel" not in state
    treg.save_pretrained(str(tmp_path / "m"), enc.cfg, state)
    cfg, back = treg.load_pretrained(str(tmp_path / "m"))
    assert sorted(back) == sorted(state) and all(torch.equal(back[k], state[k]) for k in state)
    cfg2, resolved = treg.resolve_encoder(str(tmp_path / "m"))
    assert cfg2 == cfg and sorted(resolved) == sorted(dense)
    kernel = resolved["layer_0.attention.query.kernel"]
    assert torch.equal(kernel, state["layer_0.attention.query.q"].float() * state["layer_0.attention.query.scale"])
    assert (kernel - dense["layer_0.attention.query.kernel"]).abs().max() <= dense["layer_0.attention.query.kernel"].abs().max() / 127
    Encoder(cfg2).load_state_dict(resolved)
