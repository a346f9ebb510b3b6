"""The port's generator-SFT slice against the JAX package's, on the CPU, where
``kernels.flash_attention`` takes its plain version and the JAX decoder its
einsum path.

Tolerances: the loss, ``merge_lora`` and the packing are the same arithmetic
on the same numbers: 1e-6 (f32 sums in another order) or EQUAL (token
blocks). Decoder logits at real positions 1e-4 (two layers of f32 matmuls and
a softmax summed in another order; the flash path masks by slot and segment,
the einsum path by rope position, which agree wherever the query is a real
token). ``train_generator``: both trainers start from the same saved tiny
model and LoRA factors and see the same blocks in f32 with the noise off;
every step's train loss and the validation loss over 3 AdamW steps at lr 1e-2
agree within 5e-6 (observed 1.2e-6; f32 spacing at 6.2 is 4.8e-7) and the
trained factors within 3e-4 (observed 7.5e-5: Adam's normalised update
amplifies rounding in near-zero gradient entries) of a movement of 2e-2; a
control run with lr 0 misses the loss limit a thousandfold.
"""

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.core.mesh import unbox
from dalm_tpu.data import sft as jsft
from dalm_tpu.data.tokenizer import resolve_tokenizer as jax_resolve_tokenizer
from dalm_tpu.losses.causal import causal_lm_loss as jax_causal_lm_loss
from dalm_tpu.models import decoder as jdec
from dalm_tpu.models import lora as jlora
from dalm_tpu.models import registry as jreg
from dalm_tpu_torch import interop
from dalm_tpu_torch.data import sft as tsft
from dalm_tpu_torch.data.tokenizer import resolve_tokenizer
from dalm_tpu_torch.kernels.flash_attention import flash_attention
from dalm_tpu_torch.losses.causal import causal_lm_loss
from dalm_tpu_torch.models import lora as tlora
from dalm_tpu_torch.models import registry as treg
from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
from dalm_tpu_torch.models.layers import FlexLinear
from dalm_tpu_torch.train import train_generator
from dalm_tpu_torch.train.generator_only import SFTSetup

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores


def _rows(n, seed=0, words=30):
    rng = np.random.default_rng(seed)
    vocab = ["alpha", "beta", "gamma", "delta", "retrieval", "generator", "topic", "answer", "question", "é"]
    rows = []
    for i in range(n):
        user = " ".join(rng.choice(vocab, size=int(rng.integers(3, words)))) + f" {i}?"
        reply = " ".join(rng.choice(vocab, size=int(rng.integers(3, words)))) + f" {i * 7}."
        rows.append({"messages": [{"role": "user", "content": user}, {"role": "assistant", "content": reply}]})
    return rows


@pytest.fixture(scope="module")
def jsonl_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("sft") / "chat.jsonl"
    with open(path, "w") as f:
        for row in _rows(64):
            f.write(json.dumps(row) + "\n")
    return str(path)


# --------------------------------------------------------------------------
# loss, LoRA merge, data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mask_kind", ["none", "right_padded", "all_masked", "bf16_logits"])
def test_causal_lm_loss_matches_jax(mask_kind):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 12, 40)).astype(np.float32) * 3
    ids = rng.integers(0, 40, size=(3, 12))
    mask = None
    if mask_kind in ("right_padded", "bf16_logits"):
        mask = (np.arange(12)[None, :] < np.array([[12], [7], [1]])).astype(np.int32)
    elif mask_kind == "all_masked":
        mask = np.zeros((3, 12), np.int32)
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    if mask_kind == "bf16_logits":
        jl, tl = jl.astype(jnp.bfloat16), tl.to(torch.bfloat16)
    want = float(jax_causal_lm_loss(jl, jnp.asarray(ids), None if mask is None else jnp.asarray(mask)))
    got = causal_lm_loss(tl, torch.from_numpy(ids), None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)
    if mask_kind == "all_masked":
        assert float(got) == 0.0


def _tiny_tree(kernel_dtype=np.float32):
    rng = np.random.default_rng(5)
    mk = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)  # noqa: E731
    return {
        "layer_0": {"attention": {"q_proj": {"kernel": mk(16, 16)}, "k_proj": {"kernel": mk(16, 8)},
                                  "v_proj": {"kernel": mk(16, 8)}, "o_proj": {"kernel": mk(16, 16)}},
                    "input_norm": {"scale": np.ones(16, np.float32)}},
        "lm_head": {"kernel": mk(16, 40)},
    }


@pytest.mark.parametrize("kernel_dtype", ["float32", "bfloat16"])
def test_merge_lora_matches_jax(kernel_dtype):
    tree = _tiny_tree()
    spec_j, spec_t = jlora.LoraSpec.for_sft(rank=4, alpha=8.0), tlora.LoraSpec.for_sft(rank=4, alpha=8.0)
    jtree = jax.tree.map(lambda x: jnp.asarray(x, getattr(jnp, kernel_dtype)), tree)
    lora_j = jlora.init_lora_params(jax.random.PRNGKey(0), jtree, spec_j)
    rng = np.random.default_rng(1)
    lora_np = {p: {"lora_a": np.asarray(ab["lora_a"]), "lora_b": rng.standard_normal(ab["lora_b"].shape).astype(np.float32)}
               for p, ab in lora_j.items()}
    merged_j = jlora.merge_lora(jtree, jax.tree.map(jnp.asarray, lora_np), spec_j, None)
    ttree = jax.tree.map(lambda x: interop._to_tensor(np.array(x)).to(getattr(torch, kernel_dtype)), tree)
    merged_t = tlora.merge_lora(ttree, {p: {k: torch.from_numpy(np.array(v)) for k, v in ab.items()} for p, ab in lora_np.items()},
                                spec_t)
    assert sorted(lora_np) == ["layer_0/attention/q_proj/kernel", "layer_0/attention/v_proj/kernel"]
    for path in ("q_proj", "k_proj", "v_proj"):
        want = np.asarray(merged_j["layer_0"]["attention"][path]["kernel"].astype(jnp.float32))
        got = merged_t["layer_0"]["attention"][path]["kernel"]
        assert got.dtype == getattr(torch, kernel_dtype)
        # f32: the A @ B product sums in another order; bf16: the delta is rounded to bf16 on both sides, then
        # added in bf16, and a product that lands on a rounding boundary may go either way by one bf16 ulp
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6 if kernel_dtype == "float32" else 2e-3)
    assert merged_t["layer_0"]["attention"]["k_proj"]["kernel"] is ttree["layer_0"]["attention"]["k_proj"]["kernel"]


def test_init_lora_params_and_the_module_runtime():
    tree = jax.tree.map(torch.from_numpy, _tiny_tree())
    spec = tlora.LoraSpec.for_sft(rank=4, alpha=8.0)
    a = tlora.init_lora_params(torch.Generator().manual_seed(0), tree, spec)
    b = tlora.init_lora_params(torch.Generator().manual_seed(0), tree, spec)
    assert sorted(a) == ["layer_0/attention/q_proj/kernel", "layer_0/attention/v_proj/kernel"]
    for path, ab in a.items():
        assert ab["lora_a"].dtype == ab["lora_b"].dtype == torch.float32
        assert tuple(ab["lora_a"].shape) == (16, 4) and not ab["lora_b"].any()
        assert torch.equal(ab["lora_a"], b[path]["lora_a"]) and 0.005 < float(ab["lora_a"].std()) < 0.04
    with pytest.raises(ValueError, match="no kernels matched"):
        tlora.init_lora_params(torch.Generator().manual_seed(0), {"dense": {"kernel": torch.zeros(4, 4)}}, spec)

    # FlexLinear's merge mode: forward equals x @ merge_lora(W), autograd reaches both factors and not the base
    rng = np.random.default_rng(2)
    layer = FlexLinear(16, 8)
    layer.reset_parameters(torch.Generator().manual_seed(1))
    layer.add_merge_lora(4, spec.scaling)
    A, B = rng.standard_normal((16, 4)).astype(np.float32), rng.standard_normal((4, 8)).astype(np.float32)
    with torch.no_grad():
        layer.lora_a.copy_(torch.from_numpy(A))
        layer.lora_b.copy_(torch.from_numpy(B))
    layer.kernel.requires_grad_(False)
    x = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    y = layer(x)
    merged = tlora.merge_lora({"m": {"kernel": layer.kernel.detach()}},
                              {"m/kernel": {"lora_a": torch.from_numpy(A), "lora_b": torch.from_numpy(B)}}, spec)
    np.testing.assert_allclose(y.detach().numpy(), (x @ merged["m"]["kernel"]).numpy(), atol=1e-6)
    y.pow(2).sum().backward()
    assert layer.kernel.grad is None and layer.lora_a.grad.abs().sum() > 0 and layer.lora_b.grad.abs().sum() > 0

    def loss_j(ab):
        w = jlora.merge_lora({"m": {"kernel": jnp.asarray(layer.kernel.detach().numpy())}}, {"m/kernel": ab},
                             jlora.LoraSpec.for_sft(rank=4, alpha=8.0), None)
        return jnp.sum((jnp.asarray(x.numpy()) @ w["m"]["kernel"]) ** 2)

    g = jax.grad(loss_j)({"lora_a": jnp.asarray(A), "lora_b": jnp.asarray(B)})
    np.testing.assert_allclose(layer.lora_a.grad.numpy(), np.asarray(g["lora_a"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(layer.lora_b.grad.numpy(), np.asarray(g["lora_b"]), rtol=1e-4, atol=1e-4)
    packed = FlexLinear(16, 8)
    packed.to_packed("bf16")
    with pytest.raises(ValueError, match="dense kernel"):
        packed.add_merge_lora(4, 2.0)


def test_interop_carries_the_merge_lora_tree():
    model = Decoder(DecoderConfig.tiny())
    model.reset_parameters(torch.Generator().manual_seed(0))
    spec = tlora.LoraSpec.for_sft(rank=4, alpha=8.0)
    rng = np.random.default_rng(0)
    flat = {f"layer_{i}/attention/{m}/kernel": {"lora_a": rng.standard_normal((64, 4)).astype(np.float32),
                                                "lora_b": rng.standard_normal((4, 64)).astype(np.float32)}
            for i in range(2) for m in ("q_proj", "v_proj")}
    interop.load_merge_lora(model, flat, spec)
    held = model.layer_0.attention.q_proj.lora_a
    interop.load_merge_lora(model, flat, spec)  # again: the parameters stay, the values are overwritten
    assert model.layer_0.attention.q_proj.lora_a is held and model.layer_1.attention.v_proj.merge_scaling == 2.0
    back = interop.merge_lora_tree(model)
    assert sorted(back) == sorted(flat)
    for path in flat:
        for leaf in ("lora_a", "lora_b"):
            np.testing.assert_array_equal(back[path][leaf], flat[path][leaf])
    with pytest.raises(KeyError, match="FlexLinear kernel"):
        interop.load_merge_lora(model, {"final_norm/scale": flat["layer_0/attention/q_proj/kernel"]}, spec)


def test_format_chat_and_sample_text_match_jax():
    rows = _rows(3) + [{"messages": None}, {"text": "no messages"}]
    for row in rows:
        assert tsft.prepare_sample_text(row) == jsft.prepare_sample_text(row)
    msgs = rows[0]["messages"]
    assert tsft.format_chat(msgs) == jsft.format_chat(msgs)
    assert tsft.format_chat(msgs).startswith("<|im_start|>user\n") and tsft.prepare_sample_text(rows[3]) == ""


@pytest.mark.parametrize("seq_length,limit", [(64, None), (256, 3), (100, None)])
def test_pack_and_pad_datasets_equal_jax(seq_length, limit):
    rows = _rows(12, seed=4) + [{"messages": None}]
    jt, tt = jax_resolve_tokenizer("byte"), resolve_tokenizer("byte")
    jb = jsft.pack_dataset(rows, jt, seq_length, max_blocks=limit)
    tb = tsft.pack_dataset(rows, tt, seq_length, max_blocks=limit)
    assert tb.dtype == np.int32 and tb.shape[1] == seq_length and len(tb) > 0
    np.testing.assert_array_equal(tb, jb)
    ji, jm = jsft.pad_dataset(rows, jt, seq_length, max_samples=limit)
    ti, tm = tsft.pad_dataset(rows, tt, seq_length, max_samples=limit)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)
    assert tsft.chars_token_ratio(rows, tt) == jsft.chars_token_ratio(rows, jt)
    assert tsft.pack_dataset([], tt, seq_length).shape == (0, seq_length)
    assert tsft.pad_dataset([], tt, seq_length)[0].shape == (0, seq_length)


def test_create_datasets_reads_local_files_and_splits_by_seed(jsonl_path, tmp_path):
    train, valid = tsft.create_datasets(jsonl_path, validation_split=0.25, seed=7)
    again = tsft.create_datasets(jsonl_path, validation_split=0.25, seed=7)
    other = tsft.create_datasets(jsonl_path, validation_split=0.25, seed=8)
    assert (len(train), len(valid)) == (48, 16) and (train, valid) == again and valid != other[1]
    assert sorted(json.dumps(r) for r in train + valid) == sorted(json.dumps(r) for r in _rows(64))
    as_json = tmp_path / "chat.json"
    as_json.write_text(json.dumps(_rows(64)))
    assert tsft.create_datasets(str(as_json), validation_split=0.25, seed=7) == (train, valid)
    assert len(tsft.create_datasets(jsonl_path, validation_split=5, seed=7)[1]) == 5
    for kw, err in ((dict(streaming=True, size_valid_set=4, shuffle_buffer=8), "streaming"),
                    (dict(local_dataset=False), "local_dataset")):
        with pytest.raises(NotImplementedError, match=err):
            tsft.create_datasets(jsonl_path, **kw)
    with pytest.raises(NotImplementedError, match="load_from_disk"):
        tsft.create_datasets(str(tmp_path))
    with pytest.raises(ValueError, match="validation_split"):
        tsft.create_datasets(jsonl_path, validation_split=None)


# --------------------------------------------------------------------------
# decoder: flash path against the JAX decoder
# --------------------------------------------------------------------------

def _pair(num_kv_heads=None, seed=11):
    """The same decoder in both packages, the port's with attention_impl="flash"."""
    jcfg = dataclasses.replace(jdec.DecoderConfig.tiny(), num_heads=4, num_kv_heads=num_kv_heads)
    tcfg = dataclasses.replace(DecoderConfig.tiny(), num_heads=4, num_kv_heads=num_kv_heads, attention_impl="flash")
    jmodel = jdec.Decoder(jcfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.tree.map(np.asarray, unbox(jmodel.init(jax.random.PRNGKey(seed), ids, jnp.ones_like(ids))["params"]))
    tmodel = interop.load_params(Decoder(tcfg), params)
    return jmodel, params, tmodel


def _masks(kind, B, S, rng):
    if kind == "packed":
        return np.ones((B, S), np.int32)
    n = rng.integers(S // 4, S - 4, size=(B, 1))
    pos = np.arange(S)[None, :]
    return (pos < n).astype(np.int32) if kind == "right_padded" else (pos >= S - n).astype(np.int32)


@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("kind", ["right_padded", "packed", "left_padded"])
def test_decoder_flash_path_equals_jax_at_real_positions(kind, kv_heads):
    jmodel, params, tmodel = _pair(kv_heads)
    rng = np.random.default_rng(1)
    B, S = 3, 256
    ids = rng.integers(0, 259, size=(B, S))
    mask = _masks(kind, B, S, rng)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    assert tmodel.uses_flash(S) and not tmodel.uses_flash(S, cached=True) and not tmodel.uses_flash(200)
    got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], want[real], atol=1e-4)
    # the training forward (checkpointed, with gradients) is the same function
    tmodel.cfg = dataclasses.replace(tmodel.cfg, remat=True)
    train = tmodel.train_forward(torch.from_numpy(ids), torch.from_numpy(mask))
    assert train.requires_grad
    np.testing.assert_allclose(train.detach().numpy()[real], got[real], atol=1e-6)
    # a sequence the rule rejects takes the matmul path, as in the reference
    short = tmodel(torch.from_numpy(ids[:, :200]), torch.from_numpy(np.ones((B, 200), np.int64))).numpy()
    want_short = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids[:, :200]), jnp.ones((B, 200), jnp.int32)))
    np.testing.assert_allclose(short, want_short, atol=1e-4)


def test_decoder_flash_gradients_equal_the_matmul_path():
    """Right-padded rows: the loss looks at real tokens only, so the gradients of
    the flash path (plain version on the CPU) equal the matmul path's."""
    _, params, flash = _pair(2)
    plain = interop.load_params(Decoder(dataclasses.replace(flash.cfg, attention_impl="einsum")), params)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, 259, size=(2, 256)))
    mask = torch.from_numpy(_masks("right_padded", 2, 256, rng))
    grads = []
    for model in (flash, plain):
        causal_lm_loss(model.train_forward(ids, mask), ids, mask).backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k in grads[0]:
        np.testing.assert_allclose(grads[0][k].numpy(), grads[1][k].numpy(), atol=2e-5, err_msg=k)


def test_unported_attention_knobs_still_raise():
    with pytest.raises(NotImplementedError, match="attention_impl"):
        Decoder(dataclasses.replace(DecoderConfig.tiny(), attention_impl="ring"))
    from dalm_tpu_torch.models.decoder import check_unported

    # the sliding window is ported (each layer's window goes to K4); the ring layout still raises
    assert Decoder(dataclasses.replace(DecoderConfig.tiny(), attention_impl="flash", sliding_window=64)).uses_flash(256)
    with pytest.raises(NotImplementedError, match="ring_layout"):
        check_unported({"ring_layout": "zigzag"})
    q = torch.zeros(1, 8, 2, 16)
    assert flash_attention(q, q, q).shape == q.shape  # the kernel module itself takes window / softcap


def test_neftune_same_noise_same_logits_and_own_noise_is_bounded():
    jmodel, params, tmodel = _pair()
    rng = np.random.default_rng(5)
    B, S, alpha = 2, 256, 5.0
    ids = rng.integers(0, 259, size=(B, S))
    mask = np.ones((B, S), np.int32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                                   neftune_alpha=alpha, noise_rng=key))
    noise = np.array(jax.random.uniform(key, (B, S, 64), jnp.float32, minval=-1.0, maxval=1.0))
    t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    got = tmodel.train_forward(t_ids, t_mask, neftune_alpha=alpha, noise=torch.from_numpy(np.array(noise))).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    clean = tmodel.train_forward(t_ids, t_mask).detach().numpy()
    assert np.abs(got - clean).max() > 1e-4  # the noise is load-bearing
    # alpha = 0 or no source of noise: the clean forward
    np.testing.assert_array_equal(tmodel.train_forward(t_ids, t_mask, neftune_alpha=0.0,
                                                       noise=torch.from_numpy(noise)).detach().numpy(), clean)
    np.testing.assert_array_equal(tmodel.train_forward(t_ids, t_mask, neftune_alpha=alpha).detach().numpy(), clean)

    # the port's own draw: uniform in [-1, 1) * alpha / sqrt(S * hidden), repeatable from the generator's seed
    seen = []
    hook = tmodel.layer_0.register_forward_pre_hook(lambda mod, args: seen.append(args[0].detach().clone()))
    for seed in (3, 3, 4):
        tmodel.train_forward(t_ids, t_mask, neftune_alpha=alpha, noise_generator=torch.Generator().manual_seed(seed))
    tmodel.train_forward(t_ids, t_mask)
    hook.remove()
    deltas = [h - seen[3] for h in seen[:3]]
    bound = alpha / np.sqrt(S * 64)
    assert torch.equal(deltas[0], deltas[1]) and not torch.equal(deltas[0], deltas[2])
    assert float(deltas[0].abs().max()) <= bound * (1 + 1e-5) and float(deltas[0].abs().max()) > 0.9 * bound
    assert abs(float(deltas[0].mean())) < bound * 0.02


# --------------------------------------------------------------------------
# train_generator
# --------------------------------------------------------------------------

def _save_tiny_decoder(root):
    jcfg = jdec.DecoderConfig.tiny()
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.tree.map(np.asarray, unbox(jdec.Decoder(jcfg).init(jax.random.PRNGKey(11), ids, jnp.ones_like(ids))["params"]))
    jdir, tdir = os.path.join(root, "jax_generator"), os.path.join(root, "torch_generator")
    jreg.save_pretrained(jdir, jcfg, params)
    tmod = Decoder(DecoderConfig.tiny())
    treg.save_pretrained(tdir, tmod.cfg, interop.state_dict_for(tmod, params))
    return jdir, tdir, params


def _step_losses(out_dir):
    with open(os.path.join(out_dir, "generator_finetuning_metrics.jsonl")) as f:
        return [x["train/loss"] for x in map(json.loads, f) if "train/loss" in x]


@pytest.mark.parametrize("packing", [True, False], ids=["packed", "padded"])
def test_train_generator_follows_the_jax_trainer(tmp_path, jsonl_path, monkeypatch, packing):
    from dalm_tpu.train import generator_only as jgen

    jdir, tdir, params = _save_tiny_decoder(str(tmp_path))
    seed = 5
    split = tsft.create_datasets(jsonl_path, validation_split=0.3, seed=seed)
    # The JAX trainer reads `datasets` directories and splits differently: hand it the port's split.
    monkeypatch.setattr(jgen, "create_datasets", lambda *a, **k: split)
    common = dict(seq_length=256, num_train_epochs=1, eval_steps=0, logging_steps=1, validation_split=0.3,
                  lora_r=8, lora_alpha=16, learning_rate=1e-2, num_warmup_steps=0, neftune_noise_alpha=0,
                  max_train_blocks=24, packing=packing, seed=seed, gradient_checkpointing=True)
    # The JAX run spreads its batch over the 8 virtual CPU devices: 1 row each is the port's batch of 8.
    jout = str(tmp_path / "jax_out")
    j = jgen.train_generator(jdir, "unused", output_dir=jout, per_device_train_batch_size=1,
                             per_device_eval_batch_size=1, **common)
    j_steps = _step_losses(jout)
    j_factors, _ = jlora.load_adapter(os.path.join(jout, "final_checkpoint"))

    spec = jlora.LoraSpec(rank=8, alpha=16, dropout=0.05, target_modules=jlora.CAUSAL_LM_TARGETS)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    factors = jax.tree.map(np.asarray, jlora.init_lora_params(jax.random.fold_in(init_rng, 3), params, spec))
    seen = {}

    def hook(setup):
        assert isinstance(setup, SFTSetup) and setup.lora_spec.scaling == 2.0
        assert setup.model.cfg.attention_impl == "flash" and setup.model.cfg.remat
        interop.load_merge_lora(setup.model, factors, setup.lora_spec)
        seen["trainable"] = sorted(setup.state.params)
        seen["blocks"] = setup.train_blocks.shape
        seen["masked"] = int((setup.train_masks == 0).sum())
        seen["base"] = {k: v.clone() for k, v in setup.model.state_dict().items()}
        seen["model"] = setup.model

    out_dir = str(tmp_path / "out")
    t = train_generator(tdir, jsonl_path, output_dir=out_dir, per_device_train_batch_size=8,
                        per_device_eval_batch_size=8, device="cpu", setup_hook=hook, **common)
    assert t["steps"] == j["steps"] == 3 and seen["blocks"] == (24, 256)
    assert (seen["masked"] == 0) == packing
    assert set(j) <= set(t) and t["chars_per_token"] == j["chars_per_token"] and t["samples_per_sec"] > 0
    # Both sides compute in f32 on the same blocks from the same factors. Observed: every step's loss and
    # the validation loss within 1.2e-6 of JAX's (f32 spacing at 6.2 is 4.8e-7), the trained factors within
    # 7.5e-5 (Adam's g / sqrt(v) amplifies rounding where g is near 0) of factors that moved by 2e-2.
    loss_tol, factor_tol = 5e-6, 3e-4
    t_steps = _step_losses(out_dir)
    assert len(t_steps) == len(j_steps) == 3
    assert np.abs(np.array(t_steps) - np.array(j_steps)).max() <= loss_tol, (t_steps, j_steps)
    assert abs(t["final_loss"] - j["final_loss"]) <= loss_tol, (t["final_loss"], j["final_loss"])
    assert abs(t["eval_loss"] - j["eval_loss"]) <= loss_tol, (t["eval_loss"], j["eval_loss"])
    t_factors = interop.merge_lora_tree(seen["model"])
    assert sorted(t_factors) == sorted(j_factors)
    for path, ab in t_factors.items():
        for leaf in ("lora_a", "lora_b"):
            np.testing.assert_allclose(ab[leaf], np.asarray(j_factors[path][leaf]), atol=factor_tol, err_msg=f"{path}/{leaf}")
            assert np.abs(np.asarray(j_factors[path][leaf]) - factors[path][leaf]).max() > 20 * factor_tol  # it trained
    assert seen["trainable"] == sorted(f"layer_{i}.attention.{m}.{leaf}" for i in range(2) for m in ("q_proj", "v_proj")
                                       for leaf in ("lora_a", "lora_b"))
    # the base is frozen, every factor moved
    after = seen["model"].state_dict()
    for k, v in seen["base"].items():
        assert torch.equal(after[k], v) == (k.rpartition(".")[2] not in ("lora_a", "lora_b")), k
    # saves: per epoch into output_dir and the final checkpoint, base untouched + adapter; JSON-lines metrics
    for d in (out_dir, os.path.join(out_dir, "final_checkpoint")):
        cfg, state = treg.load_pretrained(d)
        assert cfg.attention_impl == "flash" and not any("lora" in k for k in state)
        assert all(torch.equal(state[k], seen["base"][k]) for k in state)
        flat, saved_spec = tlora.load_adapter(d)
        assert saved_spec.rank == 8 and len(flat) == 4 and all(ab["lora_b"].any() for ab in flat.values())
    lines = [json.loads(x) for x in open(os.path.join(out_dir, "generator_finetuning_metrics.jsonl"))]
    assert lines[0]["event"] == "config" and [x["step"] for x in lines[1:]] == [1, 2, 3]
    assert abs(lines[-1]["train/loss"] - t["final_loss"]) < 1e-9
    # Control: a trainer whose updates do nothing (lr = 0) is far outside those limits from step 2 on,
    # so the limits do tell a sound trainer from a broken one.
    still = train_generator(tdir, jsonl_path, output_dir=str(tmp_path / "still"), per_device_train_batch_size=8,
                            per_device_eval_batch_size=8, device="cpu", setup_hook=hook,
                            **dict(common, learning_rate=0.0))
    s_steps = _step_losses(str(tmp_path / "still"))
    assert abs(s_steps[0] - j_steps[0]) <= loss_tol  # the first loss is taken before any update
    assert min(abs(s_steps[1] - j_steps[1]), abs(s_steps[2] - j_steps[2]),
               abs(still["eval_loss"] - j["eval_loss"])) > 1000 * loss_tol, (s_steps, j_steps)


def test_train_generator_full_parameter_training(tmp_path, jsonl_path):
    """A preset with use_peft=False, NEFTune noise, gradient accumulation and
    validation every 2 steps: every parameter trains and the loss falls."""
    out = train_generator("tiny", jsonl_path, output_dir=str(tmp_path / "full"), device="cpu", use_peft=False,
                          seq_length=128, per_device_train_batch_size=4, num_train_epochs=2, max_train_blocks=8,
                          validation_split=0.3, learning_rate=3e-3, num_warmup_steps=0, logging_steps=1,
                          eval_steps=2, neftune_noise_alpha=5, gradient_checkpointing=False, seed=1,
                          gradient_accumulation_steps=2, per_device_eval_batch_size=2)
    assert out["steps"] == 4 and np.isfinite(out["final_loss"]) and np.isfinite(out["eval_loss"])
    lines = [json.loads(x) for x in open(tmp_path / "full" / "generator_finetuning_metrics.jsonl")]
    train = [x["train/loss"] for x in lines if "train/loss" in x]
    assert len(train) == 4 and train[-1] < train[0] and sum("eval/loss" in x for x in lines) == 2
    assert abs(train[0] - np.log(384)) < 0.5  # a random model: near ln of the padded vocab
    assert not os.path.exists(tmp_path / "full" / "final_checkpoint" / "adapter_config.json")
    cfg, state = treg.load_pretrained(str(tmp_path / "full" / "final_checkpoint"))
    assert cfg.vocab_size == 384 and cfg.attention_impl == "flash" and not cfg.remat


def test_train_generator_noise_is_keyed_per_step(tmp_path, jsonl_path):
    kw = dict(device="cpu", output_dir=None, seq_length=128, per_device_train_batch_size=4, max_train_blocks=8,
              validation_split=0.3, lora_r=4, lora_alpha=8, num_warmup_steps=0, logging_steps=1, eval_steps=0)
    a = train_generator("tiny", jsonl_path, seed=2, **kw)
    b = train_generator("tiny", jsonl_path, seed=2, **kw)
    quiet = train_generator("tiny", jsonl_path, seed=2, neftune_noise_alpha=0, **kw)
    assert a["final_loss"] == b["final_loss"] and a["final_loss"] != quiet["final_loss"]
    assert a["eval_loss"] == b["eval_loss"]


SFT_UNPORTED = [
    ("context_parallel", dict(context_parallel=True)), ("cp_layout", dict(cp_layout="zigzag")),
    ("pipeline_stages", dict(pipeline_stages=2, use_peft=False)), ("pp_microbatches", dict(pp_microbatches=2)),
    ("pp_model_parallel", dict(pp_model_parallel=2)), ("moe_aux_weight", dict(moe_aux_weight=0.01)),
    ("mesh", dict(mesh=object())), ("streaming", dict(streaming=True)),
    ("local_dataset", dict(local_dataset=False)),
]


# knobs ported since, each with the model it needs: the case asserts the knob is taken and changes the loss
# (tests/test_torch_moe.py holds moe_aux_weight to the JAX trainer)
SFT_PORTED = {"moe_aux_weight": "tiny-moe"}


@pytest.mark.parametrize("knob,kw", SFT_UNPORTED, ids=[k for k, _ in SFT_UNPORTED])
def test_sft_unported_knobs_raise_naming_the_knob(jsonl_path, knob, kw):
    if knob in SFT_PORTED:
        small = dict(device="cpu", output_dir=None, seq_length=128, per_device_train_batch_size=4,
                     max_train_blocks=4, validation_split=0.3, lora_r=4, lora_alpha=8, num_warmup_steps=0)
        on = train_generator(SFT_PORTED[knob], jsonl_path, **small, **{knob: 1.0})
        off = train_generator(SFT_PORTED[knob], jsonl_path, **small)
        assert np.isfinite(on["final_loss"]) and on["final_loss"] != off["final_loss"]
        return
    with pytest.raises(NotImplementedError, match=knob):
        train_generator("tiny", jsonl_path, device="cpu", output_dir=None, **kw)


def test_sft_bad_arguments_warning_and_no_card(tmp_path, jsonl_path, caplog):
    # a checkpoint whose embedding table is smaller than the tokenizer's vocabulary
    small = Decoder(DecoderConfig.tiny(vocab_size=128))
    small.reset_parameters(torch.Generator().manual_seed(0))
    treg.save_pretrained(str(tmp_path / "small"), small.cfg, small.state_dict())
    with pytest.raises(ValueError, match="vocab_size 128 < tokenizer vocab 259"):
        train_generator(str(tmp_path / "small"), jsonl_path, device="cpu", output_dir=None)
    with pytest.raises(ValueError, match="zero 4096-token blocks"):
        train_generator("tiny", jsonl_path, device="cpu", output_dir=None, seq_length=4096, max_train_blocks=1,
                        validation_split=0.9)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_generator("tiny", jsonl_path, output_dir=None)  # the default device is the card
    # a long sequence that is not a multiple of 128 keeps the matmul path and says so
    seen = {}
    with caplog.at_level(logging.WARNING, logger="dalm_tpu_torch.train.generator_only"):
        out = train_generator("tiny", jsonl_path, device="cpu", output_dir=None, seq_length=1100, max_train_blocks=1,
                              validation_split=0.3, lora_r=4, lora_alpha=8, eval_steps=0, packing=False,
                              group_by_length=True, setup_hook=lambda s: seen.update(cfg=s.model.cfg))
    assert seen["cfg"].attention_impl == "einsum" and out["steps"] == 1 and np.isfinite(out["final_loss"])
    text = " ".join(r.getMessage() for r in caplog.records)
    assert "not a multiple of 128" in text and "group_by_length" in text
