"""The reference's saved artifacts in the port: ``dalm_tpu.models.registry.save_pretrained`` writes ``config.json`` +
flax's ``params.msgpack``, and the port's ``resolve_decoder`` / ``resolve_encoder`` read them with its own
pure-Python reader (``dalm_tpu_torch/core/msgpack.py``).

Tolerances: decoded trees equal flax's ``msgpack_restore`` bit for bit (bfloat16 by its bits); logits of the port
on the read weights equal the JAX model's within 1e-4 in f32 (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dalm_tpu.core.mesh import unbox
from dalm_tpu.models import decoder as jdec
from dalm_tpu.models import encoder as jenc
from dalm_tpu.models import quant as jquant
from dalm_tpu.models import registry as jreg
from dalm_tpu_torch.core import msgpack
from dalm_tpu_torch.core.tree import flatten
from dalm_tpu_torch.models import registry
from dalm_tpu_torch.models.decoder import Decoder
from dalm_tpu_torch.models.encoder import Encoder

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores

TINY = dict(vocab_size=320, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=96,
            max_position_embeddings=256)
FAMILIES = {  # the per-layer tuple and QK-norm (gemma3), a bias (qwen2.5), a bf16 tree (gemma2)
    "qwen2.5": dict(num_kv_heads=2, attention_bias=True),
    "gemma2": dict(num_kv_heads=2, head_dim_override=32, tie_embeddings=True, hidden_act="gelu_tanh",
                   scale_embeddings=True, rmsnorm_unit_offset=True, query_pre_attn_scalar=24.0,
                   attn_logit_softcap=50.0, final_logit_softcap=30.0, sliding_window=5, sliding_layers="even",
                   post_norms=True),
    "gemma3": dict(num_layers=3, num_kv_heads=1, head_dim_override=32, tie_embeddings=True, hidden_act="gelu_tanh",
                   scale_embeddings=True, rmsnorm_unit_offset=True, query_pre_attn_scalar=24.0, post_norms=True,
                   sliding_window=5, sliding_layers=(True, True, False), qk_norm=True, rope_local_theta=10000.0),
}


def _saved(tmp_path, family, param_dtype=jnp.float32):
    cfg = jdec.DecoderConfig(**{**TINY, **FAMILIES[family]}, param_dtype=param_dtype)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = unbox(jdec.Decoder(cfg).init(jax.random.PRNGKey(3), ids, jnp.ones_like(ids))["params"])
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.2, x.dtype), params)
    jreg.save_pretrained(str(tmp_path), cfg, params, extra={"saved_by": "test"})
    return cfg, params


def _ids():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, TINY["vocab_size"], size=(2, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :3] = 0
    return ids, mask


@pytest.mark.parametrize("family", ["gemma3", "qwen2.5"])
def test_decoder_params_msgpack_loads_with_equal_logits(tmp_path, family):
    jcfg, params = _saved(tmp_path, family)
    cfg, state = registry.resolve_decoder(str(tmp_path))
    assert cfg == registry.config_from_json(jreg._config_to_json(jcfg))
    model = Decoder(cfg)
    model.load_state_dict(state)
    ids, mask = _ids()
    want = np.asarray(jdec.Decoder(jcfg).apply({"params": params}, ids, mask))
    got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_bfloat16_params_msgpack_loads_exactly(tmp_path):
    """bf16 leaves (numpy has no bfloat16) come back as torch.bfloat16 with the same bits, into a model that takes
    them; the same weights in f32 give the JAX model's logits (``test_decoder_params_msgpack_loads_with_equal_
    logits``)."""
    _, params = _saved(tmp_path, "gemma2", param_dtype=jnp.bfloat16)
    cfg, state = registry.resolve_decoder(str(tmp_path), dtype="bfloat16")
    assert cfg.param_dtype == torch.bfloat16
    leaves = flatten(jax.tree.map(np.asarray, params))
    assert sorted(state) == sorted(leaves)
    for k, v in leaves.items():
        assert state[k].dtype == torch.bfloat16 and np.array_equal(state[k].view(torch.int16).numpy(), v.view(np.int16))
    model = Decoder(cfg)
    model.load_state_dict(state)
    ids, mask = _ids()
    assert bool(torch.isfinite(model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).float()).all())


def test_encoder_params_msgpack_loads_with_equal_hidden_states(tmp_path):
    jcfg = jenc.EncoderConfig.tiny()
    ids, mask = _ids()
    params = unbox(jenc.Encoder(jcfg).init(jax.random.PRNGKey(0), ids, mask)["params"])
    jreg.save_pretrained(str(tmp_path), jcfg, params)
    cfg, state = registry.resolve_encoder(str(tmp_path))
    enc = Encoder(cfg)
    enc.load_state_dict(state)
    want = np.asarray(jenc.Encoder(jcfg).apply({"params": params}, ids, mask))
    got = enc(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_int8_nodes_resolve_to_their_dequantised_kernel(tmp_path):
    """A tree with the reference's int8 nodes (``{"__int8__": q, "scale": s}``, what its merge runtime saves with
    ``use_bnb``) resolves to ``kernel = q * s`` in f32, as the reference's ``dequantize_params`` forms it."""
    cfg, params = _saved(tmp_path, "qwen2.5")
    qparams = jquant.quantize_params(jax.tree.map(np.asarray, params))
    jreg.save_pretrained(str(tmp_path), cfg, qparams)
    _, state = registry.resolve_decoder(str(tmp_path))
    want = flatten(jax.tree.map(np.asarray, jquant.dequantize_params(qparams)))
    assert sorted(state) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(state[k].numpy(), v), k


def test_reader_equals_flax_restore_on_every_type(monkeypatch):
    """Every msgpack type flax's writer emits (small and large ints, floats, str / bin of each length class, lists,
    maps, bools, None, numpy scalars, complex) and chunked arrays (the chunk size set small) decode as flax's own
    ``msgpack_restore`` decodes them."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 40],
        "floats": [0.5, -1.25e-30, 3.0e300], "flags": [True, False, None],
        "text": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000], "blob": b"\x00\x01" * 40000,
        "scalars": {"f": np.float32(2.5), "i": np.int64(-7)}, "c": 1.5 - 2.0j,
        "arrays": {"f32": rng.standard_normal((3, 5)).astype(np.float32), "i8": np.arange(-8, 8, dtype=np.int8),
                   "big": rng.standard_normal(100).astype(np.float32), "b": np.array([True, False]),
                   "bf16": jnp.asarray(rng.standard_normal((4, 4)), jnp.bfloat16)},
        "wide": {str(i): i for i in range(20)},
    }
    data = serialization.msgpack_serialize(tree)
    want = serialization.msgpack_restore(data)
    got = msgpack.restore(data)

    def same(a, b):
        if isinstance(b, dict):
            assert isinstance(a, dict) and sorted(a) == sorted(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(b, np.ndarray) and b.dtype.name == "bfloat16":
            assert a.dtype == torch.bfloat16 and np.array_equal(a.view(torch.int16).numpy(), b.view(np.int16))
        elif isinstance(b, (np.ndarray, np.generic)):
            assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)
        elif isinstance(b, bytes):
            assert bytes(a) == b
        else:
            assert type(a) is type(b) and a == b

    same(got, want)
    with pytest.raises(ValueError, match="after the msgpack object"):
        msgpack.unpackb(data + b"\xc0")
