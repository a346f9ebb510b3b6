"""``train_e2e`` as a whole against the JAX package's, on the CPU (moved out of ``tests/test_torch_train.py`` so
that the two files run on separate workers): the knobs that raise and the calibration default here; the
trajectory against the JAX trainer, accumulation and resume, and the int8-generator run in
``tests/test_torch_train_e2e_runs.py`` (a file of their own, so that ``--dist loadfile`` gives them another worker).
``SMALL`` and ``_save_tiny_bases`` are shared with the other training test files.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.core.mesh import unbox
from dalm_tpu.models import decoder as jdec
from dalm_tpu.models import encoder as jenc
from dalm_tpu.models import registry as jreg
from dalm_tpu_torch import interop
from dalm_tpu_torch.models import registry as treg
from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
from dalm_tpu_torch.models.encoder import Encoder, EncoderConfig
from dalm_tpu_torch.train.rag_e2e import train_e2e

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores

# The arguments under which the reference calibrates its activation scales (dalm_tpu/train/rag_e2e.py:741-743).
CALIBRATED = dict(use_peft="both", use_bnb="both", lora_runtime="fused", int8_compute="all")

UNPORTED = [("mesh", dict(mesh=object())), ("model_parallel", dict(model_parallel=2))]


@pytest.mark.parametrize("knob,kw", UNPORTED, ids=[k for k, _ in UNPORTED])
def test_unported_knobs_raise_naming_the_knob(toy_csv, knob, kw):
    with pytest.raises(NotImplementedError, match=knob):
        train_e2e(toy_csv, "tiny", "tiny", device="cpu", **kw)


@pytest.mark.parametrize("use_bnb", ["both", "retriever", "generator"])
def test_a8_calibrate_every_defaults_to_the_references_and_raises_where_it_would_calibrate(toy_csv, use_bnb):
    """Left out, a8_calibrate_every is the reference's 16: with a quantised sub-model that has LoRA, the fused
    runtime and int8 compute, the reference calibrates, and so does the port now (it raised before the
    calibrated path was ported): after one step every int8 layer of the quantised sub-models holds an
    activation scale, max(amax / 127, 1e-8), and no dy scale; the others hold none."""
    import inspect

    from dalm_tpu.train.rag_e2e import train_e2e as jax_train_e2e

    assert inspect.signature(train_e2e).parameters["a8_calibrate_every"].default == 16
    assert inspect.signature(jax_train_e2e).parameters["a8_calibrate_every"].default == 16
    seen = {}
    out = train_e2e(toy_csv, "tiny", "tiny", device="cpu", max_train_steps=1, per_device_train_batch_size=8,
                    setup_hook=lambda s: seen.update(rag=s.rag), **{**SMALL, **CALIBRATED, "use_bnb": use_bnb})
    assert out["steps"] == 1 and np.isfinite(out["final_loss"])
    for sub in ("retriever", "generator"):
        layers = [m for m in getattr(seen["rag"], sub).modules() if getattr(m, "q", None) is not None]
        calibrated = use_bnb in ("both", sub)
        assert bool(layers) == calibrated
        for m in layers:
            assert m.a_scale is not None and m.a_scale.dim() == 0 and float(m.a_scale) >= 1e-8 and m.dy_scale is None


def test_a8_calibrate_every_left_out_is_inert_without_int8_compute(toy_csv):
    """With int8_compute="none" the reference does not calibrate: a call that leaves a8_calibrate_every out
    trains, and exactly as with an explicit 0."""
    kw = {**SMALL, **CALIBRATED, "int8_compute": "none", "per_device_train_batch_size": 8, "max_train_steps": 1,
          "seed": 3, "device": "cpu"}
    left_out = train_e2e(toy_csv, "tiny", "tiny", **kw)
    zero = train_e2e(toy_csv, "tiny", "tiny", a8_calibrate_every=0, **kw)
    assert left_out["steps"] == zero["steps"] == 1 and np.isfinite(left_out["final_loss"])
    assert left_out["final_loss"] == zero["final_loss"]


def test_bad_arguments_and_no_card(toy_csv):
    with pytest.raises(ValueError, match="marginalize_mode"):
        train_e2e(toy_csv, "tiny", "tiny", device="cpu", marginalize_mode="word")
    with pytest.raises(ValueError, match="int8_compute"):
        train_e2e(toy_csv, "tiny", "tiny", device="cpu", int8_compute="bwd")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_e2e(toy_csv, "tiny", "tiny")  # the default device is the card


SMALL = dict(query_max_len=24, passage_max_len=72, generator_max_len=160, learning_rate=1e-3,
             num_warmup_steps=0, with_tracking=False)


def _save_tiny_bases(root):
    """The same tiny encoder and decoder, saved once in each package's format."""
    ids = jnp.zeros((1, 8), jnp.int32)
    out = {}
    for sub, jmod_cls, jcfg, tmod in (
        ("retriever", jenc.Encoder, jenc.EncoderConfig.tiny(), Encoder(EncoderConfig.tiny())),
        ("generator", jdec.Decoder, jdec.DecoderConfig.tiny(), Decoder(DecoderConfig.tiny())),
    ):
        params = jax.tree.map(np.asarray, unbox(jmod_cls(jcfg).init(jax.random.PRNGKey(11), ids, jnp.ones_like(ids))["params"]))
        jdir, tdir = os.path.join(root, f"jax_{sub}"), os.path.join(root, f"torch_{sub}")
        jreg.save_pretrained(jdir, jcfg, params)
        treg.save_pretrained(tdir, tmod.cfg, interop.state_dict_for(tmod, params))
        out[sub] = (jdir, tdir, params)
    return out
