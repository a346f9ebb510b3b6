"""``train_e2e``'s runs against the JAX package's, on the CPU (split from ``tests/test_torch_train_e2e.py`` so that
``--dist loadfile`` gives them a worker of their own): the trajectory from the same saved tiny models and LoRA
factors, dense accumulation and resume, and the int8-generator run that launches nothing on the CPU.

Tolerances: both trainers start from the same saved tiny models and the same LoRA factors and
see the same batches in f32; the final total / retriever / generator losses
after 4 optimiser steps agree within 1e-3 with ``int8_compute="none"``
(sums in another order, four Adam steps) and within 5e-3 with ``"all"``
(an activation that rounds the other way moves a product by a quantisation
step, forward and backward).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dalm_tpu.models import lora as jlora
from dalm_tpu.models import qlora as jqlora
from dalm_tpu_torch import interop
from dalm_tpu_torch.kernels import int8_matmul as T
from dalm_tpu_torch.models import registry as treg
from dalm_tpu_torch.train.rag_e2e import E2ESetup, train_e2e
from test_torch_train_e2e import SMALL, _save_tiny_bases

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores


@pytest.fixture(scope="module")
def tiny_bases(tmp_path_factory):
    """The tiny encoder and decoder saved once in each package's format, for both trajectory cases."""
    return _save_tiny_bases(str(tmp_path_factory.mktemp("bases")))


@pytest.mark.parametrize("int8_compute", ["none", "all"])
def test_train_e2e_trajectory_matches_jax(tmp_path, toy_csv, tiny_bases, int8_compute):
    """The tiny models' widths are shapes the fused form rejects, so both
    trainers run the row quantiser + int8 dot (the JAX package's form off the TPU)."""
    from dalm_tpu.train.rag_e2e import train_e2e as jax_train_e2e

    bases = tiny_bases
    seed = 5
    common = dict(SMALL, max_train_steps=4, seed=seed, use_peft="both", use_bnb="both", lora_runtime="fused",
                  int8_compute=int8_compute, a8_calibrate_every=0)
    # The JAX run spreads its batch over the 8 virtual CPU devices: 1 row each
    # is the port's batch of 8; negatives over the whole batch on both sides.
    j = jax_train_e2e(toy_csv, bases["retriever"][0], bases["generator"][0], per_device_train_batch_size=1,
                      local_negatives=False, use_dropout=False, **common)

    # The factors the JAX trainer starts from (its key derivation).
    init_rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    factors = {
        "retriever": jqlora.init_qlora_factors(jax.random.fold_in(init_rng, 23), bases["retriever"][2], jlora.LoraSpec.for_encoder()),
        "generator": jqlora.init_qlora_factors(jax.random.fold_in(init_rng, 29), bases["generator"][2], jlora.LoraSpec.for_causal_lm()),
    }
    seen = {}

    def hook(setup):
        assert isinstance(setup, E2ESetup) and setup.quantized_subs == {"retriever", "generator"}
        for sub in ("retriever", "generator"):
            interop.load_factors(getattr(setup.rag, sub), jax.tree.map(np.asarray, factors[sub]))
        seen["trainable"] = sorted(setup.state.params)

    out_dir = str(tmp_path / "out")
    t = train_e2e(toy_csv, bases["retriever"][1], bases["generator"][1], per_device_train_batch_size=8,
                  device="cpu", setup_hook=hook, output_dir=out_dir, **common)
    assert t["steps"] == j["steps"] == 4
    tol = 1e-3 if int8_compute == "none" else 5e-3
    for key in ("final_loss", "final_retriever_loss", "final_generator_loss"):
        assert abs(t[key] - j[key]) <= tol, (key, t[key], j[key])
    assert sorted(t) == sorted(k for k in j if k in t) and set(t) == set(j)
    assert all(k.rpartition(".")[2] in ("a", "b") for k in seen["trainable"]) and len(seen["trainable"]) == 2 * (6 + 4)
    # split save: the full base as loaded, plus the adapter
    for sub, tdir in (("retriever", bases["retriever"][1]), ("generator", bases["generator"][1])):
        cfg, state = treg.load_pretrained(os.path.join(out_dir, sub))
        _, base = treg.load_pretrained(tdir)
        assert sorted(state) == sorted(base) and all(torch.equal(state[k], base[k]) for k in base)
        from dalm_tpu_torch.models import lora as tlora

        flat, spec = tlora.load_adapter(os.path.join(out_dir, sub))
        assert len(flat) == (6 if sub == "retriever" else 4) and all(ab["lora_b"].any() for ab in flat.values())
        with open(os.path.join(out_dir, sub, "config.json")) as f:
            assert json.load(f)["tokenizer"] == "byte"


def test_train_e2e_dense_accumulation_and_resume(tmp_path, toy_csv):
    """No PEFT: both sub-models train densely from presets. A run resumed from
    its epoch-0 checkpoint ends where the uninterrupted run ends."""
    kw = dict(SMALL, per_device_train_batch_size=4, gradient_accumulation_steps=2, device="cpu", seed=9,
              lr_scheduler_type="constant", checkpointing_steps="epoch")
    out = str(tmp_path / "out")
    first = train_e2e(toy_csv, "tiny", "tiny", num_train_epochs=1, output_dir=out, **kw)
    assert first["steps"] == 2 and np.isfinite(first["final_loss"])
    assert os.path.isdir(os.path.join(out, "epoch_0")) and not os.path.exists(os.path.join(out, "retriever", "adapter_config.json"))
    resumed = train_e2e(toy_csv, "tiny", "tiny", num_train_epochs=2, output_dir=out,
                        resume_from_checkpoint=os.path.join(out, "epoch_0"), **dict(kw, with_tracking=True))
    straight = train_e2e(toy_csv, "tiny", "tiny", num_train_epochs=2, output_dir=str(tmp_path / "straight"), **kw)
    assert resumed["steps"] == straight["steps"] == 4
    assert abs(resumed["final_loss"] - straight["final_loss"]) < 1e-5
    lines = (tmp_path / "out" / "rag_e2e_training_metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["event"] == "config" and "train/epoch_loss" in json.loads(lines[-1])
    # step checkpoints are pruned to the newest three
    train_e2e(toy_csv, "tiny", "tiny", num_train_epochs=3, output_dir=str(tmp_path / "steps"),
              **dict(kw, checkpointing_steps=1))
    assert sorted(d for d in os.listdir(tmp_path / "steps") if d.startswith("step_")) == ["step_4", "step_5", "step_6"]


def test_train_e2e_int8_generator_only_launches_nothing_on_cpu(tmp_path, toy_csv):
    """The main path's setting at the tiny size: int8 generator base, bf16-stored
    retriever base, presets initialised straight into packed storage."""
    counts = (T.rowquant.launches, T.w8a8_fused.launches, T.int8_gemm_kn.launches, T.int8_gemm_nt.launches)
    seen = {}

    def hook(setup):
        seen["q"] = setup.rag.generator.layer_0.gate_proj.q.dtype
        seen["w"] = setup.rag.retriever.layer_0.intermediate.w.dtype
        seen["subs"] = setup.quantized_subs

    out = train_e2e(toy_csv, "tiny", "tiny", per_device_train_batch_size=8, num_train_epochs=2, device="cpu",
                    use_peft="both", use_bnb="generator", lora_runtime="fused", int8_compute="all",
                    a8_calibrate_every=0, setup_hook=hook, output_dir=str(tmp_path / "o"), **SMALL)
    assert out["steps"] == 4 and np.isfinite(out["final_loss"]) and out["samples_per_sec"] > 0
    assert seen == {"q": torch.int8, "w": torch.bfloat16, "subs": {"generator"}}
    assert counts == (T.rowquant.launches, T.w8a8_fused.launches, T.int8_gemm_kn.launches, T.int8_gemm_nt.launches)
    cfg, state = treg.load_pretrained(str(tmp_path / "o" / "generator"))  # dequantised base, loadable as a model
    assert "layer_0.gate_proj.kernel" in state and cfg.int8_compute == "all"
