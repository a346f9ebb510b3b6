"""The port's training pieces and ``train_e2e`` as a whole against the JAX
package's, on the CPU.

Tolerances: learning rates 1e-7 relative (float32 against float64
arithmetic); optimiser updates over 5 steps 1e-6 absolute on parameters of
order 1; batches, tokens and checkpoints EQUAL. The whole slice: both
trainers start from the same saved tiny models and the same LoRA factors and
see the same batches in f32; the final total / retriever / generator losses
after 4 optimiser steps agree within 1e-3 with ``int8_compute="none"``
(sums in another order, four Adam steps) and within 5e-3 with ``"all"``
(an activation that rounds the other way moves a product by a quantisation
step, forward and backward).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalm_tpu.core.mesh import unbox
from dalm_tpu.data import preprocess as jpre
from dalm_tpu.models import decoder as jdec
from dalm_tpu.models import encoder as jenc
from dalm_tpu.models import lora as jlora
from dalm_tpu.models import qlora as jqlora
from dalm_tpu.models import registry as jreg
from dalm_tpu.train import data_iter as jiter
from dalm_tpu.train import optim as joptim
from dalm_tpu_torch import interop
from dalm_tpu_torch.data import preprocess as tpre
from dalm_tpu_torch.data.loading import ColumnDataset, load_dataset
from dalm_tpu_torch.data.tokenizer import resolve_tokenizer
from dalm_tpu_torch.kernels import int8_matmul as T
from dalm_tpu_torch.models import registry as treg
from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
from dalm_tpu_torch.models.encoder import Encoder, EncoderConfig
from dalm_tpu_torch.train import checkpoints as ckpt
from dalm_tpu_torch.train import data_iter as titer
from dalm_tpu_torch.train import optim as toptim
from dalm_tpu_torch.train.metrics import MetricsLogger, StepTimer, WindowedThroughput
from dalm_tpu_torch.train.rag_e2e import E2ESetup, train_e2e
from dalm_tpu_torch.train.state import TrainState

SCHEDULES = ["linear", "cosine", "cosine_with_restarts", "polynomial", "constant", "constant_with_warmup"]


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("name", SCHEDULES)
def test_lr_schedules_equal_optax(name, warmup):
    j = joptim.make_lr_schedule(name, 3e-4, warmup, 10)
    t = toptim.make_lr_schedule(name, 3e-4, warmup, 10)
    for count in range(14):
        np.testing.assert_allclose(t(count), float(j(count)), rtol=1e-6, atol=1e-12, err_msg=f"{name} at {count}")
    with pytest.raises(ValueError, match="unknown lr scheduler"):
        toptim.make_lr_schedule("exponential", 1e-3, 0, 10)


def _optimiser_pair(rng, **kw):
    shapes = {"a": (6, 4), "b": (4,), "c": (3, 5)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tx = joptim.make_optimizer(**kw)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    return tx, jparams, tx.init(jparams), tparams, toptim.make_optimizer(tparams.values(), **kw)


@pytest.mark.parametrize("name", SCHEDULES)
def test_adam_updates_equal_optax_over_five_steps(name):
    rng = np.random.default_rng(0)
    tx, jparams, jstate, tparams, topt = _optimiser_pair(
        rng, learning_rate=1e-2, lr_scheduler_type=name, num_warmup_steps=2, total_steps=5)
    for _ in range(5):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in tparams.items()}
        updates, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        assert topt.step() is True
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-6, err_msg=k)
    assert topt.count == 5 and all(p.grad is None for p in tparams.values())


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_accumulation_and_weight_decay_equal_optax(weight_decay):
    rng = np.random.default_rng(1)
    tx, jparams, jstate, tparams, topt = _optimiser_pair(
        rng, learning_rate=1e-2, lr_scheduler_type="linear", num_warmup_steps=0, total_steps=5,
        weight_decay=weight_decay, gradient_accumulation_steps=2)
    stepped = []
    for _ in range(10):  # 5 optimiser steps of 2 micro-steps
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in tparams.items()}
        updates, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        stepped.append(topt.step())
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-6, err_msg=k)
    assert stepped == [False, True] * 5 and topt.count == 5
    # the optimiser's state survives a save and a load
    state = TrainState.create(tparams, topt)
    saved = json.loads(json.dumps(state.state_dict(), default=lambda t: t.tolist()))
    assert saved["opt_state"]["count"] == 5 and saved["step"] == 0
    with pytest.raises(ValueError, match="exactly the state's parameters"):
        TrainState.create({"a": tparams["a"]}, topt)


def test_train_state_round_trip():
    torch.manual_seed(0)
    params = {"w": torch.nn.Parameter(torch.randn(3, 2))}
    opt = toptim.make_optimizer(params.values(), learning_rate=0.1, lr_scheduler_type="constant")
    state = TrainState.create(params, opt)
    params["w"].grad = torch.ones(3, 2)
    state.apply_gradients()
    snap = ckpt._to_cpu(state.state_dict())
    snap = {k: (v if not isinstance(v, dict) else dict(v)) for k, v in snap.items()}
    snap["params"] = {"w": snap["params"]["w"].clone()}
    snap["opt_state"] = {k: ([t.clone() for t in v] if isinstance(v, list) else v) for k, v in snap["opt_state"].items()}
    params["w"].grad = torch.full((3, 2), 2.0)
    state.apply_gradients()
    after_two = params["w"].detach().clone()
    state.load_state_dict(snap)
    assert state.step == 1 and opt.count == 1
    params["w"].grad = torch.full((3, 2), 2.0)
    state.apply_gradients()
    assert torch.equal(params["w"].detach(), after_two)
    with pytest.raises(KeyError, match="do not match"):
        state.load_state_dict({**snap, "params": {"v": snap["params"]["w"]}})


def test_epoch_batches_equal_jax():
    data = {"x": np.arange(23 * 3).reshape(23, 3).tolist(), "y": list(range(23))}
    for kw in ({}, {"drop_last": True}, {"skip_batches": 2}, {"shuffle": False}):
        j = list(jiter.epoch_batches(ColumnDataset(data), ("x", "y"), 5, rng=np.random.default_rng([7, 1]), **kw))
        t = list(titer.epoch_batches(ColumnDataset(data), ("x", "y"), 5, rng=np.random.default_rng([7, 1]), **kw))
        assert len(j) == len(t) > 0
        for jb, tb in zip(j, t):
            for c in ("x", "y"):
                np.testing.assert_array_equal(tb[c], jb[c])
    assert titer.num_batches_per_epoch(23, 5) == jiter.num_batches_per_epoch(23, 5) == 5
    assert titer.num_batches_per_epoch(23, 5, drop_last=True) == 4
    padded, real = titer.pad_to_batch({"x": np.arange(6).reshape(3, 2)}, 5)
    jpadded, jreal = jiter.pad_to_batch({"x": np.arange(6).reshape(3, 2)}, 5)
    assert real == jreal == 3
    np.testing.assert_array_equal(padded["x"], jpadded["x"])


def test_loading_csv_json_jsonl_and_preprocess_equal_jax(tmp_path, toy_csv):
    ds = load_dataset(toy_csv)
    assert ds.column_names == ["Question", "Abstract", "Answer"] and len(ds) == 16
    rows = [dict(zip(ds.column_names, vals)) for vals in zip(*(ds[c] for c in ds.column_names))]
    (tmp_path / "rows.json").write_text(json.dumps(rows))
    (tmp_path / "cols.json").write_text(json.dumps(ds.columns))
    (tmp_path / "rows.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    for name in ("rows.json", "cols.json", "rows.jsonl"):
        assert load_dataset(str(tmp_path / name)).columns == ds.columns
    assert load_dataset(ds) is ds and load_dataset(ds.columns).columns == ds.columns
    with pytest.raises(ValueError, match="differ in length"):
        ColumnDataset({"a": [1], "b": [1, 2]})

    from dalm_tpu.data.tokenizer import resolve_tokenizer as jresolve

    args = ("Question", "Abstract", "Answer", 24, 40, 96)
    j = jpre.preprocess_rag_e2e_dataset(ds.columns, jresolve("byte"), jresolve("byte"), *args)
    t = tpre.preprocess_rag_e2e_dataset(ds.columns, resolve_tokenizer("byte"), resolve_tokenizer("byte"), *args)
    assert sorted(t) == sorted(j)
    for k in t:
        np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]), err_msg=k)
    mapped = ds.map(lambda ex: tpre.preprocess_rag_e2e_dataset(ex, resolve_tokenizer("byte"), resolve_tokenizer("byte"), *args))
    assert len(mapped) == 16 and "Question" not in mapped.column_names


def test_checkpoint_tags_prune_latest_and_round_trip(tmp_path):
    root = str(tmp_path)
    tree = {"step": 3, "params": {"w": torch.arange(6.0).reshape(2, 3)}, "opt_state": {"mu": [torch.ones(2)], "acc": None}}
    for i, tag in enumerate(("step_2", "step_4", "step_10", "step_6", "epoch_0")):
        path = ckpt.save_state(root, tag, tree)
        os.utime(path, (1000 + i, 1000 + i))
    os.makedirs(os.path.join(root, "retriever"))
    assert ckpt.parse_checkpoint_tag(os.path.join(root, "step_10")) == ("step", 10)
    assert ckpt.parse_checkpoint_tag("x/epoch_2/") == ("epoch", 2)
    with pytest.raises(ValueError, match="not of form"):
        ckpt.parse_checkpoint_tag(os.path.join(root, "retriever"))
    assert ckpt.latest_checkpoint(root).endswith("epoch_0")
    assert ckpt.prune_checkpoints(root, keep_last=3) == 1
    assert sorted(os.listdir(root)) == ["epoch_0", "retriever", "step_10", "step_4", "step_6"]
    assert ckpt.latest_checkpoint(str(tmp_path / "nothing")) is None and ckpt.prune_checkpoints(str(tmp_path / "nothing")) == 0
    got = ckpt.load_state(os.path.join(root, "step_10"))
    assert got["step"] == 3 and torch.equal(got["params"]["w"], tree["params"]["w"]) and got["opt_state"]["acc"] is None


def test_metrics_logger_and_timers(tmp_path):
    log = MetricsLogger(str(tmp_path), project_name="p", config={"lr": 0.1, "mode": None, "obj": object})
    log.log({"train/loss": torch.tensor(1.5), "epoch": 2}, step=7)
    log.close()
    lines = [json.loads(x) for x in (tmp_path / "p_metrics.jsonl").read_text().splitlines()]
    assert lines[0]["event"] == "config" and lines[0]["lr"] == 0.1 and isinstance(lines[0]["obj"], str)
    assert lines[1]["event"] == "metrics" and lines[1]["step"] == 7 and lines[1]["train/loss"] == 1.5
    off = MetricsLogger(None)
    off.log({"x": 1}, step=0)
    off.close()
    w = WindowedThroughput()
    assert w.avg is None and w.samples_per_sec(8) == 0.0
    w.mark(0)
    w.mark(2)
    w.mark(2)  # no steps: no window
    w.mark(5)
    assert [s for s, _ in w.windows] == [2, 3] and w.avg == w.windows[1][1] / 3
    t = StepTimer()
    t.start()
    assert t.stop() >= 0 and t.samples_per_sec(4) > 0


UNPORTED = [
    ("lora_runtime", dict(use_peft="both", lora_runtime="merge")), ("live_index", dict(live_index=True)),
    ("live_negatives_k", dict(live_negatives_k=4)), ("marginalize_k", dict(marginalize_k=2)),
    ("a8_calibrate_every", dict(a8_calibrate_every=16)), ("a8_dy_calibrate", dict(a8_dy_calibrate=True)),
    ("export_peft", dict(export_peft=True)), ("mesh", dict(mesh=object())), ("model_parallel", dict(model_parallel=2)),
    ("retriever_is_autoregressive", dict(retriever_is_autoregressive=True)), ("profile_dir", dict(profile_dir="/tmp/p")),
    ("use_dropout", dict(use_dropout=True)),
]


@pytest.mark.parametrize("knob,kw", UNPORTED, ids=[k for k, _ in UNPORTED])
def test_unported_knobs_raise_naming_the_knob(toy_csv, knob, kw):
    with pytest.raises(NotImplementedError, match=knob):
        train_e2e(toy_csv, "tiny", "tiny", device="cpu", **kw)


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


@pytest.mark.parametrize("int8_compute", ["none", "all"])
def test_train_e2e_trajectory_matches_jax(tmp_path, toy_csv, int8_compute):
    """The tiny models' widths are shapes the fused form rejects, so both
    trainers run the row quantiser + int8 dot (the JAX package's form off the TPU)."""
    from dalm_tpu.train.rag_e2e import train_e2e as jax_train_e2e

    bases = _save_tiny_bases(str(tmp_path))
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
                    setup_hook=hook, output_dir=str(tmp_path / "o"), **SMALL)
    assert out["steps"] == 4 and np.isfinite(out["final_loss"]) and out["samples_per_sec"] > 0
    assert seen == {"q": torch.int8, "w": torch.bfloat16, "subs": {"generator"}}
    assert counts == (T.rowquant.launches, T.w8a8_fused.launches, T.int8_gemm_kn.launches, T.int8_gemm_nt.launches)
    cfg, state = treg.load_pretrained(str(tmp_path / "o" / "generator"))  # dequantised base, loadable as a model
    assert "layer_0.gate_proj.kernel" in state and cfg.int8_compute == "all"
