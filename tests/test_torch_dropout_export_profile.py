"""Dropout, PEFT export, the profiler and TensorBoard metrics of the port's
trainers, on the CPU.

Dropout draws from the port's generators, not JAX's keys, so the masks differ
between the packages: the tests hold the rate (the kept share within 0.01 of
``1 - rate`` over 200,000 draws, five standard deviations), the scaling (kept
values exactly ``x / (1 - rate)``), determinism per seed, and identity when
off. The PEFT files written by ``train_generator(export_peft=True)`` against
the JAX trainer's from the same factors: the same keys, tensors within 3e-4
(trained factors, as in ``test_torch_sft``), equal JSON.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dalm_tpu.models import lora as jlora
from dalm_tpu_torch import interop
from dalm_tpu_torch.core.profiling import Profiler, annotate
from dalm_tpu_torch.models import lora as tlora
from dalm_tpu_torch.models.encoder import Encoder, EncoderConfig, dropout
from dalm_tpu_torch.models.layers import FlexLinear
from dalm_tpu_torch.train import train_e2e, train_generator, train_retriever
from dalm_tpu_torch.train.metrics import MetricsLogger
from test_torch_sft import _save_tiny_decoder, jsonl_path  # noqa: F401  (a fixture)
from test_torch_train_e2e import SMALL

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_rate_scaling_determinism_and_identity(rate):
    x = torch.rand(200_000) + 0.5
    a = dropout(x, rate, torch.Generator().manual_seed(1))
    b = dropout(x, rate, torch.Generator().manual_seed(1))
    c = dropout(x, rate, torch.Generator().manual_seed(2))
    kept = a != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.01
    assert torch.equal(a[kept], x[kept] / (1 - rate))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert dropout(x, rate, None) is x and dropout(x, 0.0, torch.Generator()) is x


def test_encoder_dropout_sites_and_identity_when_off():
    """No generator: the deterministic encoder. A generator: hidden dropout after the embeddings' norm, the
    attention output and the MLP, attention dropout on the probabilities; each rate alone changes the output."""
    cfg = EncoderConfig.tiny()
    enc = Encoder(cfg)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    ids = torch.randint(3, 200, (4, 12), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    base = enc(ids, mask)
    assert torch.equal(base, enc(ids, mask, dropout_generator=None))
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    on = enc(ids, mask, dropout_generator=g())
    assert torch.equal(on, enc(ids, mask, dropout_generator=g())) and not torch.allclose(on, base)
    import dataclasses

    for kw in (dict(hidden_dropout=0.0), dict(attention_dropout=0.0)):
        other = Encoder(dataclasses.replace(cfg, **kw))
        other.load_state_dict(enc.state_dict())
        out = other(ids, mask, dropout_generator=g())
        assert not torch.allclose(out, base) and not torch.equal(out, on)
    silent = Encoder(dataclasses.replace(cfg, hidden_dropout=0.0, attention_dropout=0.0))
    silent.load_state_dict(enc.state_dict())
    assert torch.equal(silent(ids, mask, dropout_generator=g()), base)


def test_lora_dropout_on_a_keyed_per_site():
    """The merge runtime's dropout on A, as training runs it: ``set_merge_dropout`` puts one mask a site (keyed by
    the seed and ``crc32`` of the site's path) on each ``FlexLinear``, whose forward then merges
    ``where(keep, A / (1 - rate), 0) @ B``; dA is zero where A was dropped; seed None clears the masks."""
    spec = tlora.LoraSpec.for_encoder()
    a = torch.rand(64, 8) + 0.5
    b = torch.rand(8, 64)
    flat = {f"layer_{i}/attention/query/kernel": {"lora_a": a, "lora_b": b} for i in range(2)}
    k0 = tlora.dropout_keep("layer_0/attention/query/kernel", a.shape, spec.dropout, 7, a.device)
    k1 = tlora.dropout_keep("layer_1/attention/query/kernel", a.shape, spec.dropout, 7, a.device)
    k0_other = tlora.dropout_keep("layer_0/attention/query/kernel", a.shape, spec.dropout, 8, a.device)
    assert not torch.equal(k0, k1) and not torch.equal(k0, k0_other)  # sites and seeds differ
    assert 0.9 < float(k0.float().mean()) < 1.0 and not bool(k0.all())  # rate 0.05, something dropped
    enc = Encoder(EncoderConfig.tiny())
    enc.reset_parameters(torch.Generator().manual_seed(0))
    tlora.attach_merge_lora(enc, {p: {k: v.clone() for k, v in ab.items()} for p, ab in flat.items()}, spec)
    site = enc.layer_0.attention.query
    x = torch.rand(5, 64)
    plain = x @ tlora.merge_lora({"m": {"kernel": site.kernel.detach()}}, {"m/kernel": flat[
        "layer_0/attention/query/kernel"]}, spec)["m"]["kernel"]
    tlora.set_merge_dropout(enc, spec, 7)
    assert torch.equal(site.lora_a_keep, k0) and torch.equal(enc.layer_1.attention.query.lora_a_keep, k1)
    assert site.lora_dropout == spec.dropout
    want = x @ (site.kernel.detach() + (torch.where(k0, a / (1 - spec.dropout), torch.zeros_like(a)) @ b)
                * spec.scaling)
    got = site(x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert (got - plain).abs().max() > 1e-3  # the mask changed the output
    got.sum().backward()
    assert bool((site.lora_a.grad[~k0] == 0).all()) and bool((site.lora_a.grad[k0] != 0).all())
    tlora.set_merge_dropout(enc, spec, 7)
    assert torch.equal(site.lora_a_keep, k0)  # the same seed draws the same masks
    tlora.set_merge_dropout(enc, spec, None)
    assert all(m.lora_a_keep is None for m in enc.modules() if isinstance(m, FlexLinear))
    torch.testing.assert_close(site(x), plain, rtol=0, atol=1e-5)


def test_train_e2e_use_dropout(toy_csv):
    """Merge runtime: dropout trains, repeats per seed and differs from use_dropout=False; in the fused runtime
    it is inert, as in the reference (the fused branch never drops)."""
    kw = dict(SMALL, device="cpu", per_device_train_batch_size=8, max_train_steps=2, seed=4, use_peft="both")
    a = train_e2e(toy_csv, "tiny", "tiny", lora_runtime="merge", use_dropout=True, **kw)
    b = train_e2e(toy_csv, "tiny", "tiny", lora_runtime="merge", use_dropout=True, **kw)
    c = train_e2e(toy_csv, "tiny", "tiny", lora_runtime="merge", use_dropout=False, **kw)
    assert a["final_loss"] == b["final_loss"] != c["final_loss"] and np.isfinite(a["final_loss"])
    f_on = train_e2e(toy_csv, "tiny", "tiny", lora_runtime="fused", use_dropout=True, **kw)
    f_off = train_e2e(toy_csv, "tiny", "tiny", lora_runtime="fused", use_dropout=False, **kw)
    assert f_on["final_loss"] == f_off["final_loss"]


def test_train_generator_export_peft_matches_jax(tmp_path, jsonl_path, monkeypatch):  # noqa: F811
    from dalm_tpu.train import generator_only as jgen
    from dalm_tpu_torch.data import sft as tsft

    jdir, tdir, params = _save_tiny_decoder(str(tmp_path))
    seed = 5
    split = tsft.create_datasets(jsonl_path, validation_split=0.3, seed=seed)
    monkeypatch.setattr(jgen, "create_datasets", lambda *a, **k: split)
    common = dict(seq_length=256, num_train_epochs=1, eval_steps=0, logging_steps=1, validation_split=0.3,
                  lora_r=8, lora_alpha=16, learning_rate=1e-2, num_warmup_steps=0, neftune_noise_alpha=0,
                  max_train_blocks=16, seed=seed, export_peft=True)
    jout, tout = str(tmp_path / "jax_out"), str(tmp_path / "out")
    jgen.train_generator(jdir, "unused", output_dir=jout, per_device_train_batch_size=1,
                         per_device_eval_batch_size=1, **common)
    spec = jlora.LoraSpec(rank=8, alpha=16, dropout=0.05, target_modules=jlora.CAUSAL_LM_TARGETS)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    factors = jax.tree.map(np.asarray, jlora.init_lora_params(jax.random.fold_in(init_rng, 3), params, spec))
    train_generator(tdir, jsonl_path, output_dir=tout, per_device_train_batch_size=8, per_device_eval_batch_size=8,
                    device="cpu", setup_hook=lambda s: interop.load_merge_lora(s.model, factors, s.lora_spec), **common)
    for sub in ("", "final_checkpoint"):
        td, jd = os.path.join(tout, sub), os.path.join(jout, sub)
        tp = torch.load(os.path.join(td, "adapter_model.bin"), weights_only=True)
        jp = torch.load(os.path.join(jd, "adapter_model.bin"), weights_only=True)
        assert sorted(tp) == sorted(jp) and len(tp) == 8
        assert "base_model.model.model.layers.1.self_attn.v_proj.lora_B.weight" in tp
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), jp[k].numpy(), rtol=0, atol=3e-4, err_msg=k)
        with open(os.path.join(td, "adapter_config.json")) as f1, open(os.path.join(jd, "adapter_config.json")) as f2:
            tc, jc = json.load(f1), json.load(f2)
        assert tc.pop("base_model_name_or_path") == tdir and jc.pop("base_model_name_or_path") == jdir and tc == jc
        assert tlora.load_adapter(td)[1].rank == 8  # the port's own adapter files still load beside them


def test_profiler_window_and_trainers_trace(tmp_path, toy_csv):
    prof = Profiler(str(tmp_path / "p"), start_step=1, num_steps=2)
    prof.maybe_start(0)
    assert not prof.active
    prof.maybe_start(1)
    assert prof.active
    with annotate("work"):
        torch.ones(8).sum()
    prof.maybe_stop(2)
    assert prof.active
    prof.maybe_stop(3)
    assert not prof.active and prof.done and os.path.basename(prof.trace_path) == "trace_1-3.json"
    with open(prof.trace_path) as f:
        assert "work" in f.read()
    prof.maybe_start(5)
    assert not prof.active  # one window a run
    assert not Profiler(None).enabled
    out = train_e2e(toy_csv, "tiny", "tiny", device="cpu", per_device_train_batch_size=8, max_train_steps=2,
                    profile_dir=str(tmp_path / "e2e"), profile_start_step=1, profile_num_steps=1, **SMALL)
    assert out["steps"] == 2 and os.listdir(tmp_path / "e2e") == ["trace_1-2.json"]


def _ops_in(trace_path, name):
    with open(trace_path) as f:
        return sum(1 for e in json.load(f)["traceEvents"] if e.get("name") == name)


@pytest.mark.parametrize("trainer", ["generator", "retriever", "e2e"])
def test_trainer_profile_window_covers_its_steps(tmp_path, toy_csv, jsonl_path, trainer):  # noqa: F811
    """``profile_dir`` on each trainer, three steps: the trace of steps [1, 2) and the trace of [1, 3) are written
    under their windows' names, and the second holds exactly twice the first's matrix products (the steps are
    alike), so each window holds its steps and no other."""
    def run(num, out):
        kw = dict(device="cpu", profile_dir=str(out), profile_start_step=1, profile_num_steps=num)
        if trainer == "generator":
            r = train_generator("tiny", jsonl_path, output_dir=None, seq_length=128, per_device_train_batch_size=4,
                                max_train_blocks=12, validation_split=0.3, lora_r=4, lora_alpha=8,
                                num_warmup_steps=0, logging_steps=1, eval_steps=0, **kw)
        elif trainer == "retriever":
            r = train_retriever("tiny", toy_csv, per_device_train_batch_size=4, max_train_steps=3, query_max_len=24,
                                passage_max_len=48, with_tracking=False, use_dropout=False, **kw)
        else:
            r = train_e2e(toy_csv, "tiny", "tiny", per_device_train_batch_size=4, max_train_steps=3, **kw, **SMALL)
        assert r["steps"] == 3
        return os.listdir(out)

    assert run(1, tmp_path / "one") == ["trace_1-2.json"]
    assert run(2, tmp_path / "two") == ["trace_1-3.json"]
    one = _ops_in(tmp_path / "one" / "trace_1-2.json", "aten::mm")
    assert one > 0 and _ops_in(tmp_path / "two" / "trace_1-3.json", "aten::mm") == 2 * one


@pytest.mark.parametrize("report_to", ["all", "tensorboard", "wandb"])
def test_metrics_logger_tensorboard(tmp_path, report_to):
    log = MetricsLogger(str(tmp_path), project_name="proj", config={"a": 1}, report_to=report_to)
    log.log({"train/loss": torch.tensor(1.5)}, step=3)
    log.close()
    lines = (tmp_path / "proj_metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["train/loss"] == 1.5
    tb = tmp_path / "tb" / "proj"
    assert tb.is_dir() == (report_to != "wandb")
    if report_to != "wandb":
        assert any(n.startswith("events.out.tfevents") for n in os.listdir(tb))
