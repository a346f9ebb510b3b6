"""The port's reading-comprehension pipeline (``pipelines/reading_comprehension.py``) against the JAX package's.

Both run the same seeded domain documents and vocabulary files, with the same scripted ``generate_fn`` and the same
``random.seed`` before the rows are shuffled, in REGEX, LLM and BOTH modes. Exact: the rows written (the JAX side's
``save_to_disk`` directory, the port's ``.jsonl``), each chunk's JSON outputs, the resumable state after an
interrupted run and the rows after resuming, and the keyword arguments each pipeline passes to its
``train_generator`` (captured; they differ only in the dataset's path and the port's ``device``). The last test
runs the port's pipeline whole on ``tiny`` on the CPU, SFT included, to a finite loss.
"""

import json
import os
import pickle
import random

import datasets
import numpy as np
import pytest
import torch

from dalm_tpu.pipelines import reading_comprehension as jrc
from dalm_tpu_torch.data.loading import load_dataset
from dalm_tpu_torch.pipelines import reading_comprehension as trc
from test_torch_datagen import DOMAIN_PIECES, GENERAL_PIECES, scripted_generate_fn, write_docs, write_spm

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("rc")
    write_docs(root / "docs", np.random.default_rng(21), 4, 10, csv_name="docs.csv")
    return root, write_spm(root / "general.model", GENERAL_PIECES), write_spm(root / "domain.model", DOMAIN_PIECES)


def _run(pkg, out, corpus, mode, generate_fn, domain=True, source="dir", capture=None, seed=0, **kw):
    """One pipeline run of ``pkg`` (``jrc`` or ``trc``) into ``out``; ``train_generator`` is replaced by a capture."""
    root, general, domain_path = corpus
    out.mkdir(parents=True, exist_ok=True)
    path, column, title = {"dir": (root / "docs", None, None), "csv": (root / "docs.csv", "Abstract", "Title")}[source]
    kw.setdefault("generation_state_file", str(out / "state.pkl"))
    if pkg is trc:
        kw.setdefault("device", "cpu")
    random.seed(seed)
    return pkg.pipeline(
        "tiny", str(out / "rc_dataset"), str(path), str(out / "model"),
        llm_kwargs=pkg.LLMKwargs("tiny", 900, str(out / "llm"), True, str(out / "raw")),
        synth_kwargs=pkg.SynthKwargs(general, domain_path if domain else None),
        csv_column=column, title_column=title, comprehension_type=pkg.SynthMode[mode],
        generate_fn=generate_fn, **kw)


def _rows(out, pkg):
    if pkg is jrc:
        return [dict(r) for r in datasets.load_from_disk(str(out / "rc_dataset"))]
    ds = load_dataset(str(out / "rc_dataset.jsonl"))
    return [{k: ds[k][i] for k in ds.column_names} for i in range(len(ds))]


def _dir_files(path):
    if not os.path.isdir(path):
        return {}
    return {name: json.load(open(os.path.join(path, name))) for name in sorted(os.listdir(path))}


@pytest.fixture
def captured(monkeypatch):
    seen = {}
    for pkg in (jrc, trc):
        def fake(pkg=pkg, **kw):
            seen[pkg.__name__] = kw
            return {"final_loss": 0.0}
        monkeypatch.setattr(pkg, "train_generator", fake)
    return seen


@pytest.mark.parametrize("mode,domain,source", [("REGEX", True, "dir"), ("REGEX", False, "csv"), ("LLM", True, "dir"),
                                                ("BOTH", True, "csv")])
def test_pipeline_rows_equal_jax(tmp_path, corpus, captured, mode, domain, source):
    jfn, tfn = scripted_generate_fn(), scripted_generate_fn()
    _run(jrc, tmp_path / "jax", corpus, mode, jfn, domain=domain, source=source)
    _run(trc, tmp_path / "port", corpus, mode, tfn, domain=domain, source=source)
    j, t = _rows(tmp_path / "jax", jrc), _rows(tmp_path / "port", trc)
    assert t == j and len(t) >= 4 and all(r["messages"][0]["role"] == "user" for r in t)
    assert tfn.calls == jfn.calls and (len(tfn.calls) > 4) == (mode != "REGEX")
    for sub in ("llm", "raw"):
        assert _dir_files(tmp_path / "port" / sub) == _dir_files(tmp_path / "jax" / sub)
    if mode != "REGEX":
        raw = _dir_files(tmp_path / "port" / "raw")
        assert len(raw) == len(tfn.calls) and 0 < len(_dir_files(tmp_path / "port" / "llm")) < len(raw)
    assert not (tmp_path / "port" / "state.pkl").exists() and not (tmp_path / "jax" / "state.pkl").exists()
    j_kw, t_kw = captured[jrc.__name__], captured[trc.__name__]
    assert t_kw.pop("dataset_name") == str(tmp_path / "port" / "rc_dataset.jsonl")
    assert j_kw.pop("dataset_name") == str(tmp_path / "jax" / "rc_dataset")
    assert t_kw.pop("device") == torch.device("cpu")
    assert t_kw.pop("output_dir") == str(tmp_path / "port" / "model")
    assert j_kw.pop("output_dir") == str(tmp_path / "jax" / "model")
    assert t_kw == j_kw and t_kw["seq_length"] == 2600 and t_kw["local_dataset"] is True


def test_pipeline_resumes_as_jax_after_an_interruption(tmp_path, corpus, captured):
    for pkg, side in ((jrc, "jax"), (trc, "port")):
        with pytest.raises(RuntimeError, match="interrupted at call 6"):
            _run(pkg, tmp_path / side, corpus, "BOTH", scripted_generate_fn(fail_at=6))
    states = {side: pickle.load(open(tmp_path / side / "state.pkl", "rb")) for side in ("jax", "port")}
    assert states["port"] == states["jax"] and states["port"]["total_texts"] == 5
    assert _dir_files(tmp_path / "port" / "raw") == _dir_files(tmp_path / "jax" / "raw")
    jfn, tfn = scripted_generate_fn(), scripted_generate_fn()
    _run(jrc, tmp_path / "jax", corpus, "BOTH", jfn, seed=3)
    _run(trc, tmp_path / "port", corpus, "BOTH", tfn, seed=3)
    assert tfn.calls == jfn.calls and tfn.calls  # the processed texts are skipped on both sides
    assert _rows(tmp_path / "port", trc) == _rows(tmp_path / "jax", jrc)
    assert _dir_files(tmp_path / "port" / "llm") == _dir_files(tmp_path / "jax" / "llm")
    assert not (tmp_path / "port" / "state.pkl").exists()


def test_pipeline_raises_as_jax(tmp_path, corpus, captured):
    with pytest.raises(ValueError, match="llm_kwargs is required"):
        trc.pipeline("tiny", "x", "y", "z", comprehension_type=trc.SynthMode.LLM, device="cpu")
    with pytest.raises(ValueError, match="synth_kwargs is required"):
        trc.pipeline("tiny", "x", "y", "z", device="cpu")
    with pytest.raises(ValueError, match="context_length is required"):
        trc.LLMKwargs("tiny", None, "out", True)
    if not torch.cuda.is_available():  # the card is the default, and nothing retries on the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _run(trc, tmp_path / "port", corpus, "REGEX", None, device=None)


def test_pipeline_trains_tiny_on_the_cpu(tmp_path, corpus):
    """REGEX + LLM rows into the port's own ``train_generator``: SFT on tiny, a finite loss, the adapter saved."""
    result = _run(trc, tmp_path, corpus, "BOTH", scripted_generate_fn(), seq_length=128, per_device_train_batch_size=2,
                  eval_steps=0, logging_steps=1, lora_r=4, lora_alpha=8, gradient_checkpointing=False,
                  validation_split=0.25, num_warmup_steps=0)
    assert np.isfinite(result["final_loss"]) and result["steps"] >= 2 and np.isfinite(result["eval_loss"])
    assert (tmp_path / "model" / "final_checkpoint" / "adapter_config.json").is_file()
    assert not (tmp_path / "state.pkl").exists() and len(_rows(tmp_path, trc)) > 4
