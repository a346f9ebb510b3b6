"""The port's CLI (``dalm_tpu_torch/cli.py``, argparse) against the JAX package's (``dalm_tpu/cli.py``, click).

Every JAX command exists in the port with the same positional arguments, option names, ``--x/--no-x`` pairs,
choices, types and defaults. The stated differences: ``--device`` (default ``cuda``; the JAX package has it only on
the eval commands, default ``tpu``, and the port adds it to every command that runs a model, ``qa-gen`` too) and ``--index-kernel``
(same name, choices and default; inert in the port, where K3 runs on the card whatever it says). ``eval-retriever
--device cpu`` prints the JSON line the JAX CLI prints for the same tiny weights (each side its own saved
directory, f32).
"""

import json
import subprocess
import sys

import click
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from dalm_tpu.cli import cli as jax_cli
from dalm_tpu_torch import __version__
from dalm_tpu_torch.cli import build_parser, main
from test_torch_eval import (TOP_K, assert_margins, eval_columns, jax_embeddings, jax_search_margins, shared_bases,
                             unique_passages)

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores

PORT_ONLY_DEVICE = {"train-rag-e2e", "train-retriever-only", "train-generator", "qa-gen", "serve"}


def _port_commands():
    sub = next(a for a in build_parser()._actions if a.dest == "command")
    return sub.choices


def _type_name(t):
    return {int: "integer", float: "float", str: "text", None: "text"}[t]


def port_spec(parser):
    """{"args": [names], "opts": {first flag: (all flags, default, choices, type name or "flag", required)}}."""
    args, by_dest = [], {}
    for a in parser._actions:
        if a.dest == "help":
            continue
        if not a.option_strings:
            args.append(a.dest)
            continue
        by_dest.setdefault(a.dest, []).append(a)
    opts = {}
    for dest, acts in by_dest.items():
        flags = tuple(f for a in acts for f in a.option_strings)
        boolean = all(a.const in (True, False) and a.nargs == 0 for a in acts)
        kind = "flag" if boolean else ("choice" if acts[0].choices else _type_name(acts[0].type))
        choices = tuple(acts[0].choices) if acts[0].choices else None
        opts[flags[0]] = (flags, acts[0].default, choices, kind, acts[0].required)
    return {"args": args, "opts": opts}


def click_spec(command):
    args, opts = [], {}
    for p in command.params:
        if isinstance(p, click.Argument):
            args.append(p.name)
            continue
        if p.name == "help":
            continue
        flags = tuple(p.opts) + tuple(p.secondary_opts)
        default = p.default if isinstance(p.default, (bool, int, float, str, type(None))) else None  # click's unset
        if p.is_flag:
            kind, choices = "flag", None
        elif isinstance(p.type, click.Choice):
            kind, choices = "choice", tuple(p.type.choices)
        else:
            kind, choices = p.type.name, None
        opts[flags[0]] = (flags, default, choices, kind, p.required)
    return {"args": args, "opts": opts}


def test_every_jax_command_exists_in_the_port():
    port = _port_commands()
    assert sorted(jax_cli.commands) == sorted(port) and len(port) == 8


@pytest.mark.parametrize("name", sorted(jax_cli.commands))
def test_options_flag_pairs_choices_and_defaults_equal_jax(name):
    t, j = port_spec(_port_commands()[name]), click_spec(jax_cli.commands[name])
    assert t["args"] == j["args"]
    t_dev, j_dev = t["opts"].pop("--device", None), j["opts"].pop("--device", None)
    if name in PORT_ONLY_DEVICE:
        assert j_dev is None and t_dev == (("--device",), "cuda", None, "text", False)
    elif j_dev is not None:  # the eval commands: same option, the card for the TPU
        assert j_dev[1] == "tpu" and t_dev == (("--device",), "cuda", None, "text", False)
    else:
        assert t_dev is None
    assert list(t["opts"]) == list(j["opts"])  # the same options in the same order
    for flag, want in j["opts"].items():
        assert t["opts"][flag] == want, flag


def test_version(capsys):
    assert main(["version"]) == 0
    assert __version__ in capsys.readouterr().out
    assert CliRunner().invoke(jax_cli, ["version"]).exit_code == 0


def test_qa_gen_writes_the_csvs_of_the_in_process_call(tmp_path, capsys):
    """``qa-gen --device cpu --model-spec tiny``: the tiny preset random-initialised from seed 0 on both sides."""
    from dalm_tpu_torch.data.qa_gen import generate_qa_from_disk
    from test_torch_qa_gen import write_passages_csv

    path = write_passages_csv(tmp_path / "passages.csv", 10, 4, seed=2)
    assert main(["qa-gen", path, "--sample-size", "9", "--batch-size", "4", "--max-input-tokens", "64",
                 "--output-dir", str(tmp_path / "cli"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "qa-gen done"
    generate_qa_from_disk(path, "Abstract", "Title", 9, 4, str(tmp_path / "call"), True, max_input_tokens=64,
                          model_spec="tiny", device="cpu")
    for split in ("train", "test"):
        name = f"question_answer_pairs_{split}.csv"
        assert (tmp_path / "cli" / name).read_bytes() == (tmp_path / "call" / name).read_bytes()


def test_qa_gen_as_dataset_exits_2_naming_datasets(tmp_path, capsys):
    assert main(["qa-gen", str(tmp_path / "data.csv"), "--sample-size", "4", "--as-dataset", "--device", "cpu",
                 "--output-dir", str(tmp_path / "out")]) == 2
    assert "needs the 'datasets' package" in capsys.readouterr().err and not (tmp_path / "out").exists()


def test_unported_multi_gpu_flags_reach_the_entry_points(capsys, toy_csv, tmp_path):
    assert main(["train-rag-e2e", toy_csv, "tiny", "tiny", "--device", "cpu", "--model-parallel", "2"]) == 2
    assert "model_parallel=2 is not ported yet" in capsys.readouterr().err
    assert main(["train-generator", "tiny", str(tmp_path / "chat.jsonl"), "--device", "cpu", "--context-parallel"]) == 2
    assert "context_parallel" in capsys.readouterr().err
    if not torch.cuda.is_available():  # --device defaults to the card, and nothing retries on the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["train-retriever-only", "tiny", toy_csv, "--max-train-steps", "1"])


def test_eval_retriever_prints_the_json_the_jax_cli_prints(tmp_path, tmp_path_factory, capsys):
    import csv

    bases = shared_bases(tmp_path_factory)
    cols = eval_columns()
    path = str(tmp_path / "eval.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(cols))
        w.writerows(zip(*cols.values()))
    jp = jax_embeddings(bases["retriever"][0], unique_passages(cols))
    jq = jax_embeddings(bases["retriever"][0], cols["Question"])
    assert_margins(jax_search_margins(jp, jq, False, TOP_K)[0], TOP_K, 0.0)
    opts = ["--torch-dtype", "float32", "--max-length", "32", "--top-k", str(TOP_K)]
    res = CliRunner().invoke(jax_cli, ["eval-retriever", path, bases["retriever"][0], *opts], catch_exceptions=False)
    assert res.exit_code == 0
    want = res.stdout.strip().splitlines()[-1]
    assert main(["eval-retriever", path, bases["retriever"][1], "--device", "cpu", *opts]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and json.loads(got)["total_examples"] == 18


def test_train_retriever_only_runs_one_step(tmp_path, toy_csv, capsys):
    out = tmp_path / "out"
    assert main(["train-retriever-only", "tiny", toy_csv, "--device", "cpu", "--max-train-steps", "1",
                 "--per-device-train-batch-size", "4", "--query-max-len", "16", "--passage-max-len", "16",
                 "--no-with-tracking", "--use-peft", "--output-dir", str(out)]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("train-retriever-only done: ") and "'steps': 1" in line
    assert (out / "retriever" / "state_dict.pt").is_file() and (out / "retriever" / "adapter_config.json").is_file()
    assert np.isfinite(float(line.split("'final_loss': ")[1].split(",")[0]))


def test_help_in_a_fresh_process_imports_no_jax_click_pydantic_or_datasets():
    code = (
        "import json, runpy, sys\n"
        "names = ['--help'] + [[c, '--help'] for c in ('version', 'train-rag-e2e', 'train-retriever-only',"
        " 'train-generator', 'qa-gen', 'eval-retriever', 'eval-rag', 'serve')]\n"
        "for argv in names:\n"
        "    sys.argv = ['dalm-torch'] + ([argv] if isinstance(argv, str) else argv)\n"
        "    try:\n"
        "        runpy.run_module('dalm_tpu_torch.cli', run_name='__main__', alter_sys=True)\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (argv, e.code)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "usage: dalm-torch eval-rag" in out.stdout and "dalm_tpu_torch" in loaded
    bad = [m for m in loaded if m.split(".")[0] in ("jax", "jaxlib", "click", "pydantic", "datasets", "dalm_tpu")]
    assert bad == []
