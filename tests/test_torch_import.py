"""The port stands alone: importing ``dalm_tpu_torch`` and every module of
it loads no JAX, flax, optax, orbax, ``datasets``, ``click``, ``pydantic``, ``msgpack``, ``safetensors`` or
``dalm_tpu`` module, and no source file under ``dalm_tpu_torch/`` imports them (the port reads ``params.msgpack``
and ``.safetensors`` files with its own readers; ``transformers`` is imported only where a HF tokenizer is asked
for)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent / "dalm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "datasets", "pandas", "click", "pydantic", "msgpack",
             "safetensors", "dalm_tpu")


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    mods = _modules()
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(PKG.parent), check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "dalm_tpu_torch.serve" in loaded and "dalm_tpu_torch.train.rag_e2e" in loaded
    for new in ("kernels.flash_attention", "train.generator_only", "data.sft", "losses.causal",
                "kernels.int4_matmul", "models.sampling", "models.quant", "models.decode_engine",
                "eval.common", "eval.results", "eval.retriever", "eval.rag", "cli", "core.msgpack",
                "models.hf_loader", "data.tokenizer", "models.moe", "models.mla", "models.gpt2", "data.qa_gen",
                "data.rc_regex", "data.backends", "pipelines.reading_comprehension"):
        assert f"dalm_tpu_torch.{new}" in loaded
    assert [m for m in loaded if _forbidden(m)] == [] and "transformers" not in loaded


@pytest.mark.parametrize("path", sorted(str(p.relative_to(PKG)) for p in PKG.rglob("*.py")))
def test_no_source_file_imports_jax(path):
    tree = ast.parse((PKG / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not [n for n in names if _forbidden(n)], f"{path} imports {names}"
