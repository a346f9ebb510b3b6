"""``dalm-torch`` command-line interface (counterpart of ``dalm_tpu/cli.py``).

    python3 -m dalm_tpu_torch.cli <command> [arguments]

The same eight commands as the JAX package's ``dalm`` (``version``,
``train-rag-e2e``, ``train-retriever-only``, ``train-generator``, ``qa-gen``,
``eval-retriever``, ``eval-rag``, ``serve``), with its positional arguments,
option names, ``--x/--no-x`` pairs, choices and defaults, on ``argparse``.

Differences from the JAX package's CLI:

- ``--device`` (default ``cuda``) is passed to the entry point: the eval
  commands have it there with the default ``tpu``; the training commands,
  ``qa-gen`` and ``serve`` have it here only. Nothing retries on the CPU.
- ``--index-kernel`` keeps its name, choices and default, but is inert: on the
  card the search is K3, the hand-written kernel, whatever it says.
- ``qa-gen --as-dataset`` (a dataset saved by ``save_to_disk``) needs the
  ``datasets`` package, which the port does not use: the command exits with
  status 2 and the entry point's ``NotImplementedError``.
- Knobs of paths that are not ported (``--model-parallel`` above 1,
  ``--context-parallel``, ``--pipeline-stages``, ``--pp-model-parallel``) reach
  the entry points, which raise ``NotImplementedError`` naming them; the
  command then exits with status 2 and that message.

``eval-retriever`` and ``eval-rag`` print ``EvalResults.model_dump_json()`` as
their last line.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional, Sequence

from dalm_tpu_torch import __version__

SCHEDULERS = ("linear", "cosine", "cosine_with_restarts", "polynomial", "constant", "constant_with_warmup")
MODES = ("retriever", "generator", "both")


def _opt(p, flag: str, default=None, type=None, choices=None, help=None, dest=None, required=False):
    """One valued option; its type is ``type``, else the default's (a string without either)."""
    if type is None and choices is None:
        type = _type_of(default)
    kw = {"dest": dest} if dest else {}
    p.add_argument(flag, default=default, type=type, choices=choices, help=help, required=required, **kw)


def _type_of(default):
    return float if isinstance(default, float) else int if isinstance(default, int) else str


def _flag(p, flag: str, help=None):
    p.add_argument(flag, action="store_true", default=False, help=help)


def _pair(p, on: str, off: str, default: bool, help=None):
    """An ``on/off`` pair of flags over one boolean (click's ``--x/--no-x``)."""
    dest = on.lstrip("-").replace("-", "_")
    p.add_argument(on, dest=dest, action="store_true", default=default, help=help)
    p.add_argument(off, dest=dest, action="store_false", default=default)


def _device(p, help="the entry point's device (cuda; cpu for tests)"):
    _opt(p, "--device", "cuda", help=help)


def _common_train_options(p):
    _opt(p, "--passage-column-name", "Abstract")
    _opt(p, "--query-column-name", "Question")
    _opt(p, "--query-max-len", 50)
    _opt(p, "--passage-max-len", 128)
    _opt(p, "--per-device-train-batch-size", 32)
    _opt(p, "--learning-rate", 1e-4)
    _opt(p, "--logit-scale", 100)
    _opt(p, "--weight-decay", 0.0)
    _opt(p, "--num-train-epochs", 1)
    _opt(p, "--max-train-steps", None, type=int)
    _opt(p, "--gradient-accumulation-steps", 1)
    _opt(p, "--lr-scheduler-type", "linear", choices=SCHEDULERS)
    _opt(p, "--output-dir", None)
    _opt(p, "--seed", 42)
    _opt(p, "--hub-model-id", None, help="[NOT CURRENTLY USED] parity flag")
    _opt(p, "--hub-token", None, help="[NOT CURRENTLY USED] parity flag")
    _opt(p, "--checkpointing-steps", None)
    _opt(p, "--resume-from-checkpoint", None)
    _pair(p, "--with-tracking", "--no-with-tracking", True)
    _opt(p, "--report-to", "all")
    _pair(p, "--sanity-test", "--no-sanity-test", True)
    _opt(p, "--dtype", None, help="compute dtype (bfloat16 / float32)")
    _opt(p, "--model-parallel", 1, help="tensor-parallel width (more than 1 is not ported yet)")
    _device(p)


def _common_eval_options(p):
    _opt(p, "--passage-column-name", "Abstract")
    _opt(p, "--query-column-name", "Question")
    _opt(p, "--embed-dim", None, type=int, help="inferred from the model when omitted")
    _opt(p, "--max-length", 128)
    _opt(p, "--test-batch-size", 8)
    _device(p)
    _opt(p, "--torch-dtype", "bfloat16")
    _opt(p, "--top-k", 10)
    _opt(p, "--index-kernel", "xla", choices=("xla", "pallas"),
         help="accepted for parity: the search is K3 on the card whatever it says")
    _opt(p, "--index-quantize", "none", choices=("none", "int8", "int4"),
         help="index row storage: int8 = 2x corpus per byte, int4 = 4x")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dalm-torch",
                                 description="Domain-adapted language modeling (the PyTorch / CUDA port).")
    sub = ap.add_subparsers(dest="command", required=True, metavar="command")

    sub.add_parser("version", help="Print the current version.")

    p = sub.add_parser("train-rag-e2e", help="Train a retriever and generator jointly (RAG-e2e).")
    for name in ("dataset_path", "retriever_name_or_path", "generator_name_or_path"):
        p.add_argument(name)
    _common_train_options(p)
    _opt(p, "--answer-column-name", "Answer")
    _opt(p, "--generator-max-len", 256)
    _opt(p, "--num-warmup-steps", 100)
    _opt(p, "--use-peft", None, choices=MODES)
    _opt(p, "--use-bnb", None, choices=MODES, help="quantize sub-model weights (int8 weight-only)")
    _flag(p, "--retriever-is-autoregressive")
    _opt(p, "--retriever-tokenizer", "byte")
    _opt(p, "--generator-tokenizer", "byte")
    _opt(p, "--lora-runtime", "merge", choices=("merge", "fused"), help="fused = per-layer QLoRA")
    _pair(p, "--live-index", "--no-live-index", False, help="continuously re-embed the passage index")
    _opt(p, "--live-negatives-k", 0, help=">0: top-k hard negatives from the live index each step")
    _opt(p, "--marginalize-k", 0, help=">0: true top-k RAG marginalization over gold + retrieved")
    _opt(p, "--marginalize-mode", "token", choices=("token", "sequence"))
    _opt(p, "--marginalize-scale", None, type=float, help="candidate-posterior temperature (default: logit-scale)")
    _opt(p, "--marginalize-warmup-steps", 0, help=">0: the first W steps use the diagonal loss")
    _flag(p, "--export-peft", help="also write a torch-PEFT adapter next to the native one")
    _opt(p, "--int8-compute", "none", choices=("none", "fwd", "all"),
         help="run the fused frozen int8 base through the int8 kernels (all = backward too)")

    p = sub.add_parser("train-retriever-only", help="Contrastive fine-tuning of a retriever (in-batch negatives).")
    for name in ("retriever_name_or_path", "dataset_path"):
        p.add_argument(name)
    _common_train_options(p)
    _opt(p, "--num-warmup-steps", 0)
    _pair(p, "--use-peft", "--no-use-peft", False)
    _pair(p, "--use-bnb", "--no-use-bnb", False)
    _flag(p, "--is-autoregressive")
    _opt(p, "--tokenizer", "byte")
    _flag(p, "--export-peft", help="also write a torch-PEFT adapter next to the native one")

    p = sub.add_parser("train-generator", help="Supervised fine-tuning of a generator.")
    for name in ("model_name_or_path", "dataset_path"):
        p.add_argument(name)
    _opt(p, "--output-dir", "./generator_finetuned_model")
    _opt(p, "--num-train-epochs", 1)
    _opt(p, "--seq-length", 2600)
    _opt(p, "--per-device-train-batch-size", 1)
    _opt(p, "--gradient-accumulation-steps", 1)
    _opt(p, "--learning-rate", 1e-4)
    _opt(p, "--lr-scheduler-type", "cosine")
    _opt(p, "--num-warmup-steps", 100)
    _opt(p, "--weight-decay", 0.05)
    _opt(p, "--eval-steps", 200)
    _opt(p, "--logging-steps", 10)
    _opt(p, "--validation-split", 0.05)
    _pair(p, "--packing", "--no-packing", True)
    _pair(p, "--use-peft", "--no-use-peft", True)
    _opt(p, "--lora-r", 256)
    _opt(p, "--lora-alpha", 512.0)
    _opt(p, "--neftune-noise-alpha", 5.0)
    _opt(p, "--tokenizer", "byte")
    _opt(p, "--dtype", None)
    _opt(p, "--seed", 42)
    _flag(p, "--context-parallel", help="not ported yet")
    _opt(p, "--moe-aux-weight", 0.0)
    _opt(p, "--pipeline-stages", 0, help="not ported yet above 1")
    _opt(p, "--pp-microbatches", 0)
    _opt(p, "--pp-model-parallel", 1, help="not ported yet above 1")
    _device(p)

    p = sub.add_parser("qa-gen", help="Generate question / answer pairs from a passage dataset.")
    p.add_argument("dataset_path")
    _opt(p, "--passage-column-name", "Abstract")
    _opt(p, "--title-column-name", "Title")
    _opt(p, "--sample-size", 1000)
    _opt(p, "--batch-size", 8)
    _opt(p, "--output-dir", "qa_gen_output")
    _pair(p, "--as-csv", "--as-dataset", True)
    _opt(p, "--max-input-tokens", 512)
    _opt(p, "--model-spec", "tiny", help="generator model for question writing")
    _opt(p, "--tokenizer", "byte")
    _device(p)

    p = sub.add_parser("eval-retriever", help="Evaluate retrieval recall / precision / hit rate.")
    for name in ("dataset_path", "retriever_name_or_path"):
        p.add_argument(name)
    _common_eval_options(p)
    _opt(p, "--retriever-peft-model-path", None)
    _flag(p, "--is-autoregressive")
    _opt(p, "--tokenizer", "byte")

    p = sub.add_parser("eval-rag", help="Evaluate retrieval + generator exact match.")
    for name in ("dataset_path", "retriever_name_or_path", "generator_name_or_path"):
        p.add_argument(name)
    _common_eval_options(p)
    _opt(p, "--retriever-peft-model-path", None)
    _opt(p, "--generator-peft-model-path", None)
    _opt(p, "--answer-column-name", "Answer")
    _opt(p, "--query-batch-size", 16)
    _pair(p, "--evaluate-generator", "--no-evaluate-generator", True)
    _flag(p, "--retriever-is-autoregressive")
    _opt(p, "--retriever-tokenizer", "byte")
    _opt(p, "--generator-tokenizer", "byte")
    _opt(p, "--max-new-tokens", 64)

    p = sub.add_parser("serve", help="Serve RAG answers over HTTP (and the OpenAI routes).")
    for name in ("retriever_name_or_path", "generator_name_or_path"):
        p.add_argument(name)
    _opt(p, "--passages", None, dest="passages_path", required=True,
         help="corpus file: .txt (one passage per line) or .csv (passage column)")
    _opt(p, "--passage-column-name", "Abstract")
    _opt(p, "--host", "127.0.0.1")
    _opt(p, "--port", 8080)
    _opt(p, "--num-slots", 32, help="continuous-batching decode slots")
    _opt(p, "--max-new-tokens", 64)
    _opt(p, "--max-prompt-len", 256)
    _opt(p, "--retriever-peft-path", None)
    _opt(p, "--generator-peft-path", None)
    _opt(p, "--retriever-tokenizer", "byte")
    _opt(p, "--generator-tokenizer", "byte")
    _pair(p, "--quantize-generator", "--no-quantize-generator", False, help="int8 generator weights")
    _pair(p, "--kv-quant", "--no-kv-quant", False, help="int8 KV cache")
    _opt(p, "--index-quantize", "none", choices=("none", "int8", "int4"))
    _opt(p, "--prefill-chunk", 0, help="blocked admission prefill in C-column chunks (0 = whole prompt at once)")
    _opt(p, "--temperature", 0.0, help="0 = greedy; > 0 samples (keys per request and position)")
    _opt(p, "--sampling-top-k", 0)
    _opt(p, "--sampling-top-p", 1.0)
    _opt(p, "--sampling-seed", 0)
    _device(p)
    return ap


def _read_passages(path: str, column: str) -> list:
    if path.endswith(".csv"):
        import csv

        with open(path, newline="") as f:
            return [row[column] for row in csv.DictReader(f)]
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def run(args: argparse.Namespace) -> int:
    kw = dict(vars(args))
    command = kw.pop("command")
    if command == "version":
        print(f"You are running DALM (dalm-tpu, PyTorch port) version: {__version__}")
    elif command == "train-rag-e2e":
        from dalm_tpu_torch.train.rag_e2e import train_e2e

        result = train_e2e(kw.pop("dataset_path"), kw.pop("retriever_name_or_path"),
                           kw.pop("generator_name_or_path"), **kw)
        print(f"train-rag-e2e done: {result}")
    elif command == "train-retriever-only":
        from dalm_tpu_torch.train.retriever_only import train_retriever

        result = train_retriever(kw.pop("retriever_name_or_path"), kw.pop("dataset_path"), **kw)
        print(f"train-retriever-only done: {result}")
    elif command == "train-generator":
        from dalm_tpu_torch.train.generator_only import train_generator

        result = train_generator(model_name=kw.pop("model_name_or_path"), dataset_name=kw.pop("dataset_path"), **kw)
        print(f"train-generator done: {result}")
    elif command == "qa-gen":
        from dalm_tpu_torch.data.qa_gen import generate_qa_from_disk

        generate_qa_from_disk(dataset_path=kw.pop("dataset_path"), **kw)
        print("qa-gen done")
    elif command == "eval-retriever":
        from dalm_tpu_torch.eval.retriever import evaluate_retriever

        results = evaluate_retriever(dataset_or_path=kw.pop("dataset_path"), **kw)
        print(results.model_dump_json())
    elif command == "eval-rag":
        from dalm_tpu_torch.eval.rag import evaluate_rag

        results = evaluate_rag(dataset_or_path=kw.pop("dataset_path"), **kw)
        print(results.model_dump_json())
    elif command == "serve":
        from dalm_tpu_torch.models.sampling import SamplerConfig
        from dalm_tpu_torch.serve import RagPipeline
        from dalm_tpu_torch.server_http import serve_pipeline

        passages = _read_passages(kw["passages_path"], kw["passage_column_name"])
        print(f"loaded {len(passages)} passages from {kw['passages_path']}", flush=True)
        sampler = (SamplerConfig(temperature=kw["temperature"], top_k=kw["sampling_top_k"], top_p=kw["sampling_top_p"],
                                 seed=kw["sampling_seed"]) if kw["temperature"] > 0 else None)
        pipe = RagPipeline.from_pretrained(
            kw["retriever_name_or_path"], kw["generator_name_or_path"], passages,
            retriever_peft_path=kw["retriever_peft_path"], generator_peft_path=kw["generator_peft_path"],
            retriever_tokenizer=kw["retriever_tokenizer"], generator_tokenizer=kw["generator_tokenizer"],
            max_prompt_len=kw["max_prompt_len"], max_new_tokens=kw["max_new_tokens"],
            quantize_generator=kw["quantize_generator"], kv_quant=kw["kv_quant"], sampler=sampler,
            index_quantize=kw["index_quantize"], prefill_chunk=kw["prefill_chunk"] or None, device=kw["device"],
        )
        serve_pipeline(pipe, host=kw["host"], port=kw["port"], num_slots=kw["num_slots"])
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
                        datefmt="%m/%d/%Y %H:%M:%S", level=logging.INFO)
    try:
        return run(args)
    except NotImplementedError as e:
        print(f"dalm-torch {args.command}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
