#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``dalm_tpu_torch/csrc/`` (one
``nvcc`` per source, started together), holds each against its plain PyTorch
version on the card, and drives the three main paths once at full width and
depth, bf16, random-initialised from a seed: serving (``RagPipeline`` with a
bge-large retriever and a Llama-2-7B generator over a 16,384-passage
synthetic corpus), RAG training (``train_e2e`` on a synthetic CSV, fused
QLoRA, int8 generator base, ``int8_compute="all"``, batch 18, 4 optimiser
steps; the flagship of ``bench.py`` with ``a8_calibrate_every`` at its default
of 16, beside a run with 0) and generator SFT (``train_generator`` on a synthetic chat dataset,
Llama-2-7B, LoRA r = 256 in the merge runtime, packed blocks of 2560 tokens,
batch 2, 3 optimiser steps and a validation pass, every attention call
through the flash-attention kernels); and serves again with the generator
packed to 4 bits (``RagPipeline(quantize_generator="int4", kv_quant=True)``,
every projection through the int4 kernel K5, then nf4, int4pc and the
i8mxu / groupmm variants); and serves that int4 pipeline through the
continuous-batching engine (``answer_continuous``, 32 slots: one wave of 32
queries, then 64 requests with per-request budgets recycling the slots, each
held token for token to the lockstep ``answer()``); and serves it with
prompt-lookup speculative decoding (``speculative=True``, gamma 8: lockstep,
the engine's two schedules) and through streaming sessions (``stream()``,
with and without speculation), each held to the plain path, tie-aware where
speculation rounds otherwise; serves it over HTTP (``RagHTTPServer``: 64
requests from 32 client threads over the plain and the OpenAI routes, and a
client that hangs up); refreshes the bf16 pipeline's index for new retriever
weights (``RagPipeline.refresh``: a float index swept by the incremental
refresher, int8 and int4 indexes rebuilt) and searches a tiered index whose
second half spills to host RAM; and builds a 4-bit pipeline with PEFT
adapters merged into both towers; and trains the rest of the training
paths at full width: dy-calibrated (``a8_dy_calibrate``), the live index with
hard negatives and the top-k marginal over 4,608 passages, the merge runtime
with dropout, PEFT export and a profiler window, and ``train_retriever``; and
evaluates: ``evaluate_retriever`` (bge-large over 65,536 rows into an f32 index,
then int8 and int4 indexes over 16,384), ``evaluate_rag`` (bge-large +
Llama-2-7B, exact match planted at 0.5), the autoregressive EOS-pooled
retriever at Llama-2-7B width through the eval, ``train_retriever``,
``train_e2e`` (two 7B towers on the W8A8 route) and ``RagPipeline``, and the
``dalm-torch`` CLI in subprocesses; and runs the dense model families: each of ten presets (Llama-3 / 3.1,
Llama-2-13B, Mistral, Qwen2.5 / 3, Phi-3, Gemma / 2 / 3) at full width and 2 layers with its kernels held to their
plain versions, a Llama-3.1-8B checkpoint written in the Hugging Face layout and read back, bge-large +
Llama-3.1-8B int4 serving (``answer()`` and ``answer_continuous()``), and Gemma2-2B SFT at 8,192 tokens with every
attention call on K4's head-dim-256 kernels; and the rest of the model families: Qwen3-30B-A3B (sparse MoE, 128
experts) served at full width (24 of its 48 layers) in int4 with the int8 KV cache and trained with ``moe_aux_weight``
at full depth,
deepseek-v3-mid-7b (MLA) served in int4 on its latent cache, and Mixtral, Qwen3-MoE, DeepSeek-V3 (MLA, noaux-tc MoE,
YaRN) and GPT-2 in families-small; and data generation: QA-gen with a Qwen2.5-7B writer, the reading-comprehension
pipeline with a Mistral-7B writer (regex and LLM tasks, then SFT of Mistral-7B on them), both at full width and depth,
and the CLI's ``qa-gen``. Depth cut to keep the whole within its time limit (``CUT_DEPTH``): eval-retriever's and the
CLI's bge-large 12 of 24 layers, eval-rag's Llama-2-7B 16 and eval-ar's 8 of 32, serve-moe's Qwen3-30B-A3B 24 of 48.
Fails (non-zero exit, no result line)
without a CUDA device, without the repository beside it, or if any phase
fails. ``--phases`` runs a subset while developing and prints no result line.

Phases: ``small`` (tiny pipeline, card vs CPU; and a tiny pipeline wide
enough for K5 in int4, nf4 and int4pc with the int8 KV cache), ``serve``
(and K3 at its own shape, by CUDA graph over copies of the index in turns
with ``torch.topk(q @ e.T)``), ``serve-q`` (the 4-bit tiers; reuses
``serve``'s bf16 pipeline when both run), ``serve-cb`` (continuous batching on
serve-q's int4 pipeline; ``--seed`` draws its budgets), ``serve-stream`` (speculative decoding and
streaming on that pipeline: ``answer()`` with ``speculative=True``, one verify pass fed the plain path's own
tokens, the speculative engine's fused schedule and host loop, 64 streamed queries in two bursts, a speculative
stream; K3 at one query and K5's routes at the verify pass's rows against their plain versions), ``serve-http``
(the HTTP front end on that pipeline), ``serve-refresh`` (``refresh`` on ``serve``'s pipeline: a sweep, the int8 /
int4 rebuilds; then ``TieredIndex`` over 262,144 rows, half of them on the host), ``serve-adapter`` (a 4-bit
Llama-2-7B pipeline of its own with both towers' adapters merged), ``k3`` (every row storage mode at
1M rows, each with its share of the bound), ``k2`` (timed by CUDA graph over
copies larger than the L2 at the train shapes and again at decode's 32
rows), ``k1`` (K1, its three launches one by one, and the two int8 GEMM
entries), ``grad``,
``k4`` (flash attention, the forward and the backward each on its route: the
wgmma kernels for bf16 at head dim 64 / 128, the tf32x3 kernels for f32 at 64 / 128
and the mma.sync kernels for the rest; dq, dk/dv and the dsum pre-pass), ``k5`` (the five K5 instances, the
fused decode kernel held to its plain version, counted once per call and
repeated bit for bit, and at M = 32 timed by CUDA graph over copies of the
weight in turns with ``x @ W_bf16``; K2 alone and the wrapper's host time per
call at decode rows;
K5's prefill route for base and nf4, its pre-pass and wgmma GEMM, and its fold
route for groupmm and i8mxu, the nibble pre-pass, K2 writing bf16 and the fold
GEMM, and its int8 route for pcol, K2, the int8 nibble pre-pass and the scaled
s8 GEMM (beside K1's fold instance on the same operands), against the fused
kernel forced on the same operands; i8mxu's and pcol's exactness at the
extremes of their operands; each route's crossover with the fused kernel by
rows; K5 base and nf4 at group 8, Gemma3-1B's K 1,152: the fused kernel's instances
for groups of 8 at M 32 in bf16 and f32, in turns with ``x @ W_bf16`` and with the
prefill route forced, and the prefill route at M 8,192 against ``x @ W_bf16``),
``train-small`` (tiny ``train_e2e``, card vs CPU; and a 2-step tiny run of each of these training paths:
calibrated, dy-calibrated, the merge runtime over int8 bases, the live index with both marginal modes,
``train_retriever``), ``train`` (the flagship with ``a8_calibrate_every`` 0, then 16), ``train-dycal``
(``a8_calibrate_every=2, a8_dy_calibrate=True``: every site's dy scale finite and > 0), ``train-live`` (the live
index, ``live_negatives_k=8``, ``marginalize_k`` = ``LIVE_K``, token mode, 1 warm-up step), ``train-merge``
(``lora_runtime="merge"``, int8 retriever base, dropout, PEFT export, a trace of step 1), ``train-retriever``
(``train_retriever("bge-large", ...)``, LoRA on an int8 base, dropout, batch 32),
``sft-small`` (tiny ``train_generator``, card vs CPU), ``sft``; ``k1`` also holds the calibrated-scale
quantiser (both modes) to its plain version and times it and the calibrated forward route;
``eval-retriever`` (``evaluate_retriever`` at bge-large, top-10, batch 256: ``EVAL_ROWS`` rows into an f32 index,
then ``EVAL_Q_ROWS`` into int8 and int4 indexes; every search held against the plain top-k and the metrics
recomputed from both, ``hold_eval``), ``eval-rag`` (``evaluate_rag`` at bge-large + Llama-2-7B, ``RAG_ROWS`` rows,
half the answers planted from the same generator's greedy output: exact match 0.5), ``eval-ar`` (the EOS-pooled
Llama-2-7B retriever: ``evaluate_retriever`` over ``AR_ROWS`` rows with K3 at D 4096, ``train_retriever``,
``train_e2e`` with both towers on the W8A8 route and its int8 launches split by tower, a ``RagPipeline`` with an
int4 generator), ``cli`` (``python3 -m dalm_tpu_torch.cli``: ``version``, every ``--help``, ``eval-retriever``
and ``qa-gen --device cuda`` at tiny, each equal to the in-process call);
``families-small`` (the ten new presets at full width and 2 layers: the flash forward against K4's plain version,
the cached decode against the full forward, int4 on K5 against x @ dequant(W), K4 at head dim 256 on QK-normed q / k
with window 512; a 2-layer Llama-3.1-8B written as ``config.json`` + ``model.safetensors`` and read back through
``resolve_decoder`` and ``load_hf_decoder_packed`` with logits equal bit for bit), ``serve-llama31`` (bge-large +
Llama-3.1-8B int4 + int8 KV cache: ``answer()`` with K5 launches by route and shape, the decode step against the
weight-read bound, the cache against Llama-2-7B's, ``answer_continuous()`` token for token), ``sft-gemma2``
(``train_generator("gemma2-2b", ...)`` at 8,192 tokens, 3 steps: K4's D-256 launches, every one on the wgmma
route, held to 26 layers x (2 forwards + 1 backward) a step), ``serve-moe`` (bge-large + Qwen3-30B-A3B int4 + int8 KV
cache at full width, 24 of its 48 layers: ``answer()``, the decode step against the weights it streams, ``answer_continuous()``
token for token, the peak memory; one MoE layer over 2,048 tokens, the indexed dispatch against the dense formula),
``serve-mla`` (bge-large + deepseek-v3-mid-7b int4 on the latent cache, the same measurements, the cache against
Llama-2-7B's int8 one), ``sft-moe`` (``train_generator("qwen3-moe-30b", moe_aux_weight=0.001, ...)`` at 2,048
tokens, 3 steps: K4's D-128 launches held to 48 layers x (2 forwards + 1 backward) a step, the aux value beside each
loss), ``datagen-small`` (``TorchTextGenerator("tiny")`` and ``pipeline(SynthMode.BOTH)`` with a scripted writer,
the card against the CPU), ``qa-gen`` (``generate_qa_from_disk`` with ``TorchTextGenerator("qwen2.5-7b")``: the
decode step against the weight-read bound, first tokens against the uncached argmax, the CSVs against the filtered
questions), ``rc-pipeline`` (``pipeline("mistral-7b", SynthMode.BOTH)``: 6 LLM chunks, the regex rows, SFT at 2,560
tokens in the preset's f32 compute, K4's launches on the route ``fwd_route`` gives held to 32 layers x (2 forwards +
1 backward) a step, the state file, each chunk's JSON, the rows against the regex and extracted conversations);
families-small also runs Mixtral-8x7B, Qwen3-30B-A3B, deepseek-v3-mini / mid-7b at 2 layers, DeepSeek-V3 at
its own width (2 layers, one noaux-tc MoE layer) and GPT-2 whole, the MoE rows' expert choices replayed between the
two sides of each comparison (``RouteReplay``), and reads back HF checkpoints of ``mixtral``, ``qwen3_moe``,
``deepseek_v3`` and ``gpt2`` bit for bit; ``k4`` also times the D-256 kernels (the wgmma route
in turns with the kept mma.sync instances) at sft-gemma2's two layers against SDPA without softcap, and at
Gemma-2B's attention (no softcap), where SDPA computes the same function;
and, only when named, ``profile`` / ``profile-sft`` (a ``torch.profiler``
trace of the RAG / SFT training steps: device busy share and the top kernels
by device time) and ``profile-serve`` (the same over 8 decode iterations of
the engine at serve-cb's shape, with launches per iteration).

Output: per-phase lines, one JSON line of every measured case per kernel
phase (``k3_cases``, ``k2_cases``, ``k1_cases``, ``k4_cases``, ``k5_cases``, ``k5_group8``),
the card's name and power limit, one ``{"kernels": [...]}`` JSON line (one
entry per K3 row storage mode, K2, K1 and each of its three launches (the
quantise pre-pass, the weight pre-pass, the GEMM), the calibrated-scale quantiser in its two modes
(``k1_cal_quant``, its launches from ``train``; ``k1_cal_quant[dy]``, from ``train-dycal``), each GEMM entry, each K4 kernel (the
forward's wgmma route ``k4_fwd_wgmma`` and mma.sync route ``k4_fwd``, the backward's
``k4_bwd_dq_wgmma`` / ``k4_bwd_dkv_wgmma`` and ``k4_bwd_dq`` / ``k4_bwd_dkv``, each with
its own launches, and the dsum pre-pass ``k4_dsum``), each of the five K5 instances, the prefill route's pre-pass (base,
nf4) and GEMM, the fold route's nibble pre-pass, fold GEMM (groupmm, i8mxu) and K2 in bf16, the int8 route's int8
nibble pre-pass and scaled GEMM (pcol; ``launches_train``: its calls on the calibrated route of ``train``), K4's
head-dim-256 forward, dq and dk/dv on the wgmma route (``k4_fwd_d256_wgmma``, ``k4_bwd_dq_d256_wgmma``,
``k4_bwd_dkv_d256_wgmma``, launched by sft-gemma2) and the mma.sync instances that route replaced (``k4_fwd_d256``,
``k4_bwd_dq_d256``, ``k4_bwd_dkv_d256``, no launch there);
K5 base and K3 also carry ``launches_serve_llama31``, ``launches_serve_moe`` and ``launches_serve_mla``, K4's D-128
wgmma kernels and dsum ``launches_sft_moe``; the pipeline's SFT computes in f32 at head dim 128, on K4's tf32x3 route,
and rc-pipeline holds and times those kernels at its own geometry (``k4_fwd_tf32x3``, ``k4_bwd_dq_tf32x3``,
``k4_bwd_dkv_tf32x3`` and the dsum pre-pass ``k4_dsum[f32]``, whose main path it is) in turns with the mma.sync f32
instances they replaced there (``k4_fwd[f32]``, ``k4_bwd_dq[f32]``, ``k4_bwd_dkv[f32]``, no launch there); K5 base's
instance for groups of 8 (``int4_matmul[base,group8]``) carries its launches in families-small's Gemma3-1B row; each
with its launches in its
main path: ``answer()`` for K3, the ``train_e2e`` run for the int8 kernels,
the ``train_generator`` run for K4, the 4-bit tier's own ``answer()`` for each
K5 instance, every count set to 0 just before that path is driven; K3's f32
entry and K5 base's fused kernel, pre-pass and GEMM also carry
``launches_serve_cb``, their counts in serve-cb's counted
``answer_continuous()``, and ``launches_serve_stream``, their counts in
serve-stream's speculative and streaming runs; ``launches_serve_http``,
``launches_serve_refresh`` and ``launches_serve_adapter`` likewise; K3's int8
and int4 entries count the searches of serve-refresh's rebuilt indexes;
``launches_eval_retriever`` (K3 by mode), ``launches_eval_rag``, ``launches_eval_ar``
(K3 at D 4096, K5 in the AR pipeline's ``answer()``, the int8 kernels of the
two-7B ``train_e2e``; ``launches_eval_ar_retriever`` their retriever tower's
share) and ``launches_cli`` (read from the CLI's own process) count the evaluation phases' launches), one
``k3_eval_cases`` line
(K3 timed at each eval's shape), and as the last line
``{"ok": true, "device": {...}}``.

Tolerances: K3 on exact-arithmetic inputs (small integers times powers of
two, so every partial sum is exact in f32 whatever the order) must match
the plain version exactly, ids and scores. On unit-norm float inputs and
on the pipeline's own embeddings, scores agree within 1e-5 and ids are
equal except where two rows' f64 scores lie within 1e-5 of each other
(a near tie that f32 sums in another order may resolve either way). The
int8 kernels' tolerances stand in their phases' docstrings: K2 and the GEMM
entries equal, K1 and each of its launches equal on integer-valued and
real-valued inputs, gradients equal, tiny training losses within 2e-3. K4's
stand beside ``K4_TOL``, the tiny SFT run's beside ``SFT_SMALL_TOL``, K5's
beside ``K5_TOL``, the 4-bit tiers' logits beside ``K5_LOGIT_BOUND`` and the
tiny K5 pipeline's beside ``SMALL_Q_TOL``, serve-stream's and serve-http's near ties beside
``TIE_TOL``, the refreshed rows beside ``REFRESH_TOL``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import re
import shutil
import string
import subprocess
import sys
import tempfile
import time
from pathlib import Path

NEAR_TIE = 1e-5

# Published peaks (NVIDIA data sheets; dense rates). memory B/s, f32
# CUDA-core FLOP/s, bf16 tensor-core FLOP/s, int8 tensor-core OP/s. A name
# without "PCIe" or "NVL" is taken as the SXM part.
PEAKS = {
    "PCIe": (2.0e12, 51e12, 756e12, 1513e12),
    "NVL": (3.9e12, 60e12, 835e12, 1671e12),
    "SXM": (3.35e12, 67e12, 989e12, 1979e12),
}


def ptxas_counts(log: str) -> dict:
    """ptxas's ``-v`` lines by kernel: {mangled name: {"line": the stack / spill line, "spill": bytes spilled
    (stores + loads), "used": the registers line}}."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {"line": "", "spill": 0, "used": ""}
        elif fn and "spill stores" in line:
            out[fn]["line"] = line.strip()
            out[fn]["spill"] = sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif fn and "Used" in line and "registers" in line:
            out[fn]["used"] = line.split(":", 1)[-1].strip()
            fn = None
    return out


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def peaks_for(name: str) -> tuple:
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


@contextlib.contextmanager
def k5_dequantised():
    """Inside: every packed layer computes ``x @ dequant(W)`` (the reference's product off a TPU) on the same packed
    weights instead of K5, the yardstick the K5 checks hold the kernels to."""
    from dalm_tpu_torch.kernels import int4_matmul as k5

    saved = k5.int4_matmul_fwd
    k5.int4_matmul_fwd = lambda x2, q4, scale4, instance: x2 @ k5._dequant(q4, scale4, x2.dtype, instance == "nf4")
    try:
        yield
    finally:
        k5.int4_matmul_fwd = saved


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns, reps: int = 3) -> float:
    """Device ms per call of short kernels, free of the host's launch time: ``reps`` rounds over ``fns`` (each a
    call on its own operands; a rotation larger than the 50 MB L2 reads from device memory, as a decode step reads
    each layer's weights) captured once into a CUDA graph, replayed once to warm, then timed over 5 replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            for f in fns:
                f()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    del g
    return start.elapsed_time(end) / (5 * reps * len(fns))


def compare_topk(s, i, rs, ri, q, rows_f32, scales):
    """Kernel vs plain result. Returns (max |score error|, near-tie id swaps);
    raises on a disagreement that is not a near tie."""
    import torch

    err = (s - rs).abs()
    finite = torch.isfinite(rs)
    check(torch.equal(torch.isfinite(s), finite), "kernel and plain disagree on which slots are filled")
    max_err = float(err[finite].max()) if bool(finite.any()) else 0.0
    check(max_err <= NEAR_TIE, f"score error {max_err} above {NEAR_TIE}")
    bad = (i != ri) & finite
    swaps = int(bad.sum())
    if swaps:
        qi, kj = bad.nonzero(as_tuple=True)
        got = rows_f32[i[qi, kj].long()].double()
        want = rows_f32[ri[qi, kj].long()].double()
        qd = q[qi].double()
        sg, sw = (got * qd).sum(1), (want * qd).sum(1)
        if scales is not None:
            sg = sg * scales.reshape(-1)[i[qi, kj].long()].double()
            sw = sw * scales.reshape(-1)[ri[qi, kj].long()].double()
        check(bool(((sg - sw).abs() <= NEAR_TIE).all()), f"{swaps} id mismatches that are not near ties")
    return max_err, swaps


def k3_record(mode, case, ms, plain_ms, lib_ms, max_err, nbytes, ops, mem_bw, op_rate, **extra):
    """One measured K3 case, in the kernels line's keys (without ``launches``).
    ``mode`` is the row storage: f32, bf16, int8 or int4."""
    t_bytes = nbytes / mem_bw * 1e3
    t_ops = ops / op_rate * 1e3
    return {
        "name": f"fused_dot_topk[{mode}]", "route": "cuda", "source": "dalm_tpu_torch/csrc/topk.cu",
        "replaces": "dalm_tpu/kernels/topk.py:130", "case": case,
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms, **extra,
    }


def k3_phase(gen, device, peaks):
    """K3 at N = 1,048,576 rows x D = 1024, Q = 32, all storage modes.
    Returns (one record per case, in order; {mode: its k = 4 record} for
    the modes the main path does not run)."""
    import torch

    from dalm_tpu_torch.index.dense import quantize_int4
    from dalm_tpu_torch.kernels.topk import _dequantized_rows, fused_dot_topk, fused_dot_topk_ref

    N, D, Q = 1 << 20, 1024, 32
    mem_bw, f32_rate, bf16_rate, _ = peaks

    def grid(shape, lo, hi, dtype):
        """Exact-arithmetic data: integers in [lo, hi] / 16."""
        x = torch.randint(lo, hi + 1, shape, generator=gen, device=device, dtype=torch.int16)
        return (x.float() / 16).to(dtype)

    entries, reps = [], {}

    def run(label, q, e, k, num_valid=None, scales=None, int4=False, exact=True, library=None):
        s, i = fused_dot_topk(q, e, k, num_valid=num_valid, scales=scales, int4=int4)
        rs, ri = fused_dot_topk_ref(q, e, k, num_valid=num_valid, scales=scales, int4=int4)
        torch.cuda.synchronize()
        if exact:
            check(torch.equal(i, ri) and torch.equal(s, rs), f"{label}: kernel != plain version on exact inputs")
            max_err, swaps = 0.0, 0
        else:
            max_err, swaps = compare_topk(s, i, rs, ri, q.float(), _dequantized_rows(e, int4), scales)
        ms = cuda_ms(lambda: fused_dot_topk(q, e, k, num_valid=num_valid, scales=scales, int4=int4), 20)
        plain_ms = cuda_ms(lambda: fused_dot_topk_ref(q, e, k, num_valid=num_valid, scales=scales, int4=int4), 5)
        lib_ms = cuda_ms(library, 20) if library is not None else None
        nv = e.shape[0] if num_valid is None else num_valid
        row_bytes = e.shape[1] * e.element_size() + (4 if scales is not None else 0)
        nbytes = nv * row_bytes + q.numel() * q.element_size() + Q * k * 8
        ops = 2.0 * Q * nv * D
        entry = k3_record(label.split()[0], label, ms, plain_ms, lib_ms, max_err, nbytes, ops, mem_bw,
                          f32_rate if e.dtype == torch.float32 else bf16_rate)
        print(f"[k3] {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {entry['bound_ms']:.4f} ms "
              f"({entry['bound_by']}, {entry['bound_ms'] / ms:.1%} of it), max_abs_err {max_err}, "
              f"near-tie swaps {swaps}", flush=True)
        entries.append(entry)
        return entry

    q32 = grid((Q, D), -8, 8, torch.float32)
    e32 = grid((N, D), -8, 8, torch.float32)
    for k in (1, 4, 10):
        run(f"f32 N={N} k={k}", q32, e32, k, library=lambda k=k: torch.topk(q32 @ e32.T, k))
    nv = N - 12345
    run(f"f32 N={N} k=10 num_valid={nv}", q32, e32, 10, num_valid=nv,
        library=lambda: torch.topk(q32 @ e32[:nv].T, 10))
    dup = e32[:1024].repeat(N // 1024, 1)  # every row 1024 times: ties everywhere
    run(f"f32 duplicated rows N={N} k=10", q32, dup, 10)
    del dup
    unit = torch.randn((N, D), generator=gen, device=device)
    unit /= unit.norm(dim=1, keepdim=True)
    qu = torch.randn((Q, D), generator=gen, device=device)
    qu /= qu.norm(dim=1, keepdim=True)
    run(f"f32 unit-norm N={N} k=10", qu, unit, 10, exact=False, library=lambda: torch.topk(qu @ unit.T, 10))
    del unit, e32

    q16 = grid((Q, D), -8, 8, torch.bfloat16)
    e16 = grid((N, D), -8, 8, torch.bfloat16)
    reps["bf16"] = run(f"bf16 N={N} k=4", q16, e16, 4, library=lambda: torch.topk((q16 @ e16.T).float(), 4))
    del e16
    scales = torch.rand((N, 1), generator=gen, device=device) + 0.5
    e8 = torch.randint(-127, 128, (N, D), generator=gen, device=device, dtype=torch.int8)
    for k in (1, 4, 10):
        entry = run(f"int8 N={N} k={k}", q16, e8, k, scales=scales)
        if k == 4:
            reps["int8"] = entry
    run(f"int8 N={N} k=10 num_valid={N - 777}", q16, e8, 10, num_valid=N - 777, scales=scales)
    del e8
    e4 = torch.randint(0, 256, (N, D // 2), generator=gen, device=device, dtype=torch.uint8)
    for k in (1, 4, 10):
        entry = run(f"int4 N={N} k={k}", q16, e4, k, scales=scales, int4=True)
        if k == 4:
            reps["int4"] = entry
    del e4
    # The index's own quantisers on real-valued rows, smaller N (host-side numpy).
    rows = torch.randn((1 << 16, D), generator=gen, device=device)
    rows /= rows.norm(dim=1, keepdim=True)
    packed, sc4 = quantize_int4(rows.cpu().numpy())
    run(f"int4 quantised unit-norm rows N={rows.shape[0]} k=10", qu.to(torch.bfloat16), torch.from_numpy(packed).to(device), 10,
        scales=torch.from_numpy(sc4).to(device), int4=True, exact=False)
    torch.cuda.empty_cache()
    return entries, reps


def i8_record(name, replaces, case, ms, plain_ms, lib_ms, max_err, nbytes, ops, peaks, **extra):
    """One measured int8 kernel case, in the kernels line's keys (without ``launches``)."""
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = ops / peaks[3] * 1e3
    return {
        "name": name, "route": "cuda", "source": "dalm_tpu_torch/csrc/int8_matmul.cu",
        "replaces": replaces, "case": case, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms, **extra,
    }


def show(tag, e, share=False):
    lib = "n/a" if e["library_ms"] is None else f"{e['library_ms']:.4f} ms"
    more = f", {e['bound_ms'] / e['ms']:.1%} of it" if share else ""
    print(f"[{tag}] {e['name']} {e['case']}: kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, library {lib}, "
          f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}{more}), max_abs_err {e['max_abs_err']}", flush=True)


M_TRAIN = 4608  # generator rows of one train step: batch 18 x 256 tokens
LLAMA_KN = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))  # q/k/v/o, gate/up, down, lm_head
K2_AT = "dalm_tpu/kernels/int8_matmul.py:72"
K1_AT = "dalm_tpu/kernels/int8_matmul.py:194"
DOT_AT = "dalm_tpu/kernels/int8_matmul.py:237"


def k2_phase(gen, device, peaks):
    """K2 against ``rowquant_ref``: q and s must be EQUAL (tolerance 0; the
    kernel divides and rounds as the plain version does), in both output types
    (int8, and bf16 as K5's fold route takes it). R = 4608 rows,
    K in {4096, 11008, 32000}, bf16 and f32, with and without the column
    scale; row 0 all zero, row 1 made of exact .5 ties. Timed (bf16, column
    scale) by CUDA graph over copies larger than the L2, and again at decode's
    32 rows. Returns (all records, the record at the main path's commonest
    shape)."""
    import torch

    from dalm_tpu_torch.kernels.int8_matmul import rowquant, rowquant_ref

    R = M_TRAIN
    entries, main_entry = [], None
    for K in (4096, 11008, 32000):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((R, K), generator=gen, device=device).to(dtype)
            x[0] = 0
            ties = torch.randint(-126, 127, (K,), generator=gen, device=device).float() + 0.5
            ties[0] = 127.0  # absmax 127 -> s = 1 -> every other x / s ends in .5
            x[1] = ties.to(dtype)
            cs = torch.rand((1, K), generator=gen, device=device) * 0.01 + 1e-4
            for colscale in (None, cs):
                q, s = rowquant(x, None if colscale is None else colscale.reshape(-1))
                qb, sb = rowquant(x, None if colscale is None else colscale.reshape(-1), dtype=torch.bfloat16)
                rq, rs = rowquant_ref(x, colscale)
                torch.cuda.synchronize()
                label = f"R={R} K={K} {str(dtype).split('.')[-1]}{' colscale' if colscale is not None else ''}"
                check(torch.equal(s, rs) and torch.equal(sb, rs), f"k2 {label}: scales differ from the plain version")
                check(torch.equal(q, rq), f"k2 {label}: q differs from the plain version")
                check(qb.dtype == torch.bfloat16 and torch.equal(qb, rq.to(torch.bfloat16)),
                      f"k2 {label}: the bf16 output differs from the plain version's values")
                if colscale is None:
                    check(float(s[0]) == 1.0 and not bool(q[0].any()), f"k2 {label}: zero row")
                    check(float(s[1]) == 1.0, f"k2 {label}: tie row scale")
                    want = torch.round(ties).clamp(-127, 127).to(torch.int8)
                    check(torch.equal(q[1], want), f"k2 {label}: ties must round half to even")
            if dtype != torch.bfloat16:
                continue
            csf = cs.reshape(-1).contiguous()
            ms, turns = k2_graph_ms(x, csf)
            plain_ms = cuda_ms(lambda: rowquant_ref(x, cs), 5)

            def library():
                xf = x.float() * cs
                sc = xf.abs().amax(-1, keepdim=True) / 127.0
                return torch.round(xf / sc).clamp(-127, 127).to(torch.int8), sc

            lib_ms = cuda_ms(library, 5)
            nbytes = R * K * 2 + K * 4 + R * K + R * 4
            e = i8_record("rowquant", K2_AT, f"R={R} K={K} bf16 colscale", ms, plain_ms, lib_ms, 0.0,
                          nbytes, 4.0 * R * K, peaks, K=K, ms_turns=turns,
                          wrapper_ms=cuda_ms(lambda: rowquant(x, csf), 20))
            show("k2", e, share=True)
            entries.append(e)
            if K == 4096:
                main_entry = e
            del x
    # decode's shape: K2 before K5's i8mxu / pcol instances, 32 rows, no column scale (the launch floor)
    for K in (4096, 11008):
        x = torch.randn((32, K), generator=gen, device=device).to(torch.bfloat16)
        q, s = rowquant(x)
        rq, rs = rowquant_ref(x)
        torch.cuda.synchronize()
        check(torch.equal(q, rq) and torch.equal(s, rs), f"k2 R=32 K={K}: differs from the plain version")
        ms, turns = k2_graph_ms(x, None)
        e = i8_record("rowquant", K2_AT, f"R=32 K={K} bf16", ms, cuda_ms(lambda: rowquant_ref(x), 20), None, 0.0,
                      32 * K * 3 + 32 * 4, 4.0 * 32 * K, peaks, K=K, ms_turns=turns,
                      wrapper_ms=cuda_ms(lambda: rowquant(x), 50))
        show("k2", e, share=True)
        entries.append(e)
    torch.cuda.empty_cache()
    return entries, main_entry


def k2_graph_ms(x, colscale):
    """K2's device time, by CUDA graph over copies of x (and of its outputs) that together exceed the L2 twice:
    each launch reads its x from device memory, as the train step's does. Two turns; returns (mean, turns)."""
    import torch

    from dalm_tpu_torch.kernels.int8_matmul import launch_rowquant

    per_call = x.numel() * (x.element_size() + 1)
    copies = [x] + [x.clone() for _ in range(-(-100_000_000 // per_call))]
    outs = [(torch.empty(c.shape, dtype=torch.int8, device=c.device),
             torch.empty(c.shape[:-1] + (1,), dtype=torch.float32, device=c.device)) for c in copies]
    fns = [lambda c=c, o=o: launch_rowquant(c, colscale, *o) for c, o in zip(copies, outs)]
    turns = [graph_ms(fns), graph_ms(fns)]
    return sum(turns) / 2, turns


def _weights(gen, device, K, N):
    import torch

    q = torch.randint(-127, 128, (K, N), generator=gen, device=device, dtype=torch.int8)
    scale = torch.rand((1, N), generator=gen, device=device) * 1e-3 + 1e-4
    return q, scale


def k1_phase(gen, device, peaks):
    """K1 and the two int8 GEMM entries against their plain versions at the
    Llama-7B shapes, M = 4608. K1 on integer-valued and on real-valued
    activations, bf16 and f32: equal (tolerance 0; the route keeps the plain
    version's order of operations and roundings). Each of K1's three launches
    alone: the quantise pre-pass, the weight pre-pass and the GEMM equal to
    their plain versions, timed beside their bounds. The GEMM entries are
    integer arithmetic: equal. One shape the feasibility rule rejects goes
    through ``int8_matmul`` (K2 + GEMM)."""
    import torch

    from dalm_tpu_torch.kernels import int8_matmul as im

    M = M_TRAIN
    mem_bw, op_rate = peaks[0], peaks[3]
    entries, mains = [], {}
    for K, N in LLAMA_KN:
        check(im.w8a8_fused_feasible(M, K, N), f"({M},{K},{N}) should take the fused form")
        q, scale = _weights(gen, device, K, N)
        xi = torch.randint(-8, 9, (M, K), generator=gen, device=device).to(torch.bfloat16)
        check(torch.equal(im.w8a8_fused(xi, q, scale), im.w8a8_fused_ref(xi, q, scale)),
              f"k1 ({K},{N}): kernel != plain version on integer-valued inputs")
        x = (torch.randn((M, K), generator=gen, device=device) * 0.5).to(torch.bfloat16)
        x[0] = 0
        y, ry = im.w8a8_fused(x, q, scale), im.w8a8_fused_ref(x, q, scale)
        torch.cuda.synchronize()
        max_err = float((y.float() - ry.float()).abs().max())
        check(torch.equal(y, ry), f"k1 ({K},{N}) bf16: kernel != plain version (max_abs_err {max_err})")
        xf = x.float()
        check(torch.equal(im.w8a8_fused(xf, q, scale), im.w8a8_fused_ref(xf, q, scale)),
              f"k1 ({K},{N}) f32: kernel != plain version")
        del xf, y, ry

        # The route's three launches, each alone on operands prepared once.
        bk = im.fit_div(K, 512)
        xq = torch.empty((M, K), dtype=torch.int8, device=device)
        xs = torch.empty((M, K // bk), dtype=torch.float32, device=device)
        qt = torch.empty((N, K), dtype=torch.int8, device=device)
        out = torch.empty((M, N), dtype=torch.bfloat16, device=device)
        im._launch_quant(x, bk, xq, xs)
        im._launch_transpose(q, qt)
        im._launch_fold(xq, xs, qt, scale, out)
        rq, rs = im.quant_prepass_ref(x, bk)
        torch.cuda.synchronize()
        check(torch.equal(xq, rq) and torch.equal(xs, rs), f"k1 ({K},{N}): quantise pre-pass != plain version")
        check(torch.equal(qt, im.weight_prepass_ref(q)), f"k1 ({K},{N}): weight pre-pass != q.T")
        check(torch.equal(out, im.fold_gemm_ref(xq, xs, qt, scale, torch.bfloat16)), f"k1 ({K},{N}): GEMM != plain")
        del rq, rs
        quant_ms = cuda_ms(lambda: im._launch_quant(x, bk, xq, xs), 20)
        weight_ms = cuda_ms(lambda: im._launch_transpose(q, qt), 20)
        gemm_ms = cuda_ms(lambda: im._launch_fold(xq, xs, qt, scale, out), 20)
        quant_plain = cuda_ms(lambda: im.quant_prepass_ref(x, bk), 5)
        weight_plain = cuda_ms(lambda: im.weight_prepass_ref(q), 5)
        weight_lib = cuda_ms(lambda: q.t().contiguous(), 20)
        gemm_plain = cuda_ms(lambda: im.fold_gemm_ref(xq, xs, qt, scale, torch.bfloat16), 2)

        ms = cuda_ms(lambda: im.w8a8_fused(x, q, scale), 20)
        plain_ms = cuda_ms(lambda: im.w8a8_fused_ref(x, q, scale), 2)

        def lib_q():
            xf = x.float()
            sc = xf.abs().amax(-1, keepdim=True) / 127.0
            return torch.round(xf / sc).clamp(-127, 127).to(torch.int8), sc

        def library():
            xq, sc = lib_q()
            return (torch._int_mm(xq, q).float() * sc * scale).to(x.dtype)

        lib_ms = cuda_ms(library, 5)
        wd = (q.float() * scale).to(torch.bfloat16)
        deq_ms = cuda_ms(lambda: x @ wd, 20)
        del wd
        ops = 2.0 * M * K * N
        case = f"M={M} K={K} N={N} bf16"
        parts = [
            i8_record("k1_quant_prepass", K1_AT, case, quant_ms, quant_plain, None, 0.0,
                      M * K * 2 + M * K + M * (K // bk) * 4, 4.0 * M * K, peaks, KN=[K, N],
                      library_is="none: no one PyTorch call quantises per (row, k-block)"),
            i8_record("k1_weight_prepass", K1_AT, f"K={K} N={N}", weight_ms, weight_plain, weight_lib, 0.0,
                      2 * K * N, 0.0, peaks, KN=[K, N], library_is="q.t().contiguous()"),
            i8_record("k1_gemm", K1_AT, case, gemm_ms, gemm_plain, None, 0.0,
                      M * K + N * K + M * (K // bk) * 4 + N * 4 + M * N * 2, ops, peaks, KN=[K, N],
                      tops=ops / gemm_ms * 1e-9,
                      library_is="none: torch._int_mm gives the int32 product of all of K, not the k-block fold"),
        ]
        nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
        e = i8_record("w8a8_fused", K1_AT, case, ms, plain_ms, lib_ms, max_err, nbytes, ops, peaks, KN=[K, N],
                      bf16_dequant_matmul_ms=deq_ms, tops=ops / ms * 1e-9,
                      library_is="rowquant in PyTorch + torch._int_mm + rescale (one K-block)")
        for r in parts:
            print(f"[k1]   {r['name']} {r['case']}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"plain {r['plain_ms']:.4f} ms" + (f", {r['library_is']} {r['library_ms']:.4f} ms"
                                                     if r["library_ms"] is not None else ""), flush=True)
        print(f"[k1] w8a8_fused {case}: route {ms:.4f} ms = {e['tops']:.1f} TOP/s (quantise {quant_ms:.4f} + "
              f"weight {weight_ms:.4f} + GEMM {gemm_ms:.4f} ms = {parts[2]['tops']:.1f} TOP/s), bound "
              f"{e['bound_ms']:.4f} ms; yardsticks: x @ dequant(W) in bf16 {deq_ms:.4f} ms (route {ms / deq_ms:.2f}x), "
              f"torch._int_mm form {lib_ms:.4f} ms; plain {plain_ms:.4f} ms; equal to the plain version in bf16 "
              f"and f32", flush=True)
        entries.extend([e, *parts])
        if (K, N) == (4096, 4096):
            mains["w8a8_fused"] = e
            mains.update({r["name"]: r for r in parts})
        del xq, xs, qt, out

        # The GEMM entries on int8 operands.
        a = torch.randint(-127, 128, (M, K), generator=gen, device=device, dtype=torch.int8)
        check(torch.equal(im.int8_gemm_kn(a, q), im.int8_gemm_kn_ref(a, q)), f"gemm_kn ({K},{N}) != plain")
        ms = cuda_ms(lambda: im.int8_gemm_kn(a, q), 10)
        plain_ms = cuda_ms(lambda: im.int8_gemm_kn_ref(a, q), 2)
        lib_ms = cuda_ms(lambda: torch._int_mm(a, q), 10)
        e = i8_record("int8_gemm_kn", DOT_AT, f"M={M} K={K} N={N}", ms, plain_ms, lib_ms, 0.0,
                      M * K + K * N + M * N * 4, 2.0 * M * K * N, peaks, KN=[K, N])
        show("k1", e)
        entries.append(e)
        if (K, N) == (4096, 4096):
            mains["int8_gemm_kn"] = e
        d = torch.randint(-127, 128, (M, N), generator=gen, device=device, dtype=torch.int8)
        check(torch.equal(im.int8_gemm_nt(d, q), im.int8_gemm_nt_ref(d, q)), f"gemm_nt ({K},{N}) != plain")
        ms = cuda_ms(lambda: im.int8_gemm_nt(d, q), 10)
        plain_ms = cuda_ms(lambda: im.int8_gemm_nt_ref(d, q), 2)
        lib_ms = cuda_ms(lambda: torch._int_mm(d, q.T), 10)
        e = i8_record("int8_gemm_nt", DOT_AT, f"M={M} C={N} N={K} (dx of K={K} N={N})", ms, plain_ms, lib_ms, 0.0,
                      M * N + K * N + M * K * 4, 2.0 * M * K * N, peaks, KN=[K, N], tops=2.0 * M * K * N / ms * 1e-9)
        show("k1", e)
        print(f"[k1]   int8_gemm_nt {e['tops']:.1f} TOP/s, {ms / lib_ms:.2f}x torch._int_mm(d, q.T)", flush=True)
        entries.append(e)
        if (K, N) == (4096, 4096):
            mains["int8_gemm_nt"] = e
        del a, d, x, xi, q, scale
        torch.cuda.empty_cache()

    # A shape the feasibility rule rejects (K = 4160 has no k-block that is a
    # multiple of 128): int8_matmul takes K2 + the GEMM, edges guarded.
    M2, K2, N2 = 1000, 4160, 1028
    check(not im.w8a8_fused_feasible(M2, K2, N2), "the rejected shape is feasible")
    q, scale = _weights(gen, device, K2, N2)
    x = (torch.randn((M2, K2), generator=gen, device=device) * 0.5).to(torch.bfloat16)
    before = (im.rowquant.launches, im.int8_gemm_kn.launches, im.w8a8_fused.launches)
    y = im.int8_matmul(x, q, scale)
    after = (im.rowquant.launches, im.int8_gemm_kn.launches, im.w8a8_fused.launches)
    check(after == (before[0] + 1, before[1] + 1, before[2]), "a rejected shape must take K2 + GEMM")
    check(torch.equal(y, im.int8_matmul_ref(x, q, scale)), "unfused forward != plain version")
    print(f"[k1] rejected shape M={M2} K={K2} N={N2}: K2 + int8_gemm_kn equal to the plain version", flush=True)
    torch.cuda.empty_cache()
    return entries, mains


CAL_AT = "dalm_tpu/kernels/int8_matmul.py:326"  # xq = clip(round(x / a_scale)) in _int8_matmul_cal_fwd
CAL_DY_AT = "dalm_tpu/kernels/int8_matmul.py:389"  # dq = clip(round(dy * scale / dy_scale)), + max |dy * scale|


def cal_graph_ms(x, s, colscale, plain=False):
    """The calibrated quantiser's device time (or, with ``plain``, the plain expression's), by CUDA graph over
    copies of x (and of its outputs) that together exceed the L2 twice. Two turns; returns (mean, turns)."""
    import torch

    from dalm_tpu_torch.kernels import int8_matmul as im

    per_call = x.numel() * (x.element_size() + 1)
    copies = [x] + [x.clone() for _ in range(-(-100_000_000 // per_call))]
    outs = [torch.empty(c.shape, dtype=torch.int8, device=c.device) for c in copies]
    amax = torch.zeros((), dtype=torch.float32, device=x.device) if colscale is not None else None
    if plain:
        fns = [lambda c=c: im.cal_quant_ref(c, s, colscale, colscale is not None) for c in copies]
    else:
        fns = [lambda c=c, o=o: im.launch_cal_quant(c, s, colscale, o, amax) for c, o in zip(copies, outs)]
    turns = [graph_ms(fns), graph_ms(fns)]
    return sum(turns) / 2, turns


def k1_cal_phase(gen, device, peaks):
    """The calibrated-scale quantiser against its plain version at the train shapes, M = 4608 bf16 rows of K =
    4096 and 11008, in both modes (the forward's x / a_scale; the backward's dy * scale / dy_scale with max |dy *
    scale|): EQUAL (tolerance 0: true division, round half to even, the clip), with values that clip (a scale
    at 0.6 of the absmax), in f32 too, and on a zero tensor. Timed by CUDA graph over copies larger than the L2
    beside its byte bound and the plain expression. Then the calibrated forward route (quantiser, weight
    pre-pass, scaled GEMM) at the Llama shapes, equal to ``int8_matmul_cal_ref``'s forward, timed beside K1's
    three launches and ``x @ dequant(W)``. Returns (cases, the kernels-line entries by name)."""
    import torch

    from dalm_tpu_torch.kernels import int8_matmul as im

    M = M_TRAIN
    cases, mains = [], {}
    for K in (4096, 11008):
        x = (torch.randn((M, K), generator=gen, device=device) * 2).to(torch.bfloat16)
        cs = torch.rand(K, generator=gen, device=device) * 1e-3 + 1e-4
        s = (x.float().abs().amax() / 127 * 0.6).reshape(1)
        s_dy = (x.float().abs().amax() * cs.max() / 127 * 0.6).reshape(1)
        for mode, scale, col in (("x", s, None), ("dy", s_dy, cs)):
            q, a = im.cal_quant(x, scale, col, want_amax=col is not None)
            rq, ra = im.cal_quant_ref(x, scale, col, want_amax=col is not None)
            torch.cuda.synchronize()
            clipped = int((rq.abs() == 127).sum())
            check(torch.equal(q, rq) and (a is None or torch.equal(a, ra)) and clipped > 0,
                  f"k1_cal_quant[{mode}] K={K}: kernel != plain version (or nothing clipped)")
            xf = x.float()
            q32, a32 = im.cal_quant(xf, scale, col, want_amax=col is not None)
            r32, ra32 = im.cal_quant_ref(xf, scale, col, want_amax=col is not None)
            check(torch.equal(q32, r32) and (a32 is None or torch.equal(a32, ra32)),
                  f"k1_cal_quant[{mode}] K={K} f32: kernel != plain version")
            z, za = im.cal_quant(torch.zeros_like(x), scale, col, want_amax=col is not None)
            check(not z.any() and (za is None or float(za) == 0.0), f"k1_cal_quant[{mode}]: zero tensor")
            del xf, q32, r32, z
            ms, turns = cal_graph_ms(x, scale, col)
            lib_ms, _ = cal_graph_ms(x, scale, col, plain=True)
            plain_ms = cuda_ms(lambda: im.cal_quant_ref(x, scale, col, col is not None), 5)
            nbytes = M * K * 2 + M * K + 4 + (K * 4 + 4 if col is not None else 0)
            ops = (4.0 if col is not None else 3.0) * M * K
            t_bytes, t_ops = nbytes / peaks[0] * 1e3, ops / peaks[1] * 1e3
            name = "k1_cal_quant" if mode == "x" else "k1_cal_quant[dy]"
            e = {"name": name, "route": "cuda", "source": "dalm_tpu_torch/csrc/int8_matmul.cu",
                 "replaces": CAL_AT if mode == "x" else CAL_DY_AT,
                 "case": f"M={M} K={K} bf16" + (" colscale amax" if col is not None else ""),
                 "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": lib_ms,
                 "library_is": "the plain expression, by CUDA graph over the same copies", "turns": turns,
                 "clipped": clipped}
            show("k1", e, share=True)
            cases.append(e)
            if K == 4096:
                mains[name] = e
        del x, cs
    # The calibrated forward route against K1 and x @ dequant(W).
    for K, N in LLAMA_KN[:3]:
        q, scale = _weights(gen, device, K, N)
        x = (torch.randn((M, K), generator=gen, device=device) * 0.5).to(torch.bfloat16)
        a = (x.float().abs().amax() / 127).reshape(())
        with torch.no_grad():
            y = im.int8_matmul_cal(x, q, scale, a)
            check(torch.equal(y, im.int8_matmul_cal_ref(x, q, scale, a)), f"calibrated route ({K},{N}) != plain")
            route_ms = cuda_ms(lambda: im.int8_matmul_cal(x, q, scale, a), 20)
            k1_ms = cuda_ms(lambda: im.w8a8_fused(x, q, scale), 20)
            xq, _ = im.cal_quant(x, a.reshape(1))
            qt = im.weight_prepass(q)
            xs = a.reshape(1, 1).expand(M, 1).contiguous()
            out = torch.empty((M, N), dtype=torch.bfloat16, device=device)
            gemm_ms = cuda_ms(lambda: im.launch_gemm_scaled(xq, qt, xs, scale.reshape(-1), out), 20)
            wd = (q.float() * scale).to(torch.bfloat16)
            deq_ms = cuda_ms(lambda: x @ wd, 20)
        ops = 2.0 * M * K * N
        print(f"[k1] calibrated route M={M} K={K} N={N} bf16: {route_ms:.4f} ms (scaled GEMM alone {gemm_ms:.4f} ms "
              f"= {ops / gemm_ms * 1e-9:.1f} TOP/s), K1's three launches {k1_ms:.4f} ms, x @ dequant(W) {deq_ms:.4f} ms; "
              f"equal to int8_matmul_cal_ref", flush=True)
        cases.append({"name": "int8_matmul_cal", "case": f"M={M} K={K} N={N} bf16", "ms": route_ms,
                      "scaled_gemm_ms": gemm_ms, "w8a8_fused_ms": k1_ms, "bf16_dequant_matmul_ms": deq_ms})
        del q, scale, x, y, xq, qt, xs, out, wd
    torch.cuda.empty_cache()
    return cases, mains


def grad_phase(gen, device):
    """``int8_matmul`` forward and backward on the card against the plain
    version's autograd, ``bwd_int8`` both ways: equal (tolerance 0; the int8
    backward is K2 + integer GEMM + the same f32 rescale)."""
    import torch

    from dalm_tpu_torch.kernels import int8_matmul as im

    for K, N in ((4096, 11008), (4160, 1040)):  # the second takes K2 + GEMM forward
        q, scale = _weights(gen, device, K, N)
        x0 = (torch.randn((2, 1152, K), generator=gen, device=device) * 0.5).to(torch.bfloat16)
        g = torch.randn((2, 1152, N), generator=gen, device=device).to(torch.bfloat16)
        for bwd_int8 in (False, True):
            outs = []
            for fn in (im.int8_matmul, im.int8_matmul_ref):
                x = x0.clone().requires_grad_()
                y = fn(x, q, scale, bwd_int8)
                y.backward(g)
                outs.append((y.detach(), x.grad))
            torch.cuda.synchronize()
            check(torch.equal(outs[0][0], outs[1][0]), f"grad ({K},{N}) bwd_int8={bwd_int8}: forward differs")
            check(torch.equal(outs[0][1], outs[1][1]), f"grad ({K},{N}) bwd_int8={bwd_int8}: dx differs")
            check(bool(torch.isfinite(outs[0][1]).all()) and float(outs[0][1].abs().max()) > 0, "dx is empty")
    print("[grad] int8_matmul forward and dx equal to the plain version's autograd, bwd_int8 False and True",
          flush=True)
    torch.cuda.empty_cache()



K4_AT = {"k4_fwd_wgmma": "dalm_tpu/kernels/flash_attention.py:221", "k4_fwd": "dalm_tpu/kernels/flash_attention.py:221",
         "k4_bwd_dq_wgmma": "dalm_tpu/kernels/flash_attention.py:443",
         "k4_bwd_dkv_wgmma": "dalm_tpu/kernels/flash_attention.py:461",
         "k4_bwd_dq": "dalm_tpu/kernels/flash_attention.py:443", "k4_bwd_dkv": "dalm_tpu/kernels/flash_attention.py:461",
         "k4_dsum": "dalm_tpu/kernels/flash_attention.py:390"}
# Each K4 kernel by its entry in the kernels line: C entry point, source, and the counter it moves. The forward
# and the backward each have two routes (kernels/flash_attention.py:fwd_route); the dsum pre-pass serves both.
K4_ENTRY = {"k4_fwd_wgmma": ("dalm_fa_fwd_wgmma", "dalm_tpu_torch/csrc/flash_fwd_wgmma.cu", "fwd"),
            "k4_fwd": ("dalm_fa_fwd", "dalm_tpu_torch/csrc/flash_attention.cu", "fwd"),
            "k4_bwd_dq_wgmma": ("dalm_fa_bwd_dq_wgmma", "dalm_tpu_torch/csrc/flash_bwd_wgmma.cu", "dq"),
            "k4_bwd_dkv_wgmma": ("dalm_fa_bwd_dkv_wgmma", "dalm_tpu_torch/csrc/flash_bwd_wgmma.cu", "dkv"),
            "k4_bwd_dq": ("dalm_fa_bwd_dq", "dalm_tpu_torch/csrc/flash_attention.cu", "dq"),
            "k4_bwd_dkv": ("dalm_fa_bwd_dkv", "dalm_tpu_torch/csrc/flash_attention.cu", "dkv"),
            "k4_dsum": ("dalm_fa_dsum", "dalm_tpu_torch/csrc/flash_bwd_wgmma.cu", "dsum")}
K4_FWD = ("k4_fwd_wgmma", "k4_fwd")
# name, B, H, Hk, Sq, Sk, D, then keyword options of the kernel and "seg": None | "pad" | "packed"
K4_CASES = (
    ("causal", 2, 4, 4, 256, 256, 64, dict()),
    ("non-causal", 2, 4, 4, 256, 256, 64, dict(causal=False)),
    ("segments + pad segment", 2, 4, 4, 384, 384, 64, dict(seg="pad")),
    ("packed segments, non-causal", 2, 4, 4, 256, 256, 64, dict(seg="packed", causal=False)),
    ("gqa 8/2", 2, 8, 2, 256, 256, 64, dict()),
    ("gqa 8/2 + segments", 2, 8, 2, 256, 256, 64, dict(seg="packed")),
    ("window 128", 1, 4, 4, 384, 384, 64, dict(window=128)),
    ("window 200", 1, 4, 4, 384, 384, 64, dict(window=200)),
    ("softcap 2", 2, 4, 4, 256, 256, 64, dict(softcap=2.0)),
    ("softcap 2 + window 100", 1, 4, 4, 384, 384, 64, dict(softcap=2.0, window=100)),
    ("q_offset 128, Sq 128 Sk 256", 2, 4, 4, 128, 256, 64, dict(q_offset=128)),
    ("q_offset -128, Sq 256 Sk 384 (rows 0..127 see nothing)", 2, 4, 4, 256, 384, 64, dict(q_offset=-128)),
    ("q_offset -128, Sq 128 Sk 128 (every row masked)", 2, 4, 2, 128, 128, 64, dict(q_offset=-128)),
    ("D 32", 2, 2, 2, 256, 256, 32, dict(seg="pad")),
    ("D 128", 2, 4, 2, 256, 256, 128, dict(seg="pad")),
    ("D 48, ragged Sq 200 Sk 333", 2, 4, 2, 200, 333, 48, dict(q_offset=133)),
    ("the SFT length: S 2560, D 128, 40 k tiles a row", 1, 2, 2, 2560, 2560, 128, dict(seg="pad")),
    ("D 128, window 200", 1, 4, 4, 384, 384, 128, dict(window=200)),
    ("D 128, softcap 2 + window 100", 1, 4, 4, 384, 384, 128, dict(softcap=2.0, window=100)),
    ("D 128, gqa 32/8", 1, 32, 8, 256, 256, 128, dict()),
    ("D 128, ragged Sq 200 Sk 333", 2, 4, 2, 200, 333, 128, dict(q_offset=133)),
    ("D 128, q_offset -128, Sq 128 Sk 128 (every row masked)", 2, 4, 2, 128, 128, 128, dict(q_offset=-128)),
    ("D 256, gqa 8/4, packed segments, window 100, softcap 50", 1, 8, 4, 384, 384, 256,
     dict(seg="packed", window=100, softcap=50.0)),
    ("D 256, ragged Sq 200 Sk 333", 2, 4, 2, 200, 333, 256, dict(q_offset=133)),
)
# Tolerances, row by row: |kernel - plain| <= tol * max(max |plain| over the row, K4_FLOOR), a row being
# the D values of one (batch, head, position); an lse value is a row of its own with floor 1. Scaling by
# the row and not by the tensor keeps the bound tight where it matters: at S = 2560 the first rows of
# out are O(1) (row 0 is v[0]) while late rows, averages over hundreds of keys, are ~0.05, and a fault
# in a late k tile shows only there.
# float32: both sum in f32 but in another order (the kernel tile by tile with a running maximum), and
# expf / tanhf differ from PyTorch's by an ulp or two: 2e-5 forward, 2e-4 gradients (sums over up to
# 2560 keys of O(1) terms, and dp - dsum cancels).
# bfloat16: the plain version makes the same casts, but rounds p against the row's final maximum where
# the kernel rounds it against the running one and rescales in f32, so single products differ by a
# bf16 ulp (2^-8 relative) and the outputs are themselves rounded to bf16: 2e-2 of the row's largest
# value, forward and gradients; lse stays in f32 on exact bf16 products: 1e-4.
K4_TOL = {"float32": dict(out=2e-5, lse=2e-5, grad=2e-4), "bfloat16": dict(out=2e-2, lse=1e-4, grad=2e-2)}
K4_FLOOR = 0.02
K4_SHARE = [0.0]  # the largest error / bound seen by k4_err since it was last set to 0


def k4_inputs(gen, device, dtype, B, H, Hk, Sq, Sk, D, seg):
    """q, k, v, do as (B, H, S, D) views of (B, S, H, D) storage (the layout the
    decoder hands over) and segment ids: "pad" = a real segment then a pad
    segment 0 of per-row length, "packed" = sorted ids in 0..2."""
    import torch

    def mk(S, heads):
        return torch.randn((B, S, heads, D), generator=gen, device=device).to(dtype).transpose(1, 2)

    q, k, v, do = mk(Sq, H), mk(Sk, Hk), mk(Sk, Hk), mk(Sq, H)
    seg_q = seg_k = None
    if seg == "pad":
        n_real = torch.randint(Sq // 3, Sq - 8, (B, 1), generator=gen, device=device)
        seg_q = (torch.arange(Sq, device=device)[None, :] < n_real).to(torch.int32)
        seg_k = (torch.arange(Sk, device=device)[None, :] < n_real).to(torch.int32)
    elif seg == "packed":
        seg_k = torch.sort(torch.randint(0, 3, (B, Sk), generator=gen, device=device), dim=1).values.to(torch.int32)
        seg_q = seg_k[:, :Sq].contiguous() if Sq <= Sk else None
    return q, k, v, do, seg_q, seg_k


def k4_ops_bytes(B, H, Hk, Sq, Sk, D, esize, q_offset, causal, vis=None):
    """The work the kernels NEED on these inputs: the visible share of the (Sq, Sk) scores times
    2 Sq Sk D per product (forward 2 products, either route; dq 3: s, dp, dq; dk/dv 4: s, dp, dv, dk),
    and each input read and output written once; dsum 2 D f32 operations a row (CUDA cores) against do
    and out read and dsum written. ``vis``: the visible share where segments or a window set it (else the
    causal triangle's)."""
    if vis is None:
        vis = 1.0
        if causal:
            rows = [min(max(q_offset + i + 1, 0), Sk) for i in range(Sq)]
            vis = sum(rows) / float(Sq * Sk)
    prod = 2.0 * B * H * Sq * Sk * D * vis
    qb, kb, stat = B * H * Sq * D * esize, B * Hk * Sk * D * esize, B * H * Sq * 4
    fwd = (2 * prod, 2 * qb + 2 * kb + stat)
    dq, dkv = (3 * prod, 3 * qb + 2 * kb + 2 * stat), (4 * prod, 2 * qb + 4 * kb + 2 * stat)
    return {"k4_fwd_wgmma": fwd, "k4_fwd": fwd, "k4_bwd_dq_wgmma": dq, "k4_bwd_dq": dq,
            "k4_bwd_dkv_wgmma": dkv, "k4_bwd_dkv": dkv, "k4_dsum": (2.0 * B * H * Sq * D, 2 * qb + stat)}


def k4_time(gen, device, peaks, B, S, label, iters):
    """Times of the kernels at (B, H = 32, S, D = 128), bf16, causal, all tokens in one segment (what a
    packed SFT block gives). The forward and the backward's dq and dk/dv each on both routes, launched
    through their C entry points on one argument block per route and timed in turns (wgmma, mma.sync,
    mma.sync, wgmma); the dsum pre-pass against the PyTorch expression it replaced; beside them the plain
    versions, one library call (SDPA's forward, SDPA's backward for all three gradients) and the bound.
    Every kernel is held against the plain version here."""
    import torch
    import torch.nn.functional as F

    from dalm_tpu_torch.kernels import flash_attention as fa

    H = Hk = 32
    D = 128
    q, k, v, do, _, _ = k4_inputs(gen, device, torch.bfloat16, B, H, Hk, S, S, D, None)
    seg = torch.ones((B, S), dtype=torch.int32, device=device)
    kw = dict(causal=True, scale=1.0 / D ** 0.5)
    check(fa.fwd_route(q.dtype, D) == "wgmma", "k4: bf16 at D 128 must take the wgmma route")
    dims = fa._check("time", q, k, v, seg, seg, None, None)

    def block(**tensors):
        return fa._args(q, k, v, seg, seg, True, kw["scale"], 0, None, None, dims, **tensors)

    out, lse = fa.flash_fwd(q, k, v, seg, seg, **kw)
    ro, rl = fa.flash_fwd_ref(q, k, v, seg, seg, **kw)
    mma_out, mma_lse = torch.empty_like(out), torch.empty_like(lse)
    blocks = {"k4_fwd_wgmma": block(out=out, lse=lse), "k4_fwd": block(out=mma_out, lse=mma_lse)}
    fa._launch("dalm_fa_fwd", "fwd", blocks["k4_fwd"], q)
    before = dict(fa.flash_bwd.routes)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, seg, seg, **kw)
    check(fa.flash_bwd.routes == dict(before, wgmma=before["wgmma"] + 1), "k4: the backward did not take wgmma")
    # the mma.sync pair on its own outputs, after its own dsum pre-pass
    dsum = torch.empty_like(lse)
    mq, mk, mv = torch.empty_like(dq), torch.empty_like(dk), torch.empty_like(dv)
    wg = dict(out=out, dout=do, lse=lse, dsum=dsum)
    mma_b = block(dq=mq, dk=mk, dv=mv, **wg)
    for name in ("k4_dsum", "k4_bwd_dq", "k4_bwd_dkv"):
        fa._launch(K4_ENTRY[name][0], K4_ENTRY[name][2], mma_b, q)
    rq, rk, rv = fa.flash_bwd_ref(q, k, v, out, lse, do, seg, seg, **kw)
    rsum = fa.dsum_ref(do, out)
    torch.cuda.synchronize()
    tol = K4_TOL["bfloat16"]
    K4_SHARE[0] = 0.0
    sum_err = (dsum - rsum).abs()
    check(bool((sum_err <= 1e-5 * (do.float() * out.float()).abs().sum(dim=-1)).all()),
          f"k4 {label}: the dsum pre-pass is more than 1e-5 of its row's sum of |do out| from the plain version")
    errs = {"k4_fwd_wgmma": max(k4_err(out, ro, tol["out"], f"{label} out"),
                                k4_err(lse, rl, tol["lse"], f"{label} lse")),
            "k4_fwd": max(k4_err(mma_out, ro, tol["out"], f"{label} mma.sync out"),
                          k4_err(mma_lse, rl, tol["lse"], f"{label} mma.sync lse")),
            "k4_bwd_dq_wgmma": k4_err(dq, rq, tol["grad"], f"{label} dq"),
            "k4_bwd_dkv_wgmma": max(k4_err(dk, rk, tol["grad"], f"{label} dk"),
                                    k4_err(dv, rv, tol["grad"], f"{label} dv")),
            "k4_bwd_dq": k4_err(mq, rq, tol["grad"], f"{label} mma.sync dq"),
            "k4_bwd_dkv": max(k4_err(mk, rk, tol["grad"], f"{label} mma.sync dk"),
                              k4_err(mv, rv, tol["grad"], f"{label} mma.sync dv")),
            "k4_dsum": float(sum_err.max())}
    share = K4_SHARE[0]
    del ro, rl, rq, rk, rv, rsum

    blocks.update({"k4_bwd_dq_wgmma": block(dq=dq, dk=dk, dv=dv, **wg), "k4_bwd_dq": mma_b, "k4_bwd_dkv": mma_b})
    blocks["k4_bwd_dkv_wgmma"] = blocks["k4_bwd_dq_wgmma"]
    turns = {}
    for pair in (("k4_fwd_wgmma", "k4_fwd"), ("k4_bwd_dq_wgmma", "k4_bwd_dq"), ("k4_bwd_dkv_wgmma", "k4_bwd_dkv")):
        for name in (pair[0], pair[1], pair[1], pair[0]):
            entry, _, counter = K4_ENTRY[name]
            a = blocks[name]
            turns.setdefault(name, []).append(cuda_ms(lambda: fa._launch(entry, counter, a, q), iters))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    ms["k4_dsum"] = cuda_ms(lambda: fa._launch("dalm_fa_dsum", "dsum", mma_b, q), iters)
    plain_dsum = cuda_ms(lambda: fa.dsum_ref(do, out), iters)
    lib_dsum = cuda_ms(lambda: (do.float() * out.float()).sum(dim=-1), iters)
    plain_f = cuda_ms(lambda: fa.flash_fwd_ref(q, k, v, seg, seg, **kw), 2)
    plain_b = cuda_ms(lambda: fa.flash_bwd_ref(q, k, v, out, lse, do, seg, seg, **kw), 2)

    # The library's backward alone: the graph is built once, outside the timed region, and kept.
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_f = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), iters)
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_b = cuda_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True), iters)
    del lib_out
    work = k4_ops_bytes(B, H, Hk, S, S, D, 2, 0, True)
    entries = {}
    for name in K4_ENTRY:
        ops, nbytes = work[name]
        t_ops = ops / (peaks[1] if name == "k4_dsum" else peaks[2]) * 1e3
        t_bytes = nbytes / peaks[0] * 1e3
        fwd = name in K4_FWD
        entries[name] = {
            "name": name, "route": "cuda", "source": K4_ENTRY[name][1], "replaces": K4_AT[name], "case": label,
            "max_abs_err": errs[name], "ms": ms[name],
            "plain_ms": plain_f if fwd else plain_dsum if name == "k4_dsum" else plain_b,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_f if fwd else lib_dsum if name == "k4_dsum" else lib_b,
            "library_is": "SDPA forward" if fwd else (
                "(do.float() * out.float()).sum(dim=-1), the expression the wrapper used before the pre-pass"
                if name == "k4_dsum" else
                "SDPA backward: dq, dk and dv in one call, the work of dq + dk/dv + dsum together"),
            "tflops": ops / ms[name] / 1e9,
        }
        if name in turns:
            entries[name]["turns_ms"] = turns[name]
    lib_tflops = work["k4_fwd"][0] / lib_f / 1e9

    def turns_of(name):
        e = entries[name]
        return f"{e['ms']:.4f} ms ({e['tflops']:.1f} TFLOP/s; turns {', '.join(f'{t:.4f}' for t in turns[name])})"

    w, m = entries["k4_fwd_wgmma"], entries["k4_fwd"]
    print(f"[k4] {label}: forward, wgmma route {turns_of('k4_fwd_wgmma')}, mma.sync route {turns_of('k4_fwd')}: "
          f"the wgmma route {m['ms'] / w['ms']:.2f}x faster; SDPA {lib_f:.4f} ms ({lib_tflops:.1f} TFLOP/s), wgmma / "
          f"SDPA {w['ms'] / lib_f:.2f}; plain {plain_f:.3f} ms; bound {w['bound_ms']:.4f} ms ({w['bound_by']}, "
          f"{work['k4_fwd'][0] / 1e9:.1f} GFLOP)", flush=True)
    bwd = {r: ms["k4_dsum"] + ms[f"k4_bwd_dq{r}"] + ms[f"k4_bwd_dkv{r}"] for r in ("_wgmma", "")}
    print(f"[k4] {label}: backward, wgmma route dq {turns_of('k4_bwd_dq_wgmma')} + dk/dv "
          f"{turns_of('k4_bwd_dkv_wgmma')}; mma.sync route dq {turns_of('k4_bwd_dq')} + dk/dv "
          f"{turns_of('k4_bwd_dkv')}; bounds {entries['k4_bwd_dq']['bound_ms']:.4f} ({entries['k4_bwd_dq']['bound_by']}) / "
          f"{entries['k4_bwd_dkv']['bound_ms']:.4f} ms ({entries['k4_bwd_dkv']['bound_by']})", flush=True)
    print(f"[k4] {label}: dsum pre-pass {ms['k4_dsum']:.4f} ms against the PyTorch expression {lib_dsum:.4f} ms "
          f"(plain {plain_dsum:.4f}), bound {entries['k4_dsum']['bound_ms']:.4f} ms ({entries['k4_dsum']['bound_by']}); "
          f"the three gradients: wgmma route {bwd['_wgmma']:.4f} ms, mma.sync route {bwd['']:.4f} ms (each with the "
          f"pre-pass), SDPA backward (one call, graph built outside the timing) {lib_b:.4f} ms: wgmma / SDPA "
          f"{bwd['_wgmma'] / lib_b:.2f}; plain {plain_b:.3f} ms; max errors {errs}, the worst row at {share:.3f} of "
          f"its bound ({tol['out']} x max(row max, {K4_FLOOR}))", flush=True)
    torch.cuda.empty_cache()
    return entries


# K4's f32 instances on the mma.sync route (csrc/flash_attention.cu: the products in exact f32 on the CUDA cores) by
# their kernels-line entry: the mma.sync entry of the same kernel, whose C entry point, source and counter they share.
# Since the tf32x3 route took float32 at head dim 64 / 128 they run on no main path at D 128; they stay timed beside it.
K4_F32 = {"k4_fwd[f32]": "k4_fwd", "k4_bwd_dq[f32]": "k4_bwd_dq", "k4_bwd_dkv[f32]": "k4_bwd_dkv",
          "k4_dsum[f32]": "k4_dsum"}
# K4's tf32x3 route (csrc/flash_tf32.cu: float32 at head dim 64 / 128 on the tensor cores, every product 3xTF32): C
# entry point, source, counter, and the mma.sync f32 entry it is timed in turns with.
K4_TF32 = {"k4_fwd_tf32x3": ("dalm_fa_fwd_tf32", "dalm_tpu_torch/csrc/flash_tf32.cu", "fwd", "k4_fwd[f32]"),
           "k4_bwd_dq_tf32x3": ("dalm_fa_bwd_dq_tf32", "dalm_tpu_torch/csrc/flash_tf32.cu", "dq", "k4_bwd_dq[f32]"),
           "k4_bwd_dkv_tf32x3": ("dalm_fa_bwd_dkv_tf32", "dalm_tpu_torch/csrc/flash_tf32.cu", "dkv",
                                 "k4_bwd_dkv[f32]")}


def tf32_rate(peaks) -> float:
    """The dense TF32 tensor-core rate: half the bf16 one on Hopper's data sheets (SXM 494.5 of 989 TFLOP/s, PCIe 378
    of 756, NVL 417.5 of 835)."""
    return peaks[2] / 2


def k4_f32_time(gen, device, peaks, geo, label, iters):
    """K4's float32 kernels at a main path's own geometry ``geo`` (the shapes, segment ids, scale, window and softcap
    of the path's first attention call): random f32 q, k, v, do at those shapes through ``flash_fwd`` /
    ``flash_bwd``, which must take the tf32x3 route (the forward, the dsum pre-pass, dq and dk/dv), and through the
    kept mma.sync f32 instances' C entry points on the same inputs; each held to the plain versions at
    ``K4_TOL["float32"]`` (the dsum pre-pass to 1e-5 of its row's sum of |do out|). Then the forward, dq and dk/dv of
    the two routes timed through their C entry points in turns (tf32x3, mma.sync, mma.sync, tf32x3), dsum once,
    against the plain versions, one library call (SDPA in f32 with the same boolean mask, k and v repeated to the
    query heads outside the timing: its forward, and its backward for the three gradients) and the bounds, the work
    counted over the (query, key) pairs this run's segments leave visible: the mma.sync instances at the f32
    CUDA-core peak, the tf32x3 kernels at 3 x the operations over the TF32 tensor-core peak (``bound_ms``) and at the
    CUDA-core one (``bound_f32_ms``). Returns the kernels-line records by ``K4_F32`` and ``K4_TF32`` name."""
    import torch
    import torch.nn.functional as F

    from dalm_tpu_torch.kernels import flash_attention as fa

    B, S, H, D = geo["q"]
    Hk = geo["k"][2]
    seg = None if geo["seg"] is None else geo["seg"].to(torch.int32).contiguous()
    q, k, v, do, _, _ = k4_inputs(gen, device, torch.float32, B, H, Hk, S, S, D, None)
    kw = dict(causal=geo["causal"], scale=geo["scale"], window=geo["window"], softcap=geo["softcap"])
    check(fa.fwd_route(q.dtype, D) == "tf32x3", f"k4 f32: float32 at D {D} must take the tf32x3 route")
    fwd_before, bwd_before = dict(fa.flash_fwd.routes), dict(fa.flash_bwd.routes)
    out, lse = fa.flash_fwd(q, k, v, seg, seg, **kw)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, seg, seg, **kw)
    check(fa.flash_fwd.routes == dict(fwd_before, tf32x3=fwd_before["tf32x3"] + 1)
          and fa.flash_bwd.routes == dict(bwd_before, tf32x3=bwd_before["tf32x3"] + 1),
          f"k4 {label}: the forward or the backward did not take the tf32x3 route")
    dims = fa._check("time", q, k, v, seg, seg, kw["window"], kw["softcap"])

    def block(**tensors):
        return fa._args(q, k, v, seg, seg, kw["causal"], kw["scale"], 0, kw["window"], kw["softcap"], dims, **tensors)

    # the mma.sync f32 instances on the same inputs: their own forward, then their backward from the tf32x3
    # forward's out and lse (the pair the plain backward is given)
    dsum = torch.empty_like(lse)
    m_out, m_lse = torch.empty_like(out), torch.empty_like(lse)
    m_dq, m_dk, m_dv = torch.empty_like(dq), torch.empty_like(dk), torch.empty_like(dv)
    fwd_b = block(out=m_out, lse=m_lse)
    bwd_b = block(out=out, dout=do, lse=lse, dsum=dsum, dq=m_dq, dk=m_dk, dv=m_dv)
    fa._launch("dalm_fa_fwd", "fwd", fwd_b, q)
    for name in ("k4_dsum", "k4_bwd_dq", "k4_bwd_dkv"):
        fa._launch(K4_ENTRY[name][0], K4_ENTRY[name][2], bwd_b, q)
    ro, rl = fa.flash_fwd_ref(q, k, v, seg, seg, **kw)
    rq, rk, rv = fa.flash_bwd_ref(q, k, v, out, lse, do, seg, seg, **kw)
    rsum = fa.dsum_ref(do, out)
    torch.cuda.synchronize()
    tol = K4_TOL["float32"]
    K4_SHARE[0] = 0.0
    sum_err = (dsum - rsum).abs()
    check(bool((sum_err <= 1e-5 * (do * out).abs().sum(dim=-1)).all()),
          f"k4 {label}: the dsum pre-pass is more than 1e-5 of its row's sum of |do out| from the plain version")
    errs = {"k4_fwd_tf32x3": max(k4_err(out, ro, tol["out"], f"{label} tf32x3 out"),
                                 k4_err(lse, rl, tol["lse"], f"{label} tf32x3 lse")),
            "k4_bwd_dq_tf32x3": k4_err(dq, rq, tol["grad"], f"{label} tf32x3 dq"),
            "k4_bwd_dkv_tf32x3": max(k4_err(dk, rk, tol["grad"], f"{label} tf32x3 dk"),
                                     k4_err(dv, rv, tol["grad"], f"{label} tf32x3 dv"))}
    share_tf32 = K4_SHARE[0]
    K4_SHARE[0] = 0.0
    errs.update({"k4_fwd[f32]": max(k4_err(m_out, ro, tol["out"], f"{label} mma.sync out"),
                                    k4_err(m_lse, rl, tol["lse"], f"{label} mma.sync lse")),
                 "k4_bwd_dq[f32]": k4_err(m_dq, rq, tol["grad"], f"{label} mma.sync dq"),
                 "k4_bwd_dkv[f32]": max(k4_err(m_dk, rk, tol["grad"], f"{label} mma.sync dk"),
                                        k4_err(m_dv, rv, tol["grad"], f"{label} mma.sync dv")),
                 "k4_dsum[f32]": float(sum_err.max())})
    share_mma = K4_SHARE[0]
    del ro, rl, rq, rk, rv, rsum

    tf_fwd_b = block(out=torch.empty_like(out), lse=torch.empty_like(lse))
    tf_bwd_b = block(out=out, dout=do, lse=lse, dsum=dsum, dq=torch.empty_like(dq), dk=torch.empty_like(dk),
                     dv=torch.empty_like(dv))
    calls = {"k4_fwd[f32]": ("dalm_fa_fwd", "fwd", fwd_b), "k4_bwd_dq[f32]": ("dalm_fa_bwd_dq", "dq", bwd_b),
             "k4_bwd_dkv[f32]": ("dalm_fa_bwd_dkv", "dkv", bwd_b), "k4_dsum[f32]": ("dalm_fa_dsum", "dsum", bwd_b)}
    for name, (entry, _, counter, _) in K4_TF32.items():
        calls[name] = (entry, counter, tf_fwd_b if counter == "fwd" else tf_bwd_b)
    turns = {}
    for name, (_, _, _, mma_name) in K4_TF32.items():
        for which in (name, mma_name, mma_name, name):
            entry, counter, a = calls[which]
            turns.setdefault(which, []).append(cuda_ms(lambda: fa._launch(entry, counter, a, q), iters))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    entry, counter, a = calls["k4_dsum[f32]"]
    ms["k4_dsum[f32]"] = cuda_ms(lambda: fa._launch(entry, counter, a, q), iters)
    plain_f = cuda_ms(lambda: fa.flash_fwd_ref(q, k, v, seg, seg, **kw), 2)
    plain_b = cuda_ms(lambda: fa.flash_bwd_ref(q, k, v, out, lse, do, seg, seg, **kw), 2)
    plain_dsum = cuda_ms(lambda: fa.dsum_ref(do, out), iters)

    keep = fa._keep_mask(S, S, seg, seg, kw["causal"], 0, kw["window"], device)
    vis = float(keep.float().mean()) if keep is not None else 1.0
    lib_f = lib_b = None
    if kw["softcap"] is None:  # SDPA has no softcap
        mask = keep.reshape(keep.shape[0], 1, S, S) if keep is not None else None
        kx, vx = (t.repeat_interleave(H // Hk, dim=1) for t in (k, v))
        lib_f = cuda_ms(lambda: F.scaled_dot_product_attention(q, kx, vx, attn_mask=mask, scale=kw["scale"]), iters)
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, kx, vx))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, scale=kw["scale"])
        lib_b = cuda_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True), iters)
        del lib_out, ql, kl, vl, kx, vx, mask
    lib_dsum = cuda_ms(lambda: (do * out).sum(dim=-1), iters)
    work = k4_ops_bytes(B, H, Hk, S, S, D, 4, 0, kw["causal"], vis=vis)
    records = {}
    bases = dict(K4_F32, **{name: K4_F32[spec[3]] for name, spec in K4_TF32.items()})
    for name, base in bases.items():
        ops, nbytes = work[base]
        tf32 = name in K4_TF32
        t_f32, t_bytes = ops / peaks[1] * 1e3, nbytes / peaks[0] * 1e3
        t_ops = 3 * ops / tf32_rate(peaks) * 1e3 if tf32 else t_f32
        fwd, dsum_k = base == "k4_fwd", base == "k4_dsum"
        records[name] = {
            "name": name, "route": "cuda", "source": K4_TF32[name][1] if tf32 else K4_ENTRY[base][1],
            "replaces": K4_AT[base], "case": label, "max_abs_err": errs[name], "ms": ms[name],
            "plain_ms": plain_f if fwd else plain_dsum if dsum_k else plain_b,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_f if fwd else lib_dsum if dsum_k else lib_b,
            "library_is": "SDPA forward, f32, boolean mask" if fwd else (
                "(do * out).sum(dim=-1), the expression the wrapper used before the pre-pass" if dsum_k else
                "SDPA backward, f32, boolean mask: dq, dk and dv in one call, the work of dq + dk/dv + dsum together"),
            "tflops": ops / ms[name] / 1e9, "visible_share": vis,
        }
        if name in turns:
            records[name]["turns_ms"] = turns[name]
        if tf32:
            records[name]["bound_f32_ms"] = max(t_f32, t_bytes)
    r = records

    def line(name):
        e = r[name]
        return (f"{e['ms']:.3f} ms ({e['tflops']:.1f} TFLOP/s of the f32 work; turns "
                f"{', '.join(f'{t:.3f}' for t in e.get('turns_ms', []))}; bound {e['bound_ms']:.3f} ms)")

    grads = {route: ms["k4_dsum[f32]"] + ms[dq_name] + ms[dkv_name] for route, dq_name, dkv_name in
             (("tf32x3", "k4_bwd_dq_tf32x3", "k4_bwd_dkv_tf32x3"), ("mma.sync", "k4_bwd_dq[f32]", "k4_bwd_dkv[f32]"))}
    print(f"[k4] {label}, visible share {vis:.4f}: forward tf32x3 {line('k4_fwd_tf32x3')}, mma.sync "
          f"{line('k4_fwd[f32]')}: tf32x3 {ms['k4_fwd[f32]'] / ms['k4_fwd_tf32x3']:.2f}x faster; dq tf32x3 "
          f"{line('k4_bwd_dq_tf32x3')}, mma.sync {line('k4_bwd_dq[f32]')}; dk/dv tf32x3 {line('k4_bwd_dkv_tf32x3')}, "
          f"mma.sync {line('k4_bwd_dkv[f32]')}; dsum {ms['k4_dsum[f32]']:.4f} ms (bound "
          f"{r['k4_dsum[f32]']['bound_ms']:.4f}, {r['k4_dsum[f32]']['bound_by']}); the three gradients with dsum: "
          f"tf32x3 {grads['tf32x3']:.3f} ms, mma.sync {grads['mma.sync']:.3f} ms, SDPA's f32 backward {lib_b} ms; "
          f"SDPA forward {lib_f} ms; bounds at the f32 CUDA-core peak {r['k4_fwd_tf32x3']['bound_f32_ms']:.3f} / "
          f"{r['k4_bwd_dq_tf32x3']['bound_f32_ms']:.3f} / {r['k4_bwd_dkv_tf32x3']['bound_f32_ms']:.3f} ms; plain "
          f"forward {plain_f:.3f} ms, backward {plain_b:.3f} ms, dsum {plain_dsum:.4f} ms; the dsum expression "
          f"{lib_dsum:.4f} ms; max errors {errs}, the worst row at {share_tf32:.3f} (tf32x3) / {share_mma:.3f} "
          f"(mma.sync) of its bound ({tol} x max(row max, {K4_FLOOR}))", flush=True)
    del q, k, v, do, out, lse, dq, dk, dv, keep, m_out, m_lse, m_dq, m_dk, m_dv
    torch.cuda.empty_cache()
    return records


def k4_err(got, want, tol, what) -> float:
    """max |got - want|, after holding every row to tol * max(max |want| of the row, floor): rows are the
    last axis of a 4-d tensor (floor ``K4_FLOOR``), single values of a 3-d lse (floor 1). No NaN allowed."""
    import torch

    check(bool(torch.isfinite(got.float()).all()), f"k4 {what}: non-finite values")
    g, w, floor = got.float(), want.float(), K4_FLOOR
    if w.dim() == 3:
        g, w, floor = g[..., None], w[..., None], 1.0
    err = (g - w).abs()
    share = float((err / (tol * w.abs().amax(dim=-1, keepdim=True).clamp(min=floor))).max())
    K4_SHARE[0] = max(K4_SHARE[0], share)
    check(share <= 1.0, f"k4 {what}: a row's error is {share:.3g} x its bound (tol {tol} x max(row max, {floor}))")
    return float(err.max())


def k4_phase(gen, device, peaks, sft_batch):
    """K4 (forward, dq, dk/dv, the dsum pre-pass) against its plain versions on
    the card, every case in bf16 and f32 at ``K4_TOL``, the forward and the
    backward each on its route (bf16 at D 64 / 128 on the wgmma kernels, the rest
    on the mma.sync kernels, counted by route); fully masked rows must give out =
    0, lse = -1e30 and zero gradients exactly; two key halves must merge into the
    full result; a bf16 D 128 forward or backward whose tensor map the driver
    refuses must raise without falling back or launching. Then the kernels'
    times at the SFT shape and at the RAG trainer's. Returns (all timed records,
    the records at the SFT shape)."""
    import torch

    from dalm_tpu_torch.kernels import flash_attention as fa

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name_t = str(dtype).split(".")[-1]
        tol = K4_TOL[name_t]
        for label, B, H, Hk, Sq, Sk, D, opts in K4_CASES:
            opts = dict(opts)
            q, k, v, do, seg_q, seg_k = k4_inputs(gen, device, dtype, B, H, Hk, Sq, Sk, D, opts.pop("seg", None))
            if seg_q is None:
                seg_k = None
            kw = dict(causal=opts.get("causal", True), scale=1.0 / D ** 0.5, q_offset=opts.get("q_offset", 0),
                      window=opts.get("window"), softcap=opts.get("softcap"))
            route, before = fa.fwd_route(dtype, D), dict(fa.flash_fwd.routes)
            out, lse = fa.flash_fwd(q, k, v, seg_q, seg_k, **kw)
            check(fa.flash_fwd.routes == dict(before, **{route: before[route] + 1}),
                  f"k4 {name_t} {label}: the forward did not launch on its route {route}")
            ro, rl = fa.flash_fwd_ref(q, k, v, seg_q, seg_k, **kw)
            before = dict(fa.flash_bwd.routes)
            dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, seg_q, seg_k, **kw)
            check(fa.flash_bwd.routes == dict(before, **{route: before[route] + 1}),
                  f"k4 {name_t} {label}: the backward did not launch on its route {route}")
            rq, rk, rv = fa.flash_bwd_ref(q, k, v, out, lse, do, seg_q, seg_k, **kw)
            torch.cuda.synchronize()
            what = f"{name_t} {label}"
            errs = [k4_err(out, ro, tol["out"], f"{what} out"), k4_err(lse, rl, tol["lse"], f"{what} lse"),
                    k4_err(dq, rq, tol["grad"], f"{what} dq"), k4_err(dk, rk, tol["grad"], f"{what} dk"),
                    k4_err(dv, rv, tol["grad"], f"{what} dv")]
            dead = rl <= -1e29  # rows with no visible key
            if bool(dead.any()):
                check(bool((lse[dead] == -1e30).all()), f"k4 {what}: lse of a fully masked row is not -1e30")
                check(not bool(out[dead].any()), f"k4 {what}: out of a fully masked row is not 0")
                check(not bool(dq[dead].any()), f"k4 {what}: dq of a fully masked row is not 0")
            if kw["q_offset"] < 0 and Sq == Sk:
                check(bool(dead.all()) and not bool(dk.any()) and not bool(dv.any()),
                      f"k4 {what}: every row is masked, so dk and dv must be 0")
            worst[name_t] = [max(a, b) for a, b in zip(worst.get(name_t, [0.0] * 5), errs)]
            print(f"[k4] {what}: B={B} H={H} Hk={Hk} Sq={Sq} Sk={Sk} D={D}, forward and backward on the {route} "
                  f"route; max errors "
                  f"out {errs[0]:.2e} lse "
                  f"{errs[1]:.2e} dq {errs[2]:.2e} dk {errs[3]:.2e} dv {errs[4]:.2e}; fully masked rows "
                  f"{int(dead.sum())}", flush=True)
        # The merge identity ring attention is built on: two key halves, merged by their lse, give the full result.
        q, k, v, _, _, _ = k4_inputs(gen, device, dtype, 2, 4, 4, 256, 256, 64, None)
        kw = dict(causal=True, scale=0.125)
        full, lse_full = fa.flash_fwd(q, k, v, **kw)
        o1, l1 = fa.flash_fwd(q, k[:, :, :128], v[:, :, :128], q_offset=0, **kw)
        o2, l2 = fa.flash_fwd(q, k[:, :, 128:], v[:, :, 128:], q_offset=-128, **kw)
        m = torch.maximum(l1, l2)
        w1, w2 = torch.exp(l1 - m), torch.exp(l2 - m)
        merged = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) / torch.clamp(w1 + w2, min=1e-30)[..., None]
        e_out = k4_err(merged, full, tol["out"], f"{name_t} merge identity out")
        e_lse = k4_err(m + torch.log(torch.clamp(w1 + w2, min=1e-30)), lse_full, tol["lse"], f"{name_t} merge identity lse")
        print(f"[k4] {name_t} merge of two key halves (forward on the {fa.fwd_route(dtype, 64)} route): out "
              f"{e_out:.2e}, lse {e_lse:.2e}", flush=True)
    print(f"[k4] worst errors (out, lse, dq, dk, dv) over {len(K4_CASES)} cases: {worst}; tolerances {K4_TOL} of "
          f"max(row max, {K4_FLOOR}); the worst row used {K4_SHARE[0]:.3f} of its bound", flush=True)

    # A CUDA tensor the kernel does not take raises; nothing falls back to the plain version or the other route.
    bad = torch.zeros((1, 1, 64, 24), device=device, dtype=torch.bfloat16)
    try:
        fa.flash_fwd(bad, bad, bad)
    except ValueError:
        pass
    else:
        check(False, "k4: head dim 24 must raise on a CUDA tensor")
    k = torch.zeros((1, 2, 256, 128), device=device, dtype=torch.bfloat16)
    huge = k.as_strided(k.shape, (2 ** 39,) + k.stride()[1:])  # 2^40 bytes between batches: TMA refuses it
    before = dict(fa.flash_fwd.routes)
    try:
        fa.flash_fwd(huge, k, k)
    except RuntimeError:
        pass
    else:
        check(False, "k4: a bf16 D 128 call whose tensor map the driver refuses must raise")
    check(fa.flash_fwd.routes == before, "k4: a refused wgmma call fell back to another route")
    out, lse = fa.flash_fwd(k, k, k)
    before, launches = dict(fa.flash_bwd.routes), dict(fa.flash_attention.launches)
    try:
        fa.flash_bwd(huge, k, k, out, lse, k)
    except RuntimeError:
        pass
    else:
        check(False, "k4: a bf16 D 128 backward whose tensor map the driver refuses must raise")
    check(fa.flash_bwd.routes == before and fa.flash_attention.launches == launches,
          "k4: a refused wgmma backward launched a kernel or fell back to another route")

    main = k4_time(gen, device, peaks, sft_batch, 2560, f"SFT shape B={sft_batch} H=32 S=2560 D=128 bf16 causal", 20)
    rag = k4_time(gen, device, peaks, 18, 256, "RAG trainer's shape B=18 H=32 S=256 D=128 bf16 causal", 20)
    return list(main.values()) + list(rag.values()), main


def corpus(n: int, rng) -> list:
    letters = list(string.ascii_lowercase + " ")
    return ["".join(rng.choice(letters, size=90)) + f" topic {i}" for i in range(n)]


def small_pipeline_agrees(device) -> None:
    """The tiny pipeline on the card (f32) against the same pipeline on the
    CPU, on the same weights: passage embeddings within 1e-5, retrieval ids
    equal up to near ties, answers equal."""
    import torch

    from dalm_tpu_torch.models.decoder import Decoder
    from dalm_tpu_torch.models.embedder import SentenceEmbedder
    from dalm_tpu_torch.serve import RagPipeline

    passages = [f"passage about topic {i} with unique content {i}" for i in range(64)]
    queries = [f"what is topic {i}" for i in range(8)]
    opts = dict(max_passage_len=48, max_prompt_len=96, max_new_tokens=8, embed_batch=16)
    cpu = RagPipeline.from_pretrained("tiny", "tiny", passages, device="cpu", **opts)
    retriever = SentenceEmbedder(cpu.retriever.config, device=device)
    retriever.load_state_dict(cpu.retriever.state_dict())
    generator = Decoder(cpu.generator.cfg, device=device)
    generator.load_state_dict(cpu.generator.state_dict())
    card = RagPipeline(retriever.eval(), cpu.r_tok, generator.eval(), cpu.g_tok, passages, device=device, **opts)
    emb_err = float((card.index.embeddings.cpu() - cpu.index.embeddings).abs().max())
    check(emb_err <= NEAR_TIE, f"tiny pipeline: passage embeddings differ by {emb_err}")
    s_cpu, i_cpu = cpu.retrieve(queries, 4)
    s_card, i_card = card.retrieve(queries, 4)
    q_card = card._embed_texts([f"#query# {q}" for q in queries], card.max_passage_len)
    _, swaps = compare_topk(*(torch.from_numpy(x).to(device) for x in (s_card, i_card, s_cpu, i_cpu)),
                            q_card, card.index.embeddings, None)
    a_cpu = [a.answer for a in cpu.answer(queries, 4)]
    a_card = [a.answer for a in card.answer(queries, 4)]
    check(a_cpu == a_card, "tiny pipeline: card answers differ from CPU")
    print(f"[small] tiny pipeline, card vs CPU on the same weights: embeddings max err {emb_err}, "
          f"retrieval near-tie swaps {swaps}, {len(a_card)} answers equal", flush=True)
    del cpu, card
    torch.cuda.empty_cache()


def serve_path(device, rng):
    """bge-large + Llama-2-7B RagPipeline at full width and depth, bf16, one timed answer()."""
    import numpy as np
    import torch

    from dalm_tpu_torch.kernels.topk import fused_dot_topk, fused_dot_topk_ref
    from dalm_tpu_torch.serve import RagPipeline

    passages = corpus(16384, rng)
    queries = [f"what about topic {i}" for i in range(0, 16384, 512)]  # 32 queries
    t0 = time.perf_counter()
    pipe = RagPipeline.from_pretrained(
        "bge-large", "llama2-7b", passages, dtype="bfloat16", device=device,
        max_passage_len=128, max_prompt_len=256, max_new_tokens=64, embed_batch=256,
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"[main] built pipeline (random init + {len(passages)} passages embedded): {build_s:.2f} s", flush=True)

    pipe.answer(queries, top_k=4)  # warm
    torch.cuda.synchronize()
    fused_dot_topk.launches = dict.fromkeys(fused_dot_topk.launches, 0)
    t0 = time.perf_counter()
    answers = pipe.answer(queries, top_k=4)
    torch.cuda.synchronize()
    answer_s = time.perf_counter() - t0
    launches = dict(fused_dot_topk.launches)
    check(launches["f32"] > 0, "answer() never launched the K3 kernel on its float index")
    check(len(answers) == len(queries), "wrong number of answers")
    for a in answers:
        check(len(a.passages) == 4, "an answer has not 4 passages")
        check(all(x >= y for x, y in zip(a.scores, a.scores[1:])), "passage scores increase")
        check(all(np.isfinite(a.scores)), "non-finite retrieval score")
        check(isinstance(a.answer, str), "answer is not text")

    # Pieces, timed apart on the same inputs.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q_embs = pipe._embed_texts([f"#query# {q}" for q in queries], pipe.max_passage_len)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    check(bool(torch.isfinite(q_embs).all()), "non-finite query embeddings")
    t0 = time.perf_counter()
    scores, ids = pipe.index.search(q_embs, 4)
    search_ms = (time.perf_counter() - t0) * 1e3
    rs, ri = fused_dot_topk_ref(q_embs, pipe.index.embeddings, 4)
    _, swaps = compare_topk(torch.from_numpy(scores).to(device), torch.from_numpy(ids).to(device), rs, ri,
                            q_embs, pipe.index.embeddings, None)
    check([a.passages for a in answers] == [[passages[int(j)] for j in row] for row in ids],
          "answer() passages differ from a separate retrieve")
    prompts = [f"#query# {q} #passage# {passages[int(ids[i, 0])]} #answer# " for i, q in enumerate(queries)]
    toks = pipe.g_tok(prompts, padding="max_length", max_length=pipe.max_prompt_len, truncation=True)
    p_ids = torch.as_tensor(toks["input_ids"], device=device)
    p_mask = torch.as_tensor(toks["attention_mask"], device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = pipe._generate(p_ids, p_mask)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check(tuple(gen.shape) == (len(queries), 64), f"generated shape {tuple(gen.shape)}")
    check(bool(((gen >= 0) & (gen < pipe.generator.cfg.vocab_size)).all()), "token id out of range")
    logits = pipe.generator(p_ids[:2], p_mask[:2], logits_last_only=True)
    check(bool(torch.isfinite(logits).all()), "non-finite generator logits")
    tok_s = gen.numel() / decode_s
    print(f"[main] answer(): {answer_s:.3f} s for {len(queries)} queries; query embed {embed_s:.4f} s; "
          f"search {search_ms:.3f} ms (host clock, incl. copies); prefill+decode {decode_s:.3f} s = "
          f"{tok_s:.1f} tokens/s (batch {len(queries)}, prompt {pipe.max_prompt_len}, {gen.shape[1]} new); "
          f"K3 launches per answer() by row storage {launches}; ids vs plain top-k: {swaps} near-tie swaps",
          flush=True)
    print(f"[main] sample answer: {answers[0].answer[:60]!r}", flush=True)

    # K3 at the main path's own shapes: device time by CUDA graph, each call on its own copy of the index (together
    # over twice the L2), the kernel and torch.topk(q @ e.T) in turns (kernel, library, library, kernel); then the
    # wrapper as search() calls it, host work included.
    q, e = q_embs, pipe.index.embeddings
    copies = [e] + [e.clone() for _ in range(-(-100_000_000 // (e.numel() * e.element_size())))]
    kfns = [lambda c=c: fused_dot_topk(q, c, 4) for c in copies]
    lfns = [lambda c=c: torch.topk(q @ c.T, 4) for c in copies]
    turns = {"ms_turns": [graph_ms(kfns)], "library_turns": [graph_ms(lfns)]}
    turns["library_turns"].append(graph_ms(lfns))
    turns["ms_turns"].append(graph_ms(kfns))
    turns["wrapper_ms"] = cuda_ms(lambda: fused_dot_topk(q, e, 4), 50)
    del copies, kfns, lfns
    ms, lib_ms = sum(turns["ms_turns"]) / 2, sum(turns["library_turns"]) / 2
    plain_ms = cuda_ms(lambda: fused_dot_topk_ref(q, e, 4), 20)
    return pipe, launches, (q, e, ms, plain_ms, lib_ms, turns)


TRAIN_KW = dict(use_peft="both", lora_runtime="fused", int8_compute="all", num_warmup_steps=0, with_tracking=False)


def write_csv(path, n, rng):
    """A synthetic Question/Abstract/Answer CSV: random lower-case text, lengths
    that leave an answer region inside 256 generator tokens."""
    import csv

    letters = list(string.ascii_lowercase + " ")

    def text(k):
        return "".join(rng.choice(letters, size=k))

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Question", "Abstract", "Answer"])
        for i in range(n):
            w.writerow([f"{text(28)} {i}", f"{text(90)} {i}", f"{text(56)} {i}"])


def train_small_phase(device, workdir):
    """The tiny preset through ``train_e2e`` (fused QLoRA, int8 bases on both
    sub-models, ``int8_compute="all"``) on the card and on the CPU, from the
    same initial weights and over the same batches. Losses after 1, 2 and 3
    steps agree within 2e-3 (total, retriever, generator; f32 models: the
    int8 kernels equal their plain versions, what differs is the order of
    f32 sums in the other matmuls and the odd rounding that flips)."""
    import numpy as np
    import torch

    from dalm_tpu_torch.kernels import int8_matmul as im
    from dalm_tpu_torch.train import train_e2e

    csv_path = str(Path(workdir) / "small.csv")
    write_csv(csv_path, 12, np.random.default_rng(1))
    kw = dict(TRAIN_KW, use_bnb="both", query_max_len=48, passage_max_len=112, generator_max_len=256,
              per_device_train_batch_size=4, learning_rate=1e-3, lr_scheduler_type="constant", seed=3,
              a8_calibrate_every=0)
    initial = {}

    def keep(setup):
        for sub in ("retriever", "generator"):
            initial[sub] = {k: v.detach().clone() for k, v in getattr(setup.rag, sub).state_dict().items()}

    def give(setup):
        for sub in ("retriever", "generator"):
            getattr(setup.rag, sub).load_state_dict(initial[sub])

    before = (im.rowquant.launches, im.int8_gemm_kn.launches, im.int8_gemm_nt.launches)
    worst = 0.0
    for steps in (1, 2, 3):
        cpu = train_e2e(csv_path, "tiny", "tiny", max_train_steps=steps, device="cpu", setup_hook=keep, **kw)
        card = train_e2e(csv_path, "tiny", "tiny", max_train_steps=steps, device=device, setup_hook=give, **kw)
        for key in ("final_loss", "final_retriever_loss", "final_generator_loss"):
            check(np.isfinite(card[key]), f"train-small: {key} is not finite")
            worst = max(worst, abs(card[key] - cpu[key]))
            check(abs(card[key] - cpu[key]) <= 2e-3, f"train-small step {steps}: {key} {card[key]} vs CPU {cpu[key]}")
        print(f"[train-small] step {steps}: card loss {card['final_loss']:.6f}, CPU {cpu['final_loss']:.6f}", flush=True)
    after = (im.rowquant.launches, im.int8_gemm_kn.launches, im.int8_gemm_nt.launches)
    check(all(a > b for a, b in zip(after, before)), "train-small did not launch K2 and both GEMM entries")
    print(f"[train-small] tiny train_e2e, card vs CPU, 3-step loss trajectories: max difference {worst:.2e}; "
          f"launches K2 {after[0] - before[0]}, int8_gemm_kn {after[1] - before[1]}, "
          f"int8_gemm_nt {after[2] - before[2]}", flush=True)

    # The calibrated, merge and live-index paths, each a 2-step tiny run on the card against the CPU from the same
    # initial weights (the merge runtime's factors included), losses within the same 2e-3; dropout off (its masks
    # are drawn per device).
    rows = str(Path(workdir) / "small_live.csv")
    write_csv(rows, 16, np.random.default_rng(4))
    paths = {
        "calibrated": dict(kw, a8_calibrate_every=1),
        "dy-calibrated": dict(kw, a8_calibrate_every=1, a8_dy_calibrate=True),
        "merge int8": dict(kw, lora_runtime="merge"),
        "live + marginal (token)": dict(kw, live_index=True, index_refresh_slice=5, live_negatives_k=3,
                                        marginalize_k=3, marginalize_mode="token"),
        "live + marginal (sequence), merge": dict(kw, lora_runtime="merge", live_index=True, index_refresh_slice=5,
                                                  marginalize_k=2, marginalize_mode="sequence"),
    }
    before = dict(im.cal_quant.launches)
    for label, pkw in paths.items():
        data = rows if "live" in label else csv_path
        cpu = train_e2e(data, "tiny", "tiny", max_train_steps=2, device="cpu", setup_hook=keep, **pkw)
        card = train_e2e(data, "tiny", "tiny", max_train_steps=2, device=device, setup_hook=give, **pkw)
        diff = max(abs(card[key] - cpu[key]) for key in ("final_loss", "final_retriever_loss", "final_generator_loss"))
        check(np.isfinite(card["final_loss"]) and diff <= 2e-3, f"train-small {label}: card {card} vs CPU {cpu}")
        if "live" in label:
            rdiff = float((card["live_index"].embeddings.cpu() - cpu["live_index"].embeddings).abs().max())
            check(rdiff <= 1e-4, f"train-small {label}: live index rows differ by {rdiff}")
        print(f"[train-small] {label}: card loss {card['final_loss']:.6f}, CPU {cpu['final_loss']:.6f} "
              f"(max difference {diff:.2e})", flush=True)
    check(im.cal_quant.launches["x"] > before["x"] and im.cal_quant.launches["dy"] > before["dy"],
          "train-small: the calibrated quantiser did not run in both modes")

    from dalm_tpu_torch.train import train_retriever

    rkw = dict(use_peft=True, use_bnb=True, use_dropout=False, query_max_len=48, passage_max_len=112,
               per_device_train_batch_size=4, learning_rate=1e-3, max_train_steps=2, seed=3, with_tracking=False)
    held = {}
    cpu = train_retriever("tiny", csv_path, device="cpu",
                          setup_hook=lambda st: held.update(w={k: v.detach().clone() for k, v in st.model.state_dict().items()}),
                          **rkw)
    card = train_retriever("tiny", csv_path, device=device,
                           setup_hook=lambda st: st.model.load_state_dict(held["w"]), **rkw)
    check(abs(card["final_loss"] - cpu["final_loss"]) <= 2e-3, f"train-small retriever: card {card} vs CPU {cpu}")
    print(f"[train-small] train_retriever (LoRA, int8 base): card loss {card['final_loss']:.6f}, CPU "
          f"{cpu['final_loss']:.6f}", flush=True)
    torch.cuda.empty_cache()


def _train_counters():
    from dalm_tpu_torch.kernels import int8_matmul as im

    return {"rowquant": lambda: im.rowquant.launches, "w8a8_fused": lambda: im.w8a8_fused.launches,
            "k1_quant_prepass": lambda: im.quant_prepass.launches, "k1_weight_prepass": lambda: im.weight_prepass.launches,
            "k1_gemm": lambda: im.fold_gemm.launches, "int8_gemm_kn": lambda: im.int8_gemm_kn.launches,
            "int8_gemm_nt": lambda: im.int8_gemm_nt.launches, "k1_cal_quant": lambda: im.cal_quant.launches["x"],
            "k1_cal_quant[dy]": lambda: im.cal_quant.launches["dy"],
            "k5_pcol_gemm": lambda: im.int8_gemm_scaled.launches}


def _zero_train_counters():
    from dalm_tpu_torch.kernels import int8_matmul as im

    for fn in (im.rowquant, im.w8a8_fused, im.quant_prepass, im.weight_prepass, im.fold_gemm, im.int8_gemm_kn,
               im.int8_gemm_nt, im.int8_gemm_scaled):
        fn.launches = 0
    im.cal_quant.launches = {"x": 0, "dy": 0}


def _flagship(device, csv_path, batch, **kw):
    """``train_e2e`` as ``bench.py``'s flagship runs it at full width (bge-large + Llama-2-7B, bf16, fused QLoRA,
    int8 generator base, int8_compute="all", Q/P/G 50/128/256), with ``kw`` on top."""
    from dalm_tpu_torch.train import train_e2e

    args = dict(dtype="bfloat16", use_bnb="generator", query_max_len=50, passage_max_len=128, generator_max_len=256,
                per_device_train_batch_size=batch, seed=0, retriever_tokenizer="byte@30522",
                generator_tokenizer="byte@32000", device=device, **TRAIN_KW)
    args.update(kw)
    return train_e2e(csv_path, "bge-large", "llama2-7b", **args)


def time_calibration(rag, into):
    """Wrap ``rag``'s two forwards so that each call made inside the trainer's calibration pass (while a layer
    records its amax) is timed on the card's clock, in ms, into ``into``; every other call passes straight on."""
    import torch

    sites = [m for sub in (rag.retriever, rag.generator) for m in sub.modules()
             if getattr(m, "record_amax", None) is not None]
    for name in ("embed_with", "logits_with"):
        real = getattr(rag, name)

        def timed(*a, _real=real, **k):
            if not any(m.record_amax for m in sites):
                return _real(*a, **k)
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = _real(*a, **k)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t) * 1e3)
            return r

        setattr(rag, name, timed)


def train_phase(device, workdir, batch, steps, kernel_ms, a8_calibrate_every=16):
    """The training main path: ``train_e2e`` on a synthetic CSV, bge-large +
    Llama-2-7B at full width and depth, bf16, fused QLoRA, int8 generator
    base, ``int8_compute="all"``, Q/P/G = 50/128/256, with ``a8_calibrate_every``
    at the reference's default of 16 (calibrated per-tensor activation scales:
    one calibration forward at micro step 0, then the quantiser + weight
    pre-pass + scaled GEMM), or 0 (dynamic per-row activation quant: K1). Two
    epochs of ``steps / 2`` batches: the trainer's throughput meter leaves the
    first epoch (warm-up) out of its average, and so the calibration forward:
    that is timed on its own and its share of 16 steps added to give the
    amortised step time. Returns (the launches of each int8 kernel in that run,
    the trainer's result)."""
    import gc

    import numpy as np
    import torch

    per_epoch = max(steps // 2, 1)
    csv_path = str(Path(workdir) / "train.csv")
    write_csv(csv_path, batch * per_epoch, np.random.default_rng(2))
    held = {}

    def snapshot(setup):
        held["setup"] = setup
        held["trainable"] = {k: p.detach().clone() for k, p in setup.state.params.items()}
        held["frozen"] = {
            f"{sub}.{k}": v.double().sum().item()
            for sub in ("retriever", "generator")
            for k, v in getattr(setup.rag, sub).state_dict().items()
            if f"{sub}.{k}" not in setup.state.params and k.rpartition(".")[2] not in ("a_scale", "dy_scale")
        }

    def hook(setup):
        snapshot(setup)
        time_calibration(setup.rag, cal_ms)

    cal_ms = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _train_counters()
    _zero_train_counters()
    t0 = time.perf_counter()
    out = _flagship(device, csv_path, batch, num_train_epochs=2, setup_hook=hook,
                    a8_calibrate_every=a8_calibrate_every)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: read() for name, read in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_steps = out["steps"]
    check(n_steps == 2 * per_epoch and n_steps >= 3, f"took {n_steps} optimiser steps")
    for key in ("final_loss", "final_retriever_loss", "final_generator_loss"):
        check(np.isfinite(out[key]), f"train: {key} is not finite")

    setup = held["setup"]
    layers = setup.rag.generator_config.num_layers
    # Per step: every packed linear (7 per layer + lm_head) once forward and
    # the layers' once more in the checkpointed recompute; in the backward one
    # K2 + one dx GEMM per linear whose input needs a gradient (all but layer
    # 0's q/k/v, which read the frozen embeddings). Dynamic (every=0): each
    # forward call is K1's three launches. Calibrated: one calibration forward
    # at micro step 0 (K1, no recompute: no gradient), then each forward call
    # is the quantiser, the weight pre-pass and the scaled GEMM.
    fwd = (14 * layers + 1) * n_steps
    bwd = (7 * layers - 2) * n_steps
    if a8_calibrate_every:
        passes = len(range(0, n_steps, a8_calibrate_every))
        k1 = (7 * layers + 1) * passes
        want = {"rowquant": bwd, "w8a8_fused": k1, "k1_quant_prepass": k1, "k1_weight_prepass": k1 + fwd,
                "k1_gemm": k1, "int8_gemm_kn": 0, "int8_gemm_nt": bwd, "k1_cal_quant": fwd, "k1_cal_quant[dy]": 0,
                "k5_pcol_gemm": fwd}
        sites = [m for m in setup.rag.generator.modules() if getattr(m, "q", None) is not None]
        check(all(m.a_scale is not None and float(m.a_scale) > 0 for m in sites), "train: a site has no a_scale")
        a_range = (min(float(m.a_scale) for m in sites), max(float(m.a_scale) for m in sites))
        check(len(cal_ms) == passes, f"train: {len(cal_ms)} calibration forwards timed, {passes} expected")
        # The calibration forward runs at micro step 0, in the first epoch, which the step time leaves out; a run
        # pays one every a8_calibrate_every steps, so the amortised step adds its share.
        out = dict(out, calibration_s=sum(cal_ms) / len(cal_ms) / 1e3)
        out["amortised_step_time"] = out["avg_step_time"] + out["calibration_s"] / a8_calibrate_every
    else:
        want = {"rowquant": bwd, "w8a8_fused": fwd, "k1_quant_prepass": fwd, "k1_weight_prepass": fwd, "k1_gemm": fwd,
                "int8_gemm_kn": 0, "int8_gemm_nt": bwd, "k1_cal_quant": 0, "k1_cal_quant[dy]": 0, "k5_pcol_gemm": 0}
    check(launches == want, f"train (a8_calibrate_every={a8_calibrate_every}): launches {launches}, "
                            f"the layer count predicts {want}")
    unchanged = [k for k, p in setup.state.params.items() if torch.equal(p.detach(), held["trainable"][k])]
    check(not unchanged, f"train: {len(unchanged)} trainable tensors did not change, e.g. {unchanged[:3]}")
    for sub in ("retriever", "generator"):
        for k, v in getattr(setup.rag, sub).state_dict().items():
            name = f"{sub}.{k}"
            if name in held["frozen"]:
                check(v.double().sum().item() == held["frozen"][name], f"train: frozen {name} changed")
    per_step = {k: v / n_steps for k, v in launches.items()}
    cal = (f"a8_calibrate_every={a8_calibrate_every} (a_scale {a_range[0]:.3e}..{a_range[1]:.3e} over "
           f"{len(sites)} sites; one calibration forward {out['calibration_s'] * 1e3:.1f} ms, outside the timed "
           f"epoch; step + calibration / {a8_calibrate_every} = {out['amortised_step_time']:.3f} s)"
           if a8_calibrate_every else "a8_calibrate_every=0 (dynamic per-row)")
    print(f"[train] bge-large + llama2-7b ({layers} layers), batch {batch}, Q/P/G 50/128/256, bf16, fused QLoRA, "
          f"int8 generator base, int8_compute=all, {cal}: {n_steps} optimiser steps in {wall:.1f} s (init included); "
          f"step time {out['avg_step_time']:.3f} s = {out['samples_per_sec']:.2f} samples/s (second epoch); "
          f"losses total/retriever/generator {out['final_loss']:.4f}/{out['final_retriever_loss']:.4f}/"
          f"{out['final_generator_loss']:.4f}; peak memory {peak_gib:.2f} GiB; launches per step {per_step}; "
          f"{len(held['trainable'])} trainable tensors all changed, {len(held['frozen'])} frozen unchanged", flush=True)
    if kernel_ms and not a8_calibrate_every:
        # Where one step's time goes, from each kernel's time at each shape
        # (this run's k1/k2 phases) times its launches at that shape.
        shapes = {(4096, 4096): 4 * layers, (4096, 11008): 2 * layers, (11008, 4096): layers, (4096, 32000): 1}

        def k1_total(name):  # forward and recompute of every layer's linears, the lm_head once
            return sum(kernel_ms[name, kn] * n * 2 for kn, n in shapes.items()) - kernel_ms[name, (4096, 32000)]

        k1 = k1_total("w8a8_fused")
        parts = {name: k1_total(f"k1_{name}") for name in ("quant_prepass", "weight_prepass", "gemm")}
        nt = sum(kernel_ms["int8_gemm_nt", kn] * n for kn, n in shapes.items()) - 3 * kernel_ms["int8_gemm_nt", (4096, 4096)]
        k2 = (kernel_ms["rowquant", 4096] * (5 * layers - 3) + kernel_ms["rowquant", 11008] * 2 * layers
              + kernel_ms["rowquant", 32000])
        step_ms = out["avg_step_time"] * 1e3
        print(f"[train] one step = {step_ms:.0f} ms; kernels at their measured times x launches: K1 {k1:.0f} ms "
              f"(quantise pre-pass {parts['quant_prepass']:.0f} + weight pre-pass {parts['weight_prepass']:.0f} + "
              f"GEMM {parts['gemm']:.0f} ms alone), "
              f"dx GEMM {nt:.0f} ms, K2 {k2:.0f} ms, everything else (retriever, attention, norms, LoRA, loss, "
              f"optimiser, host) {step_ms - k1 - nt - k2:.0f} ms", flush=True)
    held.clear()
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def train_dycal_phase(device, workdir, batch, steps):
    """The flagship with calibrated backward dy scales: ``a8_calibrate_every=2, a8_dy_calibrate=True``. Every step
    is a probe (its activation scales' out-of-band gradient becomes the next step's dy scales), the first with the
    dynamic dy backward; calibration passes at micro steps 0, 1 and 2. Reads the out-of-band channel before its
    1e-8 floor (each probe backward's ``max |dy * scale|``, by site): one reading a site and step, all finite,
    non-zero at every site in the first probe and at every o_proj, down_proj and lm_head in all; checks every
    site's dy scale is finite and > 0, and prints both ranges and the zero readings by projection. Returns the
    launches."""
    import numpy as np
    import torch

    per_epoch = max(steps // 2, 1)
    csv_path = str(Path(workdir) / "train.csv")
    write_csv(csv_path, batch * per_epoch, np.random.default_rng(2))
    from dalm_tpu_torch.kernels import int8_matmul as im

    held, raw, current = {}, [], []
    fn = im._Int8MatmulCal
    clamp, forward, backward = im._dy_scale_grad, fn.forward, fn.backward

    # The out-of-band channel read before its 1e-8 floor: each probe backward's max |dy * scale|, on the device,
    # under the name of its site (the forward tags its context by the site's int8 weight).
    def tagged_forward(ctx, x, q, *rest):
        ctx.site = held["names"][q.data_ptr()]
        return forward(ctx, x, q, *rest)

    def tagged_backward(ctx, dy):
        current.append(ctx.site)
        return backward(ctx, dy)

    def reading(amax):
        raw.append((current[-1], amax.detach().float().reshape(())))
        return clamp(amax)

    def hook(setup):
        held["rag"] = setup.rag
        held["names"] = {m.q.data_ptr(): name for name, m in setup.rag.generator.named_modules()
                         if getattr(m, "q", None) is not None}

    counters = _train_counters()
    _zero_train_counters()
    torch.cuda.reset_peak_memory_stats()
    im._dy_scale_grad, fn.forward, fn.backward = reading, staticmethod(tagged_forward), staticmethod(tagged_backward)
    t0 = time.perf_counter()
    try:
        out = _flagship(device, csv_path, batch, num_train_epochs=2, a8_calibrate_every=2, a8_dy_calibrate=True,
                        setup_hook=hook)
        torch.cuda.synchronize()
    finally:
        im._dy_scale_grad, fn.forward, fn.backward = clamp, staticmethod(forward), staticmethod(backward)
    wall = time.perf_counter() - t0
    launches = {name: read() for name, read in counters.items()}
    for key in ("final_loss", "final_retriever_loss", "final_generator_loss"):
        check(np.isfinite(out[key]), f"train-dycal: {key} is not finite")
    sites = [m for m in held["rag"].generator.modules() if getattr(m, "q", None) is not None]
    dys = torch.stack([m.dy_scale for m in sites]).float()
    check(bool(torch.isfinite(dys).all()) and bool((dys > 0).all()), "train-dycal: a dy scale is not finite and > 0")
    # Every step is a probe and every site is used once a step, so the channel carries one amax a site and step.
    per_site = {}
    for name, amax in raw:
        per_site.setdefault(name, []).append(amax)
    counts = {len(v) for v in per_site.values()}
    check(len(per_site) == len(sites) and counts == {out["steps"]},
          f"train-dycal: amax readings at {len(per_site)} of {len(sites)} sites, {counts} a site, {out['steps']} steps")
    names = list(per_site)
    unclamped = torch.stack([torch.stack(per_site[n]) for n in names]) / 127.0  # (sites, steps): dy scale asked for
    check(bool(torch.isfinite(unclamped).all()), "train-dycal: a non-finite amax on the out-of-band channel")
    # The first probe's backward is unquantised: every site's dy is non-zero. Later probes quantise each dx with
    # the dy scale of the step before, so a site whose max |dy * scale| is under half its scale passes a zero dx
    # upstream; o_proj, down_proj and lm_head take their dy along the residual stream from the loss, and stay
    # non-zero.
    residual = torch.tensor([n.endswith(("o_proj", "down_proj", "lm_head")) for n in names])
    check(bool((unclamped[:, 0] > 0).all()), f"train-dycal: the first probe read {int((unclamped[:, 0] == 0).sum())} "
                                             f"zero amaxes")
    check(bool((unclamped[residual] > 0).all()), "train-dycal: a zero amax at an o_proj, down_proj or lm_head")
    zero_by_kind, max_by_kind = {}, {}
    for n, row in zip(names, unclamped):
        kind = n.rpartition(".")[2]
        zero_by_kind[kind] = zero_by_kind.get(kind, 0) + int((row == 0).sum())
        max_by_kind[kind] = max(max_by_kind.get(kind, 0.0), float(row.max()))
    nonzero = unclamped[unclamped > 0]
    floored = int((nonzero < 1e-8).sum())
    check(launches["k1_cal_quant[dy]"] > 0 and launches["k1_cal_quant"] > 0, f"train-dycal: launches {launches}")
    per_step = {k: v / out["steps"] for k, v in launches.items()}
    print(f"[train-dycal] flagship with a8_calibrate_every=2, a8_dy_calibrate=True: {out['steps']} steps in {wall:.1f} s "
          f"(init included); step time {out['avg_step_time']:.3f} s = {out['samples_per_sec']:.2f} samples/s (second "
          f"epoch); losses total/retriever/generator {out['final_loss']:.4f}/{out['final_retriever_loss']:.4f}/"
          f"{out['final_generator_loss']:.4f}; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; generator "
          f"dy_scale over {len(sites)} sites min {float(dys.min()):.3e} median {float(dys.median()):.3e} max "
          f"{float(dys.max()):.3e}; before the 1e-8 floor, max |dy * scale| / 127 over {len(raw)} readings: "
          f"{nonzero.numel()} non-zero, min {float(nonzero.min()):.3e} median {float(nonzero.median()):.3e} max "
          f"{float(nonzero.max()):.3e}, {floored} of them under the floor; zero readings by projection "
          f"{zero_by_kind}, the largest by projection {{{', '.join(f'{k}: {v:.3e}' for k, v in max_by_kind.items())}}}"
          f"; the retriever (bf16 base) has none; launches per step {per_step}", flush=True)
    held.clear()
    torch.cuda.empty_cache()
    return launches


def train_live_phase(device, workdir, batch, steps, k=4):
    """The flagship with the live index, hard negatives and the true top-k marginal: ``live_index=True,
    index_refresh_slice=256, live_negatives_k=8, marginalize_k=k, marginalize_mode="token",
    marginalize_warmup_steps=1`` over a synthetic CSV of 4,608 rows with unique passages, ``steps`` steps. Each
    step ends with one refresher tick (256 passages through bge-large); after training a full sweep. Prints step
    s (host clock, tick to tick, after the first step), peak GiB, ms a tick and the index version; checks the
    index's rows are finite unit vectors. Returns the launches."""
    import numpy as np
    import torch

    csv_path = str(Path(workdir) / "live.csv")
    write_csv(csv_path, 4608, np.random.default_rng(6))  # each passage carries its row number: all distinct
    held, ticks = {}, []

    def hook(setup):
        held["refresher"] = setup.refresher
        real = setup.refresher.tick

        def timed():
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = real()
            torch.cuda.synchronize()
            ticks.append((t, time.perf_counter() - t))
            return r

        setup.refresher.tick = timed

    counters = _train_counters()
    _zero_train_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = _flagship(device, csv_path, batch, max_train_steps=steps, live_index=True, index_refresh_slice=256,
                    live_negatives_k=8, marginalize_k=k, marginalize_mode="token", marginalize_warmup_steps=1,
                    setup_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: read() for name, read in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for key in ("final_loss", "final_retriever_loss", "final_generator_loss"):
        check(np.isfinite(out[key]), f"train-live: {key} is not finite")
    rows = out["live_index"].embeddings
    norm_err = float((rows.float().norm(dim=1) - 1).abs().max())
    # bf16 embeddings, normalised in bf16: a norm within about one bf16 ulp (2^-8 = 3.9e-3) of 1
    check(rows.shape[0] == 4608 and bool(torch.isfinite(rows).all()) and norm_err < 5e-3,
          f"train-live: the index's rows are not finite unit vectors (norms off by {norm_err:.3e})")
    check(out["index_version"] >= 1 and launches["k1_cal_quant"] > 0, f"train-live: version {out['index_version']}")
    train_ticks = ticks[:steps]
    step_s = [b[0] - a[0] for a, b in zip(train_ticks, train_ticks[1:])]
    sweep = ticks[steps:]
    print(f"[train-live] flagship + live index (4608 unique passages, slice 256), live_negatives_k=8, "
          f"marginalize_k={k} (token), warm-up 1 step: {out['steps']} steps in {wall:.1f} s (init, preprocessing and "
          f"the final sweep included); step s after the first {', '.join(f'{x:.3f}' for x in step_s)}; peak "
          f"{peak:.2f} GiB; a tick {np.mean([t for _, t in ticks]) * 1e3:.1f} ms ({len(ticks)} ticks, {len(sweep)} of "
          f"them the final sweep); index version {out['index_version']}, rows' norms within {norm_err:.1e} of 1; "
          f"losses total/retriever/generator "
          f"{out['final_loss']:.4f}/{out['final_retriever_loss']:.4f}/{out['final_generator_loss']:.4f}", flush=True)
    held.clear()
    del out, rows
    torch.cuda.empty_cache()
    return launches


def train_merge_phase(device, workdir, batch, steps):
    """The reference's default runtime at full width: ``use_peft="both", use_bnb="retriever",
    lora_runtime="merge", use_dropout=True, export_peft=True``, a profiler window over step 1, ``steps`` steps;
    the split save into a temporary directory. Checks the PEFT files of both sub-models and the trace exist."""
    import numpy as np
    import torch

    per_epoch = max(steps // 2, 1)
    csv_path = str(Path(workdir) / "train.csv")
    write_csv(csv_path, batch * per_epoch, np.random.default_rng(2))
    out_dir, prof_dir = Path(workdir) / "merge_out", Path(workdir) / "merge_trace"
    import shutil

    free_gib = shutil.disk_usage(workdir).free / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = _flagship(device, csv_path, batch, num_train_epochs=2, use_bnb="retriever", lora_runtime="merge",
                    use_dropout=True, export_peft=True, profile_dir=str(prof_dir), profile_start_step=1,
                    profile_num_steps=1, output_dir=str(out_dir))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for key in ("final_loss", "final_retriever_loss", "final_generator_loss"):
        check(np.isfinite(out[key]), f"train-merge: {key} is not finite")
    for sub in ("retriever", "generator"):
        for f in ("adapter_model.bin", "adapter_config.json", "adapter_params.pt", "state_dict.pt"):
            check((out_dir / sub / f).is_file(), f"train-merge: {sub}/{f} missing")
    traces = sorted(prof_dir.glob("trace_*.json"))
    check(len(traces) == 1, f"train-merge: traces {traces}")
    peft = torch.load(out_dir / "generator" / "adapter_model.bin", weights_only=True)
    check(len(peft) == 2 * 2 * 32, f"train-merge: {len(peft)} PEFT tensors in the generator's file")
    saved = torch.load(out_dir / "retriever" / "state_dict.pt", weights_only=True)
    check(saved["layer_0.attention.query.q"].dtype == torch.int8, "train-merge: the retriever's base is not int8")
    sizes = {sub: (out_dir / sub / "state_dict.pt").stat().st_size / 2 ** 30 for sub in ("retriever", "generator")}
    print(f"[train-merge] bge-large + llama2-7b, merge runtime, LoRA on both, int8 retriever base, dropout on: "
          f"{out['steps']} steps in {wall:.1f} s (init, the trace and the {sizes['generator']:.2f} + "
          f"{sizes['retriever']:.2f} GiB save included; {free_gib:.0f} GiB free before); step time "
          f"{out['avg_step_time']:.3f} s = {out['samples_per_sec']:.2f} samples/s (second epoch); losses "
          f"total/retriever/generator {out['final_loss']:.4f}/{out['final_retriever_loss']:.4f}/"
          f"{out['final_generator_loss']:.4f}; peak {peak:.2f} GiB; trace {traces[0].name} "
          f"{traces[0].stat().st_size / 2 ** 20:.1f} MiB; PEFT files of both sub-models written", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(prof_dir, ignore_errors=True)
    del saved, peft
    torch.cuda.empty_cache()


def train_retriever_phase(device, workdir, steps):
    """``train_retriever("bge-large", csv, use_peft=True, use_bnb=True, use_dropout=True, export_peft=True,
    per_device_train_batch_size=32)`` for ``steps`` steps in two epochs, bf16, the byte tokenizer at 30522."""
    import numpy as np
    import torch

    from dalm_tpu_torch.train import train_retriever

    csv_path = str(Path(workdir) / "retr.csv")
    write_csv(csv_path, 32 * max(steps // 2, 1), np.random.default_rng(7))  # two epochs: the second is timed
    out_dir = Path(workdir) / "retr_out"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_retriever("bge-large", csv_path, use_peft=True, use_bnb=True, use_dropout=True, export_peft=True,
                          per_device_train_batch_size=32, num_train_epochs=2, tokenizer="byte@30522",
                          dtype="bfloat16", device=device, output_dir=str(out_dir), with_tracking=False, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(np.isfinite(out["final_loss"]) and out["steps"] == 2 * max(steps // 2, 1), f"train-retriever: {out}")
    for f in ("adapter_model.bin", "adapter_config.json", "state_dict.pt"):
        check((out_dir / "retriever" / f).is_file(), f"train-retriever: retriever/{f} missing")
    print(f"[train-retriever] train_retriever(bge-large, LoRA, int8 base, dropout on, batch 32, Q/P 50/128, bf16): "
          f"{out['steps']} steps in {wall:.1f} s (init included); step time {out['avg_step_time']:.3f} s (second epoch); "
          f"final loss {out['final_loss']:.4f}; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; PEFT "
          f"files written", flush=True)
    import shutil

    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()


def write_chat_jsonl(path, n, chars, rng):
    """A synthetic ``messages`` dataset: ``n`` two-turn rows of random lower-case text, ``chars`` characters a turn."""
    letters = list(string.ascii_lowercase + " ")
    with open(path, "w") as f:
        for i in range(n):
            turns = [{"role": role, "content": "".join(rng.choice(letters, size=chars)) + f" {i}"}
                     for role in ("user", "assistant")]
            f.write(json.dumps({"messages": turns}) + "\n")


# f32 losses near 6 are spaced 4.8e-7; card and CPU differed by at most 2 such steps (9.5e-7) in the runs
# recorded in PERF.md: the tolerance is 3 times that.
SFT_SMALL_TOL = 3e-6


def sft_small_phase(device, workdir):
    """The tiny preset through ``train_generator`` (LoRA merge runtime, packed
    blocks of 256 tokens so that the flash branch is taken, f32, no NEFTune
    noise) on the card and on the CPU, from the same saved model and the same
    factors. Train and validation losses after 1, 2 and 3 steps agree within
    ``SFT_SMALL_TOL`` (the K4 kernels equal their plain versions to 1e-5 in
    f32; what differs is the order of f32 sums in the matmuls, amplified by
    Adam's normalised update). A control run whose updates do nothing (learning
    rate 0) must miss that tolerance by far, so the tolerance does tell a
    sound trainer from a broken one. The counters must show 2 layers x (forward + recompute)
    forward launches and 2 dsum, 2 dq and 2 dk/dv launches a step, every backward on the route
    ``fwd_route`` gives the tiny preset (f32, head dim 32: the mma.sync pair)."""
    import numpy as np
    import torch

    from dalm_tpu_torch.kernels.flash_attention import flash_attention, flash_bwd, fwd_route
    from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
    from dalm_tpu_torch.models.registry import save_pretrained
    from dalm_tpu_torch.train import train_generator

    data = str(Path(workdir) / "chat_small.jsonl")
    write_chat_jsonl(data, 48, 150, np.random.default_rng(3))
    base = Decoder(DecoderConfig.tiny(vocab_size=384), device="cpu")
    base.reset_parameters(torch.Generator().manual_seed(4))
    model_dir = str(Path(workdir) / "tiny_generator")
    save_pretrained(model_dir, base.cfg, base.state_dict())
    kw = dict(seq_length=256, per_device_train_batch_size=4, per_device_eval_batch_size=4, validation_split=0.3,
              lora_r=8, lora_alpha=16, learning_rate=1e-2, num_warmup_steps=0, neftune_noise_alpha=0,
              logging_steps=1, eval_steps=0, output_dir=None, seed=3)
    factors = {}

    def keep(setup):
        factors.update({k: p.detach().clone() for k, p in setup.state.params.items()})

    def give(setup):
        with torch.no_grad():
            for k, p in setup.state.params.items():
                p.copy_(factors[k])

    worst = 0.0
    for steps in (1, 2, 3):
        cpu = train_generator(model_dir, data, max_train_blocks=4 * steps, device="cpu", setup_hook=keep, **kw)
        flash_attention.launches = dict.fromkeys(flash_attention.launches, 0)
        flash_bwd.routes = dict.fromkeys(flash_bwd.routes, 0)
        card = train_generator(model_dir, data, max_train_blocks=4 * steps, device=device, setup_hook=give, **kw)
        launches, routes = dict(flash_attention.launches), dict(flash_bwd.routes)
        check(card["steps"] == cpu["steps"] == steps, f"sft-small: took {card['steps']} steps, wanted {steps}")
        for key in ("final_loss", "eval_loss"):
            check(np.isfinite(card[key]), f"sft-small: {key} is not finite")
            worst = max(worst, abs(card[key] - cpu[key]))
            check(abs(card[key] - cpu[key]) <= SFT_SMALL_TOL, f"sft-small step {steps}: {key} {card[key]} vs CPU {cpu[key]}")
        layers = base.cfg.num_layers
        evals = launches["fwd"] - 2 * layers * steps  # the validation pass at the end: one forward per layer and batch
        check(launches["dq"] == launches["dkv"] == launches["dsum"] == layers * steps and evals > 0
              and evals % layers == 0, f"sft-small step {steps}: K4 launches {launches}")
        route = fwd_route(base.cfg.dtype, base.cfg.head_dim)
        check(routes == dict(dict.fromkeys(routes, 0), **{route: layers * steps}),
              f"sft-small step {steps}: backward calls by route {routes}, every one should take {route}")
        print(f"[sft-small] {steps} step(s): card loss {card['final_loss']:.6f} / eval {card['eval_loss']:.6f}, CPU "
              f"{cpu['final_loss']:.6f} / {cpu['eval_loss']:.6f}; K4 launches {launches}, backward calls by route {routes} "
              f"({evals // layers} validation batches)", flush=True)
    still = train_generator(model_dir, data, max_train_blocks=4 * 3, device=device, setup_hook=give,
                            **dict(kw, learning_rate=0.0))
    control = min(abs(still[key] - cpu[key]) for key in ("final_loss", "eval_loss"))
    check(control > 100 * SFT_SMALL_TOL, f"sft-small: a run that learns nothing is within {control} of the trained one")
    print(f"[sft-small] tiny train_generator, card vs CPU, max loss difference {worst:.2e} (tolerance {SFT_SMALL_TOL}); "
          f"control with learning rate 0 differs by {control:.2e}", flush=True)
    torch.cuda.empty_cache()


SFT_KW = dict(seq_length=2560, dtype="bfloat16", use_peft=True, lora_r=256, lora_alpha=512, packing=True,
              gradient_checkpointing=True, neftune_noise_alpha=5, tokenizer="byte@32000", output_dir=None,
              logging_steps=1, eval_steps=0, num_warmup_steps=0, validation_split=0.3, seed=0)


def sft_phase(device, workdir, batch, steps, k4_ms):
    """The SFT main path: ``train_generator`` on a synthetic chat dataset,
    Llama-2-7B at full width and depth, bf16, LoRA r = 256 on q_proj / v_proj in
    the merge runtime, packed blocks of 2560 tokens, per-layer recomputation,
    NEFTune noise, ``steps`` optimiser steps and one validation batch. Returns
    the launches of the K4 kernels in that run: the forward, dq and dk/dv by route, the dsum pre-pass."""
    import gc

    import numpy as np
    import torch

    from dalm_tpu_torch.kernels.flash_attention import flash_attention, flash_bwd, flash_fwd
    from dalm_tpu_torch.losses.causal import causal_lm_loss
    from dalm_tpu_torch.train import train_generator

    data = str(Path(workdir) / "chat.jsonl")
    # 2 x 1000 characters a row: 11 training rows pack into 8 blocks of 2560 tokens, 5 validation rows into 4
    write_chat_jsonl(data, 16, 1000, np.random.default_rng(5))
    held = {}

    def snapshot(setup):
        held["setup"] = setup
        held["trainable"] = {k: p.detach().clone() for k, p in setup.state.params.items()}
        held["frozen"] = {k: v.double().sum().item() for k, v in setup.model.state_dict().items()
                          if k not in setup.state.params}
        # The factors start with B = 0, so the model is still the random base: its loss on the first
        # training batch must lie near ln(vocabulary), above it by about half the variance of the random
        # logits (0.02^2 x 4096 = 1.6).
        ids = torch.as_tensor(setup.train_blocks[:batch].astype(np.int64), device=setup.device)
        held["initial_loss"] = float(causal_lm_loss(setup.model(ids, torch.ones_like(ids)), ids))
        # every count to 0 just before the first step
        flash_attention.launches = dict.fromkeys(flash_attention.launches, 0)
        flash_fwd.routes = dict.fromkeys(flash_fwd.routes, 0)
        flash_bwd.routes = dict.fromkeys(flash_bwd.routes, 0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_generator("llama2-7b", data, per_device_train_batch_size=batch, per_device_eval_batch_size=batch,
                          max_train_blocks=batch * steps, device=device, setup_hook=snapshot, **SFT_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes, bwd_routes = dict(flash_attention.launches), dict(flash_fwd.routes), dict(flash_bwd.routes)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    setup = held["setup"]
    cfg = setup.model.cfg
    layers, n_steps = cfg.num_layers, out["steps"]
    check(n_steps == steps and steps >= 3, f"sft: took {n_steps} optimiser steps, wanted {steps}")
    check(cfg.attention_impl == "flash" and cfg.remat and setup.train_blocks.shape == (batch * steps, 2560),
          f"sft: config {cfg.attention_impl}, remat {cfg.remat}, blocks {setup.train_blocks.shape}")
    check(np.isfinite(out["final_loss"]) and np.isfinite(out["eval_loss"]), f"sft: losses {out}")
    ln_v = float(np.log(cfg.vocab_size))
    check(abs(held["initial_loss"] - ln_v) < 1.0,
          f"sft: the untrained loss {held['initial_loss']} is not near ln({cfg.vocab_size}) = {ln_v:.3f}")
    check(out["final_loss"] < held["initial_loss"] + 0.5, f"sft: the loss rose from {held['initial_loss']} to {out['final_loss']}")
    # Per step and layer: the forward kernel once in the forward and once more in the checkpointed
    # recompute, one dsum, one dq and one dk/dv launch in the backward; per validation batch one forward a layer.
    eval_batches = len(range(0, len(setup.valid_blocks) - batch + 1, batch))
    want = {"fwd": 2 * layers * n_steps + layers * eval_batches, "dq": layers * n_steps, "dkv": layers * n_steps,
            "dsum": layers * n_steps}
    check(eval_batches >= 1 and launches == want, f"sft: K4 launches {launches}, {layers} layers predict {want}")
    check(routes == {"wgmma": want["fwd"], "tf32x3": 0, "mma": 0}, f"sft: forward launches by route {routes}: every one of the "
          f"{want['fwd']} bf16 D {cfg.hidden_size // cfg.num_heads} forwards must take the wgmma route")
    check(bwd_routes == {"wgmma": want["dq"], "tf32x3": 0, "mma": 0}, f"sft: backward calls by route {bwd_routes}: every one of "
          f"the {want['dq']} backwards must take the wgmma route")
    unchanged = [k for k, p in setup.state.params.items() if torch.equal(p.detach(), held["trainable"][k])]
    check(len(held["trainable"]) == 4 * layers and not unchanged,
          f"sft: {len(unchanged)} of {len(held['trainable'])} LoRA factors did not change, e.g. {unchanged[:3]}")
    for k, v in setup.model.state_dict().items():
        if k in held["frozen"]:
            check(v.double().sum().item() == held["frozen"][k], f"sft: base tensor {k} changed")
    step_s = out["avg_step_time"]
    tokens = batch * 2560
    print(f"[sft] llama2-7b ({layers} layers, width {cfg.hidden_size}), batch {batch} x 2560 tokens, bf16, LoRA r=256 "
          f"(merge runtime), recompute, NEFTune 5: {n_steps} optimiser steps + {eval_batches} validation batch(es) in "
          f"{wall:.1f} s (init included); step time after the first step {step_s:.3f} s = {tokens / step_s:.0f} "
          f"tokens/s; loss before training {held['initial_loss']:.4f} (ln vocab {ln_v:.3f}), at step {n_steps} "
          f"{out['final_loss']:.4f}, validation after it {out['eval_loss']:.4f}; "
          f"peak memory {peak_gib:.2f} GiB; K4 launches per step fwd {2 * layers} dsum {layers} dq {layers} dkv {layers} "
          f"(+ {layers} fwd per validation batch), total {launches}, the forward's by route {routes}, the "
          f"backward's {bwd_routes}; "
          f"{len(held['trainable'])} LoRA factors all "
          f"changed, {len(held['frozen'])} base tensors unchanged", flush=True)
    if k4_ms:
        k4 = (2 * k4_ms["k4_fwd_wgmma"] + k4_ms["k4_dsum"] + k4_ms["k4_bwd_dq_wgmma"] + k4_ms["k4_bwd_dkv_wgmma"]) * layers
        print(f"[sft] one step = {step_s * 1e3:.0f} ms; K4 at its measured times x launches = {k4:.0f} ms "
              f"({100 * k4 / (step_s * 1e3):.1f}% of the step); the rest is the torch.matmul projections, the "
              f"LoRA merges, norms, rope, loss, optimiser and host (see --phases profile-sft)", flush=True)
    held.clear()
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    return {"k4_fwd_wgmma": routes["wgmma"], "k4_fwd": routes["mma"], "k4_bwd_dq_wgmma": bwd_routes["wgmma"],
            "k4_bwd_dkv_wgmma": bwd_routes["wgmma"], "k4_bwd_dq": bwd_routes["mma"], "k4_bwd_dkv": bwd_routes["mma"],
            "k4_dsum": launches["dsum"]}


def profile_phase(device, workdir, which, batch, steps):
    """Not part of the default run: ``--phases profile`` (the RAG trainer) or
    ``--phases profile-sft`` (the SFT trainer) traces that main path's
    optimiser steps with ``torch.profiler`` (CPU + CUDA activities, started
    when the trainer's setup is done) and prints the device's busy share of
    the wall time and the kernels that take most of the device time, per step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dalm_tpu_torch.train import train_e2e, train_generator

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    clock = {}

    def start(setup):
        torch.cuda.synchronize()
        prof.__enter__()
        clock["t0"] = time.perf_counter()

    try:
        if which == "profile-sft":
            data = str(Path(workdir) / "profile.jsonl")
            write_chat_jsonl(data, 16, 1000, np.random.default_rng(5))
            out = train_generator("llama2-7b", data, per_device_train_batch_size=batch,
                                  per_device_eval_batch_size=batch, max_train_blocks=batch * steps, device=device,
                                  setup_hook=start, **SFT_KW)
        else:
            per_epoch = max(steps // 2, 1)
            csv_path = str(Path(workdir) / "profile.csv")
            write_csv(csv_path, batch * per_epoch, np.random.default_rng(2))
            out = train_e2e(csv_path, "bge-large", "llama2-7b", dtype="bfloat16", use_bnb="generator",
                            query_max_len=50, passage_max_len=128, generator_max_len=256,
                            per_device_train_batch_size=batch, num_train_epochs=2, seed=0,
                            retriever_tokenizer="byte@30522", generator_tokenizer="byte@32000",
                            device=device, setup_hook=start, **TRAIN_KW)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - clock["t0"]) * 1e3
    finally:
        prof.__exit__(None, None, None)
    n = out["steps"]
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    check(rows, "the profiler recorded no device time")
    busy = sum(r[1] for r in rows)
    tail = " (the validation batch at the end included)" if which == "profile-sft" else ""
    print(f"[{which}] {n} steps under the profiler{tail}: wall {wall_ms / n:.0f} ms/step, device busy "
          f"{busy / n:.0f} ms/step = {100 * busy / wall_ms:.1f}% (idle {100 - 100 * busy / wall_ms:.1f}%)", flush=True)
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:25]:
        print(f"[{which}] {ms / n:9.2f} ms/step {count // n:6d} launches/step  {key[:110]}", flush=True)
    del prof
    torch.cuda.empty_cache()


K5_AT = {"base": "dalm_tpu/kernels/int4_matmul.py:496", "groupmm": "dalm_tpu/kernels/int4_matmul.py:496",
         "nf4": "dalm_tpu/kernels/int4_matmul.py:496", "i8mxu": "dalm_tpu/kernels/int4_matmul.py:464",
         "pcol": "dalm_tpu/kernels/int4_matmul.py:299"}
# Tolerances against the plain version, each row held to tol x its largest |plain| value. float32 outputs: pcol
# equal (int32 sums, then the same two f32 products); i8mxu 3e-5 (exact int8 products; where the kernel splits K
# across blocks its slices' folds are added in another order than the plain version's one sequential fold, each
# fold step rounding by 2^-24); base / groupmm / nf4 1e-4 (the same bf16 x bf16 products summed in another order).
# bfloat16 outputs, every instance: one bf16 ulp of the row's largest value (2^-7), as the final rounding may fall
# the other way.
K5_TOL = {"base": 1e-4, "groupmm": 1e-4, "nf4": 1e-4, "i8mxu": 3e-5, "pcol": 0.0}
K5_FORMAT = {"base": "int4", "groupmm": "int4", "i8mxu": "int4", "nf4": "nf4", "pcol": "int4pc"}
# Relative error ||a - b|| / ||b|| of the last-position logits on the 32 prompts, random-initialised weights.
# Tiny CPU runs (f32; 2 layers of width 64 / 2 of 256 / 8 of 256): against the float generator, the per-group
# tiers (int4 in every variant, nf4) 0.067-0.073 / 0.21-0.22 / 0.28-0.29, int4pc 0.13 / 0.32 / 0.42, int8 0.007 /
# 0.018 / 0.025; the 4-bit tiers through K5's plain version against the same packed weights through x @ dequant(W)
# (the JAX package's path off the TPU): base, groupmm, nf4 0.003-0.005, i8mxu and pcol (int8 activations)
# 0.015-0.016. The random 7B amplifies every perturbation: on the card (NVIDIA H100 80GB HBM3, 700 W) int8
# weights give 0.18 against bf16 (0.025 in the 8-layer tiny model), and 4-bit weights leave the logits unrelated
# to the bf16 ones (1.04-1.23: unrelated logits of one norm sit at sqrt(2)); K5 against x @ dequant(W) gave 0.050-0.077
# (base, groupmm, nf4) and 0.24-0.25 (i8mxu, pcol). So the 7B check that can fail is K5 against x @ dequant(W),
# bounded at 0.15 and 0.5 (a kernel that wrote zeros or garbage would sit at 1 or above); against bf16 the logits
# must be finite and below 1.5.
K5_LOGIT_BOUND = {"base": 0.15, "groupmm": 0.15, "nf4": 0.15, "i8mxu": 0.5, "pcol": 0.5}
K5_LOGIT_BOUND_BF16 = 1.5


def k5_err(y, ry, instance):
    """max |y - ry| after holding every row to its K5 tolerance; returns (max error, worst share of the bound)."""
    import torch

    check(bool(torch.isfinite(y.float()).all()), f"k5 {instance}: non-finite output")
    tol = K5_TOL[instance] if y.dtype == torch.float32 else 2.0 ** -7
    err = (y.float() - ry.float()).abs()
    bound = tol * ry.float().abs().amax(dim=1, keepdim=True)
    bad = err > bound
    check(not bool(bad.any()), f"k5 {instance} {str(y.dtype)}: {int(bad.sum())} values beyond {tol} of their row's max")
    share = float((err / bound.clamp(min=1e-30)).max()) if tol > 0 else 0.0
    return float(err.max()), share


def k5_weights(gen, device, K, N):
    """One random (K, N) f32 weight in each 4-bit format, quantised on the card with the port's quantisers."""
    import torch

    from dalm_tpu_torch.models import quant

    w = torch.randn((K, N), generator=gen, device=device) * 0.02
    out = {"int4": quant.quantize_tensor_int4(w), "nf4": quant.quantize_tensor_nf4(w),
           "int4pc": quant.quantize_tensor_int4pc(w)}
    del w
    return out


K5_PREFILL_SOURCE = "dalm_tpu_torch/csrc/int4_prefill.cu"


def prefill_timing(k5, quant, x, d, fmt, inst, group, w_bf16, out, fused_ms, peaks):
    """K5's prefill route at one shape: the pre-pass (held equal to its plain version), the GEMM (held to K5_TOL)
    and both together, each alone on operands prepared once, beside the plain versions, ``x @ Wt^T`` and the
    bounds. Returns (the keys it adds to the K5 record, the records of the two kernels)."""
    import torch

    mem_bw, _, bf16_rate, _ = peaks
    M, K = x.shape
    N = w_bf16.shape[1]
    q4, s4 = d["q4"], d["scale4"]
    nf4 = inst == "nf4"
    wt = torch.empty((N, K), dtype=torch.bfloat16, device=x.device)
    k5.launch_dequant(q4, s4, group, nf4, wt)
    torch.cuda.synchronize()
    check(torch.equal(wt, w_bf16.T), f"k5 prefill pre-pass {inst} K={K} N={N}: not equal to its plain version")
    dq_ms = cuda_ms(lambda: k5.launch_dequant(q4, s4, group, nf4, wt), 20)
    dq_plain_ms = cuda_ms(lambda: k5.prefill_dequant_ref(q4, s4, nf4), 2)
    gemm_ms = cuda_ms(lambda: k5.launch_gemm(x, wt, out), 10)
    gemm_err, share = k5_err(out, k5.prefill_gemm_ref(x, wt), inst)
    gemm_plain_ms = cuda_ms(lambda: k5.prefill_gemm_ref(x, wt), 2)
    lib_ms = cuda_ms(lambda: x @ wt.T, 10)
    both_ms = cuda_ms(lambda: (k5.launch_dequant(q4, s4, group, nf4, wt), k5.launch_gemm(x, wt, out)), 10)
    dq_bytes = q4.numel() + s4.numel() * 4 + N * K * 2
    t_bytes, t_ops = (M * K + N * K + M * N) * 2 / mem_bw * 1e3, 2.0 * M * K * N / bf16_rate * 1e3
    del wt
    recs = [
        {"name": f"k5_prefill_dequant[{inst}]", "route": "cuda", "source": K5_PREFILL_SOURCE, "replaces": K5_AT[inst],
         "case": f"K={K} N={N} group={group} ({fmt})", "max_abs_err": 0.0, "ms": dq_ms, "plain_ms": dq_plain_ms,
         "bound_ms": dq_bytes / mem_bw * 1e3, "bound_by": "bytes", "library_ms": None,
         "library_is": "none: no one PyTorch call decodes the packed nibbles"},
        {"name": "k5_prefill_gemm", "route": "cuda", "source": K5_PREFILL_SOURCE, "replaces": K5_AT[inst],
         "case": f"M={M} K={K} N={N} bf16 (Wt of {fmt})", "max_abs_err": gemm_err, "ms": gemm_ms,
         "plain_ms": gemm_plain_ms, "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": lib_ms,
         "library_is": "x @ Wt.T (torch.matmul)", "worst_share_of_tolerance": share,
         "tflops": 2.0 * M * K * N / gemm_ms * 1e-9},
    ]
    print(f"[k5]   prefill route {inst} M={M} K={K} N={N}: pre-pass {dq_ms:.4f} ms (bound {recs[0]['bound_ms']:.4f}, "
          f"plain {dq_plain_ms:.4f}), GEMM {gemm_ms:.4f} ms = {recs[1]['tflops']:.0f} TFLOP/s (x @ Wt^T {lib_ms:.4f}, "
          f"bound {recs[1]['bound_ms']:.4f}), both {both_ms:.4f} ms; the fused route forced {fused_ms:.4f} ms: "
          f"{fused_ms / both_ms:.2f}x faster, {both_ms / lib_ms:.2f}x the library", flush=True)
    extra = {"prefill_ms": both_ms, "prefill_dequant_ms": dq_ms, "prefill_gemm_ms": gemm_ms,
             "speedup_over_fused": fused_ms / both_ms}
    return extra, recs


def fold_timing(k5, im, x, d, inst, group, w_bf16, out, fused_ms, peaks):
    """K5's fold route at one shape (groupmm / i8mxu): the nibble pre-pass and, for i8mxu, K2's bf16 output (each
    held equal to its plain version), the fold GEMM (i8mxu equal to its plain version, groupmm within K5_TOL) and
    the route's launches together, each alone on operands prepared once, beside the plain versions, ``x @ W_bf16``
    and the bounds. Returns (the keys it adds to the K5 record, the records of the kernels)."""
    import torch

    mem_bw, f32_rate, bf16_rate, _ = peaks
    M, K = x.shape
    N = w_bf16.shape[1]
    q4, s4 = d["q4"], d["scale4"]
    G = K // (2 * group)
    wn = torch.empty((N, K), dtype=torch.bfloat16, device=x.device)
    k5.launch_nibbles(q4, wn)
    torch.cuda.synchronize()
    check(torch.equal(wn, k5.prefill_nibbles_ref(q4)), f"k5 nibble pre-pass K={K} N={N}: not equal to its plain version")
    nib_ms = cuda_ms(lambda: k5.launch_nibbles(q4, wn), 20)
    nib_plain_ms = cuda_ms(lambda: k5.prefill_nibbles_ref(q4), 2)
    recs = [{"name": "k5_prefill_nibbles", "route": "cuda", "source": K5_PREFILL_SOURCE, "replaces": K5_AT[inst],
             "case": f"K={K} N={N} (int4, unscaled)", "max_abs_err": 0.0, "ms": nib_ms, "plain_ms": nib_plain_ms,
             "bound_ms": (q4.numel() + N * K * 2) / mem_bw * 1e3, "bound_by": "bytes", "library_ms": None,
             "library_is": "none: no one PyTorch call decodes the packed nibbles"}]
    if inst == "i8mxu":
        a = torch.empty((M, K), dtype=torch.bfloat16, device=x.device)
        xs = torch.empty((M, 1), dtype=torch.float32, device=x.device)
        im.launch_rowquant(x, None, a, xs)
        rq, rs = im.rowquant_ref(x)
        torch.cuda.synchronize()
        check(torch.equal(a, rq.to(torch.bfloat16)) and torch.equal(xs, rs),
              f"k2 bf16 output R={M} K={K}: not equal to its plain version")
        rq_ms = cuda_ms(lambda: im.launch_rowquant(x, None, a, xs), 20)
        rq_plain_ms = cuda_ms(lambda: im.rowquant_ref(x, dtype=torch.bfloat16), 3)
        del rq, rs
        recs.append({"name": "rowquant[bf16]", "route": "cuda", "source": "dalm_tpu_torch/csrc/int8_matmul.cu",
                     "replaces": K2_AT, "case": f"R={M} K={K} bf16 in, bf16 out", "max_abs_err": 0.0, "ms": rq_ms,
                     "plain_ms": rq_plain_ms, "bound_ms": (2 * M * K * 2 + M * 4) / mem_bw * 1e3, "bound_by": "bytes",
                     "library_ms": None, "library_is": "none: no one PyTorch call quantises rows"})
    else:
        a, xs = x, None
    k5.launch_fold(a, wn, s4, xs, out)
    ry = k5.prefill_fold_ref(a, wn, s4, xs)
    torch.cuda.synchronize()
    if inst == "i8mxu":
        check(torch.equal(out, ry), f"k5 fold GEMM i8mxu M={M} K={K} N={N}: not equal to its plain version")
        err, share = 0.0, 0.0
    else:
        err, share = k5_err(out, ry, inst)
    del ry
    fold_ms = cuda_ms(lambda: k5.launch_fold(a, wn, s4, xs, out), 10)
    fold_plain_ms = cuda_ms(lambda: k5.prefill_fold_ref(a, wn, s4, xs), 1)
    lib_ms = cuda_ms(lambda: x @ w_bf16, 10)

    def route():
        if xs is not None:
            im.launch_rowquant(x, None, a, xs)
        k5.launch_nibbles(q4, wn)
        k5.launch_fold(a, wn, s4, xs, out)

    both_ms = cuda_ms(route, 10)
    t_bytes = (M * K * 2 + N * K * 2 + s4.numel() * 4 + M * N * 2 + (M * 4 if xs is not None else 0)) / mem_bw * 1e3
    t_ops, t_fold = 2.0 * M * K * N / bf16_rate * 1e3, 4.0 * G * M * N / f32_rate * 1e3
    recs.append({"name": f"k5_fold_gemm[{inst}]", "route": "cuda", "source": K5_PREFILL_SOURCE, "replaces": K5_AT[inst],
                 "case": f"M={M} K={K} N={N} group={group} bf16 ({'xq as bf16' if xs is not None else 'x'})",
                 "max_abs_err": err, "ms": fold_ms, "plain_ms": fold_plain_ms,
                 "bound_ms": max(t_bytes, t_ops, t_fold), "bound_by": "bytes" if t_bytes >= max(t_ops, t_fold)
                 else "operations", "library_ms": None,
                 "library_is": "none: no one PyTorch call folds the groups (x @ W_bf16, the bf16 tier's product, in "
                               "x_at_w_bf16_ms)", "x_at_w_bf16_ms": lib_ms, "bf16_operations_ms": t_ops,
                 "fold_operations_ms": t_fold, "worst_share_of_tolerance": share,
                 "tflops": 2.0 * M * K * N / fold_ms * 1e-9})
    print(f"[k5]   fold route {inst} M={M} K={K} N={N} group={group}: nibble pre-pass {nib_ms:.4f} ms (bound "
          f"{recs[0]['bound_ms']:.4f}, plain {nib_plain_ms:.4f})"
          + (f", K2 bf16 {recs[1]['ms']:.4f} ms (bound {recs[1]['bound_ms']:.4f})" if xs is not None else "")
          + f", fold GEMM {fold_ms:.4f} ms = {recs[-1]['tflops']:.0f} TFLOP/s (bound {recs[-1]['bound_ms']:.4f}: bf16 "
          f"{t_ops:.4f}, fold {t_fold:.4f}, bytes {t_bytes:.4f}; plain {fold_plain_ms:.4f}), the route {both_ms:.4f} ms; "
          f"the fused route forced {fused_ms:.4f} ms: {fused_ms / both_ms:.2f}x faster; x @ W_bf16 {lib_ms:.4f} ms: "
          f"{both_ms / lib_ms:.2f}x its time", flush=True)
    del wn
    extra = {"fold_route_ms": both_ms, "fold_nibbles_ms": nib_ms, "fold_gemm_ms": fold_ms,
             "speedup_over_fused": fused_ms / both_ms}
    return extra, recs


K5_I8_SOURCE = "dalm_tpu_torch/csrc/int8_matmul.cu"


def pcol_timing(k5, im, x, d, w_bf16, out, fused_ms, peaks):
    """K5 pcol's int8 route at one shape: K2 writing int8, the int8 nibble pre-pass and the scaled s8 GEMM (each
    held equal to its plain version) and the route's three launches together, each alone on operands prepared once,
    beside the plain versions, ``x @ W_bf16``, ``torch._int_mm``, the fused kernel forced (with and without its K2),
    K1's fold instance on the same operands (one k-block of all of K: the same function, held equal) and the
    bounds. Returns (the keys it adds to the K5 record, the records of the two new kernels)."""
    import torch

    mem_bw, _, _, int8_rate = peaks
    M, K = x.shape
    N = w_bf16.shape[1]
    q4, s4 = d["q4"], d["scale4"]
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    xs = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    wn = torch.empty((N, K), dtype=torch.int8, device=x.device)
    im.launch_rowquant(x, None, xq, xs)
    k5.launch_nibbles(q4, wn)
    torch.cuda.synchronize()
    check(torch.equal(wn, k5.prefill_nibbles_ref(q4, torch.int8)),
          f"k5 int8 nibble pre-pass K={K} N={N}: not equal to its plain version")
    nib_ms = cuda_ms(lambda: k5.launch_nibbles(q4, wn), 20)
    nib_plain_ms = cuda_ms(lambda: k5.prefill_nibbles_ref(q4, torch.int8), 2)
    k2_ms = cuda_ms(lambda: im.launch_rowquant(x, None, xq, xs), 20)
    im.launch_gemm_scaled(xq, wn, xs, s4, out)
    ry = im.int8_gemm_scaled_ref(xq, wn, xs, s4)
    torch.cuda.synchronize()
    check(torch.equal(out, ry), f"k5 pcol GEMM M={M} K={K} N={N}: not equal to its plain version")
    del ry
    gemm_ms = cuda_ms(lambda: im.launch_gemm_scaled(xq, wn, xs, s4, out), 10)
    gemm_plain_ms = cuda_ms(lambda: im.int8_gemm_scaled_ref(xq, wn, xs, s4), 1)
    # K1's GEMM (128 x 192 tile, the k-block fold) with one k-block of all of K computes the same function
    ws, other = s4.reshape(-1), torch.empty_like(out)
    im._launch_fold(xq, xs, wn, ws, other)
    torch.cuda.synchronize()
    check(torch.equal(other, out), f"k5 pcol M={M} K={K} N={N}: K1's fold instance at bk = K differs")
    k1_fold_ms = cuda_ms(lambda: im._launch_fold(xq, xs, wn, ws, other), 10)
    int_mm_ms = cuda_ms(lambda: torch._int_mm(xq, wn.T), 10)
    lib_ms = cuda_ms(lambda: x @ w_bf16, 10)
    fused_k2_ms = cuda_ms(lambda: (im.launch_rowquant(x, None, xq, xs), k5.launch("pcol", xq, xs, q4, s4, K, other)), 5)

    def route():
        im.launch_rowquant(x, None, xq, xs)
        k5.launch_nibbles(q4, wn)
        im.launch_gemm_scaled(xq, wn, xs, s4, out)

    both_ms = cuda_ms(route, 10)
    t_bytes = (M * K + N * K + M * 4 + N * 4 + M * N * 2) / mem_bw * 1e3
    t_ops = 2.0 * M * K * N / int8_rate * 1e3
    recs = [{"name": "k5_prefill_nibbles[int8]", "route": "cuda", "source": K5_PREFILL_SOURCE,
             "replaces": K5_AT["pcol"], "case": f"K={K} N={N} (int4pc, int8 out)", "max_abs_err": 0.0, "ms": nib_ms,
             "plain_ms": nib_plain_ms, "bound_ms": (q4.numel() + N * K) / mem_bw * 1e3, "bound_by": "bytes",
             "library_ms": None, "library_is": "none: no one PyTorch call decodes the packed nibbles"},
            {"name": "k5_pcol_gemm", "route": "cuda", "source": K5_I8_SOURCE, "replaces": K5_AT["pcol"],
             "case": f"M={M} K={K} N={N} int8 x int8, row and column scales, bf16 out", "max_abs_err": 0.0,
             "ms": gemm_ms, "plain_ms": gemm_plain_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
             "library_is": "none: torch._int_mm gives the int32 sums without the scales (int_mm_ms)",
             "int_mm_ms": int_mm_ms, "k1_fold_instance_ms": k1_fold_ms, "x_at_w_bf16_ms": lib_ms,
             "tops": 2.0 * M * K * N / gemm_ms * 1e-9}]
    print(f"[k5]   int8 route pcol M={M} K={K} N={N}: K2 {k2_ms:.4f} ms, int8 nibble pre-pass {nib_ms:.4f} ms (bound "
          f"{recs[0]['bound_ms']:.4f}, plain {nib_plain_ms:.4f}), scaled GEMM {gemm_ms:.4f} ms = "
          f"{recs[1]['tops']:.0f} TOP/s = {100 * t_ops / gemm_ms:.0f}% of the int8 peak (bound {t_ops:.4f}; plain "
          f"{gemm_plain_ms:.4f}; torch._int_mm {int_mm_ms:.4f}; K1's fold instance at bk = K {k1_fold_ms:.4f} = "
          f"{100 * t_ops / k1_fold_ms:.0f}%), the route {both_ms:.4f} ms; the fused kernel forced {fused_ms:.4f} ms "
          f"({fused_k2_ms:.4f} with its K2): {fused_k2_ms / both_ms:.2f}x faster; x @ W_bf16 {lib_ms:.4f} ms: "
          f"{both_ms / lib_ms:.2f}x its time", flush=True)
    del xq, xs, wn, other
    extra = {"int8_route_ms": both_ms, "int8_route_k2_ms": k2_ms, "int8_nibbles_ms": nib_ms, "pcol_gemm_ms": gemm_ms,
             "fused_with_k2_ms": fused_k2_ms, "speedup_over_fused": fused_k2_ms / both_ms}
    return extra, recs


def _extreme_int4(gen, device, K, N, group, cancel):
    """A 4-bit weight of nibbles 0 and 15 only (nib - 8 = -8 or 7) with power-of-two scales. ``cancel``: in each
    group and column the first half of the rows +7, the rest -8, so a group's running sums climb to group / 2 x
    127 x 7 against rows of 127 and end at a small integer."""
    import torch

    if cancel:
        bits = ((torch.arange(K, device=device) % group) < group // 2).to(torch.uint8)[:, None].expand(K, N) * 15
    else:
        bits = torch.randint(0, 2, (K, N), generator=gen, device=device, dtype=torch.uint8) * 15
    half = K // 2
    q4 = (bits[:half] | (bits[half:] << 4)).contiguous()
    s4 = torch.exp2(torch.randint(-8, -4, (K // group, N), generator=gen, device=device).float())
    return q4, s4


def _extreme_pcol(gen, device, K, N, case):
    """An int4pc weight of nibbles 0 and 15 only (nib - 8 = -8 or 7) with power-of-two column scales, and rows that
    K2 quantises to +-127. ``random``: random nibbles and signs; ``ones_neg`` / ``ones_pos``: rows of ones against
    every nibble -8 / 7, so nothing cancels and every int32 sum is K * 127 * 8 (or 7)."""
    import torch

    if case == "random":
        bits = torch.randint(0, 2, (K, N), generator=gen, device=device, dtype=torch.uint8) * 15
        x = torch.randint(0, 2, (1024, K), generator=gen, device=device).float() * 2 - 1
    else:
        bits = torch.full((K, N), 0 if case == "ones_neg" else 15, dtype=torch.uint8, device=device)
        x = torch.ones((1024, K), device=device)
    q4 = (bits[:K // 2] | (bits[K // 2:] << 4)).contiguous()
    s4 = torch.exp2(torch.randint(-8, -4, (1, N), generator=gen, device=device).float())
    return q4, s4, x.to(torch.bfloat16)


# Gemma3-1B's projections whose K of 1,152 packs at group 8 (quant._int4_group): q_proj (4 heads of 256),
# k_proj / v_proj (1 kv head), gate_proj / up_proj; 26 layers. The fused kernel takes them on its instances for
# groups of 8 (csrc/int4_matmul.cu i4_kernel<BASE|NF4, T, true>); the kernels-line entry is the q shape at M 32, bf16.
GEMMA3_GROUP8 = (("q_proj", 1152, 1024), ("k_proj / v_proj", 1152, 256), ("gate_proj / up_proj", 1152, 6912))
GEMMA3_LAYERS = 26
K5_G8 = "int4_matmul[base,group8]"
K5_FUSED_SOURCE = "dalm_tpu_torch/csrc/int4_matmul.cu"


def k5_group8_time(gen, device, peaks, smi):
    """K5 base and nf4 at group 8 (Gemma3-1B's q, k / v and gate / up at K 1,152). At decode's M 32, bf16 and f32:
    ``int4_matmul_fwd`` on the route ``_route`` gives (the fused kernel's instances for groups of 8), one launch
    counted in ``fused.group8_launches``, held to the plain version (base and nf4); base timed by CUDA graph over
    copies of the weight (up to 64, so that most reads come from device memory, as a decode step's do) in turns with
    ``x @ W_bf16`` (fused, library, prefill, prefill, library, fused), the prefill route (pre-pass + GEMM, the route
    these shapes took before) forced on the same operands; f32 in turns with ``x @ W`` in f32. At prefill's M 8,192:
    the prefill route by CUDA events against ``x @ W_bf16``. Bounds: the 4-bit weight, its f32 scales, x and the
    output moved once, against 2 M N K bf16 operations. Returns (the records, the kernels-line entry)."""
    import math

    import torch

    from dalm_tpu_torch.kernels import int4_matmul as k5
    from dalm_tpu_torch.models import quant

    recs, entry, step = [], None, {"fused": 0.0, "prefill": 0.0, "library": 0.0}
    for label, K, N in GEMMA3_GROUP8:
        w = torch.randn((K, N), generator=gen, device=device) * 0.02
        d, dn = quant.quantize_tensor_int4(w), quant.quantize_tensor_nf4(w)
        del w
        group = K // d["scale4"].shape[0]
        check(group == 8 and K // dn["scale4"].shape[0] == 8, f"k5 group 8: {label} packed at group {group}")
        w_bf16 = k5._dequant(d["q4"], d["scale4"], torch.bfloat16, False)
        wbytes = d["q4"].numel() * d["q4"].element_size() + d["scale4"].numel() * d["scale4"].element_size()
        for M in (32, 8192):
            xf = torch.randn((M, K), generator=gen, device=device) * 0.5
            x = xf.to(torch.bfloat16)
            ops = 2.0 * M * N * K
            if M == 32:
                errs = {}
                for inst, dd in (("base", d), ("nf4", dn)):
                    for xt in (x, xf):
                        key = (inst, "fused")
                        before, g8 = dict(k5.int4_matmul_fwd.route_launches), dict(k5.fused.group8_launches)
                        y = k5.int4_matmul_fwd(xt, dd["q4"], dd["scale4"], inst)
                        check(k5.int4_matmul_fwd.route_launches[key] == before[key] + 1
                              and k5.fused.group8_launches[inst] == g8[inst] + 1,
                              f"k5 group 8 {label} {inst} {xt.dtype} M 32: not on the fused instance for groups of 8")
                        errs[inst, str(xt.dtype)[6:]] = k5_err(y, k5.int4_matmul_fwd_ref(xt, dd["q4"], dd["scale4"],
                                                                                         inst), inst)[0]
                        del y
                n = max(1, min(64, math.ceil(64e6 / wbytes)))
                qs = [(d["q4"].clone(), d["scale4"].clone()) for _ in range(n)]
                ws = [w_bf16.clone() for _ in range(max(1, min(64, math.ceil(64e6 / (K * N * 2)))))]
                wt = torch.empty((N, K), dtype=torch.bfloat16, device=device)
                out = torch.empty((M, N), dtype=torch.bfloat16, device=device)
                fns = {"fused": [lambda q=q, s=s: k5.int4_matmul_fwd(x, q, s, "base") for q, s in qs],
                       "library": [lambda wb=wb: x @ wb for wb in ws],
                       "prefill": [lambda q=q, s=s: (k5.launch_dequant(q, s, group, False, wt),
                                                     k5.launch_gemm(x, wt, out)) for q, s in qs],
                       "fused_f32": [lambda q=q, s=s: k5.int4_matmul_fwd(xf, q, s, "base") for q, s in qs],
                       "library_f32": [lambda wf=wf: xf @ wf for wf in [wb.float() for wb in ws[:max(1, len(ws) // 2)]]]}
                turns = {}
                for which in ("fused", "library", "prefill", "prefill", "library", "fused", "fused_f32",
                              "library_f32", "library_f32", "fused_f32"):
                    turns.setdefault(which, []).append(graph_ms(fns[which]))
                t = {k: sum(v) / len(v) for k, v in turns.items()}
                del qs, ws, wt, out, fns
                plain = cuda_ms(lambda: k5.int4_matmul_fwd_ref(x, d["q4"], d["scale4"], "base"), 3)
                reps = 2 if label != "q_proj" else 1  # per layer: k and v, gate and up
                for key in step:
                    step[key] += GEMMA3_LAYERS * reps * t[key]
                t_ops = ops / peaks[2] * 1e3
                for dtype, xbytes in (("bf16", 2), ("f32", 4)):
                    t_bytes = (wbytes + M * K * xbytes + M * N * xbytes) / peaks[0] * 1e3
                    f = "fused" if dtype == "bf16" else "fused_f32"
                    rec = dict(name=K5_G8 if dtype == "bf16" else f"{K5_G8}[f32]", route="cuda",
                               source=K5_FUSED_SOURCE, replaces=K5_AT["base"],
                               case=f"Gemma3-1B {label} M={M} K={K} N={N} group 8 {dtype}", ms=t[f],
                               turns_ms=turns[f], plain_ms=plain, bound_ms=max(t_ops, t_bytes),
                               bound_by="operations" if t_ops >= t_bytes else "bytes",
                               library_ms=t["library" if dtype == "bf16" else "library_f32"],
                               library_is="x @ W_bf16" if dtype == "bf16" else "x @ W in f32 (W = dequant(W) as f32)",
                               max_abs_err=errs["base", "bfloat16" if dtype == "bf16" else "float32"],
                               max_abs_err_nf4=errs["nf4", "bfloat16" if dtype == "bf16" else "float32"],
                               timed_by=f"CUDA graph over {n} weight copies, in turns")
                    if dtype == "bf16":
                        rec.update(prefill_ms=t["prefill"], prefill_turns_ms=turns["prefill"],
                                   library_turns_ms=turns["library"])
                        bf = rec
                        if entry is None:
                            entry = rec
                    recs.append(rec)
                print(f"[k5] group 8, Gemma3-1B {label} (K {K}, N {N}), M 32 ({smi}): fused instance for groups of 8 "
                      f"bf16 {t['fused']:.4f} ms (turns {turns['fused']}), f32 {t['fused_f32']:.4f} ms; x @ W_bf16 "
                      f"{t['library']:.4f} ms ({t['fused'] / t['library']:.2f}x), x @ W f32 {t['library_f32']:.4f} ms; "
                      f"the prefill route forced {t['prefill']:.4f} ms (turns {turns['prefill']}): the fused instance "
                      f"{t['prefill'] / t['fused']:.2f}x faster; bound {bf['bound_ms']:.4f} ms ({bf['bound_by']}); "
                      f"plain {plain:.3f} ms; max errors {errs}; by CUDA graph over {n} weight copies", flush=True)
            else:
                before = dict(k5.int4_matmul_fwd.route_launches)
                y = k5.int4_matmul_fwd(x, d["q4"], d["scale4"], "base")
                check(k5.int4_matmul_fwd.route_launches[("base", "prefill")] == before[("base", "prefill")] + 1,
                      f"k5 group 8 {label} M {M}: not on the prefill route")
                err, _ = k5_err(y, k5.int4_matmul_fwd_ref(x, d["q4"], d["scale4"], "base"), "base")
                ms = cuda_ms(lambda: k5.int4_matmul_fwd(x, d["q4"], d["scale4"], "base"), 20)
                lib = cuda_ms(lambda: x @ w_bf16, 20)
                plain = cuda_ms(lambda: k5.int4_matmul_fwd_ref(x, d["q4"], d["scale4"], "base"), 3)
                t_ops, t_bytes = ops / peaks[2] * 1e3, (wbytes + M * K * 2 + M * N * 2) / peaks[0] * 1e3
                rec = dict(name="int4_matmul[base] group 8, prefill route", route="cuda", source=K5_PREFILL_SOURCE,
                           replaces=K5_AT["base"], case=f"Gemma3-1B {label} M={M} K={K} N={N} group 8 bf16", ms=ms,
                           plain_ms=plain, bound_ms=max(t_ops, t_bytes),
                           bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=lib,
                           library_is="x @ W_bf16", max_abs_err=err, timed_by="CUDA events, 20 calls")
                recs.append(rec)
                print(f"[k5] group 8, Gemma3-1B {label} (K {K}, N {N}), M {M}, prefill route ({smi}): {ms:.4f} ms; "
                      f"x @ W_bf16 {lib:.4f} ms ({ms / lib:.2f}x); bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
                      f"{rec['bound_ms'] / ms:.1%} of it); plain {plain:.3f} ms; max error {err:.3g}", flush=True)
                del y
            del x, xf
        del d, dn, w_bf16
        torch.cuda.empty_cache()
    print(f"[k5] group 8, Gemma3-1B's decode step at M 32 ({GEMMA3_LAYERS} layers x (q + k + v + gate + up), each at "
          f"its time above): the fused instances {step['fused']:.3f} ms, the prefill route {step['prefill']:.3f} ms, "
          f"x @ W_bf16 {step['library']:.3f} ms", flush=True)
    return recs, entry


def k5_prefill_phase(gen, device, peaks):
    """The prefill routes beyond the Llama shapes: base and nf4 (the prefill route), groupmm and i8mxu (the fold
    route), pcol (the int8 route) on ragged shapes (M from M_PREFILL up, N no multiple of 128, groups 16-128)
    against the plain version, counted per route, i8mxu and pcol equal to it; i8mxu's exactness at the extremes of
    its operands (+-127 x -8 / 7) at groups 16 and 64, and pcol's at K 11008 and 4096; the fused kernel and each
    route timed by rows at two Llama shapes (the crossover that sets M_PREFILL). Returns the crossover records."""
    import torch

    from dalm_tpu_torch.kernels import int4_matmul as k5
    from dalm_tpu_torch.kernels import int8_matmul as im
    from dalm_tpu_torch.models import quant

    worst = {}
    qz = {"base": quant.quantize_tensor_int4, "nf4": quant.quantize_tensor_nf4, "groupmm": quant.quantize_tensor_int4,
          "i8mxu": quant.quantize_tensor_int4, "pcol": lambda w, group: quant.quantize_tensor_int4pc(w)}
    exact = ("i8mxu", "pcol")
    for M, K, N, group in ((k5.M_PREFILL, 1024, 136, 64), (300, 2048, 1000, 128), (1000, 11008, 264, 16),
                           (640, 4096, 1000, 32), (8192, 4096, 136, 32), (8192, 11008, 11008, 16)):
        w = torch.randn((K, N), generator=gen, device=device) * 0.02
        for inst in k5.PREFILL_INSTANCES:
            d = qz[inst](w, group)
            check(inst == "pcol" or K // d["scale4"].shape[0] == group, f"k5 prefill: group {group} at K={K}")
            x = (torch.randn((M, K), generator=gen, device=device) * 0.5).to(torch.bfloat16)
            x[0] = 0
            route = k5.PREFILL_ROUTE[inst]
            before = k5.int4_matmul_fwd.route_launches[inst, route]
            y = k5.int4_matmul_fwd(x, d["q4"], d["scale4"], inst)
            ry = k5.int4_matmul_fwd_ref(x, d["q4"], d["scale4"], inst)
            torch.cuda.synchronize()
            check(k5.int4_matmul_fwd.route_launches[inst, route] == before + 1, f"k5 {route} {inst}: route not taken")
            check(tuple(y.shape) == (M, N) and not bool(y[0].any()), f"k5 {route} {inst}: shape / zero row")
            check(inst not in exact or torch.equal(y, ry), f"k5 {route} {inst} M={M} K={K} N={N}: not equal to plain")
            worst[inst] = max(worst.get(inst, 0.0), k5_err(y, ry, inst)[1])
            del x, y, ry
        del w
    print(f"[k5] prefill, fold and int8 routes on ragged shapes (M {k5.M_PREFILL}-8192, N 136-11008, groups 16-128, "
          f"bf16): every instance within its tolerance, i8mxu and pcol equal to their plain versions; worst share of "
          f"the bound {worst}", flush=True)
    for K, group in ((11008, 16), (4096, 64)):
        for cancel in (False, True):
            q4, s4 = _extreme_int4(gen, device, K, 1000, group, cancel)
            x = torch.ones((1024, K), device=device) if cancel else \
                torch.randint(0, 2, (1024, K), generator=gen, device=device).float() * 2 - 1
            x = x.to(torch.bfloat16)
            y, ry = k5.int4_matmul_fwd(x, q4, s4, "i8mxu"), k5.int4_matmul_fwd_ref(x, q4, s4, "i8mxu")
            xq, _ = im.rowquant(x, dtype=torch.bfloat16)
            torch.cuda.synchronize()
            check(bool((xq.abs() == 127).all()), "k5 fold extremes: K2's values are not all +-127")
            check(torch.equal(y, ry), f"k5 fold i8mxu at the extremes (group {group}, "
                                      f"{'cancelling' if cancel else 'random'}): not equal to the plain version")
            del q4, s4, x, y, ry, xq
    print("[k5] fold route i8mxu at the extremes of its operands (K2's values +-127, nibbles -8 / 7; group 16 and 64, "
          "random and cancelling signs): equal to the plain version", flush=True)
    for K, case in ((11008, "random"), (11008, "ones_neg"), (11008, "ones_pos"), (4096, "ones_neg")):
        q4, s4, x = _extreme_pcol(gen, device, K, 1000, case)
        before = k5.int4_matmul_fwd.route_launches["pcol", "int8"]
        y, ry = k5.int4_matmul_fwd(x, q4, s4, "pcol"), k5.int4_matmul_fwd_ref(x, q4, s4, "pcol")
        xq, _ = im.rowquant(x)
        torch.cuda.synchronize()
        check(bool((xq.abs() == 127).all()), "k5 int8 route extremes: K2's values are not all +-127")
        check(k5.int4_matmul_fwd.route_launches["pcol", "int8"] == before + 1, "k5 int8 route extremes: route not taken")
        check(torch.equal(y, ry), f"k5 int8 route pcol at the extremes (K {K}, {case}): not equal to the plain version")
        del q4, s4, x, y, ry, xq
    print("[k5] int8 route pcol at the extremes of its operands (K2's values +-127, nibbles -8 / 7; K 11008 random, "
          "and rows of ones against every nibble -8 or 7, nothing cancelling, at K 11008 and 4096): equal to the plain "
          "version", flush=True)

    crossover = []
    for K, N in ((4096, 4096), (11008, 4096)):
        w = torch.randn((K, N), generator=gen, device=device) * 0.02
        d4, dpc = quant.quantize_tensor_int4(w), quant.quantize_tensor_int4pc(w)
        del w
        wt = torch.empty((N, K), dtype=torch.bfloat16, device=device)
        wn8 = torch.empty((N, K), dtype=torch.int8, device=device)
        for inst in ("base", "groupmm", "i8mxu", "pcol"):
            q4, s4 = (dpc if inst == "pcol" else d4)["q4"], (dpc if inst == "pcol" else d4)["scale4"]
            group = K // s4.shape[0]
            row = []
            for M in (32, 64, 128, 192, 256, 384, 512, 1024, 2048):
                x = (torch.randn((M, K), generator=gen, device=device) * 0.5).to(torch.bfloat16)
                out = torch.empty((M, N), dtype=torch.bfloat16, device=device)
                xs = torch.empty((M, 1), dtype=torch.float32, device=device)
                xq8 = torch.empty((M, K), dtype=torch.int8, device=device)
                xqb = torch.empty((M, K), dtype=torch.bfloat16, device=device)
                i8 = inst in ("i8mxu", "pcol")

                def fused():
                    if i8:
                        im.launch_rowquant(x, None, xq8, xs)
                    k5.launch(inst, xq8 if i8 else x, xs if i8 else None, q4, s4, group, out)

                def other():
                    if inst == "base":
                        k5.launch_dequant(q4, s4, group, False, wt)
                        k5.launch_gemm(x, wt, out)
                        return
                    if inst == "pcol":
                        im.launch_rowquant(x, None, xq8, xs)
                        k5.launch_nibbles(q4, wn8)
                        im.launch_gemm_scaled(xq8, wn8, xs, s4, out)
                        return
                    if i8:
                        im.launch_rowquant(x, None, xqb, xs)
                    k5.launch_nibbles(q4, wt)
                    k5.launch_fold(xqb if i8 else x, wt, s4, xs if i8 else None, out)

                row.append({"M": M, "fused_ms": graph_ms([fused], 10), "route_ms": graph_ms([other], 10)})
                del x, out, xs, xq8, xqb
            route = k5.PREFILL_ROUTE[inst]
            first = next((r["M"] for r in row if r["route_ms"] < r["fused_ms"]), None)
            crossover.append({"instance": inst, "route": route, "K": K, "N": N, "group": group, "rows": row,
                              "route_faster_from_M": first})
            print(f"[k5] crossover K={K} N={N} ({inst}, bf16; the fused kernel{' after K2' if i8 else ''} against the "
                  f"{route} route), ms fused / {route} by M: "
                  + ", ".join(f"{r['M']}: {r['fused_ms']:.4f} / {r['route_ms']:.4f}" for r in row)
                  + f"; {route} faster from M = {first}; M_PREFILL = {k5.M_PREFILL}", flush=True)
        del d4, dpc, wt, wn8

    torch.cuda.empty_cache()
    return {"crossover": crossover}


def k5_phase(gen, device, peaks):
    """Each K5 instance against its plain version on the card: small and ragged shapes (M 1-300, N not a
    multiple of 128, groups 16-128, x in f32 and bf16), then the Llama-2-7B shapes at decode (M = 32; x in
    f32 and bf16) and prefill (M = 8192, bf16; lm_head at M = 32 only), timed there beside the plain version,
    two library yardsticks and the bound. Returns (all timed records, {instance: its record at (4096, 4096),
    M = 32}, {(instance, K, N, M): ms})."""
    import torch

    from dalm_tpu_torch.kernels import int4_matmul as k5
    from dalm_tpu_torch.kernels import int8_matmul as im
    from dalm_tpu_torch.models import quant

    mem_bw, _, bf16_rate, int8_rate = peaks
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    worst = dict.fromkeys(k5.INSTANCES, 0.0)
    for M, K, N, group in ((1, 256, 136, 16), (5, 2048, 1000, 128), (77, 512, 264, 32), (300, 1024, 512, 64),
                           (33, 11008, 256, 16)):
        w = torch.randn((K, N), generator=gen, device=device) * 0.02
        fmts = {"int4": quant.quantize_tensor_int4(w, group), "nf4": quant.quantize_tensor_nf4(w, group),
                "int4pc": quant.quantize_tensor_int4pc(w)}
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((M, K), generator=gen, device=device) * 0.5).to(dtype)
            x[0] = 0
            for inst in k5.INSTANCES:
                d = fmts[K5_FORMAT[inst]]
                y, ry = k5.int4_matmul_fwd(x, d["q4"], d["scale4"], inst), k5.int4_matmul_fwd_ref(x, d["q4"], d["scale4"], inst)
                torch.cuda.synchronize()
                check(tuple(y.shape) == (M, N) and y.dtype == dtype and not bool(y[0].any()), f"k5 {inst}: shape/zero row")
                worst[inst] = max(worst[inst], k5_err(y, ry, inst)[1])
    print(f"[k5] small and ragged shapes (M 1-300, N 136-1000, groups 16-128, f32 and bf16): every instance within "
          f"its tolerance; worst share of the bound by instance {worst}", flush=True)

    entries, mains, ms_at = [], {}, {}
    for K, N in LLAMA_KN:
        fmts = k5_weights(gen, device, K, N)
        group = K // fmts["int4"]["scale4"].shape[0]
        w_bf16 = {f: quant.dequantize_tensor_int4(d, torch.bfloat16) for f, d in fmts.items()}
        for M in ((32,) if N == 32000 else (32, 8192)):
            x = (torch.randn((M, K), generator=gen, device=device) * 0.5).to(torch.bfloat16)
            xf = x.float() if M == 32 else None
            iters = 50 if M == 32 else 10
            for inst in k5.INSTANCES:
                fmt = K5_FORMAT[inst]
                d = fmts[fmt]
                q4, s4 = d["q4"], d["scale4"]
                y, ry = k5.int4_matmul_fwd(x, q4, s4, inst), k5.int4_matmul_fwd_ref(x, q4, s4, inst)
                torch.cuda.synchronize()
                max_err, share = k5_err(y, ry, inst)
                if xf is not None:
                    k5_err(k5.int4_matmul_fwd(xf, q4, s4, inst), k5.int4_matmul_fwd_ref(xf, q4, s4, inst), inst)
                del y
                # the kernel alone on operands prepared once (K2's rowquant for i8mxu / pcol outside the timing),
                # then the wrapper as the model calls it (checks, allocation, K2)
                g_arg = K if inst == "pcol" else group
                route = k5._route(x, inst, g_arg)
                geo = k5._splits(M, N, K // 2, g_arg, inst, sms)
                a, xs = k5.rowquant(x) if inst in ("i8mxu", "pcol") else (x, None)
                o, o2 = torch.empty((M, N), dtype=x.dtype, device=device), torch.empty((M, N), dtype=x.dtype, device=device)
                before = k5.fused.launches[inst]
                k5.launch(inst, a, xs, q4, s4, g_arg, o)
                check(k5.fused.launches[inst] == before + 1, f"k5 {inst}: the fused kernel's counter did not move by one")
                k5.launch(inst, a, xs, q4, s4, g_arg, o2)
                torch.cuda.synchronize()
                check(torch.equal(o, o2), f"k5 {inst} M={M} K={K} N={N}: two runs of the fused kernel differ")
                # the fused kernel's own output, also where int4_matmul_fwd took another route above
                fused_err, fused_share = k5_err(o, ry, inst)
                del ry
                wb = w_bf16[fmt]
                turns = {}
                if M == 32:
                    # decode: device time by CUDA graph, each call on its own copy of the weight (together > 2 x
                    # the L2), the kernel and x @ W_bf16 in turns (kernel, library, library, kernel)
                    copies = [(q4, s4)] + [(q4.clone(), s4.clone()) for _ in range(max(1, -(-100_000_000 // q4.numel())))]
                    wbs = [wb] + [wb.clone() for _ in range(max(1, -(-100_000_000 // (2 * wb.numel()))))]
                    ob = torch.empty((M, N), dtype=torch.bfloat16, device=device)
                    kfns = [lambda qc=qc, sc=sc: k5.launch(inst, a, xs, qc, sc, g_arg, o) for qc, sc in copies]
                    lfns = [lambda w=w: torch.matmul(x, w, out=ob) for w in wbs]
                    turns = {"ms_turns": [graph_ms(kfns)], "library_turns": [graph_ms(lfns)]}
                    turns["library_turns"].append(graph_ms(lfns))
                    turns["ms_turns"].append(graph_ms(kfns))
                    ms = sum(turns["ms_turns"]) / 2
                    lib_ms = sum(turns["library_turns"]) / 2
                    del copies, wbs, kfns, lfns, ob
                else:
                    ms = cuda_ms(lambda: k5.launch(inst, a, xs, q4, s4, g_arg, o), iters)
                    lib_ms = cuda_ms(lambda: x @ wb, iters)
                extra = {}
                if route != "fused":
                    if route == "prefill":
                        extra, prefill_records = prefill_timing(k5, quant, x, d, fmt, inst, group, w_bf16[fmt], o,
                                                                ms, peaks)
                    elif route == "int8":
                        check(max_err == 0.0, f"k5 pcol M={M} K={K} N={N}: the int8 route differs from the plain "
                                              f"version")
                        extra, prefill_records = pcol_timing(k5, im, x, d, w_bf16[fmt], o, ms, peaks)
                    else:
                        check(inst != "i8mxu" or max_err == 0.0, f"k5 i8mxu M={M} K={K} N={N}: the fold route "
                                                                 f"differs from the plain version")
                        extra, prefill_records = fold_timing(k5, im, x, d, inst, group, w_bf16[fmt], o, ms, peaks)
                    extra.update(prefill_max_abs_err=max_err, prefill_worst_share_of_tolerance=share)
                    entries.extend(prefill_records)
                    if (K, N) == (4096, 4096):
                        for r in prefill_records:
                            mains.setdefault(r["name"], r)
                wrapper_ms = cuda_ms(lambda: k5.int4_matmul_fwd(x, q4, s4, inst), iters)
                plain_ms = cuda_ms(lambda: k5.int4_matmul_fwd_ref(x, q4, s4, inst), 2)
                deq_ms = cuda_ms(lambda: x @ quant.dequantize_tensor_int4(d, torch.bfloat16), max(iters // 5, 2))
                nbytes = a.numel() * a.element_size() + (M * 4 if xs is not None else 0) + q4.numel() + s4.numel() * 4 + M * N * 2
                ops = 2.0 * M * K * N
                t_bytes, t_ops = nbytes / mem_bw * 1e3, ops / (int8_rate if inst in ("i8mxu", "pcol") else bf16_rate) * 1e3
                e = {"name": f"int4_matmul[{inst}]", "route": "cuda", "source": "dalm_tpu_torch/csrc/int4_matmul.cu",
                     "replaces": K5_AT[inst], "case": f"M={M} K={K} N={N} group={group if inst != 'pcol' else K} bf16",
                     "max_abs_err": fused_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": lib_ms,
                     "library_is": "x @ W_bf16 (torch.matmul on the weight dequantised beforehand: the bf16 tier)",
                     "dequant_matmul_ms": deq_ms, "wrapper_ms": wrapper_ms, "splits": geo.splits,
                     "worst_share_of_tolerance": fused_share, "k5_route": route, **turns, **extra}
                show("k5", e)
                print(f"[k5]   route {route}; through int4_matmul_fwd (checks, allocation{', K2' if xs is not None else ''}): "
                      f"{wrapper_ms:.4f} ms; K split in {geo.splits} (a cluster of {geo.splits}, grid {geo.grid}); "
                      f"{100 * e['bound_ms'] / ms:.0f}% of the bound, {ms / lib_ms:.2f}x x @ W_bf16's time"
                      + (f" (device time by CUDA graph over copies of the weight, in turns: kernel {turns['ms_turns']}, "
                         f"x @ W_bf16 {turns['library_turns']})" if turns else ""), flush=True)
                entries.append(e)
                ms_at[inst, K, N, M] = ms
                del a, xs, o, o2
                if (K, N, M) == (4096, 4096, 32):
                    mains[inst] = e
            print(f"[k5]   M={M} K={K} N={N}: x @ dequantize_tensor_int4(...) (dequant + cuBLAS) "
                  f"{entries[-1]['dequant_matmul_ms']:.4f} ms (int4pc weights)", flush=True)
            del x, xf
        del fmts, w_bf16
        torch.cuda.empty_cache()
    decode_host_phase(k5, im, gen, device)
    return entries, mains, ms_at


def decode_host_phase(k5, im, gen, device):
    """What one decode call costs beside the kernel: K2 alone at decode's 32 rows (device time by CUDA graph, K
    4096 and 11008), and the wrapper's host time per call of int4_matmul_fwd (host clock over 2000 enqueues, base
    and pcol at (4096, 4096): the checks, the allocation, K2's and the kernel's launches)."""
    import torch

    from dalm_tpu_torch.models import quant

    k2 = {}
    for K in (4096, 11008):
        x = (torch.randn((32, K), generator=gen, device=device) * 0.5).to(torch.bfloat16)
        xq = torch.empty((32, K), dtype=torch.int8, device=device)
        xs = torch.empty((32, 1), dtype=torch.float32, device=device)
        k2[K] = graph_ms([lambda: im.launch_rowquant(x, None, xq, xs)], 20)
    w = torch.randn((4096, 4096), generator=gen, device=device) * 0.02
    x = (torch.randn((32, 4096), generator=gen, device=device) * 0.5).to(torch.bfloat16)
    host = {}
    for inst, d in (("base", quant.quantize_tensor_int4(w)), ("pcol", quant.quantize_tensor_int4pc(w))):
        for _ in range(20):
            k5.int4_matmul_fwd(x, d["q4"], d["scale4"], inst)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            k5.int4_matmul_fwd(x, d["q4"], d["scale4"], inst)
        host[inst] = (time.perf_counter() - t0) / 2000 * 1e3
        torch.cuda.synchronize()
    print(f"[k5] decode beside the kernel: K2 alone at M=32 {k2[4096]:.4f} ms (K 4096), {k2[11008]:.4f} ms (K 11008) "
          f"device time; int4_matmul_fwd's host time per call at M=32 (4096, 4096), host clock over 2000 enqueues: "
          f"base {host['base']:.4f} ms, pcol {host['pcol']:.4f} ms (with K2's launch)", flush=True)
    print(json.dumps({"k5_decode_host": {"k2_ms": k2, "host_ms_per_call": host}}), flush=True)
    return k2, host


def forced_logits(decoder, ids, mask, forced):
    """The last-position logits of every step of a cached decode that is fed ``forced`` (B, T) tokens, as
    ``build_greedy_generate`` runs it: (B, T, V) f32 on the CPU."""
    import torch

    B, P = ids.shape
    T = forced.shape[1]
    cache = decoder.init_kv_cache(B, P + T, device=ids.device)
    slot_mask = torch.cat([mask, torch.ones((B, T), dtype=mask.dtype, device=ids.device)], dim=1)
    positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
    logits, cache = decoder(ids, slot_mask, positions=positions, kv_cache=cache, cache_index=0, logits_last_only=True)
    out = [logits[:, -1].float().cpu()]
    pos = mask.sum(dim=1)
    for t in range(T - 1):
        logits, cache = decoder(forced[:, t:t + 1].to(ids.device), slot_mask, positions=pos[:, None], kv_cache=cache,
                                cache_index=P + t)
        out.append(logits[:, 0].float().cpu())
        pos = pos + 1
    return torch.stack(out, dim=1)


# The tiny feasible-width pipeline, card (K5) against CPU (plain K5) on the same weights, teacher-forced with the
# CPU's tokens. The model is f32 and its float version agrees within 1e-6 between card and CPU, but where K5 rounds
# (an activation to bf16, an int4pc activation to int8, a key or value to int8) a value that card and CPU computed
# an f32 ulp apart can round to the neighbouring step, and the next layers carry that on. Measured on the card
# (max logit about 1.1): 2.1e-3 (int4) and 2.4e-3 (nf4) with the float cache; 2.7e-3, 2.9e-3 and 1.2e-2 (int4pc,
# whose int8 steps are the coarsest) with the int8 cache. Bounds: SMALL_Q_TOL = 3e-2 of the largest logit; the
# int4pc model with the float cache, whose K5 sums are exact integers, 1e-5. A wrong weight, scale or group moves
# the logits by tens of percent.
SMALL_Q_TOL = 3e-2


def small_quant_agrees(device):
    """A tiny pipeline whose generator is wide enough for the reference's rule to admit every projection
    (hidden 256, intermediate 512: groups 16 and 32), packed by ``RagPipeline`` in int4, nf4 and int4pc with
    the int8 KV cache, on the card and on the CPU from the same weights. The packed buffers are equal; the
    teacher-forced logits agree within ``SMALL_Q_TOL`` (int4pc without the int8 cache within 1e-5); answers
    agree except where the CPU's top two logits at the first differing token lie within twice that (near ties,
    counted)."""
    import dataclasses

    import torch

    from dalm_tpu_torch.kernels import int4_matmul as k5
    from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
    from dalm_tpu_torch.models.embedder import SentenceEmbedder
    from dalm_tpu_torch.serve import RagPipeline

    passages = [f"passage about topic {i} with unique content {i}" for i in range(64)]
    queries = [f"what is topic {i}" for i in range(8)]
    opts = dict(max_passage_len=48, max_prompt_len=96, max_new_tokens=8, embed_batch=16)
    cpu0 = RagPipeline.from_pretrained("tiny", "tiny", passages, device="cpu", **opts)
    retriever = SentenceEmbedder(cpu0.retriever.config, device=device)
    retriever.load_state_dict(cpu0.retriever.state_dict())
    cfg = dataclasses.replace(DecoderConfig.tiny(), hidden_size=256, num_heads=4, intermediate_size=512)
    base = Decoder(cfg, device="cpu")
    base.reset_parameters(torch.Generator().manual_seed(1))
    _, ids = cpu0.retrieve(queries, 1)
    prompts = [f"#query# {q} #passage# {passages[int(ids[i, 0])]} #answer# " for i, q in enumerate(queries)]
    toks = cpu0.g_tok(prompts, padding="max_length", max_length=opts["max_prompt_len"], truncation=True)
    p_ids, p_mask = torch.as_tensor(toks["input_ids"]), torch.as_tensor(toks["attention_mask"])
    for fmt in ("int4", "nf4", "int4pc"):
        gens = {}
        for dev in ("cpu", device):
            g = Decoder(cfg, device=dev)
            g.load_state_dict(base.state_dict())
            gens[dev] = g.eval()
        cpu = RagPipeline(cpu0.retriever, cpu0.r_tok, gens["cpu"], cpu0.g_tok, passages, device="cpu",
                          quantize_generator=fmt, kv_quant=True, **opts)
        before = dict(k5.int4_matmul_fwd.launches)
        card = RagPipeline(retriever.eval(), cpu0.r_tok, gens[device], cpu0.g_tok, passages, device=device,
                           quantize_generator=fmt, kv_quant=True, **opts)
        cb = dict(cpu.generator.named_buffers())
        check(all(torch.equal(v.cpu(), cb[k]) for k, v in card.generator.named_buffers()),
              f"small {fmt}: the card's packed weights differ from the CPU's")
        t_cpu = cpu._generate(p_ids, p_mask)
        t_card = card._generate(p_ids.to(device), p_mask.to(device)).cpu()
        diffs, l_cpu = {}, None
        for kv in (False, True):  # the same packed models with the float cache, then with the int8 one
            for g in (cpu.generator, card.generator):
                g.cfg = dataclasses.replace(g.cfg, kv_quant=kv)
            lc = forced_logits(cpu.generator, p_ids, p_mask, t_cpu)
            ld = forced_logits(card.generator, p_ids.to(device), p_mask.to(device), t_cpu)
            diffs[kv] = float((ld - lc).abs().max())
            l_cpu = lc
        inst = {"int4": "base", "nf4": "nf4", "int4pc": "pcol"}[fmt]
        check(k5.int4_matmul_fwd.launches[inst] > before[inst], f"small {fmt}: the card pipeline never launched K5")
        scale = float(l_cpu.abs().max())
        exact = 1e-5 if fmt == "int4pc" else SMALL_Q_TOL
        check(diffs[False] <= exact * scale and diffs[True] <= SMALL_Q_TOL * scale,
              f"small {fmt}: teacher-forced logits differ by {diffs} (max logit {scale})")
        ties = 0
        for b in range(t_cpu.shape[0]):
            differ = (t_card[b] != t_cpu[b]).nonzero()
            if len(differ):
                t = int(differ[0])
                gap = float(l_cpu[b, t, int(t_cpu[b, t])] - l_cpu[b, t, int(t_card[b, t])])
                check(gap <= 2 * SMALL_Q_TOL * scale, f"small {fmt}: row {b} differs at step {t} with a gap of {gap}")
                ties += 1
        a_cpu = [a.answer for a in cpu.answer(queries, 4)]
        a_card = [a.answer for a in card.answer(queries, 4)]
        check(sum(x != y for x, y in zip(a_cpu, a_card)) <= ties, f"small {fmt}: answers differ beyond the near ties")
        print(f"[small] feasible-width tiny pipeline {fmt}, card (K5 {inst}) vs CPU: packed weights equal; "
              f"teacher-forced logits max diff {diffs[False]:.3e} with the float KV cache, {diffs[True]:.3e} with "
              f"the int8 one (max logit {scale:.3f}; bounds {exact} and {SMALL_Q_TOL} of it); near-tie rows {ties}, "
              f"{len(a_card)} answers", flush=True)
        del cpu, card, gens
    torch.cuda.empty_cache()


def packed_copy(base, device):
    """A generator that shares every tensor of ``base`` (no copy) until ``RagPipeline`` packs it."""
    from dalm_tpu_torch.models.decoder import Decoder

    g = Decoder(base.cfg, device="meta")
    g.load_state_dict(base.state_dict(), assign=True)
    return g.eval()


def serve_q_phase(device, rng, base_pipe):
    """The 4-bit serving tiers at full width and depth: the bf16 pipeline's bge-large retriever, corpus and
    Llama-2-7B weights, the generator packed by ``RagPipeline(quantize_generator=..., kv_quant=True)``. int4
    (K5 base): a warm and a timed ``answer()`` of 32 queries, top-4, 256-token prompts, 64 new tokens, split
    as in ``[main]``, K5 launches counted (225 a forward x 64 forwards; the prefill forward's 224 projections on
    the prefill route, the rest on the fused kernel), the prefill timed again with every projection on the fused
    kernel; then one ``answer()`` each for nf4,
    int4pc (its prefill forward's 224 projections on the int8 route, counted per kernel, and its prefill timed on
    that route and with every projection on the fused kernel), and int4 with ``DEFAULT_VARIANT`` i8mxu and groupmm
    (their prefill forward's 224 projections on the fold route, counted per kernel); the last-position logits of
    each tier against
    the bf16 generator's; a sampled ``answer()`` that repeats. Returns the K5 launches of each instance in its
    own ``answer()``, the decode times and the int4 pipeline."""
    import gc

    import numpy as np
    import torch

    from dalm_tpu_torch.kernels import int4_matmul as k5
    from dalm_tpu_torch.kernels import int8_matmul as im
    from dalm_tpu_torch.models.generate import build_greedy_generate
    from dalm_tpu_torch.models.sampling import SamplerConfig
    from dalm_tpu_torch.serve import RagPipeline

    pipe = base_pipe
    queries = [f"what about topic {i}" for i in range(0, 16384, 512)]
    opts = dict(max_passage_len=pipe.max_passage_len, max_prompt_len=pipe.max_prompt_len, max_new_tokens=64,
                embed_batch=pipe.embed_batch)
    scores, ids = pipe.retrieve(queries, 4)
    prompts = [f"#query# {q} #passage# {pipe.passages[int(ids[i, 0])]} #answer# " for i, q in enumerate(queries)]
    toks = pipe.g_tok(prompts, padding="max_length", max_length=pipe.max_prompt_len, truncation=True)
    p_ids = torch.as_tensor(toks["input_ids"], device=device)
    p_mask = torch.as_tensor(toks["attention_mask"], device=device)
    ref_logits = pipe.generator(p_ids, p_mask, logits_last_only=True).float()
    layers = pipe.generator.cfg.num_layers
    per_forward = 7 * layers + 1
    launches, out = {}, {}

    def tier_pipeline(fmt, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = RagPipeline(pipe.retriever, pipe.r_tok, packed_copy(pipe.generator, device), pipe.g_tok, pipe.passages,
                        device=device, quantize_generator=fmt, kv_quant=True, **dict(opts, **kw))
        torch.cuda.synchronize()
        return q, time.perf_counter() - t0

    def last_logits(q, fallback=False):
        """The tier's last-position logits on the prompts; ``fallback``: through the reference's off-TPU
        path, ``x @ dequant(W)``, instead of K5 (the same packed weights)."""
        if not fallback:
            return q.generator(p_ids, p_mask, logits_last_only=True).float()
        with k5_dequantised():
            return q.generator(p_ids, p_mask, logits_last_only=True).float()

    def rel_err(a, b):
        return float((a - b).norm() / b.norm())

    def logit_err(q, inst):
        """(relative error against the bf16 generator, against the same tier through x @ dequant(W))."""
        got = last_logits(q)
        check(bool(torch.isfinite(got).all()), f"serve-q {inst}: non-finite logits")
        errs = (rel_err(got, ref_logits), rel_err(got, last_logits(q, fallback=True)))
        rels[inst] = errs
        return errs

    rels = {}
    i8 = packed_copy(pipe.generator, device)
    from dalm_tpu_torch.models.qlora import pack_module

    pack_module(i8, True)
    rels["int8"] = (rel_err(i8(p_ids, p_mask, logits_last_only=True).float(), ref_logits), 0.0)
    print(f"[serve-q] int8 generator (dequantised in each matmul): last-position logits relative error "
          f"{rels['int8'][0]:.4f} against bf16", flush=True)
    del i8
    torch.cuda.empty_cache()

    def counted_answer(q):
        k5.int4_matmul_fwd.launches = dict.fromkeys(k5.INSTANCES, 0)
        k5.int4_matmul_fwd.route_launches = dict.fromkeys(k5.int4_matmul_fwd.route_launches, 0)
        k5.fused.launches = dict.fromkeys(k5.INSTANCES, 0)
        k5.prefill_dequant.launches = dict.fromkeys(k5.SCALED_INSTANCES, 0)
        k5.prefill_gemm.launches = 0
        k5.prefill_nibbles.launches = 0
        k5.prefill_nibbles.int8_launches = 0
        k5.prefill_fold.launches = dict.fromkeys(k5.FOLD_INSTANCES, 0)
        im.int8_gemm_scaled.launches = 0
        im.rowquant.bf16_launches = 0
        k2 = im.rowquant.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers = q.answer(queries, top_k=4)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(len(answers) == len(queries) and all(len(a.passages) == 4 for a in answers), "serve-q: answers")
        check([a.passages for a in answers] == [[pipe.passages[int(j)] for j in row] for row in ids],
              "serve-q: retrieval differs from the bf16 pipeline's")
        return answers, dt, dict(k5.int4_matmul_fwd.launches), im.rowquant.launches - k2

    def check_routes(inst, label):
        """K5's routes in the last counted answer(): every projection of the prefill forward (8192 rows) on the
        prefill route for base / nf4, on the fold route for groupmm / i8mxu and on the int8 route for pcol, the rest
        (lm_head at 32 rows, 63 decode forwards) on the fused kernel."""
        routes = k5.int4_matmul_fwd.route_launches
        route = k5.PREFILL_ROUTE.get(inst)
        pre = 7 * layers if route else 0
        got = {r: routes[inst, r] for r in k5.ROUTES}
        expect = dict(dict.fromkeys(k5.ROUTES, 0), fused=want - pre, **({route: pre} if route else {}))
        check(got == expect and sum(routes.values()) == want, f"serve-q {label}: K5 routes {got}, want {expect}")
        kernel = {i: got["fused"] if i == inst else 0 for i in k5.INSTANCES}
        check(k5.fused.launches == kernel, f"serve-q {label}: the fused kernel launched {k5.fused.launches} times, "
                                           f"want one launch per fused call, {kernel}")
        scaled, folded = (pre if route == "prefill" else 0), (pre if route == "fold" else 0)
        dq, fold = k5.prefill_dequant.launches, k5.prefill_fold.launches
        check(dq == {i: scaled if i == inst else 0 for i in k5.SCALED_INSTANCES} and k5.prefill_gemm.launches == scaled,
              f"serve-q {label}: prefill kernels launched {dq}, {k5.prefill_gemm.launches} times, want {scaled} each")
        check(fold == {i: folded if i == inst else 0 for i in k5.FOLD_INSTANCES} and
              k5.prefill_nibbles.launches == folded and im.rowquant.bf16_launches == (folded if inst == "i8mxu" else 0),
              f"serve-q {label}: fold kernels launched {fold}, nibble pre-pass {k5.prefill_nibbles.launches}, K2 in "
              f"bf16 {im.rowquant.bf16_launches} times, want {folded} each")
        int8 = pre if route == "int8" else 0
        check(k5.prefill_nibbles.int8_launches == int8 and im.int8_gemm_scaled.launches == int8,
              f"serve-q {label}: int8 route kernels launched {k5.prefill_nibbles.int8_launches} (int8 pre-pass), "
              f"{im.int8_gemm_scaled.launches} (scaled GEMM) times, want {int8} each")
        return got

    # int4 + int8 KV cache, K5 base: the slice's main path
    q, build_s = tier_pipeline("int4")
    gen = q.generator
    packed = sum(b.numel() * b.element_size() for n, b in gen.named_buffers() if n.endswith(("q4", "scale4")))
    check(sum(1 for n, _ in gen.named_buffers() if n.endswith(".q4")) == per_forward, "serve-q: not every projection is packed")
    q.answer(queries, top_k=4)  # warm
    answers, answer_s, counts, _ = counted_answer(q)
    want = per_forward * 64
    check(counts["base"] == want and sum(counts.values()) == want,
          f"serve-q int4: K5 launches {counts}, {layers} layers x 64 forwards predict {want} base")
    routes = check_routes("base", "int4")
    launches["base"] = k5.fused.launches["base"]  # the fused kernel's own count; the prefill route's kernels count apart
    launches["k5_prefill_dequant[base]"] = k5.prefill_dequant.launches["base"]
    launches["k5_prefill_gemm"] = k5.prefill_gemm.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q_embs = q._embed_texts([f"#query# {x}" for x in queries], q.max_passage_len)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q.index.search(q_embs, 4)
    search_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks_out = q._generate(p_ids, p_mask)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0

    def prefill_times(g):
        """The prefill (+ the first token) of generator ``g`` on its routes, then with every projection on the fused
        kernel; each timed after a warm call."""
        first = build_greedy_generate(g, 1, eos_token_id=pipe.g_tok.eos_token_id,
                                      pad_token_id=pipe.g_tok.pad_token_id or 0)
        times = []
        m_prefill = k5.M_PREFILL
        for forced in (False, True):
            k5.M_PREFILL = 1 << 30 if forced else m_prefill
            try:
                first(p_ids, p_mask)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                first(p_ids, p_mask)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            finally:
                k5.M_PREFILL = m_prefill
        return times

    prefill_s, prefill_fused_s = prefill_times(gen)
    check(tuple(toks_out.shape) == (len(queries), 64) and bool(((toks_out >= 0) & (toks_out < 32000)).all()),
          "serve-q int4: generated ids")
    step_ms = (decode_s - prefill_s) / 63 * 1e3
    err, err_fb = logit_err(q, "base")
    out.update(int4_answer_s=answer_s, decode_step_ms=step_ms, prefill_s=prefill_s, decode_s=decode_s,
               prefill_fused_s=prefill_fused_s)
    print(f"[serve-q] int4 + int8 KV cache (K5 base): pipeline built in {build_s:.2f} s (pack + {len(pipe.passages)} "
          f"passages embedded; packed weights and scales {packed / 1e9:.3f} GB); answer(): {answer_s:.3f} s for "
          f"{len(queries)} queries; query embed {embed_s:.4f} s; search {search_ms:.3f} ms; prefill+decode "
          f"{decode_s:.3f} s = {toks_out.numel() / decode_s:.1f} tokens/s; prefill (+ first token) {prefill_s:.3f} s "
          f"(every projection on the fused kernel instead: {prefill_fused_s:.3f} s); "
          f"decode {step_ms:.2f} ms/step against a weight-read bound of 1.19 ms; K5 launches per answer() {counts}, "
          f"by route {routes}; "
          f"last-position logits: relative error {err:.4f} against bf16, {err_fb:.4f} against x @ dequant(W)",
          flush=True)
    print(f"[serve-q] sample answer: {answers[0].answer[:60]!r}", flush=True)

    for variant in ("i8mxu", "groupmm"):
        k5.DEFAULT_VARIANT = variant
        try:
            _, dt, counts, k2 = counted_answer(q)
            routes = check_routes(variant, variant)
            launches[variant] = k5.fused.launches[variant]
            launches.setdefault("k5_prefill_nibbles", k5.prefill_nibbles.launches)
            launches[f"k5_fold_gemm[{variant}]"] = k5.prefill_fold.launches[variant]
            if variant == "i8mxu":
                launches["rowquant[bf16]"] = im.rowquant.bf16_launches
            err, err_fb = logit_err(q, variant)
            v_prefill_s, v_fused_s = prefill_times(gen)
        finally:
            k5.DEFAULT_VARIANT = "base"
        check(counts[variant] == want and sum(counts.values()) == want, f"serve-q {variant}: K5 launches {counts}")
        check(k2 == (want if variant == "i8mxu" else 0), f"serve-q {variant}: {k2} K2 launches")
        out.update({f"{variant}_answer_s": dt, f"{variant}_prefill_s": v_prefill_s,
                    f"{variant}_prefill_fused_s": v_fused_s})
        print(f"[serve-q] int4 with DEFAULT_VARIANT={variant}: answer() {dt:.3f} s; prefill (+ first token) "
              f"{v_prefill_s:.3f} s (every projection on the fused kernel instead: {v_fused_s:.3f} s); K5 {variant} "
              f"launches {counts[variant]} (by route {routes}), K2 {k2}; logits relative error {err:.4f} against bf16, {err_fb:.4f} against "
              f"x @ dequant(W)", flush=True)

    # a sampled answer(): valid ids, the same ids again from the same seed
    sampler = SamplerConfig(temperature=0.7, top_k=50, top_p=0.9, seed=0)
    s = RagPipeline(pipe.retriever, pipe.r_tok, gen, pipe.g_tok, pipe.passages, device=device, kv_quant=True,
                    sampler=sampler, **opts)
    a1 = s._generate(p_ids, p_mask)
    a2 = s._generate(p_ids, p_mask)
    sampled = s.answer(queries, top_k=4)
    check(bool(((a1 >= 0) & (a1 < 32000)).all()) and torch.equal(a1, a2), "serve-q: sampled ids invalid or not repeated")
    check([x.answer for x in sampled] == [s.g_tok.decode(r, skip_special_tokens=True).split("#answer#")[0].strip()
                                          for r in a1.cpu().numpy()], "serve-q: sampled answer() differs from its ids")
    greedy_same = int((a1 == toks_out).all(dim=1).sum())
    print(f"[serve-q] sampled answer() (temperature 0.7, top-k 50, top-p 0.9, seed 0): ids in range, repeated "
          f"exactly; {greedy_same} of {len(queries)} rows equal the greedy ones", flush=True)
    int4_pipe = q  # kept for serve-cb
    del s, gen
    gc.collect()
    torch.cuda.empty_cache()

    for fmt, inst in (("nf4", "nf4"), ("int4pc", "pcol")):
        q, build_s = tier_pipeline(fmt)
        _, dt, counts, k2 = counted_answer(q)
        check(counts[inst] == want and sum(counts.values()) == want, f"serve-q {fmt}: K5 launches {counts}")
        routes = check_routes(inst, fmt)
        check(k2 == want if inst == "pcol" else k2 == 0, f"serve-q {fmt}: {k2} K2 launches")
        pre = ""
        if inst == "nf4":
            launches["k5_prefill_dequant[nf4]"] = k5.prefill_dequant.launches["nf4"]
        else:
            launches["k5_prefill_nibbles[int8]"] = k5.prefill_nibbles.int8_launches
            launches["k5_pcol_gemm"] = im.int8_gemm_scaled.launches
            p_s, p_fused_s = prefill_times(q.generator)
            out.update({f"{fmt}_prefill_s": p_s, f"{fmt}_prefill_fused_s": p_fused_s})
            pre = f"prefill (+ first token) {p_s:.3f} s (every projection on the fused kernel instead: {p_fused_s:.3f} s); "
        err, err_fb = logit_err(q, inst)
        launches[inst] = routes["fused"]  # the fused kernel's own count at the end of the answer() (check_routes)
        out[f"{fmt}_answer_s"] = dt
        print(f"[serve-q] {fmt} + int8 KV cache: built in {build_s:.2f} s; answer() {dt:.3f} s (first, not warmed); "
              f"{pre}K5 {inst} launches {counts[inst]} (by route {routes}), K2 {k2}; logits relative error {err:.4f} "
              f"against bf16, {err_fb:.4f} against x @ dequant(W)", flush=True)
        del q
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[serve-q] last-position logits, relative error by K5 instance (against bf16, against the same tier "
          f"through x @ dequant(W)): {rels}; bounds {K5_LOGIT_BOUND_BF16} and {K5_LOGIT_BOUND}", flush=True)
    for inst, (err, err_fb) in rels.items():
        check(err <= K5_LOGIT_BOUND_BF16, f"serve-q {inst}: logits relative error {err} against bf16")
        check(inst == "int8" or err_fb <= K5_LOGIT_BOUND[inst],
              f"serve-q {inst}: logits relative error {err_fb} against x @ dequant(W)")
    return launches, out, int4_pipe


def int4_pipeline(device, base_pipe):
    """The serve-q tier's int4 + int8 KV cache pipeline on ``base_pipe``'s retriever, corpus and 7B weights."""
    from dalm_tpu_torch.serve import RagPipeline

    pipe = base_pipe
    return RagPipeline(pipe.retriever, pipe.r_tok, packed_copy(pipe.generator, device), pipe.g_tok, pipe.passages,
                       device=device, quantize_generator="int4", kv_quant=True, max_passage_len=pipe.max_passage_len,
                       max_prompt_len=pipe.max_prompt_len, max_new_tokens=64, embed_batch=pipe.embed_batch)


def zero_serving_counts():
    """Every launch count of the 4-bit serving path set to 0: K5 by call, route and kernel, K3 by mode."""
    from dalm_tpu_torch.kernels import int4_matmul as k5
    from dalm_tpu_torch.kernels.topk import fused_dot_topk

    k5.int4_matmul_fwd.launches = dict.fromkeys(k5.INSTANCES, 0)
    k5.int4_matmul_fwd.route_launches = dict.fromkeys(k5.int4_matmul_fwd.route_launches, 0)
    k5.fused.launches = dict.fromkeys(k5.INSTANCES, 0)
    k5.prefill_dequant.launches = dict.fromkeys(k5.SCALED_INSTANCES, 0)
    k5.prefill_gemm.launches = 0
    fused_dot_topk.launches = dict.fromkeys(fused_dot_topk.launches, 0)


def serving_counts():
    from dalm_tpu_torch.kernels import int4_matmul as k5
    from dalm_tpu_torch.kernels.topk import fused_dot_topk

    return {"int4_matmul[base]": k5.fused.launches["base"],
            "k5_prefill_dequant[base]": k5.prefill_dequant.launches["base"],
            "k5_prefill_gemm": k5.prefill_gemm.launches,
            "fused_dot_topk[f32]": fused_dot_topk.launches["f32"],
            "routes": {r: k5.int4_matmul_fwd.route_launches["base", r] for r in k5.ROUTES}}


class EngineProbe:
    """Counts what the continuous-batching engine does inside one call, from outside it: admission waves and
    their wall time (synchronised), decode iterations (single-token steps or verify passes), active slot-steps
    of the single-token steps (summed on the device), and the value ``generate_fused`` returned. Installed on the
    engine's instance, removed by ``close``."""

    def __init__(self, eng):
        import torch

        self.eng = eng
        self.waves, self.admit_s, self.iters, self.results = 0, 0.0, 0, None
        self.active = torch.zeros((), dtype=torch.long, device=eng.device)
        admit, step, advance, verify, fused = eng._admit, eng._step, eng._advance, eng._verify, eng.generate_fused

        def _admit(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = admit(*a)
            torch.cuda.synchronize()
            self.waves += 1
            self.admit_s += time.perf_counter() - t0
            return out

        def _step(*a):
            self.iters += 1
            return step(*a)

        def _verify(*a):
            self.iters += 1
            return verify(*a)

        def _advance(active, tok):
            self.active += active.sum()
            return advance(active, tok)

        def _fused(*a, **k):
            self.results = fused(*a, **k)
            return self.results

        eng._admit, eng._step, eng._advance, eng._verify, eng.generate_fused = _admit, _step, _advance, _verify, _fused

    def close(self):
        for name in ("_admit", "_step", "_advance", "_verify", "generate_fused"):
            delattr(self.eng, name)

    def stats(self, wall_s, tokens):
        """(occupancy, decode ms per iteration, tokens/s) of the call that took ``wall_s``."""
        iters = max(self.iters, 1)
        occupancy = int(self.active) / (iters * self.eng.num_slots)
        return occupancy, (wall_s - self.admit_s) / iters * 1e3, tokens / wall_s


def lockstep_tokens(q, queries):
    """``q.answer(queries)``: its answers, the token rows its lockstep generate returned, the prompt ids and mask
    it was given (numpy), and its wall time."""
    import torch

    calls, gen = [], q._generate

    def generate(ids, mask):
        calls.append((gen(ids, mask), ids, mask))
        return calls[-1][0]

    q._generate = generate
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers = q.answer(queries, top_k=4)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        q._generate = gen
    rows, ids, mask = (t.cpu().numpy() for t in calls[0])
    return answers, rows, ids, mask, dt


def trim(row, eos, cap):
    """A lockstep row cut at its first EOS (excluded) and at ``cap`` tokens."""
    out = []
    for t in row:
        if len(out) >= cap or t == eos:
            break
        out.append(int(t))
    return out


def serve_cb_phase(device, q, seed):
    """Continuous batching at full width: ``RagPipeline.answer_continuous`` on the int4 + int8 KV cache
    pipeline (bge-large + Llama-2-7B, 16,384 passages, 256-token prompts, 64 new tokens, 32 slots, the fused
    schedule). (a) One wave of 32 queries: a warm call, then a counted and timed one; every answer's text equals
    ``answer()``'s on the same queries and the engine's tokens equal the lockstep generate's up to EOS. (b)
    Recycling: 64 queries through the engine with budgets drawn from ``seed`` in [8, 64]; each request's tokens
    equal the first ``budget`` tokens (up to EOS) of a lockstep ``answer()`` over the same 64 queries in two
    batches of 32, which have the engine's shapes (32 rows at decode, 32 x 256 at admission; every kernel on the
    path computes an output row from its own input row). (c) K5's launches in the counted ``answer_continuous()``:
    the prefill route at admission (224 a wave), the fused kernel at decode (225 an iteration, and the first
    token's lm_head at 32 rows a wave); K3's. Returns the launches of (c) and the numbers printed."""
    import numpy as np
    import torch

    B, max_new = 32, 64
    eos = q.g_tok.eos_token_id
    layers = q.generator.cfg.num_layers
    queries = [f"what about topic {i}" for i in range(0, 16384, 512)]  # 32 queries

    # (a) one wave
    t0 = time.perf_counter()
    warm = q.answer_continuous(queries, top_k=4, num_slots=B)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    eng = q._engine
    lock, lock_rows, _, _, lock_s = lockstep_tokens(q, queries)
    probe = EngineProbe(eng)
    zero_serving_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cont = q.answer_continuous(queries, top_k=4, num_slots=B)
        torch.cuda.synchronize()
        cont_s = time.perf_counter() - t0
    finally:
        probe.close()
    launches = serving_counts()
    check(q._engine is eng, "serve-cb: answer_continuous() did not keep its engine")
    check([a.answer for a in cont] == [a.answer for a in lock] == [a.answer for a in warm],
          "serve-cb (a): answer_continuous() text differs from answer()'s")
    check([a.passages for a in cont] == [a.passages for a in lock], "serve-cb (a): passages differ from answer()'s")
    want = [trim(r, eos, max_new) for r in lock_rows]
    got = probe.results
    diff = [i for i in range(B) if got[i] != want[i]]
    check(not diff, f"serve-cb (a): engine tokens differ from the lockstep generate's for requests {diff}")
    waves, iters = probe.waves, probe.iters
    routes = launches["routes"]
    check(routes["prefill"] == 7 * layers * waves and launches["k5_prefill_gemm"] == routes["prefill"]
          and launches["k5_prefill_dequant[base]"] == routes["prefill"],
          f"serve-cb (c): K5's prefill route {routes}, {launches} for {waves} admission waves")
    check(routes["fused"] == launches["int4_matmul[base]"] == waves + (7 * layers + 1) * iters
          and routes["fold"] == routes["int8"] == 0, f"serve-cb (c): K5's fused kernel {launches} for {iters} iterations")
    check(launches["fused_dot_topk[f32]"] > 0 and min(routes["fused"], routes["prefill"]) > 0,
          f"serve-cb (c): a kernel of the path was never launched: {launches}")
    tokens = sum(len(r) for r in got)
    occ, step_ms, tok_s = probe.stats(cont_s, tokens)
    out = dict(one_wave_s=cont_s, one_wave_warm_s=warm_s, one_wave_lockstep_s=lock_s, one_wave_waves=waves,
               one_wave_iterations=iters, one_wave_occupancy=occ, one_wave_decode_ms=step_ms,
               one_wave_admit_s=probe.admit_s, one_wave_tokens_per_s=tok_s)
    print(f"[serve-cb] (a) answer_continuous() of {B} queries on {B} slots: {cont_s:.3f} s (first call, engine "
          f"built: {warm_s:.3f} s); answer() of the same queries {lock_s:.3f} s; {waves} admission wave(s) "
          f"({probe.admit_s:.3f} s), {iters} decode iterations, slot occupancy {occ:.3f}; decode "
          f"{step_ms:.2f} ms an iteration (host clock, admission excluded) against a weight-read bound of 1.19 ms; "
          f"{tokens} tokens = {tok_s:.1f} tokens/s; {B} answers and token lists equal answer()'s; launches {launches}",
          flush=True)

    # (b) recycling: 64 queries on 32 slots with budgets
    queries = [f"what about topic {i}" for i in range(0, 16384, 256)]  # 64 queries
    budgets = np.random.default_rng(seed).integers(8, max_new + 1, size=len(queries))
    halves = [lockstep_tokens(q, queries[h:h + B]) for h in (0, B)]  # the prompts of the same retrieval calls
    lock_rows, p_ids, p_mask = (np.concatenate([h[j] for h in halves]) for j in (1, 2, 3))
    lock2_s = sum(h[4] for h in halves)
    probe = EngineProbe(eng)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = eng.generate_fused(p_ids, p_mask, budgets=budgets)
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
    finally:
        probe.close()
    want = [trim(lock_rows[i], eos, int(budgets[i])) for i in range(len(queries))]
    diff = [i for i in range(len(queries)) if got[i] != want[i]]
    check(not diff, f"serve-cb (b): engine tokens differ from the lockstep batches' for requests {diff}")
    tokens = sum(len(r) for r in got)
    occ, step_ms, tok_s = probe.stats(rec_s, tokens)
    out.update(recycle_s=rec_s, recycle_lockstep_s=lock2_s, recycle_waves=probe.waves, recycle_iterations=probe.iters,
               recycle_occupancy=occ, recycle_decode_ms=step_ms, recycle_admit_s=probe.admit_s,
               recycle_tokens_per_s=tok_s, recycle_tokens=tokens)
    print(f"[serve-cb] (b) generate_fused() of {len(queries)} requests on {B} slots, budgets from seed {seed} in "
          f"[8, {max_new}] (sum {int(budgets.sum())}): {rec_s:.3f} s; {probe.waves} admission waves "
          f"({probe.admit_s:.3f} s), {probe.iters} decode iterations, slot occupancy {occ:.3f}; decode {step_ms:.2f} "
          f"ms an iteration against 1.19 ms; {tokens} tokens = {tok_s:.1f} tokens/s; lockstep answer() in two "
          f"batches of {B}: {lock2_s:.3f} s ({halves[0][4]:.3f} + {halves[1][4]:.3f}); every request's tokens equal "
          f"its lockstep tokens up to its budget", flush=True)
    print(json.dumps({"serve_cb": out}), flush=True)
    return launches, out


def profile_serve_phase(device, q, start=4, iters=8):
    """Not part of the default run: ``--phases profile-serve`` traces ``iters`` decode iterations of the engine's
    fused schedule at the serve-cb shape (32 queries on 32 slots, int4 + int8 KV cache, 7B), from the start of
    iteration ``start`` to the start of iteration ``start + iters``, with ``torch.profiler``: kernel launches per
    iteration, device-busy time against wall time, the kernels that take most of the device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    queries = [f"what about topic {i}" for i in range(0, 16384, 512)]
    if q._engine_key != (32, 64, 8):
        q.answer_continuous(queries, top_k=4, num_slots=32)  # builds the engine and its pool
    eng = q._engine
    _, ids = q.retrieve(queries, 4)
    toks = q._prompt_tokens(queries, ids)
    p_ids, p_mask = np.asarray(toks["input_ids"], np.int64), np.asarray(toks["attention_mask"], np.int64)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    clock = {"i": 0, "open": False}
    step = eng._step

    def traced(*a):
        if clock["i"] in (start, start + iters):
            torch.cuda.synchronize()
            if clock["i"] == start:
                prof.__enter__()
                clock["open"], clock["t0"] = True, time.perf_counter()
            else:
                clock["wall_ms"] = (time.perf_counter() - clock["t0"]) * 1e3
                prof.__exit__(None, None, None)
                clock["open"] = False
        clock["i"] += 1
        return step(*a)

    eng._step = traced
    try:
        eng.generate_fused(p_ids, p_mask)
    finally:
        del eng._step
        if clock["open"]:
            prof.__exit__(None, None, None)
    check("wall_ms" in clock, f"profile-serve: only {clock['i']} decode iterations ran")
    wall = clock["wall_ms"]
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    check(rows, "profile-serve: the profiler recorded no device time")
    busy = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    print(f"[profile-serve] {iters} decode iterations of the fused schedule (32 slots, int4 + int8 KV cache) under "
          f"the profiler: wall {wall / iters:.2f} ms an iteration, device busy {busy / iters:.2f} ms = "
          f"{100 * busy / wall:.1f}% (idle {100 - 100 * busy / wall:.1f}%), {launches / iters:.0f} device launches "
          f"an iteration", flush=True)
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:25]:
        print(f"[profile-serve] {ms / iters:9.3f} ms/iteration {count / iters:7.1f} launches/iteration  {key[:110]}",
              flush=True)
    print(json.dumps({"profile_serve": {"iterations": iters, "wall_ms": wall, "busy_ms": busy,
                                        "launches": launches, "top": [
                                            {"kernel": k[:200], "ms": ms, "count": c}
                                            for k, ms, c in sorted(rows, key=lambda r: -r[1])[:25]]}}), flush=True)
    del prof
    torch.cuda.empty_cache()


# serve-stream's tie-aware checks. A verify pass runs the 7B's projections at M = 32 x 9 = 288 rows on K5's prefill
# route (bf16 wgmma GEMM), the plain step at M = 32 on the fused kernel (f32 sums), and its attention over a cache
# 9 slots longer: the sums round otherwise, and a random 7B carries that to its logits, so where its top two logits
# nearly tie the argmax may flip. Two token lists are held equal up to their first difference; there, the plain
# path's logits recomputed by one teacher-forced forward (the prefill route) must put both tokens within TIE_TOL of
# the top logit; after it, nothing is compared. The bound is the rounding noise between the two routes, printed
# by every run as "route noise": the plain path's cached logits against one teacher-forced forward's differed by
# up to 0.72 (0.50 at the chosen token; logit std 1.29; 418 of 2048 argmaxes flipped) on an NVIDIA H100 80GB
# HBM3 at 700 W. A wrong token lies several logit standard deviations below the top.
TIE_TOL = 1.0
GAMMA = 8


def first_diff(a, b, eos):
    """The first position where token lists ``a`` and ``b`` differ (a list that ended reads as ``eos`` there),
    or None."""
    for t in range(max(len(a), len(b))):
        x = a[t] if t < len(a) else eos
        y = b[t] if t < len(b) else eos
        if x != y:
            return t, x, y
    return None


def tie_aware(label, gen, p_ids, p_mask, plain, other, eos, phase="serve-stream"):
    """Hold ``other`` to ``plain`` (token lists per request) tie-aware, with one teacher-forced forward of the
    diverging requests over their prompt and plain tokens. Returns (requests equal, diverging, the largest
    distance of a flipped token from the top logit)."""
    import numpy as np
    import torch

    diffs = {i: d for i, (a, b) in enumerate(zip(plain, other)) if (d := first_diff(a, b, eos)) is not None}
    worst = 0.0
    if diffs:
        rows = sorted(diffs)
        T = max(len(plain[i]) for i in rows)
        seq = np.zeros((len(rows), p_ids.shape[1] + T), np.int64)
        seq_mask = np.zeros_like(seq)
        for j, i in enumerate(rows):
            n = len(plain[i])
            seq[j, : p_ids.shape[1]], seq[j, p_ids.shape[1]: p_ids.shape[1] + n] = p_ids[i], plain[i]
            seq_mask[j, : p_ids.shape[1]], seq_mask[j, p_ids.shape[1]: p_ids.shape[1] + n] = p_mask[i], 1
        logits = gen(torch.as_tensor(seq, device=gen.final_norm.scale.device),
                     torch.as_tensor(seq_mask, device=gen.final_norm.scale.device))
        where = []
        for j, i in enumerate(rows):
            t, a, b = diffs[i]
            lg = logits[j, p_ids.shape[1] + t - 1].float().cpu()
            top = float(lg.max())
            far = max(top - float(lg[a]), top - float(lg[b]))
            where.append((i, t, round(far, 4)))
            worst = max(worst, far)
            check(far <= TIE_TOL, f"{phase} {label}: request {i} differs at token {t} ({a} against {b}) where "
                                  f"the plain path's logits do not nearly tie ({far:.4f} > {TIE_TOL})")
        del logits
        print(f"[{phase}] {label}: (request, first differing token, the farther token's distance below the "
              f"recomputed top logit): {where}", flush=True)
    return len(plain) - len(diffs), len(diffs), worst


def route_noise(gen, p_ids, p_mask, rows):
    """The rounding noise between two routes to the same logits: the plain path's cached decode fed its own
    tokens ``rows`` (the fused kernel at 32 rows a step) against one teacher-forced forward over them (the
    prefill route). Prints and returns the largest difference, the largest at the chosen token, the logits'
    standard deviation, the median top-two gap and how many argmaxes flip between the two."""
    import torch

    dev = gen.final_norm.scale.device
    ids, mask = torch.as_tensor(p_ids, device=dev), torch.as_tensor(p_mask, device=dev)
    forced = torch.as_tensor(rows, device=dev).long()
    cached = forced_logits(gen, ids, mask, forced)  # (B, T, V) f32 on the CPU
    full = gen(torch.cat([ids, forced[:, :-1]], dim=1), torch.cat([mask, torch.ones_like(forced[:, :-1])], dim=1))
    tf = full[:, ids.shape[1] - 1:].float().cpu()
    del full
    chosen = forced.cpu()[..., None]
    top2 = torch.topk(cached, 2, dim=-1).values
    out = dict(max=float((tf - cached).abs().max()), chosen=float((tf.gather(-1, chosen) - cached.gather(-1, chosen))
                                                                  .abs().max()),
               std=float(cached.std()), median_gap=float((top2[..., 0] - top2[..., 1]).median()),
               flips=int((tf.argmax(-1) != cached.argmax(-1)).sum()), positions=int(chosen.numel()))
    print(f"[serve-stream] route noise: the plain path's cached logits against one teacher-forced forward's differ "
          f"by up to {out['max']:.4f} ({out['chosen']:.4f} at the chosen token; logit std {out['std']:.4f}, median "
          f"top-two gap {out['median_gap']:.4f}); argmax flips at {out['flips']} of {out['positions']} positions; "
          f"TIE_TOL {TIE_TOL}", flush=True)
    return out


class K5Capture:
    """Keeps the operands of the K5 calls numbered ``keep`` (from 0), passing every call through."""

    def __init__(self, keep):
        from dalm_tpu_torch.kernels import int4_matmul as k5

        self.k5, self.fwd, self.calls, self.n = k5, k5.int4_matmul_fwd, [], 0

        def capture(x2, q4, scale4, instance):
            if self.n in keep:
                self.calls.append((x2.clone(), q4, scale4, instance))
            self.n += 1
            return self.fwd(x2, q4, scale4, instance)

        capture.launches, capture.route_launches = self.fwd.launches, self.fwd.route_launches
        k5.int4_matmul_fwd = capture

    def close(self):
        self.k5.int4_matmul_fwd = self.fwd


def serve_stream_phase(device, q, seed):
    """Streaming and speculative decoding at full width: the int4 + int8 KV cache pipeline of serve-q (bge-large
    + Llama-2-7B, 16,384 passages, 256-token prompts, 64 new tokens, 32 slots, gamma 8) and the 32 queries of
    serve-cb (a). (a) ``answer()`` of a ``RagPipeline(speculative=True)`` on the same generator against the plain
    ``answer()``, tie-aware (``TIE_TOL``); passes a request and accepted drafts a pass. (b) One ``verify_step``
    of the pool at full width, each slot's draft the plain path's own next 8 tokens: every draft is accepted
    up to the first near tie. (c) ``answer_continuous()`` with speculation (the fused schedule) and the engine's
    host loop, tie-aware against (a). (d) ``stream()`` without speculation: 64 queries in two bursts of 32 (the
    second sent once every request of the first has its first token) with serve-cb (b)'s budgets from ``seed``,
    equal token for token to the engine's ``generate`` on the prompts the session built; time to first token
    and tokens/s a request; the first token of each request before its end. (e) ``stream()`` with speculation on
    the 32 queries, tie-aware against (c). K3 at Q = 1 and each K5 route the phase launches (the fused kernel at
    M = 32 and 36, the prefill route at M = 288) against their plain versions on the phase's own operands. Every
    handle must succeed and the scheduler thread end cleanly. Returns the launches of K3 and K5 on the phase's
    main paths (counted from 0 before each) and the numbers printed."""
    import numpy as np
    import torch

    from dalm_tpu_torch.kernels import int4_matmul as k5
    from dalm_tpu_torch.kernels.topk import fused_dot_topk, fused_dot_topk_ref
    from dalm_tpu_torch.models.speculative import build_speculative_generate
    from dalm_tpu_torch.serve import RagPipeline

    B, max_new, G = 32, 64, GAMMA
    eos, pad = q.g_tok.eos_token_id, q.g_tok.pad_token_id or 0
    gen = q.generator
    queries = [f"what about topic {i}" for i in range(0, 16384, 512)]  # serve-cb (a)'s 32 queries
    out, totals = {"launches": {}}, {}

    def counted(case, fn):
        """Run one main-path piece with every serving count from 0; keep its counts under ``case`` and add them
        to ``totals``."""
        zero_serving_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out["launches"][case] = counts = serving_counts()
        for name, n in counts.items():
            if name == "routes":
                for r, c in n.items():
                    totals.setdefault("routes", {}).setdefault(r, 0)
                    totals["routes"][r] += c
            else:
                totals[name] = totals.get(name, 0) + n
        return res, dt

    # (a) lockstep speculative answer() against the plain answer()
    plain, plain_rows, p_ids, p_mask, plain_s = lockstep_tokens(q, queries)
    plain_lists = [trim(r, eos, max_new) for r in plain_rows]
    spec = RagPipeline(q.retriever, q.r_tok, gen, q.g_tok, q.passages, device=device, kv_quant=True,
                       speculative=True, speculative_gamma=G, max_passage_len=q.max_passage_len,
                       max_prompt_len=q.max_prompt_len, max_new_tokens=max_new, embed_batch=q.embed_batch)
    # the pipeline's own generator, with return_stats: the passes each request took
    stats = build_speculative_generate(gen, max_new, eos_token_id=eos, pad_token_id=pad, gamma=G, return_stats=True)
    seen = {}

    def with_stats(ids, mask):
        seen["toks"], seen["passes"] = stats(ids, mask)
        return seen["toks"]

    spec._generate = with_stats
    spec.answer(queries[:2], top_k=4)  # warm
    spec_answers, spec_s = counted("a", lambda: spec.answer(queries, top_k=4))
    routes = out["launches"]["a"]["routes"]
    passes = seen["passes"].cpu().numpy()
    check([a.passages for a in spec_answers] == [a.passages for a in plain], "serve-stream (a): retrieval differs")
    spec_lists = [trim(r, eos, max_new) for r in seen["toks"].cpu().numpy()]
    eq, dv, worst = tie_aware("(a)", gen, p_ids, p_mask, plain_lists, spec_lists, eos)
    noise = route_noise(gen, p_ids, p_mask, plain_rows)
    # the first token comes from the prefill; the passes commit the other max_new - 1
    per_pass = (max_new - 1) / passes.clip(min=1)
    layers = gen.cfg.num_layers
    n_pass = int(passes.max())
    check(routes["prefill"] == 7 * layers + (7 * layers + 1) * n_pass and routes["fold"] == routes["int8"] == 0,
          f"serve-stream (a): K5 routes {routes} for {n_pass} verify passes (each 225 projections at M = "
          f"{B * (G + 1)} on the prefill route) and one prefill")
    out.update(route_noise=noise, a_spec_s=spec_s, a_plain_s=plain_s, a_passes_mean=float(passes.mean()),
               a_passes_max=n_pass,
               a_accepted_per_pass=float((per_pass - 1).mean()), a_equal=eq, a_diverged=dv, a_worst_tie=worst,
               a_routes=routes)
    print(f"[serve-stream] (a) answer() with speculative=True, gamma {G}, {B} queries: {spec_s:.3f} s against the "
          f"plain answer()'s {plain_s:.3f} s ({spec_s / plain_s:.2f}x); verify passes a request mean "
          f"{passes.mean():.2f} (max {n_pass}, min {int(passes.min())}), accepted drafts a pass mean "
          f"{(per_pass - 1).mean():.3f}; {eq} requests equal to the plain tokens, {dv} first differ at a near tie "
          f"(largest {worst:.4f}, tolerance {TIE_TOL}); K5 by route {routes} (the verify pass at M = {B * (G + 1)} on the "
          f"prefill route, the first token's lm_head at M = {B} fused)", flush=True)

    # (b) one verify_step on the pool at full width, drafts = the plain path's own next G tokens
    eng = spec._new_engine(B, max_new, 8)
    reqs = np.arange(B)
    first = eng._admit_rows(p_ids, p_mask, reqs, reqs).cpu().numpy()
    check(first.tolist() == [r[0] for r in plain_lists], "serve-stream (b): admission's first tokens differ")
    drafts = np.array([r[1:1 + G] for r in plain_lists], np.int64)
    held = {}

    def verify_captured():  # installed after counted() zeroes the counts, so the capture shares them
        held["cap"] = cap = K5Capture(set(range(7)) | {7 * layers})  # layer 0's seven projections, the lm_head
        try:
            return eng._verify(np.ones(B, bool), drafts, np.full(B, max_new - 1), reqs, np.ones(B, np.int64))
        finally:
            cap.close()

    (emit, m), verify_s = counted("b", verify_captured)
    cap, b_routes = held["cap"], out["launches"]["b"]["routes"]
    emit, m = emit.cpu().numpy(), m.cpu().numpy()
    lists_b = [r[:1] + [int(t) for t in emit[i, :m[i]]] for i, r in enumerate(plain_lists)]
    short = [r[:1 + G + 1] for r in plain_lists]
    eq_b, dv_b, worst_b = tie_aware("(b)", gen, p_ids, p_mask, short, lists_b, eos)
    check(b_routes["prefill"] == 7 * layers + 1 and b_routes["fused"] == 0,
          f"serve-stream (b): the verify pass's K5 routes {b_routes}, want 225 at M = {B * (G + 1)} on the prefill "
          f"route")
    out.update(b_committed=m.tolist(), b_equal=eq_b, b_diverged=dv_b, b_verify_s=verify_s)
    print(f"[serve-stream] (b) one verify pass of {B} slots at gamma {G} ({verify_s * 1e3:.1f} ms) with each slot's "
          f"plain next {G} tokens as its draft: committed a slot {sorted(m.tolist())}; {eq_b} slots all {G} drafts "
          f"accepted and the bonus equal to the plain token, {dv_b} cut at a near tie (largest {worst_b:.4f})",
          flush=True)

    # K5 held against its plain version on this phase's operands: M = 288 (prefill route), 36 and 32 (fused)
    worst_k5 = {}
    for x2, q4, scale4, inst in cap.calls:
        for rows, route in ((B * (G + 1), "prefill"), (4 * (G + 1), "fused"), (B, "fused")):
            x = x2[:rows].contiguous()
            group = k5._check(x, q4, scale4, inst)
            check(k5._route(x, inst, group) == route, f"serve-stream: K5 at M = {rows} is not on the {route} route")
            err, share = k5_err(k5.int4_matmul_fwd(x, q4, scale4, inst), k5.int4_matmul_fwd_ref(x, q4, scale4, inst),
                                inst)
            worst_k5[rows] = max(worst_k5.get(rows, 0.0), share)
    print(f"[serve-stream] K5 on the verify pass's own operands (layer 0's seven projections and the lm_head) "
          f"against the plain version, worst share of the K5_TOL bound by M: {worst_k5}", flush=True)
    del cap, eng
    torch.cuda.empty_cache()

    # (c) the speculative engine: the fused schedule (answer_continuous) and the host loop
    spec.answer_continuous(queries[:2], top_k=4, num_slots=B)  # builds the engine (its pool on first use)
    probe = EngineProbe(spec._engine)
    try:
        cont, fused_s = counted("c_fused", lambda: spec.answer_continuous(queries, top_k=4, num_slots=B))
    finally:
        probe.close()
    fused_passes, res_fused = probe.iters, probe.results
    check([a.passages for a in cont] == [a.passages for a in plain], "serve-stream (c): retrieval differs")
    eq_c, dv_c, worst_c = tie_aware("(c) fused", gen, p_ids, p_mask, spec_lists, res_fused, eos)
    probe = EngineProbe(spec._engine)
    try:
        res_host, host_s = counted("c_host", lambda: spec._engine.generate(p_ids, p_mask))
    finally:
        probe.close()
    eq_h, dv_h, worst_h = tie_aware("(c) host loop", gen, p_ids, p_mask, spec_lists, res_host, eos)
    out.update(c_fused_s=fused_s, c_host_s=host_s, c_fused_passes=fused_passes, c_host_passes=probe.iters,
               c_equal=[eq_c, eq_h], c_diverged=[dv_c, dv_h])
    print(f"[serve-stream] (c) answer_continuous() with speculation (fused schedule): {fused_s:.3f} s, "
          f"{fused_passes} verify passes; the host loop generate(): {host_s:.3f} s, {probe.iters} passes "
          f"({probe.admit_s:.3f} s admitting); against (a): fused {eq_c} equal / {dv_c} near ties, host loop "
          f"{eq_h} / {dv_h}", flush=True)

    # (d) streaming without speculation: 64 queries in two bursts of 32
    queries64 = [f"what about topic {i}" for i in range(0, 16384, 256)]
    budgets = np.random.default_rng(seed).integers(8, max_new + 1, size=len(queries64))
    session = q.stream(num_slots=B)
    calls = {"_admit": 0, "_decode_chunk": 0}  # admission waves and decode chunks of the session's engine

    def counting(name):
        fn = getattr(session._server.engine, name)

        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        setattr(session._server.engine, name, wrapped)

    for name in calls:
        counting(name)

    def stream_two_bursts():  # the engine's methods are counted only while the session runs
        with session:
            handles = [session.submit(x, top_k=4, budget=int(b)) for x, b in zip(queries64[:B], budgets[:B])]
            t_end = time.monotonic() + 300
            while not all(h._handle.t_first_token is not None or h.done for h in handles):
                check(time.monotonic() < t_end and session._server._crashed is None,
                      "serve-stream (d): the first burst's first tokens did not arrive")
                time.sleep(0.005)
            handles += [session.submit(x, top_k=4, budget=int(b)) for x, b in zip(queries64[B:], budgets[B:])]
            results = [h._handle.result(timeout=600) for h in handles]
        for name in calls:
            delattr(session._server.engine, name)
        return handles, results

    (handles, results), stream_s = counted("d", stream_two_bursts)
    server = session._server
    check(server._crashed is None and not server._thread.is_alive(), "serve-stream (d): the scheduler failed")
    prompts = q.g_tok([f"#query# {x} #passage# {h.passages[0]} #answer# " for x, h in zip(queries64, handles)],
                      padding="max_length", max_length=q.max_prompt_len, truncation=True)
    s_ids, s_mask = np.asarray(prompts["input_ids"], np.int64), np.asarray(prompts["attention_mask"], np.int64)
    want = server.engine.generate(s_ids, s_mask, budgets=budgets)
    diff = [i for i in range(len(queries64)) if results[i] != want[i]]
    check(not diff, f"serve-stream (d): streamed tokens differ from the engine's generate for requests {diff}")
    ttft = np.array([h._handle.t_first_token - h._handle.t_submit for h in handles])
    per_req = np.array([len(r) / (h._handle.t_done - h._handle.t_submit) for h, r in zip(handles, results)])
    check(all(h._handle.t_first_token < h._handle.t_done for h, r in zip(handles, results) if len(r) > 1),
          "serve-stream (d): a request's first token did not arrive before its end")
    tokens = sum(len(r) for r in results)
    out.update(d_s=stream_s, d_tokens=tokens, d_ttft_s=[float(np.median(ttft[:B])), float(np.median(ttft[B:]))],
               d_tokens_per_s_request=float(np.median(per_req)), d_waves=calls["_admit"],
               d_chunks=calls["_decode_chunk"])
    print(f"[serve-stream] (d) stream() of {len(queries64)} queries in two bursts of {B} on {B} slots, budgets from "
          f"seed {seed} (sum {int(budgets.sum())}): {stream_s:.3f} s, {tokens} tokens = {tokens / stream_s:.1f} "
          f"tokens/s; time to first token median {np.median(ttft[:B]):.3f} s (first burst), "
          f"{np.median(ttft[B:]):.3f} s (second, max {ttft.max():.3f} s); tokens/s a request median "
          f"{np.median(per_req):.2f}; {calls['_admit']} admission waves (a prefill of {B} rows each), "
          f"{calls['_decode_chunk']} decode chunks of 8 steps; every request equal to the engine's generate(); "
          f"every first token before its request's end", flush=True)
    del session, server
    torch.cuda.empty_cache()

    # (e) streaming with speculation: the 32 queries, tie-aware against (c)
    session = spec.stream(num_slots=B)

    def stream_spec():
        with session:
            hs = [session.submit(x, top_k=4) for x in queries]
            return hs, [h._handle.result(timeout=600) for h in hs]

    (handles, results), spec_stream_s = counted("e", stream_spec)
    server = session._server
    check(server._crashed is None and not server._thread.is_alive(), "serve-stream (e): the scheduler failed")
    check([h.passages for h in handles] == [a.passages for a in plain], "serve-stream (e): retrieval differs")
    eq_e, dv_e, worst_e = tie_aware("(e)", gen, p_ids, p_mask, res_fused, results, eos)
    rounds = np.array([h._handle.spec_rounds for h in handles])
    out.update(e_s=spec_stream_s, e_rounds_mean=float(rounds.mean()), e_equal=eq_e, e_diverged=dv_e)
    print(f"[serve-stream] (e) stream() with speculation, {B} queries: {spec_stream_s:.3f} s, verify rounds a "
          f"request mean {rounds.mean():.2f}; against (c): {eq_e} equal, {dv_e} near ties", flush=True)
    del session, server

    # K3 at Q = 1 (a session's retrieval) against its plain version
    q1 = q._embed_texts([f"#query# {queries[0]}"], q.max_passage_len)
    e = q.index.embeddings
    ks, ki = fused_dot_topk(q1, e, 4)
    rs, ri = fused_dot_topk_ref(q1, e, 4)
    k3_err, swaps = compare_topk(ks, ki, rs, ri, q1, e, None)
    print(f"[serve-stream] K3 at Q = 1 x N {e.shape[0]} x D {e.shape[1]}, k 4: max score error {k3_err:.2e}, "
          f"{swaps} near-tie swaps", flush=True)
    check(totals["fused_dot_topk[f32]"] > 0 and totals["routes"]["prefill"] > 0 and totals["routes"]["fused"] > 0,
          f"serve-stream: a kernel of the path was never launched: {totals}")
    print(f"[serve-stream] launches on the phase's main paths, each counted from 0: {out['launches']}; in all "
          f"{totals}", flush=True)
    print(json.dumps({"serve_stream": out}), flush=True)
    return totals, out


# serve-refresh: new retriever weights are the serve cell's own, each floating tensor moved by seeded Gaussian noise
# of REFRESH_NOISE times its own standard deviation: enough to change retrieval (the run prints the share of the
# 32 queries' top-4 ids that change). A swept row is held to a fresh ``_embed_texts`` of its passage under the new
# weights within REFRESH_TOL: both embed in batches of 256 through the same bf16 encoder, so they differ only if the
# batch composition changes the sums; one bf16 ulp of a unit-norm row's largest entries is 2^-9.
REFRESH_NOISE = 0.1
REFRESH_TOL = 2.0 ** -9
SPILL_ROWS, SPILL_DEVICE_ROWS = 262144, 131072


def serve_refresh_phase(device, pipe):
    """``RagPipeline.refresh`` and the spill tier at full width: the serve cell's pipeline (bge-large, 16,384
    passages, passages of 128 tokens, batches of 256, the 32 serve queries). (a) A sweep: new retriever weights,
    an ``AsyncIndexRefresher`` at slice 256 (64 ticks); after half the ticks the queries' search equals the search
    before the refresh bit for bit; after the swap the active rows equal a fresh ``_embed_texts`` of the corpus
    within ``REFRESH_TOL`` and K3 on them equals its plain version. (b) The rebuild: ``refresh`` on int8 and int4
    indexes of the corpus; each search runs K3 in that mode and equals its plain version. (c) A ``TieredIndex`` over
    a seeded 262,144 x 1024 f32 corpus (1 GiB of host RAM), 131,072 rows on the device, 32 queries, k 10, against
    an exact f64 search of the whole corpus on the card: ids equal but at near ties, scores within 1e-5. The
    pipeline's weights and rows are restored at the end. Returns K3's launches by mode on the phase's main paths
    (the searches of (a) and (b), the device tier of (c)) and the numbers printed."""
    import copy

    import numpy as np
    import torch

    from dalm_tpu_torch.index.dense import DenseIndex
    from dalm_tpu_torch.index.host_index import TieredIndex, scan_threads
    from dalm_tpu_torch.index.refresh import AsyncIndexRefresher
    from dalm_tpu_torch.kernels.topk import _dequantized_rows, fused_dot_topk, fused_dot_topk_ref

    queries = [f"what about topic {i}" for i in range(0, 16384, 512)]
    texts = [f"#passage# {p}" for p in pipe.passages]
    qtexts = [f"#query# {x}" for x in queries]
    launches, out = dict.fromkeys(("f32", "int8", "int4"), 0), {}

    def counted(fn):
        before = dict(fused_dot_topk.launches)
        res = fn()
        for mode in launches:
            launches[mode] += fused_dot_topk.launches[mode] - before[mode]
        return res

    old_state = {k: v.clone() for k, v in pipe.retriever.state_dict().items()}
    g = torch.Generator(device=device).manual_seed(17)
    new_state = {}
    for k, v in old_state.items():
        if v.is_floating_point() and v.numel() > 1:
            noise = torch.randn(v.shape, generator=g, device=device, dtype=torch.float32)
            new_state[k] = (v.float() + REFRESH_NOISE * v.float().std() * noise).to(v.dtype)
        else:
            new_state[k] = v
    old_rows = pipe.index.embeddings

    # (a) the sweep
    q_old = pipe._embed_texts(qtexts, pipe.max_passage_len)
    s0, i0 = counted(lambda: pipe.index.search(q_old, 4))
    pipe.retriever.load_state_dict(new_state)
    toks = pipe.r_tok(texts, padding="max_length", max_length=pipe.max_passage_len, truncation=True)
    refresher = AsyncIndexRefresher(pipe.index, pipe._embed, toks["input_ids"], toks["attention_mask"],
                                    slice_size=256)
    ticks = -(-len(texts) // 256)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks // 2):
        stats = refresher.tick()
    torch.cuda.synchronize()
    half_s = time.perf_counter() - t0
    check(not stats["swapped"] and stats["cursor"] == 256 * (ticks // 2) and pipe.index.embeddings is old_rows,
          f"serve-refresh (a): after {ticks // 2} ticks {stats}")
    s_mid, i_mid = counted(lambda: pipe.index.search(q_old, 4))
    check(np.array_equal(i_mid, i0) and np.array_equal(s_mid, s0),
          "serve-refresh (a): a search in the middle of the sweep differs from the search before it")
    t0 = time.perf_counter()
    n_ticks = ticks // 2
    while True:
        n_ticks += 1
        if refresher.tick()["swapped"]:
            break
    torch.cuda.synchronize()
    sweep_s = half_s + time.perf_counter() - t0
    check(n_ticks == ticks and refresher.version == 1 and pipe.index.embeddings is not old_rows,
          f"serve-refresh (a): {n_ticks} ticks, version {refresher.version}")
    fresh = pipe._embed_texts(texts, pipe.max_passage_len)
    row_err = float((pipe.index.embeddings - fresh).abs().max())
    check(row_err <= REFRESH_TOL, f"serve-refresh (a): swept rows differ from a fresh embedding by {row_err}")
    del fresh
    q_new = pipe._embed_texts(qtexts, pipe.max_passage_len)
    s1, i1 = counted(lambda: pipe.index.search(q_new, 4))
    changed = float(np.mean([len(set(a) - set(b)) / 4 for a, b in zip(i1.tolist(), i0.tolist())]))
    check(changed > 0, "serve-refresh (a): the new weights changed no top-4 id")
    e = pipe.index.embeddings
    ks, ki = fused_dot_topk(q_new, e, 4)
    rs, ri = fused_dot_topk_ref(q_new, e, 4)
    err_a, swaps_a = compare_topk(ks, ki, rs, ri, q_new, e, None)
    check(np.array_equal(ki.cpu().numpy(), i1), "serve-refresh (a): search() ids differ from K3's on the same rows")
    out.update(sweep_s=sweep_s, sweep_passages_per_s=len(texts) / sweep_s, tick_ms=sweep_s / ticks * 1e3,
               row_err=row_err, top4_changed=changed, k3_err=err_a)
    print(f"[serve-refresh] (a) AsyncIndexRefresher over {len(texts)} passages at slice 256: {ticks} ticks in "
          f"{sweep_s:.3f} s = {len(texts) / sweep_s:.0f} passages/s, {sweep_s / ticks * 1e3:.2f} ms a tick; after "
          f"{ticks // 2} ticks the {len(queries)} queries' search equals the search before the refresh bit for bit; "
          f"swept rows against a fresh _embed_texts max abs err {row_err} (tolerance {REFRESH_TOL}); the new weights "
          f"(noise {REFRESH_NOISE} x each tensor's std) change {changed:.1%} of the top-4 ids; K3 f32 on the new "
          f"rows against its plain version: max score error {err_a:.2e}, {swaps_a} near-tie swaps", flush=True)

    # (b) the rebuild of quantised indexes
    q_bf16 = q_new.to(torch.bfloat16)
    for mode, quantize in (("int8", True), ("int4", "int4")):
        qp = copy.copy(pipe)  # shares the retriever; refresh() rebinds only this copy's index
        qp.index = DenseIndex.build(old_rows, quantize=quantize, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qp.refresh(new_state)
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t0
        check(qp.index.int4 == (mode == "int4") and qp.index.scales is not None and pipe.index.scales is None,
              f"serve-refresh (b): the {mode} rebuild gave another index")
        sq, iq = counted(lambda: qp.retrieve(queries, 4))
        rows, scales, int4 = qp.index.embeddings, qp.index.scales, qp.index.int4
        ks, ki = fused_dot_topk(q_bf16, rows, 4, scales=scales, int4=int4)
        rs, ri = fused_dot_topk_ref(q_bf16, rows, 4, scales=scales, int4=int4)
        err, swaps = compare_topk(ks, ki, rs, ri, q_bf16.float(), _dequantized_rows(rows, int4), scales)
        check(np.array_equal(ki.cpu().numpy(), iq), f"serve-refresh (b): {mode} retrieve() ids differ from K3's")
        out[f"rebuild_{mode}_s"] = rebuild_s
        print(f"[serve-refresh] (b) refresh() of an {mode} index: re-embedded and rebuilt in {rebuild_s:.3f} s; "
              f"K3 {mode} on the rebuilt rows against its plain version: max score error {err:.2e}, {swaps} "
              f"near-tie swaps; top-4 ids shared with the f32 index {float((iq == i1).mean()):.1%}", flush=True)
        del qp
    check(launches["int8"] > 0 and launches["int4"] > 0, f"serve-refresh (b): K3 launches {launches}")
    pipe.retriever.load_state_dict(old_state)  # the serve cell as it was: its weights and its rows
    pipe.index.embeddings = old_rows
    del refresher, old_state, new_state, e, q_old, q_new, q_bf16
    torch.cuda.empty_cache()

    # (c) the spill tier
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    corpus_rows = rng.standard_normal((SPILL_ROWS, 1024), dtype=np.float32)
    corpus_rows /= np.linalg.norm(corpus_rows, axis=1, keepdims=True)
    qs = rng.standard_normal((32, 1024), dtype=np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    make_s = time.perf_counter() - t0
    tiered = TieredIndex.build(corpus_rows, hbm_budget_rows=SPILL_DEVICE_ROWS, device=device)
    check(tiered.host_index is not None and tiered.host_index.use_native
          and tiered.host_index.embeddings.shape[0] == SPILL_ROWS - SPILL_DEVICE_ROWS, "serve-refresh (c): tiers")
    tiered.search(qs, 10)  # warm both tiers

    def timed(fn):
        t = time.perf_counter()
        res = fn()
        return res, time.perf_counter() - t

    _, dev_s = counted(lambda: timed(lambda: tiered.device_index.search(qs, 10)))
    _, host_s = timed(lambda: tiered.host_index.search(qs, 10))
    (ts, ti), all_s = counted(lambda: timed(lambda: tiered.search(qs, 10)))
    full = torch.from_numpy(corpus_rows).to(device)
    exact = torch.from_numpy(qs).to(device).double() @ full.double().T
    es, ei = (x.cpu().numpy() for x in torch.topk(exact, 10))
    exact = exact.cpu().numpy()
    del full
    torch.cuda.empty_cache()
    ties = 0
    for r, c in zip(*np.nonzero(ti != ei)):
        ties += 1
        check(abs(exact[r, ti[r, c]] - exact[r, ei[r, c]]) <= NEAR_TIE,
              f"serve-refresh (c): query {r} rank {c}: id {ti[r, c]} against the exact {ei[r, c]}, not a near tie")
    spill_err = float(np.abs(ts - es).max())
    check(spill_err <= NEAR_TIE, f"serve-refresh (c): scores differ from the exact search by {spill_err}")
    threads = scan_threads()
    out.update(spill_device_ms=dev_s * 1e3, spill_host_ms=host_s * 1e3, spill_ms=all_s * 1e3,
               spill_threads=threads, spill_err=spill_err, spill_ties=ties)
    print(f"[serve-refresh] (c) TieredIndex over {SPILL_ROWS} x 1024 f32 rows ({corpus_rows.nbytes / 2**30:.2f} GiB "
          f"made from seed 0 in {make_s:.2f} s), {SPILL_DEVICE_ROWS} on the device, 32 queries, k 10 (host clock): "
          f"device tier (K3 f32) {dev_s * 1e3:.3f} ms, host tier (the C++ scan, {threads} OpenMP threads; torch "
          f"{torch.get_num_threads()} threads) {host_s * 1e3:.3f} ms, both and the merge {all_s * 1e3:.3f} ms; "
          f"against an exact f64 search of the whole corpus on the card: max score error {spill_err:.2e}, {ties} "
          f"near-tie id swaps", flush=True)
    del tiered, corpus_rows
    gc.collect()
    torch.cuda.empty_cache()
    counts = {f"fused_dot_topk[{m}]": n for m, n in launches.items()}
    print(f"[serve-refresh] K3 launches on the phase's main paths: {counts}", flush=True)
    print(json.dumps({"serve_refresh": out}), flush=True)
    return counts, out


def serve_adapter_phase(device, passages, retriever="bge-large", generator="llama2-7b"):
    """PEFT adapters at full width: both towers' adapters written by the port's ``save_adapter`` with seeded
    nonzero factors at r 8, alpha 16 and ``LoraSpec``'s targets (query / key / value; q_proj / v_proj), then
    ``RagPipeline.from_pretrained("bge-large", "llama2-7b", ..., quantize_generator="int4", kv_quant=True,
    generator_peft_path=..., retriever_peft_path=...)``. No ``FlexLinear`` keeps a factor; q_proj and v_proj of the
    first and last layer hold exactly ``pack(W + scaling * A @ B)`` (computed here in plain PyTorch from the kernel
    ``W`` the merge was given) and differ from ``pack(W)``; the encoder's layer-0 query kernel equals ``W +
    scaling * A @ B``. One ``answer()`` of the 32 serve queries on K5, its launches counted by route. The pipeline
    is freed at the end. Returns its K3 / K5 launches and the numbers printed."""
    import numpy as np
    import torch

    from dalm_tpu_torch.eval import rag as rag_mod
    from dalm_tpu_torch.eval import retriever as retriever_mod
    from dalm_tpu_torch.models.decoder import Decoder
    from dalm_tpu_torch.models.embedder import SentenceEmbedder
    from dalm_tpu_torch.models.layers import FlexLinear
    from dalm_tpu_torch.models.lora import LoraSpec, save_adapter
    from dalm_tpu_torch.models.qlora import _pack_leaf
    from dalm_tpu_torch.models.registry import resolve_decoder, resolve_encoder
    from dalm_tpu_torch.serve import RagPipeline

    gen = torch.Generator(device=device).manual_seed(23)
    r_spec, g_spec = LoraSpec.for_encoder(), LoraSpec.for_causal_lm()

    def factors(module, spec):
        """Seeded nonzero factors for every target of ``module`` (built on the meta device: shapes only)."""
        out = {}
        for name, m in module.named_modules():
            if isinstance(m, FlexLinear) and name.rsplit(".", 1)[-1] in spec.target_modules:
                out[name.replace(".", "/") + "/kernel"] = {
                    "lora_a": torch.randn((m.in_features, spec.rank), generator=gen, device=device) * 0.02,
                    "lora_b": torch.randn((spec.rank, m.out_features), generator=gen, device=device) * 0.02}
        return out

    r_lora = factors(SentenceEmbedder(resolve_encoder(retriever)[0], device="meta").module, r_spec)
    g_cfg = resolve_decoder(generator)[0]
    g_lora = factors(Decoder(g_cfg, device="meta"), g_spec)
    layers = g_cfg.num_layers
    watch = [f"layer_{i}/attention/{p}/kernel" for i in (0, layers - 1) for p in ("q_proj", "v_proj")]
    watch_r = "layer_0/attention/query/kernel"
    seen, merge = {}, rag_mod.merge_lora_inplace

    def capturing(module, lora_params, spec):  # keeps the kernels W the merge is given
        for path in lora_params:
            if path in watch or path == watch_r:
                seen[path] = module.get_submodule(".".join(path.split("/")[:-1])).kernel.detach().clone()
        return merge(module, lora_params, spec)

    queries = [f"what about topic {i}" for i in range(0, 16384, 512)]
    with tempfile.TemporaryDirectory() as tmp:
        save_adapter(f"{tmp}/retriever", r_lora, r_spec)
        save_adapter(f"{tmp}/generator", g_lora, g_spec)
        rag_mod.merge_lora_inplace = retriever_mod.merge_lora_inplace = capturing
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe = RagPipeline.from_pretrained(
                retriever, generator, passages, dtype="bfloat16", device=device, quantize_generator="int4",
                kv_quant=True, generator_peft_path=f"{tmp}/generator", retriever_peft_path=f"{tmp}/retriever",
                max_passage_len=128, max_prompt_len=256, max_new_tokens=64, embed_batch=256)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
        finally:
            rag_mod.merge_lora_inplace = retriever_mod.merge_lora_inplace = merge
    left = [n for m in (pipe.retriever, pipe.generator) for n, x in m.named_modules()
            if isinstance(x, FlexLinear) and any(getattr(x, f) is not None for f in ("lora_a", "lora_b", "a", "b"))]
    check(not left and len(seen) == len(watch) + 1, f"serve-adapter: layers keep factors {left[:4]}, or the merge "
                                                     f"never saw {set(watch) - set(seen)}")
    moved = {}
    for path in watch:
        w, ab = seen[path], g_lora[path]
        want = _pack_leaf(w + ((ab["lora_a"] @ ab["lora_b"]) * g_spec.scaling).to(w.dtype), "int4")
        plain = _pack_leaf(w, "int4")
        site = pipe.generator.get_submodule(".".join(path.split("/")[:-1]))
        check(site.kernel is None and torch.equal(site.q4, want["q4"]) and torch.equal(site.scale4, want["scale4"]),
              f"serve-adapter: {path} is not pack(W + scaling * A @ B)")
        moved[path] = float((site.q4 != plain["q4"]).float().mean())
        check(moved[path] > 0, f"serve-adapter: {path} equals pack(W): the adapter changed nothing")
    w, ab = seen[watch_r], r_lora[watch_r]
    want = w + ((ab["lora_a"] @ ab["lora_b"]) * r_spec.scaling).to(w.dtype)
    got = pipe.retriever.module.get_submodule("layer_0.attention.query").kernel
    r_moved = float((want - w).abs().max())
    check(torch.equal(got, want) and r_moved > 0, "serve-adapter: the encoder's query kernel is not W + scaling*A@B")
    pipe.answer(queries[:2], top_k=4)  # warm
    zero_serving_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    answers = pipe.answer(queries, top_k=4)
    torch.cuda.synchronize()
    answer_s = time.perf_counter() - t0
    counts = serving_counts()
    routes = counts["routes"]
    per_forward = 7 * layers + 1
    check(routes["prefill"] == 7 * layers and routes["fused"] == per_forward * 64 - 7 * layers
          and routes["fold"] == routes["int8"] == 0 and counts["fused_dot_topk[f32]"] == 1,
          f"serve-adapter: launches {counts} for one answer() of 64 forwards")
    check(len(answers) == len(queries) and all(len(a.passages) == 4 and np.all(np.isfinite(a.scores))
                                               for a in answers), "serve-adapter: answers")
    out = dict(build_s=build_s, answer_s=answer_s, q4_bytes_changed=moved, encoder_delta_max=r_moved)
    print(f"[serve-adapter] from_pretrained with both adapters (r {g_spec.rank}, alpha {g_spec.alpha}; {len(r_lora)} "
          f"encoder and {len(g_lora)} generator kernels merged, then packed to int4): {build_s:.2f} s; no layer "
          f"keeps a factor; q_proj / v_proj of layers 0 and {layers - 1} equal pack(W + scaling A B) bit for bit, "
          f"their share of packed bytes that differ from pack(W): "
          + ", ".join(f"{k.split('/')[0]}.{k.split('/')[2]} {v:.1%}" for k, v in moved.items())
          + f"; the encoder's layer-0 query kernel equals W + scaling A B (largest delta {r_moved:.2e}); answer() of "
          f"{len(queries)} queries {answer_s:.3f} s; launches {counts}", flush=True)
    del pipe, seen, r_lora, g_lora
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"serve_adapter": out}), flush=True)
    return counts, out


HTTP_ROUTES = ("answer", "stream", "chat", "chat-stream")


def serve_http_phase(device, q, seed, stream_s=None):
    """The HTTP / OpenAI front end at full width: a ``RagHTTPServer`` on port 0 over serve-q's int4 + int8 KV cache
    pipeline with 32 slots. 32 client threads send serve-cb (b)'s 64 queries with its budgets from ``seed``
    (``budget`` / ``max_tokens``), in turn to ``/answer``, ``/stream``, ``/v1/chat/completions`` and the same with
    ``stream: true``. Each response's text equals the decode of the tokens its request streamed, and those equal
    ``DecodeEngine.generate()``'s for the same prompt and budget, tie-aware (``TIE_TOL``); SSE ends with
    ``[DONE]`` and ``usage.completion_tokens`` counts the tokens. Then one client hangs up on ``/stream`` after its
    first chunk (or its headers, when its text has not grown), and the pool's free slots come back to 32. K3's
    launches equal the requests, counted from request threads under the counter's lock. ``shutdown()`` raises if
    the scheduler crashed. Returns the launches and the numbers printed."""
    import concurrent.futures
    import http.client
    import socket
    import struct

    import numpy as np

    from dalm_tpu_torch.server_http import RagHTTPServer

    B, max_new = 32, 64
    eos = q.g_tok.eos_token_id
    queries = [f"what about topic {i}" for i in range(0, 16384, 256)]  # serve-cb (b)'s 64 queries
    budgets = np.random.default_rng(seed).integers(8, max_new + 1, size=len(queries))
    srv = RagHTTPServer(q, port=0, num_slots=B)
    session, handles = srv.session, {}
    submit = session.submit

    def recording(query, top_k=4, budget=None):  # the handle of each request, by its query
        handles[query] = submit(query, top_k=top_k, budget=budget)
        return handles[query]

    session.submit = recording
    zero_serving_counts()
    srv.start_background()

    def request(i):
        query, budget, route = queries[i], int(budgets[i]), HTTP_ROUTES[i % len(HTTP_ROUTES)]
        if route in ("answer", "stream"):
            path, body = f"/{route}", {"query": query, "top_k": 4, "budget": budget}
        else:
            path, body = "/v1/chat/completions", {"messages": [{"role": "user", "content": query}], "top_k": 4,
                                                  "max_tokens": budget, "stream": route == "chat-stream"}
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=600)
        try:
            t0 = time.perf_counter()
            conn.request("POST", path, body=json.dumps(body), headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            ttfb = time.perf_counter() - t0
            data = resp.read()  # de-chunked
            return dict(i=i, route=route, status=resp.status, data=data, ttfb=ttfb, wall=time.perf_counter() - t0)
        finally:
            conn.close()

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(32) as pool:
        responses = list(pool.map(request, range(len(queries))))
    wall_s = time.perf_counter() - t0
    results = {x: handles[x]._handle.result(timeout=600) for x in queries}

    # one client hangs up on /stream after its first chunk (after its headers if no text comes first)
    gone = "what about topic 100"
    body = json.dumps({"query": gone, "top_k": 4}).encode()
    with socket.create_connection((srv.host, srv.port), timeout=600) as s:
        s.sendall(b"POST /stream HTTP/1.1\r\nHost: x\r\nConnection: close\r\nContent-Type: application/json\r\n"
                  b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
        got = b""
        while b"\r\n\r\n" not in got:
            got += s.recv(4096)
        s.settimeout(0.01)
        while not re.search(rb"\r\n\r\n[0-9A-F]+\r\n.", got, re.S) and not handles[gone].done:
            try:
                got += s.recv(4096)
            except socket.timeout:
                pass
        first_chunk = bool(re.search(rb"\r\n\r\n[0-9A-F]+\r\n.", got, re.S))
        done_at_hangup = handles[gone].done
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))  # reset the connection on close
    gone_tokens = handles[gone]._handle.result(timeout=600)
    deadline = time.monotonic() + 120
    while session._server.free_slots != B and time.monotonic() < deadline:
        time.sleep(0.01)
    free = session._server.free_slots
    srv.shutdown()  # raises if the scheduler crashed
    check(free == B, f"serve-http: {free} of {B} slots free after the client went away")
    counts = serving_counts()
    check(counts["fused_dot_topk[f32]"] == len(queries) + 1,
          f"serve-http: K3 counted {counts['fused_dot_topk[f32]']} launches for {len(queries) + 1} requests")
    check(counts["routes"]["fused"] > 0 and counts["routes"]["prefill"] > 0, f"serve-http: K5 launches {counts}")

    # every response against its request's tokens; the tokens against the engine's generate(), tie-aware
    for r in responses:
        x = queries[r["i"]]
        toks, h = results[x], handles[x]
        text = q.g_tok.decode(toks, skip_special_tokens=True).split("#answer#")[0]
        check(r["status"] == 200, f"serve-http: request {r['i']} ({r['route']}) got status {r['status']}")
        if r["route"] == "answer":
            obj = json.loads(r["data"])
            check(obj["answer"] == text.strip() and obj["passages"] == h.passages, f"serve-http: /answer {r['i']}")
        elif r["route"] == "stream":
            check(r["data"].decode("utf-8") == text, f"serve-http: /stream {r['i']}")
        else:
            cap = min(int(budgets[r["i"]]), max_new)
            finish = "length" if len(toks) >= cap else "stop"
            if r["route"] == "chat":
                obj = json.loads(r["data"])
                choice = obj["choices"][0]
                check(choice["message"]["content"] == text.strip() and choice["finish_reason"] == finish
                      and obj["usage"]["completion_tokens"] == len(toks) and obj["dalm"]["passages"] == h.passages,
                      f"serve-http: chat {r['i']}")
            else:
                events = [e[len(b"data: "):] for e in r["data"].split(b"\n\n") if e]
                check(events[-1] == b"[DONE]", f"serve-http: SSE {r['i']} does not end with [DONE]")
                chunks = [json.loads(e) for e in events[:-1]]
                content = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
                check(chunks[0]["choices"][0]["delta"] == {"role": "assistant"} and content == text
                      and chunks[-1]["choices"][0]["finish_reason"] == finish
                      and chunks[-1]["usage"]["completion_tokens"] == len(toks), f"serve-http: SSE {r['i']}")
    prompts = q.g_tok([f"#query# {x} #passage# {handles[x].passages[0]} #answer# " for x in queries],
                      padding="max_length", max_length=q.max_prompt_len, truncation=True)
    s_ids, s_mask = np.asarray(prompts["input_ids"], np.int64), np.asarray(prompts["attention_mask"], np.int64)
    want = session._server.engine.generate(s_ids, s_mask, budgets=budgets)
    got = [results[x] for x in queries]
    eq, dv, worst = tie_aware("(HTTP against generate())", q.generator, s_ids, s_mask, want, got, eos,
                              phase="serve-http")
    tokens = sum(len(t) for t in got)
    streamed = [r["ttfb"] for r in responses if r["route"] in ("stream", "chat-stream")]
    ttft = [handles[x]._handle.t_first_token - handles[x]._handle.t_submit for x in queries]
    out = dict(wall_s=wall_s, requests_per_s=len(queries) / wall_s, tokens=tokens, tokens_per_s=tokens / wall_s,
               ttfb_median_s=float(np.median(streamed)), ttfb_p90_s=float(np.percentile(streamed, 90)),
               ttft_median_s=float(np.median(ttft)), equal=eq, near_ties=dv, worst_tie=worst,
               hangup_after_first_chunk=first_chunk, hangup_done_already=done_at_hangup, hangup_tokens=len(gone_tokens),
               stream_d_s=stream_s)
    vs = "" if stream_s is None else f" (serve-stream (d)'s 64 requests through stream(): {stream_s:.3f} s)"
    print(f"[serve-http] RagHTTPServer, {B} slots, {len(queries)} requests from 32 client threads ({', '.join(HTTP_ROUTES)} "
          f"in turn), budgets from seed {seed} (sum {int(budgets.sum())}): {wall_s:.3f} s{vs} = "
          f"{len(queries) / wall_s:.2f} requests/s, {tokens} tokens = {tokens / wall_s:.1f} tokens/s; time to first "
          f"byte on the streamed routes median {np.median(streamed):.3f} s, p90 {np.percentile(streamed, 90):.3f} s; "
          f"time to first token median {np.median(ttft):.3f} s; every response equals its request's tokens; {eq} "
          f"requests equal to generate(), {dv} first differ at a near tie (largest {worst:.4f}); the client that hung "
          f"up after {'its first chunk' if first_chunk else 'its headers'} "
          f"({'its request had ended: no text before its end' if done_at_hangup else 'mid-answer'}) had "
          f"{len(gone_tokens)} of {max_new} tokens and its slot came back ({free} free); launches {counts}",
          flush=True)
    print(json.dumps({"serve_http": out}), flush=True)
    return counts, out


def serve_phase(device, rng, peaks, kernels):
    """The serving main path, then K3 against its plain version at that path's
    own shapes. Fills ``kernels`` with the f32 record and the launch counts
    of every row storage mode. Returns the bf16 pipeline."""
    import gc

    import torch

    from dalm_tpu_torch.kernels.topk import fused_dot_topk, fused_dot_topk_ref

    pipe, launches, (q, e, ms, plain_ms, lib_ms, turns) = serve_path(device, rng)
    Q, D = q.shape
    N = e.shape[0]
    ks, ki = fused_dot_topk(q, e, 4)
    rs, ri = fused_dot_topk_ref(q, e, 4)
    max_err, _ = compare_topk(ks, ki, rs, ri, q, e, None)
    nbytes = N * D * 4 + Q * D * 4 + Q * 4 * 8
    entry = k3_record("f32", f"main path Q={Q} N={N} D={D} k=4", ms, plain_ms, lib_ms, max_err,
                      nbytes, 2.0 * Q * N * D, peaks[0], peaks[1], **turns)
    print(f"[k3] main-path shape f32 Q={Q} N={N} D={D} k=4 (CUDA graph over {len(turns['ms_turns'])} turns): kernel "
          f"{ms:.4f} ms {turns['ms_turns']}, library {lib_ms:.4f} ms {turns['library_turns']}, through the wrapper "
          f"{turns['wrapper_ms']:.4f} ms, plain {plain_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
          f"({entry['bound_by']}, {entry['bound_ms'] / ms:.1%} of it)", flush=True)
    kernels["fused_dot_topk[f32]"] = dict(entry, launches=launches["f32"])
    kernels["_k3_launches"] = launches
    del q, e, ks, ki, rs, ri
    gc.collect()
    torch.cuda.empty_cache()
    return pipe


# The preset each of these phases cuts and the layers it keeps (bge-large has 24, Llama-2-7B 32, Qwen3-30B-A3B 48), so
# that the whole script stays within its time limit beside the later phases: a cut of depth, as the widths, shapes,
# kernels and metrics these phases check do not depend on it. eval-rag and eval-ar since a whole run of 1,195.1 s,
# eval-retriever and the CLI's eval since one of 1,106.2 s with the data-generation phases, serve-moe since one of
# 1,146.7 s with it whole and the CLI's processes already at once (PERF.md §4).
CUT_DEPTH = {"eval-rag": ("decoder", "llama2-7b", 16), "eval-ar": ("decoder", "llama2-7b", 8),
             "eval-retriever": ("encoder", "bge-large", 12), "cli": ("encoder", "bge-large", 12),
             "serve-moe": ("decoder", "qwen3-moe-30b", 24)}
EVAL_ROWS = 65536  # eval-retriever's f32 run: its rows are its queries, their unique passages its index
EVAL_Q_ROWS = 16384  # the int8 / int4 runs' and the CLI's rows
EVAL_DUPS = 64  # rows that repeat an earlier passage
RAG_ROWS = 64  # eval-rag
AR_ROWS = 4096  # eval-ar (a)


@contextlib.contextmanager
def cut_depth(phase):
    """``CUT_DEPTH[phase]``'s preset cut to its layers while the block runs, for every entry point that resolves it."""
    import dataclasses

    from dalm_tpu_torch.models import registry

    kind, name, layers = CUT_DEPTH[phase]
    presets = registry.ENCODER_PRESETS if kind == "encoder" else registry.DECODER_PRESETS
    make = presets[name]
    presets[name] = lambda: dataclasses.replace(make(), num_layers=layers)
    try:
        yield
    finally:
        presets[name] = make


def eval_columns(n, rng, dups=EVAL_DUPS):
    """Question / Abstract / Answer columns of ``n`` rows: ``n - dups`` unique synthetic passages (90 random
    lower-case characters and an id), each asked by a 40-character span of itself, then ``dups`` rows that repeat
    earlier passages, each asked by another span."""
    import numpy as np

    letters = np.array(list(string.ascii_lowercase + " "))
    u = n - dups
    chars = letters[rng.integers(0, len(letters), (u, 90))]
    passages = ["".join(row) + f" topic {i}" for i, row in enumerate(chars)]
    questions = [p[s:s + 40] for p, s in zip(passages, rng.integers(0, 50, u))]
    for j in rng.choice(u, dups, replace=False):
        passages.append(passages[j])
        questions.append(passages[j][50:90])
    return {"Question": questions, "Abstract": passages, "Answer": [f"answer {i}" for i in range(n)]}


class SearchLog:
    """While installed, ``DenseIndex.search`` keeps each call's index, queries (as passed), K3's (scores, ids) and
    host-clock seconds (synchronised before and after; it returns host arrays)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch

        from dalm_tpu_torch.index.dense import DenseIndex

        self._real = real = DenseIndex.search

        def search(index, queries, k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, i = real(index, queries, k)
            self.calls.append(dict(index=index, q=queries, k=k, s=s, i=i, t=time.perf_counter() - t0))
            return s, i

        DenseIndex.search = search
        return self

    def __exit__(self, *exc):
        from dalm_tpu_torch.index.dense import DenseIndex

        DenseIndex.search = self._real

    @property
    def seconds(self):
        return sum(c["t"] for c in self.calls)


class Timed:
    """While installed, ``module.name`` (a function) is timed on the host clock, synchronised; calls and seconds
    add up in ``n`` and ``seconds``."""

    def __init__(self, module, name):
        self.module, self.name, self.n, self.seconds = module, name, 0, 0.0

    def __enter__(self):
        import torch

        self._real = real = getattr(self.module, self.name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            self.n += 1
            self.seconds += time.perf_counter() - t0
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._real)


def hold_eval(label, log, gold, result, threshold=0.0):
    """Every search of an eval held against ``fused_dot_topk_ref`` on the same queries and rows (``compare_topk``:
    scores within NEAR_TIE, ids equal but at near ties), and the four metrics recomputed from both results: the
    kernel's must give the eval's ``EvalResults`` exactly; a query whose metrics differ between the two must be one
    whose top-k differs at a near tie; with no such query the plain result gives the eval's numbers too. Returns
    (max score error, queries with a near-tie id swap, queries whose metrics differ)."""
    import numpy as np
    import torch

    from dalm_tpu_torch.eval.common import aggregate_results, score_batch, threshold_hits
    from dalm_tpu_torch.kernels.topk import _dequantized_rows, fused_dot_topk_ref

    id_to_passage = dict(enumerate(dict.fromkeys(gold)))
    sums = {"kernel": ([], [], [], 0), "plain": ([], [], [], 0)}
    start, max_err, tie_queries, differing = 0, 0.0, 0, 0
    for c in log.calls:
        idx = c["index"]
        q = c["q"].to(device=idx.device, dtype=torch.bfloat16 if idx.scales is not None else idx.embeddings.dtype)
        rs, ri = fused_dot_topk_ref(q, idx.embeddings, c["k"], num_valid=idx.num_real, scales=idx.scales,
                                    int4=idx.int4)
        s, i = (torch.from_numpy(x).to(idx.device) for x in (c["s"], c["i"]))
        err, _ = compare_topk(s, i, rs, ri, q.float(), _dequantized_rows(idx.embeddings, idx.int4), idx.scales)
        max_err = max(max_err, err)
        ties = (i != ri).any(dim=1).cpu().numpy()
        g = gold[start:start + len(ties)]
        start += len(ties)
        per = {}
        for name, (sc, ids) in (("kernel", (c["s"], c["i"])), ("plain", (rs.cpu().numpy(), ri.cpu().numpy()))):
            p, r, h, _, rr = score_batch(threshold_hits(sc, ids, id_to_passage, threshold), g)
            ps, rs_, rrs, hs = sums[name]
            sums[name] = (ps + p, rs_ + r, rrs + rr, hs + h)
            per[name] = list(zip(p, r, rr))
        diff = np.array([a != b for a, b in zip(per["kernel"], per["plain"])])
        check(not (diff & ~ties).any(), f"{label}: metrics differ at a query whose top-k has no near tie")
        tie_queries += int(ties.sum())
        differing += int(diff.sum())
    check(start == len(gold), f"{label}: searched {start} queries of {len(gold)}")
    kernel_res = aggregate_results(len(gold), *sums["kernel"][:2], sums["kernel"][3], sums["kernel"][2])
    plain_res = aggregate_results(len(gold), *sums["plain"][:2], sums["plain"][3], sums["plain"][2])
    check(kernel_res == result, f"{label}: the eval's results {result} are not its searches' {kernel_res}")
    check(differing > 0 or plain_res == result, f"{label}: the plain top-k gives {plain_res}, the eval {result}")
    return max_err, tie_queries, differing


def k3_eval_record(mode, label, idx, q, k, peaks):
    """K3 timed at an eval's own shape: one search's queries against the eval's index, by CUDA events, beside its
    plain version and (float rows) ``torch.topk(q @ e.T)``."""
    import torch

    from dalm_tpu_torch.kernels.topk import fused_dot_topk, fused_dot_topk_ref

    q = q.to(device=idx.device, dtype=torch.bfloat16 if idx.scales is not None else idx.embeddings.dtype).contiguous()
    kw = dict(num_valid=idx.num_real, scales=idx.scales, int4=idx.int4)
    e = idx.embeddings
    ms = cuda_ms(lambda: fused_dot_topk(q, e, k, **kw), 20)
    plain_ms = cuda_ms(lambda: fused_dot_topk_ref(q, e, k, **kw), 5)
    lib_ms = cuda_ms(lambda: torch.topk(q @ e.T, k), 20) if idx.scales is None else None
    Q, D = q.shape  # the full width (int4 rows hold D / 2 bytes)
    N = e.shape[0]
    nbytes = e.numel() * e.element_size() + (4 * N if idx.scales is not None else 0) + q.numel() * q.element_size() \
        + Q * k * 8
    rec = k3_record(mode, f"{label} Q={Q} N={N} D={D} k={k}", ms, plain_ms, lib_ms, 0.0, nbytes, 2.0 * Q * N * D,
                    peaks[0], peaks[1] if e.dtype == torch.float32 else peaks[2])
    print(f"[{label}] K3 at this eval's shape ({rec['case']}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
          f"{rec['bound_ms'] / ms:.1%} of it)", flush=True)
    return rec


def _k3_zero():
    from dalm_tpu_torch.kernels.topk import fused_dot_topk

    fused_dot_topk.launches = dict.fromkeys(fused_dot_topk.launches, 0)


def _k3_counts():
    from dalm_tpu_torch.kernels.topk import fused_dot_topk

    return dict(fused_dot_topk.launches)


def eval_retriever_phase(device, peaks, smi, f32_rows=EVAL_ROWS):
    """``evaluate_retriever("bge-large", top_k=10, max_length=128, test_batch_size=256)`` (random from seed 0,
    bf16) over ``f32_rows`` synthetic rows into an f32 index, then with ``index_quantize="int8"`` and ``"int4"``
    over ``EVAL_Q_ROWS``. Every K3 search held against the plain version and the metrics recomputed
    (``hold_eval``); K3 timed at each run's shape. Returns ({mode: K3 launches}, {mode: its record}, numbers)."""
    import gc

    import numpy as np
    import torch

    from dalm_tpu_torch.eval import retriever as retriever_mod
    from dalm_tpu_torch.eval.retriever import evaluate_retriever

    launches, records, out = {}, {}, {}
    for mode, rows in (("f32", f32_rows), ("int8", EVAL_Q_ROWS), ("int4", EVAL_Q_ROWS)):
        cols = eval_columns(rows, np.random.default_rng(11))
        n_unique = len(dict.fromkeys(cols["Abstract"]))
        _k3_zero()
        with SearchLog() as log, Timed(retriever_mod, "embed_dataset") as embed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = evaluate_retriever(cols, "bge-large", top_k=10, max_length=128, test_batch_size=256, device=device,
                                     index_quantize=False if mode == "f32" else mode)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches[mode] = _k3_counts()
        check(launches[mode][mode] == len(log.calls) == -(-rows // 256) and sum(launches[mode].values()) == len(
            log.calls), f"eval-retriever {mode}: K3 launches {launches[mode]} for {len(log.calls)} searches")
        check(res.total_examples == rows and 0.0 <= res.hit_rate <= 1.0 and res.recall == res.hit_rate
              and all(np.isfinite([res.precision, res.mrr])), f"eval-retriever {mode}: {res}")
        max_err, ties, differing = hold_eval(f"eval-retriever {mode}", log, cols["Abstract"], res)
        records[mode] = k3_eval_record(mode, "eval-retriever", log.calls[0]["index"], log.calls[0]["q"], 10, peaks)
        out[mode] = dict(rows=rows, passages=n_unique, wall_s=wall, embed_s=embed.seconds,
                         passages_per_s=n_unique / embed.seconds, search_s=log.seconds, searches=len(log.calls),
                         results=json.loads(res.model_dump_json()), near_tie_queries=ties,
                         metric_differing_queries=differing, max_abs_err=max_err, launches=launches[mode])
        print(f"[eval-retriever] {mode} index, {rows} queries over {n_unique} unique passages (bge-large bf16, "
              f"top-10, max_length 128, batch 256; {smi}): wall {wall:.2f} s; passage embedding {embed.seconds:.2f} s "
              f"= {n_unique / embed.seconds:.0f} passages/s; {len(log.calls)} searches {log.seconds:.3f} s (host "
              f"clock, copies included); queries' embedding and metrics the rest; {res.model_dump_json()}; K3 vs "
              f"plain: max score err {max_err:.2e}, {ties} queries with a near-tie id swap, {differing} whose "
              f"metrics differ; K3 launches by mode {launches[mode]}", flush=True)
        del log, res, cols
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"eval_retriever": out}), flush=True)
    return launches, records, out


def eval_rag_phase(device, smi):
    """``evaluate_rag(cols, "bge-large", "llama2-7b")`` at the JAX package's defaults (bf16, max_length 128,
    query_batch_size 16, max_new_tokens 64, top-10) over ``RAG_ROWS`` rows. The answers are planted first: the
    same retrieval (the eval's own helpers, batch sizes and K3) gives each query's top-1 passage, the same
    generator (llama2-7b from seed 0) answers its prompt greedily in the same 16-prompt batches, and every second
    row's answer is set to that text; ``exact_match`` must then read 0.5, and the prompts the eval generates from
    must be those. main() runs it with llama2-7b cut to ``CUT_DEPTH["eval-rag"]``'s layers. Returns (K3
    launches, numbers)."""
    import gc

    import numpy as np
    import torch

    from dalm_tpu_torch.data.loading import ColumnDataset
    from dalm_tpu_torch.data.tokenizer import resolve_tokenizer
    from dalm_tpu_torch.eval import rag as rag_mod
    from dalm_tpu_torch.eval import retriever as retriever_mod
    from dalm_tpu_torch.eval.common import preprocess_eval_dataset
    from dalm_tpu_torch.models.generate import build_greedy_generate

    cols = eval_columns(RAG_ROWS, np.random.default_rng(12), dups=4)
    qbs, max_len, new = 16, 128, 64
    t0 = time.perf_counter()
    model, tok = retriever_mod.load_retriever_for_eval("bge-large", None, False, "bfloat16", "byte", device=device)
    processed = preprocess_eval_dataset(ColumnDataset(cols), tok, "Question", "Abstract", max_len)
    index, id_to_passage = retriever_mod.embed_and_index(model, processed, "Abstract", 8, None, False)
    top1 = []
    retriever_mod.search_and_score(model, processed, index, id_to_passage, "Abstract", 8, 10,
                                   on_batch=lambda start, end, top: top1.extend(top))
    prompts = [rag_mod.rag_prompt(q, p) for q, p in zip(cols["Question"], top1)]
    del model, index
    generator = rag_mod.load_generator_for_eval("llama2-7b", None, "bfloat16", device)
    g_tok = resolve_tokenizer("byte")
    g_tok.padding_side = "left"
    generate = build_greedy_generate(generator, new, eos_token_id=g_tok.eos_token_id, pad_token_id=g_tok.pad_token_id)
    planted, want_ids = [], []
    for s in range(0, RAG_ROWS, qbs):
        batch = prompts[s:s + qbs]
        real = len(batch)
        batch += [batch[-1]] * (qbs - real)
        t = g_tok(batch, padding="max_length", max_length=max_len, truncation=True)
        want_ids.append(np.asarray(t["input_ids"]))
        out = generate(torch.as_tensor(t["input_ids"], device=device), torch.as_tensor(t["attention_mask"],
                                                                                          device=device)).cpu().numpy()
        planted += [(batch[r] + g_tok.decode(out[r])).split("#answer#")[1].strip() for r in range(real)]
    del generator, generate
    gc.collect()
    torch.cuda.empty_cache()
    plant_s = time.perf_counter() - t0
    cols["Answer"] = [a if r % 2 == 0 else f"not {a}" for r, a in enumerate(planted)]

    seen_ids, gen_t = [], {"s": 0.0, "tokens": 0}
    real_build = rag_mod.build_greedy_generate

    def recording_build(*a, **kw):
        fn = real_build(*a, **kw)

        def gen(ids, mask):
            seen_ids.append(ids.cpu().numpy())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(ids, mask)
            torch.cuda.synchronize()
            gen_t["s"] += time.perf_counter() - t1
            gen_t["tokens"] += out.numel()
            return out

        return gen

    _k3_zero()
    rag_mod.build_greedy_generate = recording_build
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rag_mod.evaluate_rag(cols, "bge-large", "llama2-7b", device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        rag_mod.build_greedy_generate = real_build
    launches = _k3_counts()
    check(len(seen_ids) == len(want_ids) and all(np.array_equal(a, b) for a, b in zip(seen_ids, want_ids)),
          "eval-rag: the eval's prompts are not those built from K3's top-1 ids")
    check(res.exact_match == 0.5, f"eval-rag: exact_match {res.exact_match}, planted 0.5")
    check(res.total_examples == RAG_ROWS and launches["f32"] == -(-RAG_ROWS // 8), f"eval-rag: {res}, K3 {launches}")
    out = dict(wall_s=wall, generate_s=gen_t["s"], tokens_per_s=gen_t["tokens"] / gen_t["s"], plant_s=plant_s,
               results=json.loads(res.model_dump_json()), launches=launches)
    print(f"[eval-rag] evaluate_rag(bge-large, llama2-7b, bf16, {RAG_ROWS} queries over "
          f"{len(dict.fromkeys(cols['Abstract']))} passages, batches of {qbs}, {new} new tokens; {smi}): wall "
          f"{wall:.2f} s, generation {gen_t['s']:.2f} s = {gen_t['tokens'] / gen_t['s']:.1f} tokens/s "
          f"({len(seen_ids)} batches); {res.model_dump_json()} (exact match planted at 0.5; planting took "
          f"{plant_s:.1f} s); the prompts are those from K3's top-1 ids; K3 launches {launches}", flush=True)
    print(json.dumps({"eval_rag": out}), flush=True)
    return launches, out


def _tower_counts(tower_of):
    """Wrap the int8 autograd functions so that every launch counted inside their forward (the calibration pass
    and remat's recompute included) and backward is added to the tower that owns the weight (``tower_of(weight
    data_ptr)``). Returns (per-tower counts, restore)."""
    from dalm_tpu_torch.kernels import int8_matmul as im

    counters = _train_counters()
    per, depth = {}, [0]
    saved = [(fn, fn.forward, fn.backward) for fn in (im._Int8Matmul, im._Int8MatmulCal)]

    def counted(tower, call):
        # A backward that unpacks a checkpointed layer's saved tensors recomputes that layer's forwards inside it:
        # the outermost call counts them (a layer's sites are all of one tower).
        if depth[0]:
            return call()
        depth[0] += 1
        before = {k: read() for k, read in counters.items()}
        try:
            out = call()
        finally:
            depth[0] -= 1
        d = per.setdefault(tower, dict.fromkeys(counters, 0))
        for k, read in counters.items():
            d[k] += read() - before[k]
        return out

    for fn, fwd, bwd in saved:
        def forward(ctx, x, q, *rest, fwd=fwd):
            ctx.tower = tower_of(q.data_ptr())  # tagged in the forward: saved tensors unpack once under remat
            return counted(ctx.tower, lambda: fwd(ctx, x, q, *rest))

        def backward(ctx, dy, bwd=bwd):
            return counted(ctx.tower, lambda: bwd(ctx, dy))

        fn.forward, fn.backward = staticmethod(forward), staticmethod(backward)

    def restore():
        for fn, fwd, bwd in saved:
            fn.forward, fn.backward = staticmethod(fwd), staticmethod(bwd)

    return per, restore


def eval_ar_phase(device, workdir, peaks, smi):
    """The autoregressive (EOS-pooled) retriever at Llama-2-7B width, bf16, random from seed 0:
    (a) ``evaluate_retriever("llama2-7b", is_autoregressive=True)`` over ``AR_ROWS`` rows, batch 64: K3 on f32 rows
    at D 4096, held against the plain version and timed at its shape;
    (b) ``train_retriever("llama2-7b", csv, is_autoregressive=True, use_peft=True, use_bnb=True)``, batch 32, Q/P
    50/128, 2 epochs = 4 steps (the merge runtime: no hand-written kernel);
    (c) ``train_e2e(csv, "llama2-7b", "llama2-7b", retriever_is_autoregressive=True, use_peft="both",
    use_bnb="both", lora_runtime="fused", int8_compute="all")``, batch 18, Q/P/G 50/128/256, 2 epochs = 4 steps,
    K1 / the calibrated route's launches split by tower;
    (d) ``RagPipeline.from_pretrained("llama2-7b", "llama2-7b", 4,096 passages, retriever_is_autoregressive=True,
    quantize_generator="int4")``: one ``answer()`` of 32 queries, its retrieval held against the plain top-k.
    main() runs it with llama2-7b cut to ``CUT_DEPTH["eval-ar"]``'s layers (its width, 4096, is what K3 at
    D 4096 and the towers' routes check). Returns ({phase part: launches}, K3's record at D 4096, numbers)."""
    import gc

    import numpy as np
    import torch

    from dalm_tpu_torch.eval.retriever import evaluate_retriever
    from dalm_tpu_torch.kernels.topk import fused_dot_topk_ref
    from dalm_tpu_torch.serve import RagPipeline
    from dalm_tpu_torch.train import train_e2e, train_retriever

    launches, out = {}, {}
    # (a)
    cols = eval_columns(AR_ROWS, np.random.default_rng(13))
    _k3_zero()
    with SearchLog() as log:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate_retriever(cols, "llama2-7b", is_autoregressive=True, top_k=10, max_length=128,
                                 test_batch_size=64, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches["eval"] = _k3_counts()
    idx = log.calls[0]["index"]
    check(idx.embeddings.shape[1] == 4096 and launches["eval"]["f32"] == len(log.calls) == AR_ROWS // 64,
          f"eval-ar (a): index {tuple(idx.embeddings.shape)}, K3 {launches['eval']}")
    max_err, ties, differing = hold_eval("eval-ar (a)", log, cols["Abstract"], res)
    record = k3_eval_record("f32", "eval-ar", idx, log.calls[0]["q"], 10, peaks)
    out["eval"] = dict(wall_s=wall, search_s=log.seconds, results=json.loads(res.model_dump_json()),
                       near_tie_queries=ties, metric_differing_queries=differing, max_abs_err=max_err)
    print(f"[eval-ar] (a) evaluate_retriever(llama2-7b, is_autoregressive=True, bf16, EOS-pooled, {AR_ROWS} queries "
          f"over {idx.num_real} passages, batch 64; {smi}): wall {wall:.2f} s = {2 * AR_ROWS / wall:.0f} texts/s "
          f"embedded; {res.model_dump_json()}; K3 on f32 rows at D 4096 vs plain: max score err {max_err:.2e}, "
          f"{ties} queries with a near-tie swap, {differing} whose metrics differ; K3 launches {launches['eval']}",
          flush=True)
    del log, idx, res
    gc.collect()
    torch.cuda.empty_cache()

    # (b)
    csv_path = str(Path(workdir) / "ar_retr.csv")
    write_csv(csv_path, 64, np.random.default_rng(14))
    _zero_train_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = train_retriever("llama2-7b", csv_path, is_autoregressive=True, use_peft=True, use_bnb=True,
                        per_device_train_batch_size=32, num_train_epochs=2, tokenizer="byte@32000", dtype="bfloat16",
                        device=device, with_tracking=False, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = {k: read() for k, read in _train_counters().items()}
    check(np.isfinite(r["final_loss"]) and r["steps"] == 4, f"eval-ar (b): {r}")
    check(not any(counts.values()), f"eval-ar (b): the merge runtime launched int8 kernels {counts}")
    out["train_retriever"] = dict(wall_s=wall, step_s=r["avg_step_time"], peak_gib=peak, final_loss=r["final_loss"])
    print(f"[eval-ar] (b) train_retriever(llama2-7b, is_autoregressive=True, LoRA q/v on an int8 base, merge runtime, "
          f"batch 32, Q/P 50/128, bf16): {r['steps']} steps in {wall:.1f} s (init included); step time "
          f"{r['avg_step_time']:.3f} s (second epoch); final loss {r['final_loss']:.4f}; peak {peak:.2f} GiB; int8 "
          f"kernels launched: none (the merge runtime dequantises)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (c)
    csv_path = str(Path(workdir) / "ar_e2e.csv")
    write_csv(csv_path, TRAIN_BATCH * 2, np.random.default_rng(15))
    held = {}

    def hook(setup):
        held["sites"] = {m.q.data_ptr(): sub for sub in ("retriever", "generator")
                         for m in getattr(setup.rag, sub).modules() if getattr(m, "q", None) is not None}
        check(setup.quantized_subs == {"retriever", "generator"}, "eval-ar (c): both towers are int8")

    per, restore = _tower_counts(lambda ptr: held["sites"][ptr])
    _zero_train_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        e = train_e2e(csv_path, "llama2-7b", "llama2-7b", retriever_is_autoregressive=True, use_peft="both",
                      use_bnb="both", lora_runtime="fused", int8_compute="all", per_device_train_batch_size=TRAIN_BATCH,
                      num_train_epochs=2, query_max_len=50, passage_max_len=128, generator_max_len=256,
                      dtype="bfloat16", retriever_tokenizer="byte@32000", generator_tokenizer="byte@32000",
                      num_warmup_steps=0, with_tracking=False, seed=0, device=device, setup_hook=hook)
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches["train_e2e"] = {k: read() for k, read in _train_counters().items()}
    held.clear()
    for key in ("final_loss", "final_retriever_loss", "final_generator_loss"):
        check(np.isfinite(e[key]), f"eval-ar (c): {key} is not finite")
    check(e["steps"] == 4, f"eval-ar (c): {e}")
    for tower in ("retriever", "generator"):
        t = per.get(tower, {})
        check(t.get("w8a8_fused", 0) + t.get("k1_cal_quant", 0) > 0, f"eval-ar (c): no K1 / calibrated launch in the "
                                                                      f"{tower}: {t}")
    total = {k: sum(p.get(k, 0) for p in per.values()) for k in launches["train_e2e"]}
    check(total == launches["train_e2e"], f"eval-ar (c): the towers' counts {per} do not add to {launches['train_e2e']}")
    out["train_e2e"] = dict(wall_s=wall, step_s=e["avg_step_time"], samples_per_s=e["samples_per_sec"],
                            peak_gib=peak, final_retriever_loss=e["final_retriever_loss"], by_tower=per)
    print(f"[eval-ar] (c) train_e2e(llama2-7b retriever EOS-pooled + llama2-7b generator, fused QLoRA, int8 bases on "
          f"both, int8_compute=all, a8_calibrate_every 16, batch {TRAIN_BATCH}, Q/P/G 50/128/256, bf16; {smi}): "
          f"{e['steps']} steps in {wall:.1f} s (init included); step time {e['avg_step_time']:.3f} s = "
          f"{e['samples_per_sec']:.2f} samples/s (second epoch); losses total/retriever/generator "
          f"{e['final_loss']:.4f}/{e['final_retriever_loss']:.4f}/{e['final_generator_loss']:.4f}; peak {peak:.2f} "
          f"GiB; int8 launches by tower {per}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (d)
    passages = corpus(4096, np.random.default_rng(16))
    queries = [f"what about topic {i}" for i in range(0, 4096, 128)]  # 32 queries
    t0 = time.perf_counter()
    pipe = RagPipeline.from_pretrained("llama2-7b", "llama2-7b", passages, retriever_is_autoregressive=True,
                                       quantize_generator="int4", dtype="bfloat16", device=device, max_passage_len=128,
                                       max_prompt_len=256, max_new_tokens=64, embed_batch=64)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(pipe.index.embeddings.shape == (4096, 4096), f"eval-ar (d): index {tuple(pipe.index.embeddings.shape)}")
    pipe.answer(queries[:2], top_k=4)  # warm
    zero_serving_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    answers = pipe.answer(queries, top_k=4)
    torch.cuda.synchronize()
    answer_s = time.perf_counter() - t0
    launches["pipeline"] = serving_counts()
    check(launches["pipeline"]["fused_dot_topk[f32]"] == 1 and launches["pipeline"]["int4_matmul[base]"] > 0,
          f"eval-ar (d): launches {launches['pipeline']}")
    q_embs = pipe._embed_texts([f"#query# {q}" for q in queries], pipe.max_passage_len)
    scores, ids = pipe.index.search(q_embs, 4)
    rs, ri = fused_dot_topk_ref(q_embs, pipe.index.embeddings, 4)
    _, swaps = compare_topk(torch.from_numpy(scores).to(device), torch.from_numpy(ids).to(device), rs, ri, q_embs,
                            pipe.index.embeddings, None)
    check([a.passages for a in answers] == [[passages[int(j)] for j in row] for row in ids],
          "eval-ar (d): answer() passages differ from a separate retrieve")
    check(all(np.all(np.isfinite(a.scores)) for a in answers), "eval-ar (d): a non-finite retrieval score")
    out["pipeline"] = dict(build_s=build_s, answer_s=answer_s, near_tie_swaps=swaps)
    print(f"[eval-ar] (d) RagPipeline.from_pretrained(llama2-7b EOS-pooled retriever, llama2-7b int4, 4096 passages): "
          f"built in {build_s:.2f} s; answer() of {len(queries)} queries {answer_s:.3f} s; retrieval vs the plain "
          f"top-k: {swaps} near-tie swaps; launches {launches['pipeline']}", flush=True)
    del pipe, answers, q_embs
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"eval_ar": out}), flush=True)
    return launches, record, out


def cli_phase(device, workdir, smi):
    """``python3 -m dalm_tpu_torch.cli`` in subprocesses on the card: ``version``; ``--help`` of the program and of
    every command (one process, the module run as ``__main__`` for each); ``eval-retriever <csv> bge-large --top-k
    10 --test-batch-size 256`` over ``EVAL_Q_ROWS`` rows, the module run as ``__main__`` in a process that then
    writes K3's launch counts to its stderr as JSON. That count must be one launch a query batch, on f32 rows; the
    last stdout line must parse as ``EvalResults`` and equal the in-process ``evaluate_retriever`` on the same file.
    Then ``qa-gen <csv> --device cuda`` at tiny: its two CSVs equal, byte for byte, to the in-process
    ``generate_qa_from_disk`` on the same seeded file. The four processes run at once (each spends most of its time
    starting), beside the in-process calls. main() runs it under ``cut_depth("cli")``, and the CLI's eval-retriever
    process cuts bge-large the same way. Returns (K3 launches in the CLI's process, numbers)."""
    import csv
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from dalm_tpu_torch.data.qa_gen import generate_qa_from_disk
    from dalm_tpu_torch.eval.results import EvalResults
    from dalm_tpu_torch.eval.retriever import evaluate_retriever

    root = Path(__file__).resolve().parent
    cols = eval_columns(EVAL_Q_ROWS, np.random.default_rng(17))
    path = str(Path(workdir) / "cli_eval.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(cols))
        w.writerows(zip(*cols.values()))

    def run(args, timeout):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, *args], cwd=str(root), capture_output=True, text=True, timeout=timeout)
        check(p.returncode == 0, f"cli: {args[:4]} exited {p.returncode}: {p.stderr[-2000:]}")
        return p.stdout, p.stderr, time.perf_counter() - t0

    def as_main(argv, after=""):
        """Code that runs the CLI as ``python3 -m dalm_tpu_torch.cli`` would with ``argv``, then ``after``."""
        return ("import json, runpy, sys\n"
                f"sys.argv = ['dalm-torch'] + {list(argv)!r}\n"
                "try:\n"
                "    runpy.run_module('dalm_tpu_torch.cli', run_name='__main__', alter_sys=True)\n"
                "except SystemExit as e:\n"
                "    assert e.code in (0, None), (sys.argv, e.code)\n" + after)

    commands = ("version", "train-rag-e2e", "train-retriever-only", "train-generator", "qa-gen", "eval-retriever",
                "eval-rag", "serve")
    code = "".join(as_main(argv) for argv in [["--help"]] + [[c, "--help"] for c in commands])
    counted = ("from dalm_tpu_torch.kernels.topk import fused_dot_topk\n"
               "print('K3 ' + json.dumps(fused_dot_topk.launches), file=sys.stderr)\n")
    _, name, layers = CUT_DEPTH["cli"]  # the cut main() applies here, applied in the CLI's process too
    cut = ("import dataclasses\nfrom dalm_tpu_torch.models import registry\n"
           f"_make = registry.ENCODER_PRESETS[{name!r}]\n"
           f"registry.ENCODER_PRESETS[{name!r}] = lambda: dataclasses.replace(_make(), num_layers={layers})\n")
    qa_path = qa_csv(Path(workdir) / "cli_qa.csv", np.random.default_rng(29))
    with ThreadPoolExecutor(4) as pool:
        version = pool.submit(run, ["-m", "dalm_tpu_torch.cli", "version"], 120)
        helps = pool.submit(run, ["-c", code], 120)
        evals = pool.submit(run, ["-c", cut + as_main(["eval-retriever", path, "bge-large", "--top-k", "10",
                                                        "--test-batch-size", "256"], counted)], 600)
        # qa-gen at tiny (random init from seed 0 on the card, in the CLI's process as in this one)
        qa = pool.submit(run, ["-m", "dalm_tpu_torch.cli", "qa-gen", qa_path, "--sample-size", "16", "--batch-size",
                               "8", "--output-dir", str(Path(workdir) / "cli_qa"), "--device", "cuda"], 300)
        want = evaluate_retriever(path, "bge-large", top_k=10, test_batch_size=256, device=device)
        generate_qa_from_disk(qa_path, "Abstract", "Title", 16, 8, str(Path(workdir) / "cli_qa_call"), True,
                              model_spec="tiny", device=device)
        torch.cuda.synchronize()
        (stdout, _, version_s), (helped, _, help_s) = version.result(), helps.result()
        (evaled, stderr, eval_s), (qa_out, _, qa_s) = evals.result(), qa.result()
    check("version: 0.1.0" in stdout, f"cli: version printed {stdout!r}")
    for c in commands:
        check(f"usage: dalm-torch {c}" in helped, f"cli: no --help for {c}")
    line = evaled.strip().splitlines()[-1]
    got = EvalResults(**json.loads(line))
    launches = json.loads([x for x in stderr.splitlines() if x.startswith("K3 ")][-1][3:])
    batches = -(-EVAL_Q_ROWS // 256)
    check(launches["f32"] == sum(launches.values()) == batches,
          f"cli: the CLI's process launched K3 {launches}, not once on f32 rows for each of {batches} query batches")
    check(got == want and line == want.model_dump_json(), f"cli: eval-retriever printed {line}, in process {want}")
    check(qa_out.strip().splitlines()[-1] == "qa-gen done", f"cli: qa-gen printed {qa_out[-500:]!r}")
    for split in ("train", "test"):
        name = f"question_answer_pairs_{split}.csv"
        check((Path(workdir) / "cli_qa" / name).read_bytes() == (Path(workdir) / "cli_qa_call" / name).read_bytes(),
              f"cli: qa-gen's {name} differs from the in-process generate_qa_from_disk's")
    out = dict(version_s=version_s, help_s=help_s, eval_s=eval_s, results=json.loads(line), launches=launches,
               qa_gen_s=qa_s)
    print(f"[cli] python3 -m dalm_tpu_torch.cli ({smi}): version {version_s:.2f} s; --help of the program and its "
          f"{len(commands)} commands {help_s:.2f} s; eval-retriever over {EVAL_Q_ROWS} rows {eval_s:.2f} s (process "
          f"start included), K3 launches in its process {launches}; last line {line} = the in-process "
          f"evaluate_retriever on the same file; qa-gen --device cuda at tiny over {QA_ROWS} passages {qa_s:.2f} s, "
          f"its two CSVs equal to the in-process generate_qa_from_disk's; the four processes at once, beside the "
          f"in-process calls", flush=True)
    print(json.dumps({"cli": out}), flush=True)
    return launches, out


# --------------------------------------------------------------------------
# The dense families: K4 at head dim 256, families-small, serve-llama31, sft-gemma2
# --------------------------------------------------------------------------

# K4 at head dim 256 by its entry in the kernels line: C entry point, counter, source, the TPU kernel it replaces.
# bf16 at D 256 takes the wgmma route (csrc/flash_fwd_wgmma.cu, csrc/flash_bwd_wgmma.cu); the mma.sync instances of
# csrc/flash_attention.cu stay reachable through their entry points and are timed in turns with it.
K4_D256 = {"k4_fwd_d256_wgmma": ("dalm_fa_fwd_wgmma", "fwd", "dalm_tpu_torch/csrc/flash_fwd_wgmma.cu",
                                 "dalm_tpu/kernels/flash_attention.py:221"),
           "k4_bwd_dq_d256_wgmma": ("dalm_fa_bwd_dq_wgmma", "dq", "dalm_tpu_torch/csrc/flash_bwd_wgmma.cu",
                                    "dalm_tpu/kernels/flash_attention.py:443"),
           "k4_bwd_dkv_d256_wgmma": ("dalm_fa_bwd_dkv_wgmma", "dkv", "dalm_tpu_torch/csrc/flash_bwd_wgmma.cu",
                                     "dalm_tpu/kernels/flash_attention.py:461"),
           "k4_fwd_d256": ("dalm_fa_fwd", "fwd", "dalm_tpu_torch/csrc/flash_attention.cu",
                           "dalm_tpu/kernels/flash_attention.py:221"),
           "k4_bwd_dq_d256": ("dalm_fa_bwd_dq", "dq", "dalm_tpu_torch/csrc/flash_attention.cu",
                              "dalm_tpu/kernels/flash_attention.py:443"),
           "k4_bwd_dkv_d256": ("dalm_fa_bwd_dkv", "dkv", "dalm_tpu_torch/csrc/flash_attention.cu",
                               "dalm_tpu/kernels/flash_attention.py:461")}
K4_D256_PAIRS = (("k4_fwd_d256_wgmma", "k4_fwd_d256"), ("k4_bwd_dq_d256_wgmma", "k4_bwd_dq_d256"),
                 ("k4_bwd_dkv_d256_wgmma", "k4_bwd_dkv_d256"))
# sft-gemma2's attention: Gemma2-2B's 8 query / 4 kv heads of 256, its context of 8192 tokens, the window 4096 of the
# even layers (odd layers attend globally), softcap 50, query scale 1 / sqrt(256)
GEMMA2_ATTN = dict(B=1, H=8, Hk=4, S=8192, D=256, window=4096, softcap=50.0, scale=1.0 / 16)
# Gemma-2B's attention at the same length: 8 query heads over 1 kv head of 256, no softcap, no window, scale
# 1 / sqrt(256): the function SDPA computes too, so the library column compares like with like
GEMMA_2B_ATTN = dict(B=1, H=8, Hk=1, S=8192, D=256, window=None, softcap=None, scale=1.0 / 16)


def visible_share(Sq, Sk, q_offset, causal, window):
    """The share of the (Sq, Sk) scores a causal / windowed mask keeps (what the kernels must compute)."""
    kept = 0
    for i in range(Sq):
        hi = min(q_offset + i + 1, Sk) if causal else Sk
        lo = max(0, q_offset + i - window + 1) if window else 0
        kept += max(hi - lo, 0)
    return kept / float(Sq * Sk)


def k4_d256_layer(gen, device, peaks, c, window, softcap, label, iters):
    """One D-256 shape, bf16, causal, one segment: the wgmma route's forward, dq and dk/dv (through the wrappers)
    and the mma.sync instances (through their C entry points, on outputs of their own) each held against the plain
    version; then each wgmma kernel timed in turns with its mma.sync instance on the same operands (wgmma,
    mma.sync, mma.sync, wgmma), the plain versions once, SDPA's forward and backward (its backward alone, graph
    built outside the timing) at the same shape without softcap and window, and the bound from this shape's work.
    Returns (ms by name, turns by name, max error by name, plain fwd / bwd ms, SDPA fwd / bwd ms, bound by name,
    visible share)."""
    import torch
    import torch.nn.functional as F

    from dalm_tpu_torch.kernels import flash_attention as fa

    B, H, Hk, S, D = c["B"], c["H"], c["Hk"], c["S"], c["D"]
    q, k, v, do, _, _ = k4_inputs(gen, device, torch.bfloat16, B, H, Hk, S, S, D, None)
    seg = torch.ones((B, S), dtype=torch.int32, device=device)
    kw = dict(causal=True, scale=c["scale"], window=window, softcap=softcap)
    check(fa.fwd_route(q.dtype, D) == "wgmma", "k4 d256: bf16 at head dim 256 must take the wgmma route")
    dims = fa._check("time", q, k, v, seg, seg, window, softcap)
    tol = K4_TOL["bfloat16"]
    routes = (dict(fa.flash_fwd.routes), dict(fa.flash_bwd.routes))
    out, lse = fa.flash_fwd(q, k, v, seg, seg, **kw)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, seg, seg, **kw)
    check(fa.flash_fwd.routes["wgmma"] == routes[0]["wgmma"] + 1
          and fa.flash_bwd.routes["wgmma"] == routes[1]["wgmma"] + 1,
          f"k4 d256 {label}: the wrappers did not take the wgmma route")
    mma_out, mma_lse, dsum = torch.empty_like(out), torch.empty_like(lse), torch.empty_like(lse)
    mq, mk, mv = torch.empty_like(dq), torch.empty_like(dk), torch.empty_like(dv)

    def block(**tensors):
        return fa._args(q, k, v, seg, seg, True, c["scale"], 0, window, softcap, dims, **tensors)

    # argument blocks by (direction, route); both backward routes read the wgmma forward's out and lse and one dsum
    blk = {("fwd", "wgmma"): block(out=out, lse=lse), ("fwd", "mma"): block(out=mma_out, lse=mma_lse),
           ("bwd", "wgmma"): block(out=out, lse=lse, dout=do, dsum=dsum, dq=dq, dk=dk, dv=dv),
           ("bwd", "mma"): block(out=out, lse=lse, dout=do, dsum=dsum, dq=mq, dk=mk, dv=mv)}
    fa._launch("dalm_fa_fwd", "fwd", blk["fwd", "mma"], q)
    fa._launch("dalm_fa_dsum", "dsum", blk["bwd", "mma"], q)
    fa._launch("dalm_fa_bwd_dq", "dq", blk["bwd", "mma"], q)
    fa._launch("dalm_fa_bwd_dkv", "dkv", blk["bwd", "mma"], q)
    ro, rl = fa.flash_fwd_ref(q, k, v, seg, seg, **kw)
    torch.cuda.synchronize()
    errs = {"k4_fwd_d256_wgmma": max(k4_err(out, ro, tol["out"], f"d256 {label} out"),
                                     k4_err(lse, rl, tol["lse"], f"d256 {label} lse")),
            "k4_fwd_d256": max(k4_err(mma_out, ro, tol["out"], f"d256 {label} mma.sync out"),
                               k4_err(mma_lse, rl, tol["lse"], f"d256 {label} mma.sync lse"))}
    del ro, rl, mma_out, mma_lse
    rq, rk, rv = fa.flash_bwd_ref(q, k, v, out, lse, do, seg, seg, **kw)
    errs["k4_bwd_dq_d256_wgmma"] = k4_err(dq, rq, tol["grad"], f"d256 {label} dq")
    errs["k4_bwd_dkv_d256_wgmma"] = max(k4_err(dk, rk, tol["grad"], f"d256 {label} dk"),
                                        k4_err(dv, rv, tol["grad"], f"d256 {label} dv"))
    errs["k4_bwd_dq_d256"] = k4_err(mq, rq, tol["grad"], f"d256 {label} mma.sync dq")
    errs["k4_bwd_dkv_d256"] = max(k4_err(mk, rk, tol["grad"], f"d256 {label} mma.sync dk"),
                                  k4_err(mv, rv, tol["grad"], f"d256 {label} mma.sync dv"))
    del rq, rk, rv
    turns = {}
    for pair in K4_D256_PAIRS:
        for name in (pair[0], pair[1], pair[1], pair[0]):
            entry, counter = K4_D256[name][:2]
            a = blk["fwd" if counter == "fwd" else "bwd", "wgmma" if name.endswith("_wgmma") else "mma"]
            turns.setdefault(name, []).append(cuda_ms(lambda: fa._launch(entry, counter, a, q), iters))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    plain_f = cuda_ms(lambda: fa.flash_fwd_ref(q, k, v, seg, seg, **kw), 1)
    plain_b = cuda_ms(lambda: fa.flash_bwd_ref(q, k, v, out, lse, do, seg, seg, **kw), 1)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa = dict(is_causal=True, scale=c["scale"], enable_gqa=True)
    lib_f = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, **sdpa), iters)
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, **sdpa)
    lib_b = cuda_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True), iters)
    del lib_out, ql, kl, vl
    vis = visible_share(S, S, 0, True, window)
    prod = 2.0 * B * H * S * S * D * vis
    qb, kb, stat = B * H * S * D * 2, B * Hk * S * D * 2, B * H * S * 4
    work = {"fwd": (2 * prod, 2 * qb + 2 * kb + stat), "dq": (3 * prod, 3 * qb + 2 * kb + 2 * stat),
            "dkv": (4 * prod, 2 * qb + 4 * kb + 2 * stat)}
    bound = {}
    for name, (_, counter, _, _) in K4_D256.items():
        ops, nbytes = work[counter]
        t_ops, t_bytes = ops / peaks[2] * 1e3, nbytes / peaks[0] * 1e3
        bound[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", ops)
    del q, k, v, do, out, lse, dq, dk, dv, mq, mk, mv, dsum
    torch.cuda.empty_cache()
    return ms, turns, errs, (plain_f, plain_b), (lib_f, lib_b), bound, vis


def k4_d256_time(gen, device, peaks, iters=5):
    """K4 at head dim 256, bf16: the wgmma route's forward, dq and dk/dv and the kept mma.sync instances, at
    sft-gemma2's odd (global) and even (window 4096) layers, at the odd layer without its softcap (what the
    softcap costs), and at Gemma-2B's attention (no softcap: the function SDPA computes), each layer by
    ``k4_d256_layer``. Returns the records of the kernels line (at the odd layer,
    with the even layer's and the like-for-like shape's numbers beside)."""
    import torch

    c = GEMMA2_ATTN
    B, H, Hk, S, D = c["B"], c["H"], c["Hk"], c["S"], c["D"]
    layers = {"odd": k4_d256_layer(gen, device, peaks, c, None, c["softcap"], "sft-gemma2 odd (global)", iters),
              "even": k4_d256_layer(gen, device, peaks, c, c["window"], c["softcap"], "sft-gemma2 even (window 4096)",
                                    iters),
              "gemma": k4_d256_layer(gen, device, peaks, GEMMA_2B_ATTN, None, None, "Gemma-2B H 8 / Hk 1, no softcap",
                                     iters),
              # the odd layer with the softcap removed: what the softcap's tanh costs each kernel, measured
              "nocap": k4_d256_layer(gen, device, peaks, c, None, None, "sft-gemma2 odd without softcap", iters)}
    ms, turns, errs, plain, lib, bound, vis = layers["odd"]
    g = GEMMA_2B_ATTN
    entries = {}
    for name, (_, counter, source, replaces) in K4_D256.items():
        fwd = counter == "fwd"
        lw, ll = layers["even"], layers["gemma"]
        entries[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "case": f"sft-gemma2 odd layer B={B} H={H} Hk={Hk} S={S} D={D} bf16 causal softcap 50 scale 1/16",
            "max_abs_err": max(layers[r][2][name] for r in layers), "ms": ms[name], "turns_ms": turns[name],
            "plain_ms": plain[0] if fwd else plain[1], "bound_ms": bound[name][0], "bound_by": bound[name][1],
            "library_ms": None,
            "library_is": "none at this shape: SDPA takes no softcap (see like_for_like)",
            "tflops": bound[name][2] / ms[name] / 1e9,
            "ms_even_layer_window_4096": lw[0][name], "bound_ms_even_layer": lw[5][name][0],
            "sdpa_no_softcap_ms": lib[0] if fwd else lib[1],
            "ms_odd_layer_without_softcap": layers["nocap"][0][name],
            "like_for_like": {
                "case": f"Gemma-2B attention B={g['B']} H={g['H']} Hk={g['Hk']} S={g['S']} D={g['D']} bf16 causal, "
                        f"no softcap, scale 1/16",
                "ms": ll[0][name], "bound_ms": ll[5][name][0], "library_ms": ll[4][0] if fwd else ll[4][1],
                "library_is": "SDPA forward" if fwd else "SDPA backward: dq, dk and dv in one call"},
        }
    for name, e in entries.items():
        lf = e["like_for_like"]
        print(f"[k4] D 256, {name}: sft-gemma2 odd layer {e['ms']:.4f} ms (turns "
              f"{', '.join(f'{t:.4f}' for t in e['turns_ms'])}; {e['tflops']:.1f} TFLOP/s; bound {e['bound_ms']:.4f} ms, "
              f"{e['bound_by']}: {e['bound_ms'] / e['ms']:.1%} of it), even layer (window 4096, "
              f"{layers['even'][6]:.3f} of the scores visible against {vis:.3f}) {e['ms_even_layer_window_4096']:.4f} ms "
              f"(bound {e['bound_ms_even_layer']:.4f}); Gemma-2B no softcap {lf['ms']:.4f} ms (bound "
              f"{lf['bound_ms']:.4f}, {lf['library_is']} {lf['library_ms']:.4f}); the odd layer without softcap "
              f"{e['ms_odd_layer_without_softcap']:.4f} ms; plain {e['plain_ms']:.2f} ms; max error "
              f"{e['max_abs_err']:.3g}", flush=True)
    for label, (ms_l, _, _, _, (lf, lb), _, _) in (("sft-gemma2 odd layer (SDPA without softcap)", layers["odd"]),
                                                  ("sft-gemma2 even layer (SDPA without softcap or window)",
                                                   layers["even"]),
                                                  ("Gemma-2B, like for like", layers["gemma"])):
        for route, (f, dq, dkv) in (("wgmma", ("k4_fwd_d256_wgmma", "k4_bwd_dq_d256_wgmma", "k4_bwd_dkv_d256_wgmma")),
                                    ("mma.sync", ("k4_fwd_d256", "k4_bwd_dq_d256", "k4_bwd_dkv_d256"))):
            bwd = ms_l[dq] + ms_l[dkv]
            print(f"[k4] D 256, {label}, {route} route: forward {ms_l[f]:.4f} ms = {ms_l[f] / lf:.2f}x SDPA's "
                  f"{lf:.4f}; dq + dk/dv {bwd:.4f} ms = {bwd / lb:.2f}x SDPA's backward {lb:.4f} (dsum apart)",
                  flush=True)
    torch.cuda.empty_cache()
    return entries


FAMILY_PRESETS = ("llama3-8b", "llama3.1-8b", "llama2-13b", "mistral-7b", "qwen2.5-7b", "qwen3-8b", "phi3-mini",
                  "gemma-2b", "gemma2-2b", "gemma3-1b", "mixtral-8x7b", "qwen3-moe-30b", "deepseek-v3-mini",
                  "deepseek-v3-mid-7b", "deepseek-v3", "gpt2")
FAMILY_S = 1024  # tokens a row: above gemma3's 512 window, so that it masks
# deepseek-ai/DeepSeek-V3's published config.json (the values hf_decoder_config reads), cut to 2 layers with
# first_k_dense_replace lowered from 3 to 1, so that the second layer is a noaux-tc MoE layer (about 27 GB in bf16)
DEEPSEEK_V3_HF = {
    "model_type": "deepseek_v3", "vocab_size": 129280, "hidden_size": 7168, "intermediate_size": 18432,
    "moe_intermediate_size": 2048, "num_hidden_layers": 2, "num_attention_heads": 128, "num_key_value_heads": 128,
    "n_shared_experts": 1, "n_routed_experts": 256, "routed_scaling_factor": 2.5, "kv_lora_rank": 512,
    "q_lora_rank": 1536, "qk_rope_head_dim": 64, "v_head_dim": 128, "qk_nope_head_dim": 128,
    "topk_method": "noaux_tc", "n_group": 8, "topk_group": 4, "num_experts_per_tok": 8, "first_k_dense_replace": 1,
    "norm_topk_prob": True, "scoring_func": "sigmoid", "hidden_act": "silu", "max_position_embeddings": 163840,
    "rms_norm_eps": 1e-06, "tie_word_embeddings": False, "rope_theta": 10000, "attention_bias": False,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 1.0, "mscale_all_dim": 1.0,
                     "original_max_position_embeddings": 4096, "type": "yarn"}}
# Relative error ||a - b|| / ||b|| over the real tokens' logits, bf16, 2 random layers (the MoE rows with their
# expert choices replayed between the two sides of each comparison: RouteReplay): the kernel and its plain
# version make the same casts and differ in the order of f32 sums and where p is rounded (2e-2); the cached decode
# against the same module's full einsum forward, one attention implementation on both sides, so only the cache,
# the per-layer window masks and the GEMMs' row counts (another order of f32 sums, bf16 outputs) differ (1e-2: an
# H100 read 0 for MHA and 3.4e-3 to 7.0e-3 for the GQA presets; the MoE rows run their dense path on both sides);
# MLA's absorbed decode against its decompressed
# forward, which round different bf16 intermediates (3e-2: deepseek-v3-mini read 1.3e-2 in bf16 on a CPU); K5
# against x @ dequant(W) on the same packed weights (bf16 products summed in f32 in another order, 2e-2).
FAMILY_TOL = {"plain": 2e-2, "cached": 1e-2, "cached_mla": 3e-2, "int4": 2e-2}


def write_safetensors(path, hf_config, tensors):
    """A Hugging Face checkpoint: ``config.json`` and ``model.safetensors`` in the format's own layout (an 8-byte
    little-endian header length, the JSON header padded to 8 bytes, the tensors' raw bytes), each tensor in its
    own type (BF16 or F32). Returns the bytes of tensor data."""
    import torch

    header, at, order = {"__metadata__": {"format": "pt"}}, 0, []
    for name, t in tensors:
        t = t.detach().contiguous()
        kind = {torch.bfloat16: "BF16", torch.float32: "F32"}[t.dtype]
        header[name] = {"dtype": kind, "shape": list(t.shape), "data_offsets": [at, at + t.numel() * t.element_size()]}
        at += t.numel() * t.element_size()
        order.append(t)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    Path(path).mkdir(parents=True, exist_ok=True)
    (Path(path) / "config.json").write_text(json.dumps(hf_config, indent=2))
    with open(Path(path) / "model.safetensors", "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for t in order:
            f.write(t.cpu().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy().tobytes())
    return at


def hf_tensors(model, model_type):
    """The HF-named tensors of a port decoder of ``model_type`` llama, mixtral, qwen3_moe, deepseek_v3 or gpt2: Linear
    weights as (out, in), stacked experts split one tensor an expert, MLA's raw ``kv_b_proj`` transposed, GPT-2's
    Conv1D weights as they are (in, out). Every module parameter is named once."""
    cfg, sd = model.cfg, model.state_dict()
    out, seen = [], set()

    def put(theirs, ours, linear=False):
        seen.add(ours)
        out.append((theirs, sd[ours].T if linear else sd[ours]))

    if model_type == "gpt2":
        for n in ("wte.embedding", "wpe.embedding"):
            put(n.replace("embedding", "weight"), n)
        put("ln_f.weight", "ln_f.scale")
        put("ln_f.bias", "ln_f.bias")
        for i in range(cfg.num_layers):
            for ours, theirs in (("ln_1", "ln_1"), ("ln_2", "ln_2"), ("attn.c_attn", "attn.c_attn"),
                                 ("attn.c_proj", "attn.c_proj"), ("c_fc", "mlp.c_fc"), ("mlp_proj", "mlp.c_proj")):
                leaf = "scale" if ours.startswith("ln") else "kernel"
                put(f"h.{i}.{theirs}.weight", f"layer_{i}.{ours}.{leaf}")
                put(f"h.{i}.{theirs}.bias", f"layer_{i}.{ours}.bias")
    else:
        put("model.embed_tokens.weight", "embed_tokens.embedding")
        put("model.norm.weight", "final_norm.scale")
        put("lm_head.weight", "lm_head.kernel", True)
        for i in range(cfg.num_layers):
            hl, at = f"model.layers.{i}", f"layer_{i}"
            put(f"{hl}.input_layernorm.weight", f"{at}.input_norm.scale")
            put(f"{hl}.post_attention_layernorm.weight", f"{at}.post_attention_norm.scale")
            sa = f"{hl}.self_attn"
            if cfg.mla:
                put(f"{sa}.q_a_proj.weight", f"{at}.attention.q_a_proj.kernel", True)
                put(f"{sa}.q_a_layernorm.weight", f"{at}.attention.q_a_norm.scale")
                put(f"{sa}.q_b_proj.weight", f"{at}.attention.q_b_proj.kernel", True)
                put(f"{sa}.kv_a_proj_with_mqa.weight", f"{at}.attention.kv_a_proj.kernel", True)
                put(f"{sa}.kv_a_layernorm.weight", f"{at}.attention.kv_a_norm.scale")
                put(f"{sa}.kv_b_proj.weight", f"{at}.attention.kv_b_proj", True)
                put(f"{sa}.o_proj.weight", f"{at}.attention.o_proj.kernel", True)
            else:
                for p in ("q_proj", "k_proj", "v_proj", "o_proj"):
                    put(f"{sa}.{p}.weight", f"{at}.attention.{p}.kernel", True)
                if cfg.qk_norm:
                    for p in ("q_norm", "k_norm"):
                        put(f"{sa}.{p}.weight", f"{at}.attention.{p}.scale")
            if hasattr(getattr(model, at), "moe"):
                base, names = (f"{hl}.block_sparse_moe", ("w1", "w3", "w2")) if model_type == "mixtral" else \
                    (f"{hl}.mlp", ("gate_proj", "up_proj", "down_proj"))
                put(f"{base}.gate.weight", f"{at}.moe.router", True)
                for ours, theirs in zip(("w_gate", "w_up", "w_down"), names):
                    seen.add(f"{at}.moe.{ours}")
                    out += [(f"{base}.experts.{j}.{theirs}.weight", w.T) for j, w in enumerate(sd[f"{at}.moe.{ours}"])]
                if cfg.moe_router == "noaux_tc":
                    put(f"{base}.gate.e_score_correction_bias", f"{at}.moe.e_score_correction_bias")
                if cfg.moe_n_shared_experts:
                    for ours, theirs in (("shared_gate", "gate_proj"), ("shared_up", "up_proj"),
                                         ("shared_down", "down_proj")):
                        put(f"{base}.shared_experts.{theirs}.weight", f"{at}.moe.{ours}", True)
            else:
                for p in ("gate_proj", "up_proj", "down_proj"):
                    put(f"{hl}.mlp.{p}.weight", f"{at}.{p}.kernel", True)
    check(seen == set(sd), f"hf_tensors: {sorted(set(sd) - seen)} unmapped")
    return out


def family_checkpoints():
    """(model type, the writer's config, the HF config.json) of each checkpoint families-small writes and reads
    back: Llama-3.1-8B at full width and 2 layers, Mixtral-8x7B and Qwen3-30B-A3B at full width and 1 layer, DeepSeek-V3's format at deepseek-v3-mini's width
    (8 routed experts, 1 shared, first_k_dense_replace 1, 2 layers), GPT-2 whole."""
    import dataclasses

    import torch

    from dalm_tpu_torch.models.gpt2 import GPT2Config
    from dalm_tpu_torch.models.hf_loader import hf_decoder_config
    from dalm_tpu_torch.models.registry import DECODER_PRESETS

    def common(c):
        return {"vocab_size": c.vocab_size, "hidden_size": c.hidden_size, "num_hidden_layers": c.num_layers,
                "num_attention_heads": c.num_heads, "num_key_value_heads": c.kv_heads,
                "intermediate_size": c.intermediate_size, "max_position_embeddings": c.max_position_embeddings,
                "rope_theta": c.rope_theta, "rms_norm_eps": c.rms_norm_eps, "hidden_act": "silu",
                "tie_word_embeddings": False, "torch_dtype": "bfloat16"}

    bf = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=False)
    llama = dataclasses.replace(DECODER_PRESETS["llama3.1-8b"](), num_layers=2, **bf)
    f, lo, hi, old = llama.rope_llama3
    mix = dataclasses.replace(DECODER_PRESETS["mixtral-8x7b"](), num_layers=1, **bf)
    qw = dataclasses.replace(DECODER_PRESETS["qwen3-moe-30b"](), num_layers=1, **bf)
    mini = DECODER_PRESETS["deepseek-v3-mini"]()
    ds_hf = dict(common(mini), model_type="deepseek_v3", num_hidden_layers=2, q_lora_rank=mini.q_lora_rank,
                 kv_lora_rank=mini.kv_lora_rank, qk_nope_head_dim=mini.qk_nope_head_dim,
                 qk_rope_head_dim=mini.qk_rope_head_dim, v_head_dim=mini.v_head_dim, n_routed_experts=8,
                 num_experts_per_tok=2, n_group=4, topk_group=2, moe_intermediate_size=1536, n_shared_experts=1,
                 routed_scaling_factor=2.5, norm_topk_prob=True, first_k_dense_replace=1)
    g = GPT2Config.gpt2_124m()
    return (
        ("llama", llama, dict(common(llama), model_type="llama", rope_scaling={
            "rope_type": "llama3", "factor": f, "low_freq_factor": lo, "high_freq_factor": hi,
            "original_max_position_embeddings": int(old)})),
        ("mixtral", mix, dict(common(mix), model_type="mixtral", num_local_experts=8, num_experts_per_tok=2,
                              sliding_window=None)),
        ("qwen3_moe", qw, dict(common(qw), model_type="qwen3_moe", head_dim=128, moe_intermediate_size=768,
                               num_experts=128, num_experts_per_tok=8, norm_topk_prob=True, use_sliding_window=False,
                               sliding_window=None)),
        ("deepseek_v3", dataclasses.replace(hf_decoder_config(ds_hf), **bf), ds_hf),
        ("gpt2", dataclasses.replace(g, dtype=torch.bfloat16, param_dtype=torch.bfloat16),
         {"model_type": "gpt2", "vocab_size": g.vocab_size, "n_embd": g.hidden_size, "n_layer": g.num_layers,
          "n_head": g.num_heads, "n_positions": g.max_position_embeddings, "layer_norm_epsilon": g.layer_norm_eps}),
    )


class RouteReplay:
    """Holds the MoE rows' expert choices fixed between two computations that round differently (K4 and its plain
    version; a cached decode and the full forward; K5 and x @ dequant(W)), so that a near tie between two experts' router scores cannot flip
    a route between them: ``record`` keeps each MoE layer's indices in call order; ``replay`` gives each layer the
    recorded indices of the tokens ``rows`` names (None: the same tokens) and the weights of those experts from its
    own router scores. Installed over ``models/moe.py``'s two routers, removed by ``close``."""

    def __init__(self):
        from dalm_tpu_torch.models import moe

        self.moe, self.orig = moe, (moe.route_topk, moe.route_noaux_tc)
        self.mode, self.rec, self.calls, self.rows = None, [], 0, None
        moe.route_topk, moe.route_noaux_tc = self.topk, self.noaux_tc

    def start(self, mode, rows=None):
        self.mode, self.calls, self.rows = mode, 0, rows
        if mode == "record":
            self.rec = []

    def _route(self, weights, idx, scores, norm, eps=0.0, scaling=1.0):
        import torch

        if self.mode == "record":
            self.rec.append(idx)
        elif self.mode == "replay":
            want = self.rec[self.calls % len(self.rec)]
            self.calls += 1
            idx = want if self.rows is None else want[self.rows]
            weights = torch.gather(scores, 1, idx)
            if norm:
                weights = weights / (weights.sum(dim=-1, keepdim=True) + eps)
            weights = weights * scaling
        return weights, idx

    def topk(self, logits, k, norm):
        import torch

        w, idx = self.orig[0](logits, k, norm)
        return self._route(w, idx, torch.softmax(logits.float(), dim=-1), norm)

    def noaux_tc(self, logits, bias, k, n_group, topk_group, norm, scaling):
        import torch

        w, idx = self.orig[1](logits, bias, k, n_group, topk_group, norm, scaling)
        return self._route(w, idx, torch.sigmoid(logits), norm, 1e-20, scaling)

    def close(self):
        self.moe.route_topk, self.moe.route_noaux_tc = self.orig


def family_config(name):
    """families-small's config of a preset: 2 layers (GPT-2 whole), bf16, no recompute, the flash path where the
    family has one."""
    import dataclasses

    import torch

    from dalm_tpu_torch.models.gpt2 import GPT2Config
    from dalm_tpu_torch.models.hf_loader import hf_decoder_config
    from dalm_tpu_torch.models.registry import DECODER_PRESETS

    if name == "gpt2":
        return dataclasses.replace(GPT2Config.gpt2_124m(), dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    if name == "deepseek-v3":
        return dataclasses.replace(hf_decoder_config(DEEPSEEK_V3_HF), dtype=torch.bfloat16,
                                   param_dtype=torch.bfloat16, attention_impl="flash")
    base = DECODER_PRESETS[name]()
    layers = base.sliding_layers[:2] if isinstance(base.sliding_layers, tuple) else base.sliding_layers
    return dataclasses.replace(base, num_layers=2, sliding_layers=layers, dtype=torch.bfloat16, remat=False,
                               attention_impl="flash")


def packed_projections(cfg):
    """The projections ``pack_module`` packs to 4 bits, one K5 call each a forward, counted from the architecture:
    GPT-2's four a layer (``c_attn``, ``c_proj``, ``c_fc``, ``mlp_proj``; the head tied); a decoder layer's attention
    (q / k / v / o; MLA's ``q_a_proj`` / ``q_b_proj`` / ``kv_a_proj`` / ``o_proj``, or ``q_proj`` / ``kv_a_proj`` /
    ``o_proj`` without q-LoRA) and, but in an MoE layer, gate / up / down; an untied head. The experts, the router and
    MLA's ``kv_b_proj`` are raw parameters and stay bf16, as the reference packs only 2-D ``kernel`` leaves
    (``dalm_tpu/models/quant.py:204-227``)."""
    from dalm_tpu_torch.models.decoder import DecoderConfig

    if not isinstance(cfg, DecoderConfig):
        return 4 * cfg.num_layers
    attention = (4 if cfg.q_lora_rank else 3) if cfg.mla else 4
    moe_layers = cfg.num_layers - min(cfg.moe_layer_start, cfg.num_layers) if cfg.num_experts else 0
    return attention * cfg.num_layers + 3 * (cfg.num_layers - moe_layers) + (0 if cfg.tie_embeddings else 1)


def families_small_phase(device, workdir, smi):
    """Each family preset at full width and 2 layers (GPT-2 whole; DeepSeek-V3 at its own width from its published
    config.json, 2 layers, one of them a noaux-tc MoE layer), bf16, random from ``gen``, with 2 x ``FAMILY_S`` tokens
    (row 1 right-padded): (a) for the families with a flash path, the forward through the kernels against the same
    module with K4's plain version (MLA and GPT-2 attend by matmuls, as the reference's); (b) a cached decode
    (prefill of all but the last 8 tokens, then 8 single steps; MLA's absorbed path) against the same module's full
    forward on the matmul path at the same positions (the MoE rows on their dense path on both sides); (c) the module
    packed to int4, every packed projection on K5 (the experts and MLA's kv_b stay bf16), against the same packed
    weights through x @ dequant(W); (d) for Gemma / Gemma3: K4 at head dim 256 with window 512 on QK-normed q and k,
    forward and backward, against its plain versions. Then HF checkpoints written here and read back through
    ``resolve_decoder`` (and ``load_hf_decoder_packed`` for the decoder types), logits equal to the writer's bit for
    bit: ``family_checkpoints()``."""
    import dataclasses

    import numpy as np
    import torch

    import dalm_tpu_torch.models.decoder as dec
    from dalm_tpu_torch.kernels import flash_attention as fa
    from dalm_tpu_torch.kernels import int4_matmul as k5
    from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig, RMSNorm
    from dalm_tpu_torch.models.layers import FlexLinear
    from dalm_tpu_torch.models.moe import MoEBlock
    from dalm_tpu_torch.models.qlora import load_hf_decoder_packed, load_packed, pack_module
    from dalm_tpu_torch.models.registry import DECODER_PRESETS, build_decoder, resolve_decoder

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def set_moe_impl(model, impl):
        for m in model.modules():
            if isinstance(m, MoEBlock):
                m.cfg = dataclasses.replace(m.cfg, moe_impl=impl)

    gen = torch.Generator(device=device).manual_seed(20)  # the phase's own weights, whatever ran before it
    rng = np.random.default_rng(20)
    S = FAMILY_S
    mask = torch.ones((2, S), dtype=torch.long, device=device)
    mask[1, S - 100:] = 0
    real = mask.bool()
    rows, t_all = {}, time.perf_counter()
    for name in FAMILY_PRESETS:
        t0 = time.perf_counter()
        cfg = family_config(name)
        flash = isinstance(cfg, DecoderConfig) and not cfg.mla
        model = build_decoder(cfg, device=device).eval()
        model.reset_parameters(gen)
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, S)), device=device)
        before = dict(fa.flash_attention.launches)
        routes = RouteReplay()
        try:
            routes.start("record")
            logits = model(ids, mask)
            torch.cuda.synchronize()
            e_plain = None
            if flash:
                check(fa.flash_attention.launches["fwd"] - before["fwd"] == 2, f"families-small {name}: K4 launches")
                dec.flash_attention = fa.flash_attention_ref
                routes.start("replay")
                plain = model(ids, mask)
        finally:
            dec.flash_attention = fa.flash_attention
            routes.close()
        if flash:
            e_plain = rel(logits[real], plain[real])
            check(bool(torch.isfinite(logits).all()) and e_plain <= FAMILY_TOL["plain"],
                  f"families-small {name}: kernel against plain forward {e_plain:.3g}")
            del plain
        check(bool(torch.isfinite(logits[real]).all()), f"families-small {name}: logits")
        P = S - 8
        cache = model.init_kv_cache(2, S)
        full = torch.ones_like(mask)
        set_moe_impl(model, "dense")
        if flash:
            model.cfg = dataclasses.replace(cfg, attention_impl="einsum")  # the cached path's attention, full length
        routes = RouteReplay()
        try:
            routes.start("record")
            logits1 = model(ids, full)
            routes.start("replay", (torch.arange(2, device=device)[:, None] * S
                                    + torch.arange(P, device=device)).reshape(-1))
            model.cfg = cfg
            out, cache = model(ids[:, :P], full, kv_cache=cache, cache_index=0, logits_last_only=True)
            steps = [out[:, -1]]
            for t in range(P, S - 1):
                routes.start("replay", torch.arange(2, device=device) * S + t)
                out, cache = model(ids[:, t:t + 1], full, kv_cache=cache, cache_index=t)
                steps.append(out[:, -1])
        finally:
            model.cfg = cfg
            routes.close()
        set_moe_impl(model, cfg.moe_impl if isinstance(cfg, DecoderConfig) else "auto")
        e_cached = rel(torch.stack(steps, 1), logits1[:, P - 1:S - 1])
        tol = FAMILY_TOL["cached_mla" if getattr(cfg, "mla", False) else "cached"]
        check(e_cached <= tol, f"families-small {name}: cached decode against the full forward {e_cached:.3g}")
        del cache, logits1, logits, out, steps
        pack_module(model, "int4")
        packed = sum(1 for m in model.modules() if isinstance(m, FlexLinear) and m.q4 is not None)
        calls = dict(k5.int4_matmul_fwd.launches)
        by_route, g8 = dict(k5.int4_matmul_fwd.route_launches), dict(k5.fused.group8_launches)
        routes = RouteReplay()
        try:
            routes.start("record")
            q_full, q_short = model(ids, mask), model(ids[:, :16], mask[:, :16])
            torch.cuda.synchronize()
            k5_calls = sum(k5.int4_matmul_fwd.launches.values()) - sum(calls.values())
            k5_routes = {f"{i}/{r}": n - by_route[i, r] for (i, r), n in k5.int4_matmul_fwd.route_launches.items()
                         if n != by_route[i, r]}
            k5_g8 = {i: n - g8[i] for i, n in k5.fused.group8_launches.items() if n != g8[i]}
            routes.start("replay")
            with k5_dequantised():
                d_full, d_short = model(ids, mask), model(ids[:, :16], mask[:, :16])
        finally:
            routes.close()
        e_int4 = max(rel(q_full[real], d_full[real]), rel(q_short, d_short))
        projections = 2 * packed_projections(cfg)
        check(2 * packed == projections and k5_calls == projections and e_int4 <= FAMILY_TOL["int4"],
              f"families-small {name}: int4 ({packed} projections packed, {k5_calls} K5 calls of {projections} "
              f"projections) against x @ dequant(W) {e_int4:.3g}")
        if name == "gemma3-1b":  # K 1,152 packs at group 8: the 32-row forward runs the fused instances for it
            want_g8 = 5 * cfg.num_layers  # q, k, v, gate, up a layer, in the 32-row forward only
            check(k5_g8.get("base", 0) == want_g8,
                  f"families-small {name}: {k5_g8} fused launches at group 8, {want_g8} expected (K5 routes {k5_routes})")
        rows[name] = dict(plain=e_plain, cached=e_cached, int4=e_int4, k5_calls=k5_calls, projections=projections,
                          k5_routes=k5_routes, k5_group8_launches=k5_g8, s=time.perf_counter() - t0)
        if name in ("gemma-2b", "gemma3-1b", "gemma2-2b"):
            H, Hk, D = cfg.num_heads, cfg.kv_heads, cfg.head_dim
            q, k, v, do, _, _ = k4_inputs(gen, device, torch.bfloat16, 1, H, Hk, 2048, 2048, D, None)
            qn, kn = RMSNorm(D, 1e-6, torch.bfloat16, torch.bfloat16, device, True), \
                RMSNorm(D, 1e-6, torch.bfloat16, torch.bfloat16, device, True)
            with torch.no_grad():
                qn.scale.normal_(0.0, 0.5, generator=gen)
                kn.scale.normal_(0.0, 0.5, generator=gen)
                q, k = qn(q.transpose(1, 2)).transpose(1, 2), kn(k.transpose(1, 2)).transpose(1, 2)
            kw = dict(causal=True, scale=1.0 / 16, window=512, softcap=cfg.attn_logit_softcap)
            out, lse = fa.flash_fwd(q, k, v, None, None, **kw)
            grads = fa.flash_bwd(q, k, v, out, lse, do, None, None, **kw)
            ro, rl = fa.flash_fwd_ref(q, k, v, None, None, **kw)
            refs = fa.flash_bwd_ref(q, k, v, out, lse, do, None, None, **kw)
            tol = K4_TOL["bfloat16"]
            rows[name]["k4_d256"] = max(k4_err(out, ro, tol["out"], f"families-small {name} out"),
                                        k4_err(lse, rl, tol["lse"], f"families-small {name} lse"),
                                        *(k4_err(g, r, tol["grad"], f"families-small {name} grad")
                                          for g, r in zip(grads, refs)))
            del q, k, v, do, out, lse, grads, ro, rl, refs
        shape = (f"heads {cfg.num_heads} x {cfg.head_dim}" if not isinstance(cfg, DecoderConfig) else
                 f"heads {cfg.num_heads}/{cfg.kv_heads} x {cfg.qk_head_dim if cfg.mla else cfg.head_dim}"
                 + (f", latent {cfg.kv_lora_rank} + rope {cfg.qk_rope_head_dim}" if cfg.mla else "")
                 + (f", {cfg.num_experts} experts top-{cfg.num_experts_per_tok} from layer {cfg.moe_layer_start}"
                    if cfg.num_experts else "") + f", windows {[cfg.layer_window(i) for i in range(2)]}")
        print(f"[families-small] {name} ({smi}): {cfg.num_layers} layers at width {cfg.hidden_size}, {shape}, vocab "
              f"{cfg.vocab_size}: "
              + (f"kernels vs plain K4 {e_plain:.2e}, " if e_plain is not None else "no K4 (matmul attention), ")
              + f"cached decode vs full {e_cached:.2e}, int4 ({k5_calls} of {projections} projections on K5; by "
              f"instance / route {k5_routes}, of them on the fused instances for groups of 8 {k5_g8}) vs "
              f"x @ dequant(W) {e_int4:.2e}"
              + (f", K4 D {cfg.head_dim} window 512 on QK-normed q/k max error {rows[name]['k4_d256']:.2e}"
                 if "k4_d256" in rows[name] else "") + f"; {rows[name]['s']:.1f} s", flush=True)
        del model, q_full, q_short, d_full, d_short
        torch.cuda.empty_cache()

    checkpoints = {}
    for model_type, cfg, hf in family_checkpoints():
        t0 = time.perf_counter()
        model = build_decoder(cfg, device=device).eval()
        model.reset_parameters(gen)
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 256)), device=device)
        want = model(ids, mask[:, :256])
        path = str(Path(workdir) / f"{model_type}_hf")
        nbytes = write_safetensors(path, hf, hf_tensors(model, model_type))
        del model
        torch.cuda.empty_cache()
        write_s = time.perf_counter() - t0
        rcfg, state = resolve_decoder(path, dtype="bfloat16")
        check(dataclasses.replace(rcfg, param_dtype=cfg.param_dtype) == cfg,
              f"families-small: the {model_type} checkpoint's config reads back as {rcfg}")
        read = build_decoder(rcfg, device=device).eval()
        read.load_state_dict(state)
        del state
        got = read(ids, mask[:, :256])
        del read
        torch.cuda.empty_cache()
        check(torch.equal(got, want), f"families-small: {model_type} logits read back through resolve_decoder differ "
                                      f"from the writer's: max {float((got.float() - want.float()).abs().max()):.3g}")
        if model_type != "gpt2":
            pcfg, res, quant, _ = load_hf_decoder_packed(path, quantize=False, dtype=torch.bfloat16, device=device)
            packed = Decoder(dataclasses.replace(pcfg, param_dtype=torch.bfloat16), device="meta").eval()
            packed.to_empty(device=device)
            load_packed(packed, res, quant)
            got_packed = packed(ids, mask[:, :256])
            check(torch.equal(got_packed, want), f"families-small: {model_type} logits through "
                  f"load_hf_decoder_packed differ: max {float((got_packed.float() - want.float()).abs().max()):.3g}")
            del packed, res, quant, got_packed
        checkpoints[model_type] = dict(bytes=nbytes, write_s=write_s, round_trip_s=time.perf_counter() - t0)
        del got, want
        torch.cuda.empty_cache()
        print(f"[families-small] {model_type} checkpoint ({cfg.num_layers} layers at width {cfg.hidden_size}; {smi}): "
              f"written as config.json + model.safetensors ({nbytes / 1e9:.2f} GB) in {write_s:.1f} s; read back "
              f"through resolve_decoder" + (" and load_hf_decoder_packed (bf16 storage, streamed tensor by tensor)"
                                            if model_type != "gpt2" else "")
              + f": logits equal to the writer's bit for bit; {checkpoints[model_type]['round_trip_s']:.1f} s in all",
              flush=True)
    out = dict(presets=rows, checkpoints=checkpoints, phase_s=time.perf_counter() - t_all)
    print(f"[families-small] phase {out['phase_s']:.1f} s", flush=True)
    print(json.dumps({"families_small": out}), flush=True)
    return out


LLAMA31_SHAPES = {(4096, 4096): "q / o", (4096, 1024): "k / v", (4096, 14336): "gate / up", (14336, 4096): "down",
                  (4096, 128256): "lm_head"}


def serve_llama31_phase(device, passages, peaks, smi):
    """``serve_family_phase`` at Llama-3.1-8B int4 + int8 KV cache (32 layers, GQA 32 / 8, the llama3 rope bands,
    vocab 128,256): every one of Llama-3.1's five projection shapes on the fused kernel, its int8 cache a quarter of
    Llama-2-7B's (GQA 32 / 8). Returns the launches of the timed ``answer()`` and the results."""
    import torch

    launches, out, pipe, shapes = serve_family_phase("serve-llama31", "llama3.1-8b", device, passages, peaks, smi,
                                                     True)
    cfg = pipe.generator.cfg
    check(cfg.num_layers == 32 and cfg.kv_heads == 8 and cfg.rope_llama3 and cfg.kv_quant,
          f"serve-llama31: generator config {cfg}")
    check({(K, N) for _, K, N in shapes} == set(LLAMA31_SHAPES)
          and {(K, N) for r, K, N in shapes if r == "fused"} == set(LLAMA31_SHAPES),
          f"serve-llama31: K5 ran at shapes {sorted(shapes)}, not all five of Llama-3.1's on the fused kernel")
    kv31, kv2 = out["kv_cache_bytes"], out["kv_cache_bytes_llama2_7b_int8"]
    check(abs(kv2 / kv31 - 4.0) < 1e-6, f"serve-llama31: int8 cache {kv31} bytes against Llama-2-7B's {kv2}")
    print(json.dumps({"serve_llama31": out}), flush=True)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def sft_gemma2_phase(device, workdir, smi, steps=3):
    """``train_generator("gemma2-2b", ...)`` at full width and depth (26 layers, vocab 256,000 through a byte
    tokenizer padded to it), bf16, batch 1 x 8,192 tokens (Gemma2's own context, so that the 4,096 window of the
    even layers masks), LoRA r = 256 in the merge runtime, packing, recompute, NEFTune 5, ``steps`` optimiser steps
    and the validation batches: every attention call on K4's head-dim-256 kernels (the wgmma route), counted by
    direction and route and held to 26 layers x (2 forwards + 1 backward) a step plus 26 forwards a validation
    batch. Returns the launches by kernel (the kept mma.sync instances' entries at 0) and the results."""
    import numpy as np
    import torch

    from dalm_tpu_torch.kernels.flash_attention import flash_attention, flash_bwd, flash_fwd
    from dalm_tpu_torch.train import train_generator

    t_all = time.perf_counter()
    data = str(Path(workdir) / "chat_gemma2.jsonl")
    # 2 x 4000 characters a row: 5 training rows pack into 4 blocks of 8192 tokens (3 used), 3 validation rows into 2
    write_chat_jsonl(data, 8, 4000, np.random.default_rng(6))
    held = {}

    def snapshot(setup):
        held["setup"] = setup
        held["trainable"] = {k: p.detach().clone() for k, p in setup.state.params.items()}
        flash_attention.launches = dict.fromkeys(flash_attention.launches, 0)
        flash_fwd.routes = dict.fromkeys(flash_fwd.routes, 0)
        flash_bwd.routes = dict.fromkeys(flash_bwd.routes, 0)

    kw = dict(SFT_KW, seq_length=8192, tokenizer="byte@256000")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_generator("gemma2-2b", data, per_device_train_batch_size=1, per_device_eval_batch_size=1,
                          max_train_blocks=steps, device=device, setup_hook=snapshot, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes, bwd_routes = dict(flash_attention.launches), dict(flash_fwd.routes), dict(flash_bwd.routes)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    setup = held["setup"]
    cfg = setup.model.cfg
    layers, n_steps = cfg.num_layers, out["steps"]
    check(n_steps == steps and cfg.head_dim == 256 and cfg.attention_impl == "flash" and cfg.remat
          and cfg.vocab_size == 256000 and setup.train_blocks.shape == (steps, 8192),
          f"sft-gemma2: {n_steps} steps, config {cfg}, blocks {setup.train_blocks.shape}")
    check(np.isfinite(out["final_loss"]) and np.isfinite(out["eval_loss"]), f"sft-gemma2: losses {out}")
    eval_batches = len(setup.valid_blocks)
    want = {"fwd": 2 * layers * n_steps + layers * eval_batches, "dq": layers * n_steps, "dkv": layers * n_steps,
            "dsum": layers * n_steps}
    check(eval_batches >= 1 and launches == want, f"sft-gemma2: K4 launches {launches}, {layers} layers predict {want}")
    check(routes == {"wgmma": want["fwd"], "tf32x3": 0, "mma": 0}
          and bwd_routes == {"wgmma": want["dq"], "tf32x3": 0, "mma": 0},
          f"sft-gemma2: every bf16 D 256 call must take the wgmma route: {routes}, {bwd_routes}")
    unchanged = [k for k, p in setup.state.params.items() if torch.equal(p.detach(), held["trainable"][k])]
    check(len(held["trainable"]) == 4 * layers and not unchanged,
          f"sft-gemma2: {len(unchanged)} of {len(held['trainable'])} LoRA factors did not change")
    step_s = out["avg_step_time"]
    res = dict(steps=n_steps, eval_batches=eval_batches, wall_s=wall, step_s=step_s, tokens_per_s=8192 / step_s,
               peak_gib=peak_gib, final_loss=out["final_loss"], eval_loss=out["eval_loss"], launches=launches,
               phase_s=time.perf_counter() - t_all)
    print(f"[sft-gemma2] gemma2-2b ({layers} layers, width {cfg.hidden_size}, heads {cfg.num_heads}/{cfg.kv_heads} x "
          f"{cfg.head_dim}, windows 4096 / global alternating, softcap 50 / 30, vocab {cfg.vocab_size}) ({smi}): "
          f"batch 1 x 8192 tokens, bf16, LoRA r=256 (merge runtime), recompute, NEFTune 5: {n_steps} steps + "
          f"{eval_batches} validation batches in {wall:.1f} s (init included); step {step_s:.3f} s = "
          f"{8192 / step_s:.0f} tokens/s (0.736-0.845 s on the mma.sync D-256 kernels); loss at step {n_steps} "
          f"{out['final_loss']:.4f}, validation "
          f"{out['eval_loss']:.4f}; peak {peak_gib:.2f} GiB; K4 launches {launches} = {layers} x (2 forwards + 1 "
          f"backward) a step + {layers} forwards a validation batch, every one at D 256 on the wgmma route", flush=True)
    print(json.dumps({"sft_gemma2": res}), flush=True)
    held.clear()
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    return {"k4_fwd_d256_wgmma": routes["wgmma"], "k4_bwd_dq_d256_wgmma": bwd_routes["wgmma"],
            "k4_bwd_dkv_d256_wgmma": bwd_routes["wgmma"], "k4_fwd_d256": routes["mma"],
            "k4_bwd_dq_d256": bwd_routes["mma"], "k4_bwd_dkv_d256": bwd_routes["mma"]}, res


MOE_TOL = 1e-2  # the indexed dispatch against the dense formula, bf16, same routes: only the order of the sums


def moe_layer_check(block, device, T=2048, dense_tokens=(32, 128, 512, 2048)):
    """One MoE layer of the served model at full width over ``T`` random bf16 tokens: the dispatch path by index
    (dropless) against the reference's all-expert dense formula on the same routes; both timed by CUDA events. Then
    the dense path's two forms, split at ``moe.DENSE_ALL_TOKENS``, on the first ``dense_tokens`` of them: the
    all-expert formula and the sum over the touched experts, held to each other and timed (events around the calls,
    so the touched form's host sync on its per-expert counts is inside its time)."""
    import torch

    from dalm_tpu_torch.models import moe

    cfg = block.cfg
    x = torch.randn((1, T, cfg.hidden_size), generator=torch.Generator(device=device).manual_seed(5),
                    device=device).to(cfg.dtype)
    with torch.no_grad():
        x2 = x.reshape(T, -1)
        w, idx = moe.route_topk(x2 @ block.router.to(cfg.dtype), cfg.num_experts_per_tok, cfg.norm_topk_prob)
        dense = block._dense_all(x2, w, idx)
        disp, aux = block(x)
        err = float((disp.reshape(T, -1).float() - dense.float()).norm() / dense.float().norm())
        check(bool(torch.isfinite(disp).all()) and err <= MOE_TOL and bool(torch.isfinite(aux)),
              f"serve-moe: indexed dispatch against the dense formula {err:.3g}")
        dispatch_ms = cuda_ms(lambda: block(x), 3)
        dense_ms = cuda_ms(lambda: block._dense_all(x2, w, idx), 3)
        forms = {}
        for t in dense_tokens:
            xt, wt, it = x2[:t], w[:t], idx[:t]
            every, by_touched = block._dense_all(xt, wt, it), block._by_index(xt, wt, it, None)
            e = float((by_touched.float() - every.float()).norm() / every.float().norm())
            check(e <= MOE_TOL, f"serve-moe: the dense path's two forms over {t} tokens differ by {e:.3g}")
            forms[t] = dict(rel_err=e, all_experts_ms=cuda_ms(lambda: block._dense_all(xt, wt, it), 3),
                            touched_ms=cuda_ms(lambda: block._by_index(xt, wt, it, None), 3),
                            experts_touched=int(torch.unique(it).numel()))
    touched = int(torch.unique(idx).numel())
    return dict(tokens=T, rel_err=err, dispatch_ms=dispatch_ms, dense_ms=dense_ms, experts_touched=touched,
                aux=float(aux), dense_forms=forms)


def serve_family_phase(tag, preset, device, passages, peaks, smi, kv_quant):
    """``RagPipeline.from_pretrained("bge-large", preset, quantize_generator="int4", kv_quant=kv_quant)`` at full
    width and depth, bf16, random from seed 1, over the serve cell's 16,384 passages; 32 queries, top-4, 256-token
    prompts, 64 new tokens: a warm and a counted ``answer()`` (every packed projection on K5: the prefill forward's
    on the prefill route but the head, the rest on the fused kernel), the prefill and the decode step timed apart,
    the step against the read of the weights it must stream, the KV cache's bytes against Llama-2-7B's int8 cache at
    the same slots, ``answer_continuous()`` on 32 slots (each request's tokens equal to the lockstep generate's up
    to EOS) and the peak memory. Returns (launches of the counted ``answer()``, results, the pipeline, its K5 calls
    by (route, K, N))."""
    import dataclasses

    import torch

    from dalm_tpu_torch.kernels import int4_matmul as k5
    from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
    from dalm_tpu_torch.models.generate import build_greedy_generate
    from dalm_tpu_torch.models.layers import FlexLinear
    from dalm_tpu_torch.serve import RagPipeline

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    pipe = RagPipeline.from_pretrained("bge-large", preset, passages, dtype="bfloat16", device=device,
                                       quantize_generator="int4", kv_quant=kv_quant, max_passage_len=128,
                                       max_prompt_len=256, max_new_tokens=64, embed_batch=256)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_all
    g = pipe.generator
    cfg = g.cfg
    queries = [f"what about topic {i}" for i in range(0, 16384, 512)]
    pipe.answer(queries, top_k=4)  # warm
    shapes = {}
    fwd = k5.int4_matmul_fwd

    def counted(x2, q4, scale4, instance):
        K, N = x2.shape[1], q4.shape[1]
        route = k5._route(x2, instance, K // scale4.shape[0])
        shapes[route, K, N] = shapes.get((route, K, N), 0) + 1
        return fwd(x2, q4, scale4, instance)

    zero_serving_counts()
    counted.launches, counted.route_launches = fwd.launches, fwd.route_launches  # the wrapped function counts there
    k5.int4_matmul_fwd = counted
    try:
        answers, rows, p_ids, p_mask, answer_s = lockstep_tokens(pipe, queries)
    finally:
        k5.int4_matmul_fwd = fwd
    launches = serving_counts()
    per_forward = packed_projections(cfg)
    packed_modules = sum(1 for m in g.modules() if isinstance(m, FlexLinear) and m.q4 is not None)
    check(packed_modules == per_forward, f"{tag}: {packed_modules} projections packed, not {per_forward}")
    routes = launches["routes"]
    check(routes["prefill"] == per_forward - 1 and routes["fused"] == 64 * per_forward - routes["prefill"]
          and launches["int4_matmul[base]"] == routes["fused"] and launches["k5_prefill_gemm"] == routes["prefill"],
          f"{tag}: K5 launches {launches} for {per_forward} packed projections x 64 forwards")
    check(len(answers) == 32 and launches["fused_dot_topk[f32]"] > 0, f"{tag}: answers / K3")
    p_ids_t, p_mask_t = torch.as_tensor(p_ids, device=device), torch.as_tensor(p_mask, device=device)
    times = []
    for new in (1, 64):
        run = build_greedy_generate(g, new, eos_token_id=pipe.g_tok.eos_token_id,
                                    pad_token_id=pipe.g_tok.pad_token_id or 0)
        if new == 1:
            run(p_ids_t, p_mask_t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = run(p_ids_t, p_mask_t)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    check(tuple(toks.shape) == (32, 64) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{tag}: ids")
    prefill_s, decode_s = times
    step_ms = (decode_s - prefill_s) / 63 * 1e3
    # what a decode step streams: the packed projections, and the raw bf16 weights it reads whole (the MoE experts,
    # every one on the dense path at 32 slots; MLA's kv_b)
    packed = sum(b.numel() * b.element_size() for n, b in g.named_buffers() if n.rpartition(".")[2]
                 in ("q4", "scale4"))
    raw = sum(p.numel() * p.element_size() for n, p in g.named_parameters()
              if n.rpartition(".")[2] in ("w_gate", "w_up", "w_down", "kv_b_proj", "shared_gate", "shared_up",
                                           "shared_down"))
    bound_ms = (packed + raw) / peaks[0] * 1e3
    cache = g.init_kv_cache(32, 320)
    kv_bytes = sum(t.numel() * t.element_size() for layer in cache.values() for t in layer.values())
    del cache
    llama = Decoder(dataclasses.replace(DecoderConfig.llama2_7b(), kv_quant=True), device="meta")
    kv_llama = sum(t.numel() * t.element_size() for layer in llama.init_kv_cache(32, 320, device="meta").values()
                   for t in layer.values())
    eos = pipe.g_tok.eos_token_id
    pipe.answer_continuous(queries, top_k=4, num_slots=32)  # warm; builds the engine
    probe = EngineProbe(pipe._engine)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cont = pipe.answer_continuous(queries, top_k=4, num_slots=32)
        torch.cuda.synchronize()
        cont_s = time.perf_counter() - t0
    finally:
        probe.close()
    want = [trim(r, eos, 64) for r in rows]
    diff = [i for i in range(32) if probe.results[i] != want[i]]
    check(not diff, f"{tag}: answer_continuous() tokens differ from answer()'s for requests {diff}")
    check([a.answer for a in cont] == [a.answer for a in answers], f"{tag}: answer_continuous() text differs")
    occ, cb_step_ms, _ = probe.stats(cont_s, sum(len(r) for r in probe.results))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    out = dict(preset=preset, layers=cfg.num_layers, build_s=build_s, answer_s=answer_s, prefill_s=prefill_s,
               decode_s=decode_s, decode_step_ms=step_ms, packed_weight_bytes=packed, raw_weight_bytes=raw,
               weight_read_bound_ms=bound_ms, kv_cache_bytes=kv_bytes, kv_cache_bytes_llama2_7b_int8=kv_llama,
               answer_continuous_s=cont_s, continuous_decode_ms=cb_step_ms, continuous_occupancy=occ,
               peak_gib=peak_gib, packed_projections_a_forward=per_forward,
               k5_by_route_and_shape={f"{r} {K}x{N}": n for (r, K, N), n in sorted(shapes.items())},
               launches={k: v for k, v in launches.items() if k != "routes"}, routes=routes,
               phase_s=time.perf_counter() - t_all)
    print(f"[{tag}] bge-large + {preset} int4{' + int8 KV cache' if kv_quant else ''} ({smi}): {cfg.num_layers} "
          f"layers, built in {build_s:.1f} s; answer() of 32 queries {answer_s:.3f} s; prefill (+ first token) "
          f"{prefill_s:.3f} s, prefill + 64 tokens {decode_s:.3f} s: decode {step_ms:.2f} ms a step against a "
          f"weight-read bound of {bound_ms:.3f} ms ({packed / 1e9:.3f} GB packed + {raw / 1e9:.3f} GB bf16 read "
          f"whole); K5 launches by route {routes} ({per_forward} packed projections a forward); KV cache for 32 slots "
          f"x 320 tokens {kv_bytes / 2 ** 20:.1f} MiB against Llama-2-7B's int8 cache {kv_llama / 2 ** 20:.1f} MiB; "
          f"answer_continuous() on 32 slots {cont_s:.3f} s ({probe.waves} wave(s), {probe.iters} iterations, "
          f"{cb_step_ms:.2f} ms an iteration), every request's tokens equal answer()'s; peak {peak_gib:.2f} GiB; "
          f"K5 by route and shape {out['k5_by_route_and_shape']}; phase {out['phase_s']:.1f} s", flush=True)
    return {k: v for k, v in launches.items() if k != "routes"}, out, pipe, shapes


def serve_moe_phase(device, passages, peaks, smi):
    """serve-moe: Qwen3-30B-A3B (128 experts, top-8, hidden 2048, vocab 151,936) served at full width, its 48 layers
    cut to ``CUT_DEPTH["serve-moe"]``'s by main(), packed to int4 (attention and head; the experts stay bf16, as the
    reference packs only 2-D kernels) with the int8 KV cache; then one of its MoE layers at full width over 2,048
    tokens, the indexed dispatch held against the dense formula."""
    import torch

    from dalm_tpu_torch.models.moe import DENSE_ALL_TOKENS

    launches, out, pipe, _ = serve_family_phase("serve-moe", "qwen3-moe-30b", device, passages, peaks, smi, True)
    g = pipe.generator
    layers = CUT_DEPTH["serve-moe"][2]
    check(g.cfg.num_experts == 128 and g.cfg.num_experts_per_tok == 8 and g.cfg.num_layers == layers
          and all(hasattr(getattr(g, f"layer_{i}"), "moe") for i in range(layers)), f"serve-moe: config {g.cfg}")
    out["moe_layer"] = moe_layer_check(g.layer_0.moe, device)
    m = out["moe_layer"]
    print(f"[serve-moe] one MoE layer at full width over {m['tokens']} tokens: indexed dispatch against the dense "
          f"formula rel. error {m['rel_err']:.2e} (bound {MOE_TOL}); dispatch {m['dispatch_ms']:.2f} ms, dense "
          f"formula {m['dense_ms']:.2f} ms; {m['experts_touched']} of 128 experts touched; the dense path's forms "
          f"(split at {DENSE_ALL_TOKENS} tokens) by tokens, all experts / touched experts: "
          + ", ".join(f"{t}: {f['all_experts_ms']:.2f} / {f['touched_ms']:.2f} ms ({f['experts_touched']} touched, "
                      f"rel. error {f['rel_err']:.1e})" for t, f in m["dense_forms"].items()), flush=True)
    print(json.dumps({"serve_moe": out}), flush=True)
    del pipe, g
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def serve_mla_phase(device, passages, peaks, smi):
    """serve-mla: deepseek-v3-mid-7b (32 layers, latent 512 + rope 64, q-LoRA 1536, about 5.9B parameters) served at
    full width and depth, packed to int4 on K5, on the latent cache (no int8 KV: the reference raises there)."""
    import torch

    launches, out, pipe, _ = serve_family_phase("serve-mla", "deepseek-v3-mid-7b", device, passages, peaks, smi, False)
    cfg = pipe.generator.cfg
    check(cfg.mla and cfg.kv_lora_rank == 512 and cfg.qk_rope_head_dim == 64 and cfg.num_layers == 32,
          f"serve-mla: config {cfg}")
    want = 32 * 32 * 320 * (512 + 64) * 2
    check(out["kv_cache_bytes"] == want, f"serve-mla: latent cache {out['kv_cache_bytes']} bytes, not {want}")
    print(json.dumps({"serve_mla": out}), flush=True)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def sft_moe_phase(device, workdir, smi, steps=3):
    """``train_generator("qwen3-moe-30b", moe_aux_weight=0.001, use_peft=True, lora_r=256, packing=True,
    gradient_checkpointing=True)`` at full width and depth (48 layers, about 61 GB of frozen bf16 base), batch 1 x
    2,048 tokens, ``steps`` steps and the validation batches: K4's forward, dq and dk/dv at GQA 32 / 4 (the wgmma
    route) held to 48 layers x (2 forwards + 1 backward) a step plus 48 forwards a validation batch, the dispatch
    path's backward, the aux value of each step beside its loss (0.001 is Qwen3-MoE's published
    ``router_aux_loss_coef``). Returns the K4 launches by kernel and the results."""
    import numpy as np
    import torch

    from dalm_tpu_torch.kernels.flash_attention import flash_attention, flash_bwd, flash_fwd
    from dalm_tpu_torch.train import train_generator

    t_all = time.perf_counter()
    data = str(Path(workdir) / "chat_moe.jsonl")
    write_chat_jsonl(data, 8, 1500, np.random.default_rng(7))
    held = {"aux": []}

    def snapshot(setup):
        held["setup"] = setup
        fwd = setup.model.train_forward

        def train_forward(*a, **k):
            out = fwd(*a, **k)
            if k.get("return_moe_aux"):
                held["aux"].append(out[1].detach())
            return out

        setup.model.train_forward = train_forward
        held["trainable"] = {k: p.detach().clone() for k, p in setup.state.params.items()}
        flash_attention.launches = dict.fromkeys(flash_attention.launches, 0)
        flash_fwd.routes = dict.fromkeys(flash_fwd.routes, 0)
        flash_bwd.routes = dict.fromkeys(flash_bwd.routes, 0)

    kw = dict(SFT_KW, seq_length=2048, tokenizer="byte@151936", moe_aux_weight=0.001)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_generator("qwen3-moe-30b", data, per_device_train_batch_size=1, per_device_eval_batch_size=1,
                          max_train_blocks=steps, device=device, setup_hook=snapshot, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes, bwd_routes = dict(flash_attention.launches), dict(flash_fwd.routes), dict(flash_bwd.routes)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    setup = held["setup"]
    cfg = setup.model.cfg
    layers, n_steps = cfg.num_layers, out["steps"]
    check(n_steps == steps and cfg.num_experts == 128 and cfg.attention_impl == "flash" and cfg.remat
          and layers == 48 and setup.train_blocks.shape == (steps, 2048),
          f"sft-moe: {n_steps} steps, config {cfg}, blocks {setup.train_blocks.shape}")
    aux = [float(a) for a in held["aux"]]
    check(len(aux) == steps and all(np.isfinite(aux)) and min(aux) > 0 and np.isfinite(out["final_loss"])
          and np.isfinite(out["eval_loss"]), f"sft-moe: losses {out}, aux {aux}")
    eval_batches = len(setup.valid_blocks)
    want = {"fwd": 2 * layers * n_steps + layers * eval_batches, "dq": layers * n_steps, "dkv": layers * n_steps,
            "dsum": layers * n_steps}
    check(eval_batches >= 1 and launches == want, f"sft-moe: K4 launches {launches}, {layers} layers predict {want}")
    check(routes == {"wgmma": want["fwd"], "tf32x3": 0, "mma": 0}
          and bwd_routes == {"wgmma": want["dq"], "tf32x3": 0, "mma": 0},
          f"sft-moe: every bf16 D 128 call must take the wgmma route: {routes}, {bwd_routes}")
    unchanged = [k for k, p in setup.state.params.items() if torch.equal(p.detach(), held["trainable"][k])]
    check(len(held["trainable"]) == 4 * layers and not unchanged,
          f"sft-moe: {len(unchanged)} of {len(held['trainable'])} LoRA factors did not change")
    step_s = out["avg_step_time"]
    res = dict(steps=n_steps, eval_batches=eval_batches, wall_s=wall, step_s=step_s, tokens_per_s=2048 / step_s,
               peak_gib=peak_gib, final_loss=out["final_loss"], eval_loss=out["eval_loss"], aux=aux,
               launches=launches, phase_s=time.perf_counter() - t_all)
    print(f"[sft-moe] qwen3-moe-30b ({layers} layers, 128 experts top-8, width {cfg.hidden_size}, heads "
          f"{cfg.num_heads}/{cfg.kv_heads} x {cfg.head_dim}, vocab {cfg.vocab_size}) ({smi}): batch 1 x 2048 tokens, "
          f"bf16, LoRA r=256 (merge runtime), recompute, NEFTune 5, moe_aux_weight 0.001: {n_steps} steps + {eval_batches} "
          f"validation batches in {wall:.1f} s (init included); step {step_s:.3f} s = {2048 / step_s:.0f} tokens/s; "
          f"loss at step {n_steps} {out['final_loss']:.4f} (loss + 0.001 x aux), aux by step "
          f"{[round(a, 5) for a in aux]}, validation {out['eval_loss']:.4f}; peak {peak_gib:.2f} GiB; K4 launches "
          f"{launches} = {layers} x (2 forwards + 1 backward) a step + {layers} forwards a validation batch, every "
          f"one on the wgmma route", flush=True)
    print(json.dumps({"sft_moe": res}), flush=True)
    held.clear()
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    return {"k4_fwd_wgmma": routes["wgmma"], "k4_bwd_dq_wgmma": bwd_routes["wgmma"],
            "k4_bwd_dkv_wgmma": bwd_routes["wgmma"], "k4_dsum": launches["dsum"]}, res


# --------------------------------------------------------------------------
# Data generation: datagen-small, qa-gen, rc-pipeline
# --------------------------------------------------------------------------

WB = "▁"  # sentencepiece's word-boundary marker
RC_WORDS = ("the cell stack panel layer module array circuit wafer film contact junction emitter substrate current "
            "voltage output yield loss efficiency temperature").split()
RC_KEYWORDS = ("photovoltaic", "heterojunction", "passivation", "recombination", "encapsulation", "interconnection",
               "electroluminescence", "thermoregulation", "metallization", "antireflective")
RC_GENERAL = [WB + w for w in "the of and a to in is was for on with".split()]
RC_DOMAIN = RC_GENERAL + [WB + k for k in RC_KEYWORDS]
RC_DOCS = 3  # rc-pipeline's documents: 6 LLM chunks of 400 bytes, 2 train blocks + 1 validation block of 2,560 tokens
QA_ROWS, QA_TITLES = 16, 8


def spm_model_bytes(pieces) -> bytes:
    """A sentencepiece ``ModelProto`` in protobuf wire format: field 1 a ``SentencePiece`` (piece, score, type) for
    each piece, then a ``trainer_spec`` (field 2, with a varint and a 64-bit field) and a ``normalizer_spec`` (field
    3), which a reader must skip. The card's machine has no ``tokenizers`` or ``sentencepiece`` package, and nothing is
    downloaded: the phases (and the CPU tests) write their vocabulary files with this."""
    import struct

    def varint(n):
        out = b""
        while True:
            b, n = n & 0x7F, n >> 7
            out += bytes([b | (0x80 if n else 0)])
            if not n:
                return out

    out = b""
    for i, p in enumerate(pieces):
        pb = p.encode("utf-8")
        sub = b"\x0a" + varint(len(pb)) + pb + b"\x15" + struct.pack("<f", -float(i)) + b"\x18" + varint(1)
        out += b"\x0a" + varint(len(sub)) + sub
    spec = b"\x08" + varint(32000) + b"\x19" + struct.pack("<d", 0.5)
    name = b"nmt_nfkc"
    norm = b"\x0a" + varint(len(name)) + name
    return out + b"\x12" + varint(len(spec)) + spec + b"\x1a" + varint(len(norm)) + norm


def rc_clause(rng, lower=False, keywords=0) -> str:
    """A clause the miners take: at least 50 characters, no comma, a full stop."""
    words = list(rng.choice(RC_WORDS, size=6))
    for k in rng.choice(RC_KEYWORDS, size=keywords, replace=False):
        words.insert(int(rng.integers(0, len(words) + 1)), str(k))
    s = " ".join(words)
    while len(s) < 50:
        s += " " + str(rng.choice(RC_WORDS))
    return (s if lower else s[0].upper() + s[1:]) + "."


def rc_text(rng) -> str:
    """A domain document for the miners: one premise + connective pair for each NLI / cause-effect / paraphrase
    verbalizer family (Therefore, However, Moreover, In other words), an effect-cause pair ("due to") and a sentence
    of three domain keywords (word2text), in a seeded order."""
    units = [f"{rc_clause(rng)} {verb}, {rc_clause(rng, lower=True)}"
             for verb in ("Therefore", "However", "Moreover", "In other words")]
    units.append(f"{rc_clause(rng)} due to {rc_clause(rng, lower=True)}")
    units.append(rc_clause(rng, keywords=3))
    rng.shuffle(units)
    return " ".join(units)


def rc_inputs(root, n_docs, rng):
    """``n_docs`` documents under ``root / "docs"`` and the general / domain vocabulary files."""
    docs = Path(root) / "docs"
    docs.mkdir(parents=True, exist_ok=True)
    for i in range(n_docs):
        (docs / f"doc_{i}.txt").write_text(rc_text(rng))
    general, domain = Path(root) / "general.model", Path(root) / "domain.model"
    general.write_bytes(spm_model_bytes(RC_GENERAL))
    domain.write_bytes(spm_model_bytes(RC_DOMAIN))
    return str(docs), str(general), str(domain)


def scripted_tasks(prompts):
    """A scripted ``generate_fn`` for the comparisons of datagen-small: QUESTION / ANSWER text for most prompts, text
    the extractor misses for every third."""
    return ["no tasks here" if len(p) % 3 == 0 else
            f"1. QUESTION: what does the text of {len(p)} characters say?\nANSWER: it names {p.count(' ')} words.\n"
            f"QUESTION: is it long?\nANSWER: {'yes' if len(p) > 900 else 'no'}." for p in prompts]


def scripted_questions(prompts):
    """A scripted QA-gen writer for datagen-small: a question of more than five words for most prompts, and "-",
    which ``filter_malformed_questions`` drops, for every fourth."""
    return ["-" if i % 4 == 3 else f"Which part of the text of {len(p)} characters names {p.count(' ')} words?"
            for i, p in enumerate(prompts)]


def capture_generate(gen, calls, prefill=False):
    """Wrap ``gen._generate`` (a ``TorchTextGenerator``'s greedy loop): each call appends its ids, mask, tokens and
    wall seconds to ``calls``; with ``prefill``, also the seconds of its first decoder forward (the prefill), timed
    between two synchronisations (the decode steps run unsynchronised)."""
    import torch

    raw, model = gen._generate, gen.model
    fwd = model.forward
    state = {"first": False, "prefill_s": None}

    def forward(*a, **k):
        if not state["first"]:
            return fwd(*a, **k)
        state["first"] = False
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fwd(*a, **k)
        torch.cuda.synchronize()
        state["prefill_s"] = time.perf_counter() - t
        return out

    def generate(ids, mask):
        state["first"] = prefill
        if ids.is_cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        toks = raw(ids, mask)
        if ids.is_cuda:
            torch.cuda.synchronize()
        calls.append(dict(ids=ids, mask=mask, toks=toks, s=time.perf_counter() - t, prefill_s=state["prefill_s"]))
        return toks

    if prefill:
        model.forward = forward
    gen._generate = generate


def first_token_ties(model, calls, tol):
    """Each call's first generated token against the argmax of the same decoder's forward without a cache over the
    same left-padded ids, mask and positions. Returns (rows compared, rows that differ, rows that differ at a top-two
    gap under ``tol``)."""
    import torch

    n = bad = tied = 0
    with torch.no_grad():
        for c in calls:
            pos = torch.clamp(torch.cumsum(c["mask"], dim=1) - 1, min=0)
            logits = model(c["ids"], c["mask"], positions=pos, logits_last_only=True)[:, -1].float()
            top = torch.topk(logits, 2, dim=-1).values
            differ = c["toks"][:, 0].long() != logits.argmax(-1)
            n += len(differ)
            bad += int(differ.sum())
            tied += int((differ & (top[:, 0] - top[:, 1] < tol)).sum())
            del logits
    return n, bad, tied


def datagen_small_phase(device, workdir, smi):
    """Tiny, f32, the card against ``device="cpu"``: ``TorchTextGenerator`` completions for 12 prompts of mixed length
    at batch 8 (a padded second batch) equal token for token (the CPU's weights loaded on the card; a step where a row
    differs must be a near tie of the CPU logits, within ``NEAR_TIE``, and none came in the recorded runs); then
    ``pipeline(comprehension_type=SynthMode.BOTH)`` with a scripted ``generate_fn`` on both devices writes equal
    ``.jsonl`` rows and trains tiny to a finite loss on each; and ``generate_qa_from_disk`` with a scripted writer
    (``scripted_questions``) on both devices writes the same CSV bytes, whose rows are the kept questions."""
    import csv
    import io
    import random

    import numpy as np
    import torch

    from dalm_tpu_torch.data.backends import TorchTextGenerator
    from dalm_tpu_torch.data.loading import load_dataset
    from dalm_tpu_torch.data.qa_gen import generate_qa_from_disk
    from dalm_tpu_torch.pipelines import LLMKwargs, SynthKwargs, SynthMode, pipeline

    t_all = time.perf_counter()
    kw = dict(max_input_tokens=128, max_new_tokens=16, batch_size=8, system_message="Write one question.")
    cpu = TorchTextGenerator("tiny", device="cpu", **kw)
    card = TorchTextGenerator("tiny", device=device, **kw)
    card.model.load_state_dict(cpu.model.state_dict())
    rng = np.random.default_rng(12)
    prompts = [" ".join(rng.choice(RC_WORDS, size=int(rng.integers(1, 30)))) for _ in range(12)]
    calls = {"cpu": [], "card": []}
    capture_generate(cpu, calls["cpu"])
    capture_generate(card, calls["card"])
    texts = {"cpu": cpu(prompts), "card": card(prompts)}
    check(len(calls["card"]) == 2 and calls["card"][1]["ids"].shape == (8, 128),
          f"datagen-small: {len(calls['card'])} generate calls")
    steps_equal = []
    for c, g in zip(calls["cpu"], calls["card"]):
        want, got = c["toks"], g["toks"].cpu()
        diff = torch.nonzero((got != want).any(dim=0)).flatten()
        if len(diff):
            step = int(diff[0])
            full = torch.cat([c["ids"], want[:, :step].long()], 1)
            m = torch.cat([c["mask"], torch.ones_like(want[:, :step]).long()], 1)
            pos = torch.clamp(torch.cumsum(m, 1) - 1, min=0)
            top = torch.topk(cpu.model(full, m, positions=pos)[:, -1], 2).values
            rows = (got[:, step] != want[:, step]).nonzero().flatten()
            check(bool(((top[rows, 0] - top[rows, 1]) < NEAR_TIE).all()),
                  f"datagen-small: the card's tokens differ from the CPU's at step {step} without a near tie")
            steps_equal.append(step)
        else:
            steps_equal.append(want.shape[1])
    if steps_equal == [16, 16]:
        check(texts["card"] == texts["cpu"], "datagen-small: equal tokens decoded to different completions")

    docs, general, domain = rc_inputs(Path(workdir) / "datagen_small", 2, np.random.default_rng(13))
    rows, losses = {}, {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        out = Path(workdir) / "datagen_small" / name
        out.mkdir()
        random.seed(0)
        res = pipeline("tiny", str(out / "rc_dataset"), docs, str(out / "model"),
                       llm_kwargs=LLMKwargs("tiny", 1024, str(out / "llm"), True, str(out / "raw")),
                       synth_kwargs=SynthKwargs(general, domain), comprehension_type=SynthMode.BOTH,
                       generation_state_file=str(out / "state.pkl"), seq_length=256, per_device_train_batch_size=1,
                       eval_steps=0, logging_steps=1, lora_r=8, lora_alpha=16, gradient_checkpointing=False,
                       validation_split=0.25, num_warmup_steps=0, generate_fn=scripted_tasks, device=dev)
        rows[name] = load_dataset(str(out / "rc_dataset.jsonl"))["messages"]
        losses[name] = res["final_loss"]
        check(not (out / "state.pkl").exists(), f"datagen-small: the {name} run left its state file")
    check(rows["card"] == rows["cpu"] and len(rows["card"]) > 2, "datagen-small: the card's rows differ from the CPU's")
    check(all(np.isfinite(v) for v in losses.values()), f"datagen-small: losses {losses}")

    qa_path = qa_csv(Path(workdir) / "datagen_small" / "passages.csv", np.random.default_rng(14))
    csvs, written = {}, {}

    def writer(outs):  # scripted_questions, keeping what it wrote
        def generate(prompts):
            outs.extend(scripted_questions(prompts))
            return outs[-len(prompts):]
        return generate

    for name, dev in (("card", device), ("cpu", "cpu")):
        out = Path(workdir) / "datagen_small" / f"qa_{name}"
        generate_qa_from_disk(qa_path, "Abstract", "Title", QA_ROWS, 8, str(out), True,
                              generate_fn=writer(written.setdefault(name, [])), device=dev)
        csvs[name] = [(out / f"question_answer_pairs_{split}.csv").read_bytes() for split in ("train", "test")]
    kept = [q for q in written["card"] if q != "-"]
    got = []
    for data in csvs["card"]:
        table = list(csv.reader(io.StringIO(data.decode("utf-8"), newline="")))
        check(not table or table[0] == ["Title", "Abstract", "Question", "Answer"], f"datagen-small: header {table[:1]}")
        got += [r[2] for r in table[1:]]
    qa_bytes = sum(map(len, csvs["card"]))
    check(csvs["card"] == csvs["cpu"] and got == kept and len(written["card"]) == QA_ROWS and kept,
          f"datagen-small: QA-gen CSVs of {qa_bytes} bytes, rows {got} against the kept questions {kept}")
    res = dict(steps_equal=steps_equal, rows=len(rows["card"]), losses=losses, qa_rows=len(kept),
               qa_csv_bytes=qa_bytes, phase_s=time.perf_counter() - t_all)
    print(f"[datagen-small] tiny, f32 ({smi}): TorchTextGenerator on the card equal to the CPU token for token over 12 "
          f"prompts at batch 8 (steps compared {steps_equal}); pipeline(BOTH) with a scripted generate_fn wrote "
          f"{len(rows['card'])} equal rows on both devices; final loss card {losses['card']:.6f}, CPU "
          f"{losses['cpu']:.6f}; generate_qa_from_disk with a scripted writer wrote the same {qa_bytes} CSV "
          f"bytes on both devices, {len(kept)} rows; {res['phase_s']:.1f} s", flush=True)
    print(json.dumps({"datagen_small": res}), flush=True)
    return res


def qa_csv(path, rng):
    """The QA-gen cell's passages: ``QA_ROWS`` rows over ``QA_TITLES`` titles in the CLI's columns, Title / Abstract."""
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Title", "Abstract"])
        w.writerows([f"Title {i % QA_TITLES}", rc_text(rng)] for i in range(QA_ROWS))
    return str(path)


def qa_gen_phase(device, workdir, smi):
    """``generate_qa_from_disk`` on a seeded CSV (``QA_ROWS`` passages over ``QA_TITLES`` titles, ``sample_size`` 16,
    ``batch_size`` 8, ``max_input_tokens`` 512, ``as_csv=True``) with ``TorchTextGenerator("qwen2.5-7b",
    max_new_tokens=128)`` at full width and depth (28 layers, bf16 parameters, the preset's f32 compute, as the JAX
    class takes it; *cut of scale*: 128 new tokens against the class's 512). Checks every row's first generated
    token against the argmax of the same decoder's forward without a cache (a differing row must sit at a top-two
    gap under ``TIE_TOL``) and the CSVs against the generated questions that pass ``filter_malformed_questions``.
    Prints wall s, generate calls, prefill s, decode ms a step against the weight-read bound, rows kept, titles."""
    import csv
    import io

    import numpy as np
    import torch

    from dalm_tpu_torch.data.backends import TorchTextGenerator
    from dalm_tpu_torch.data.loading import load_dataset
    from dalm_tpu_torch.data.qa_gen import SPLIT_SEED, filter_malformed_questions, generate_qa_from_disk, split_dataset

    t_all = time.perf_counter()
    root = Path(workdir) / "qa_gen"
    root.mkdir()
    path = qa_csv(root / "passages.csv", np.random.default_rng(23))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = TorchTextGenerator("qwen2.5-7b", max_new_tokens=128, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = gen.model.cfg
    check(cfg.num_layers == 28 and cfg.hidden_size == 3584 and cfg.vocab_size == 152064
          and cfg.param_dtype == torch.bfloat16, f"qa-gen: config {cfg}")
    calls, outputs = [], []
    capture_generate(gen, calls, prefill=True)

    def generate_fn(prompts):
        outs = gen(prompts)
        outputs.extend(zip(prompts, outs))
        return outs

    t0 = time.perf_counter()
    generate_qa_from_disk(path, "Abstract", "Title", 16, 8, str(root / "out"), True, max_input_tokens=512,
                          generate_fn=generate_fn)
    wall = time.perf_counter() - t0
    del gen.model.forward  # the timing wrapper of capture_generate
    n, bad, tied = first_token_ties(gen.model, calls, TIE_TOL)
    check(bad == tied, f"qa-gen: {bad} of {n} first tokens differ from the uncached argmax, {tied} of them at a tie")
    passages = load_dataset(path)
    kept = []
    for prompt, question in outputs:  # build_prompt ends with the passage and a line break
        passage = next(a for a in passages["Abstract"] if prompt.endswith(a + "\n"))
        q = question.strip().replace("\n", " ")
        if filter_malformed_questions({"Question": q}):
            kept.append((passage, q))
    got = []
    for split in ("train", "test"):
        data = (root / "out" / f"question_answer_pairs_{split}.csv").read_text(encoding="utf-8")
        if data:
            table = list(csv.reader(io.StringIO(data, newline="")))
            check(table[0] == ["Title", "Abstract", "Question", "Answer"], f"qa-gen: {split} header {table[0]}")
            got += [(r[1], r[2]) for r in table[1:]]
    check(got == kept, f"qa-gen: the CSVs hold {len(got)} rows, the filter keeps {len(kept)} generated questions")
    splits = split_dataset(passages.shuffle(seed=SPLIT_SEED).select(range(16)), "Title")
    titles = {k: sorted(set(v["Title"])) for k, v in splits.items()}
    batches = sum(-(-len(v) // 8) for v in splits.values())  # each split in batches of 8
    check(len(calls) == batches and len(outputs) == 16 and not set(titles["train"]) & set(titles["test"]),
          f"qa-gen: {len(calls)} generate calls for {batches} batches, {len(outputs)} questions, titles {titles}")
    prefill_s = [c["prefill_s"] for c in calls]
    step_ms = [1e3 * (c["s"] - c["prefill_s"]) / (c["toks"].shape[1] - 1) for c in calls]
    read = sum(p.numel() * p.element_size() for name, p in gen.model.named_parameters()
               if cfg.tie_embeddings or not name.startswith("embed_tokens."))
    bound_ms = 1e3 * read / 3.35e12
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    res = dict(wall_s=wall, build_s=build_s, calls=len(calls), prefill_s=prefill_s, decode_step_ms=step_ms,
               bound_ms=bound_ms, weight_bytes=read, rows=len(outputs), kept=len(kept), titles=titles,
               first_token_rows=n, first_token_ties=tied, peak_gib=peak_gib, phase_s=time.perf_counter() - t_all)
    print(f"[qa-gen] generate_qa_from_disk with TorchTextGenerator('qwen2.5-7b') ({cfg.num_layers} layers, width "
          f"{cfg.hidden_size}, vocab {cfg.vocab_size}, bf16 parameters, f32 compute) ({smi}): {QA_ROWS} passages, "
          f"batch 8 x 512 tokens, 128 new tokens: {wall:.2f} s over {len(calls)} generate calls (model built in "
          f"{build_s:.2f} s); prefill {', '.join(f'{s:.3f}' for s in prefill_s)} s, decode "
          f"{', '.join(f'{s:.2f}' for s in step_ms)} ms a step against a weight-read bound of {bound_ms:.2f} ms "
          f"({read / 1e9:.2f} GB of bf16 parameters a step reads); {len(kept)} of {len(outputs)} questions kept by the "
          f"filter (random weights: ids past 255 decode to nothing); titles train {titles['train']}, test "
          f"{titles['test']}; first tokens {n - bad} of {n} equal to the uncached argmax ({tied} near ties); peak "
          f"{peak_gib:.2f} GiB", flush=True)
    print(json.dumps({"qa_gen": res}), flush=True)
    del gen, calls
    gc.collect()
    torch.cuda.empty_cache()
    return res


def rc_pipeline_phase(device, workdir, smi, torch_gen, peaks):
    """``pipeline(model_name="mistral-7b", comprehension_type=SynthMode.BOTH, ...)`` at full width and depth: regex
    RC over ``RC_DOCS`` seeded documents with vocabulary files written here, LLM RC with ``TorchTextGenerator(
    "mistral-7b", max_input_tokens=1024, max_new_tokens=96)`` (chunks of 1,024 tokens less the prompt's 624), then
    ``train_generator`` at ``seq_length=2560`` (2600, the default, is no multiple of 128 and would never reach K4),
    LoRA r 256 / alpha 512, recompute, packing, NEFTune 5, ``validation_split=0.25``, ``tokenizer="byte@32000"`` (byte
    ids in Mistral's 32,000-row vocabulary, as the sft cell), in the preset's dtypes (bf16 parameters, f32 compute, as
    the JAX pipeline trains it). Checks the state file gone, each chunk's unprocessed JSON,
    the ``.jsonl`` rows against the regex conversations plus the extracted ones, a finite loss, and K4's launches on
    the tf32x3 route (the f32 compute's at head dim 128) held to 32 layers x (2 forwards + 1 backward) a step plus 32
    forwards a validation block; then ``k4_f32_time`` holds and times the tf32x3 kernels beside the kept mma.sync f32
    instances at the geometry of the SFT's first attention call (its shapes and packed segment ids). Returns (the
    ``K4_TF32`` and ``K4_F32`` kernels-line records with this run's launches, numbers)."""
    import random
    from functools import partial

    import numpy as np
    import torch

    from dalm_tpu_torch.data.backends import TorchTextGenerator
    from dalm_tpu_torch.data.loading import load_dataset
    from dalm_tpu_torch.data.rc_regex import RegexBasedReadingComprehension
    from dalm_tpu_torch.data.rc_synthetic import SYSTEM_MESSAGE
    from dalm_tpu_torch.data.rc_utils import question_and_answer_extractor
    from dalm_tpu_torch.kernels.flash_attention import flash_attention, flash_bwd, flash_fwd, fwd_route
    from dalm_tpu_torch.models import decoder
    from dalm_tpu_torch.pipelines import LLMKwargs, SynthKwargs, SynthMode, pipeline
    from dalm_tpu_torch.pipelines import reading_comprehension as rcp
    from dalm_tpu_torch.train import generator_only, train_generator

    t_all = time.perf_counter()
    root = Path(workdir) / "rc_pipeline"
    docs, general, domain = rc_inputs(root, RC_DOCS, np.random.default_rng(31))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = TorchTextGenerator("mistral-7b", max_input_tokens=1024, max_new_tokens=96, system_message=SYSTEM_MESSAGE,
                             device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    calls = []
    capture_generate(gen, calls)
    held = {}

    def snapshot(setup):
        held["setup"] = setup
        flash_attention.launches = dict.fromkeys(flash_attention.launches, 0)
        flash_fwd.routes = dict.fromkeys(flash_fwd.routes, 0)
        flash_bwd.routes = dict.fromkeys(flash_bwd.routes, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held["t"] = time.perf_counter()
        held["marks"] = [held["t"]]
        apply = setup.state.apply_gradients

        def apply_gradients(*a, **k):  # the end of each step, on the device too: the trainer's own meter reads
            out = apply(*a, **k)      # windows between loss read-backs, here one window holding the epoch's save
            torch.cuda.synchronize()
            held["marks"].append(time.perf_counter())
            return out

        setup.state.apply_gradients = apply_gradients

    saves = []
    save = generator_only._save

    def timed_save(*a, **k):  # the SFT saves its base (14.5 GB of bf16) and the adapter per epoch and at the end
        t = time.perf_counter()
        save(*a, **k)
        saves.append(time.perf_counter() - t)

    attend = decoder.flash_attention

    def capturing(q, k, v, seg_q=None, seg_k=None, **kw):  # the geometry of the SFT's first attention call
        if "geo" not in held:
            seg = None if seg_q is None else seg_q.detach().clone()
            held["geo"] = dict(q=tuple(q.shape), k=tuple(k.shape), seg=seg, **kw)
        return attend(q, k, v, seg_q, seg_k, **kw)

    rcp.train_generator = partial(train_generator, setup_hook=snapshot)
    generator_only._save = timed_save
    decoder.flash_attention = capturing
    try:
        random.seed(0)
        t0 = time.perf_counter()
        out = pipeline("mistral-7b", str(root / "rc_dataset"), docs, str(root / "model"),
                       llm_kwargs=LLMKwargs("mistral-7b", context_length=1024, dataset_output_path=str(root / "llm"),
                                            chunk=True, unprocessed_dataset_output_path=str(root / "raw")),
                       synth_kwargs=SynthKwargs(general_spm_path=general, domain_spm_path=domain),
                       comprehension_type=SynthMode.BOTH, generation_state_file=str(root / "state.pkl"),
                       seq_length=2560, lora_r=256, lora_alpha=512, gradient_checkpointing=True, packing=True,
                       neftune_noise_alpha=5, validation_split=0.25, tokenizer="byte@32000", generate_fn=gen,
                       device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sft_s = time.perf_counter() - held["t"]
    finally:
        rcp.train_generator = train_generator
        generator_only._save = save
        decoder.flash_attention = attend
    launches, routes, bwd_routes = dict(flash_attention.launches), dict(flash_fwd.routes), dict(flash_bwd.routes)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    setup = held.pop("setup")
    cfg = setup.model.cfg
    layers, steps, eval_batches = cfg.num_layers, out["steps"], len(setup.valid_blocks)

    check(not (root / "state.pkl").exists(), "rc-pipeline: the generation state file was not removed")
    raw = {f.name: json.loads(f.read_text()) for f in sorted((root / "raw").iterdir())}
    extracted = []
    for name, r in raw.items():
        want = question_and_answer_extractor(r["gen_text"], r["context"])
        check(r["qanda"] == want and name == f"{r['text_identifier']}_{r['index']}.json",
              f"rc-pipeline: {name} holds {r['qanda']}, the extractor gives {want}")
        if want:
            extracted.append(want)
    check(len(raw) == len(calls) and len(calls) >= 2 * RC_DOCS,
          f"rc-pipeline: {len(raw)} unprocessed JSON files for {len(calls)} chunks")
    llm_files = sorted((root / "llm").iterdir())
    check(len(llm_files) == len(extracted), f"rc-pipeline: {len(llm_files)} LLM rows, {len(extracted)} extracted")
    regex = [conv for _, _, conv in RegexBasedReadingComprehension(general, domain).dataset_generator(docs)]
    rows = load_dataset(str(root / "rc_dataset.jsonl"))["messages"]
    key = lambda conv: json.dumps(conv, sort_keys=True)  # noqa: E731
    check(sorted(map(key, rows)) == sorted(map(key, regex + extracted)),
          f"rc-pipeline: {len(rows)} rows written, {len(regex)} regex + {len(extracted)} extracted expected")
    check(np.isfinite(out["final_loss"]) and np.isfinite(out["eval_loss"]) and 2 <= steps <= 4 and eval_batches >= 1
          and layers == 32 and cfg.hidden_size == 4096 and cfg.vocab_size == 32000 and cfg.attention_impl == "flash"
          and cfg.remat and setup.train_blocks.shape[1] == 2560,
          f"rc-pipeline: {out}, {steps} steps, {eval_batches} validation blocks, config {cfg}")
    route = fwd_route(cfg.dtype, cfg.head_dim)
    want = {"fwd": 2 * layers * steps + layers * eval_batches, "dq": layers * steps, "dkv": layers * steps,
            "dsum": layers * steps}
    check(cfg.dtype == torch.float32 and route == "tf32x3" and launches == want
          and routes == {"tf32x3": want["fwd"], "wgmma": 0, "mma": 0}
          and bwd_routes == {"tf32x3": want["dq"], "wgmma": 0, "mma": 0},
          f"rc-pipeline: {cfg.dtype} compute, K4 launches {launches}, routes {routes} / {bwd_routes}; {layers} layers "
          f"predict {want}, every call on the f32 tf32x3 route")
    gen_s = [c["s"] for c in calls]
    step_times = list(np.diff(held.pop("marks")))  # the first holds the first step's set-up on the card
    check(len(step_times) == steps, f"rc-pipeline: {len(step_times)} steps timed, {steps} run")
    step_s = step_times[-1]
    res = dict(wall_s=wall, build_s=build_s, chunks=len(calls), generate_s=gen_s,
               texts_missed=len(raw) - len(extracted), regex_rows=len(regex), rows=len(rows), sft_s=sft_s, steps=steps,
               eval_batches=eval_batches,
               step_s=step_s, tokens_per_s=2560 / step_s, peak_gib=peak_gib, final_loss=out["final_loss"],
               eval_loss=out["eval_loss"], save_s=saves, step_times=step_times, route=route, launches=launches)
    print(f"[rc-pipeline] pipeline('mistral-7b', SynthMode.BOTH) ({layers} layers, width {cfg.hidden_size}, heads "
          f"{cfg.num_heads}/{cfg.kv_heads} x {cfg.head_dim}, bf16 parameters, {str(cfg.dtype)[6:]} compute) ({smi}): "
          f"{wall:.1f} s (generator built in {build_s:.1f} s first); LLM RC {len(calls)} chunks at "
          f"{np.mean(gen_s):.2f} s a chunk ({min(gen_s):.2f}-{max(gen_s):.2f}; batch 8 x 1024 tokens, 96 new), "
          f"{len(raw) - len(extracted)} texts missed; {len(regex)} regex rows; SFT {steps} steps + {eval_batches} "
          f"validation blocks in {sft_s:.1f} s (init and {len(saves)} saves of {sum(saves):.1f} s included): steps "
          f"{', '.join(f'{t:.3f}' for t in step_times)} s, the last = {2560 / step_s:.0f} tokens/s, loss "
          f"{out['final_loss']:.4f}, validation "
          f"{out['eval_loss']:.4f}, peak {peak_gib:.2f} GiB; K4 launches "
          f"{launches} = {layers} x (2 forwards + 1 backward) a step + {layers} forwards a validation block, every one "
          f"on the {route} route (forwards by route {routes}, backwards {bwd_routes})", flush=True)
    del gen, setup, calls
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root)  # the saved checkpoints: the disk is shared with the later phases
    geo = held.pop("geo")
    check(geo["q"] == (1, 2560, cfg.num_heads, cfg.head_dim) and geo["k"] == (1, 2560, cfg.kv_heads, cfg.head_dim)
          and geo["seg"] is not None, f"rc-pipeline: the first attention call's geometry {geo}")
    B, S, H, D = geo["q"]
    records = k4_f32_time(torch_gen, device, peaks, geo, f"rc-pipeline's SFT, B={B} H={H}/{geo['k'][2]} S={S} D={D} "
                          f"f32 causal, window {geo['window']}, segment ids {geo['seg'].unique().tolist()}", 5)
    by_route = {"fwd": routes, "dq": bwd_routes, "dkv": bwd_routes}
    for name, (_, _, kind, mma_name) in K4_TF32.items():  # every call took the tf32x3 route, none the mma.sync one
        records[name]["launches"] = records[name]["launches_rc_pipeline"] = by_route[kind]["tf32x3"]
        records[mma_name]["launches"] = records[mma_name]["launches_rc_pipeline"] = by_route[kind]["mma"]
    records["k4_dsum[f32]"]["launches"] = records["k4_dsum[f32]"]["launches_rc_pipeline"] = launches["dsum"]
    res["phase_s"] = time.perf_counter() - t_all
    print(json.dumps({"rc_pipeline": res}), flush=True)
    return records, res


KERNEL_SOURCES = ("topk", "int8_matmul", "flash_attention", "flash_fwd_wgmma", "flash_bwd_wgmma", "flash_tf32",
                  "int4_matmul", "int4_prefill")
TRAIN_BATCH = 18
TRAIN_STEPS = 4
SFT_BATCH = 2
SFT_STEPS = 3
PHASES = ("small", "serve", "serve-q", "serve-cb", "serve-stream", "serve-http", "serve-refresh", "serve-adapter", "k3",
          "k2", "k1", "grad", "k4", "k5", "train-small", "train", "train-dycal", "train-live", "train-merge",
          "train-retriever", "sft-small", "sft", "eval-retriever", "eval-rag", "eval-ar", "cli", "families-small",
          "serve-llama31", "sft-gemma2", "serve-moe", "serve-mla", "sft-moe", "datagen-small", "qa-gen",
          "rc-pipeline")
LIVE_K = 4  # marginalize_k of the train-live cell
EXTRA_PHASES = ("profile", "profile-sft", "profile-serve")  # run only when named
PHASE_S = {}  # wall seconds of each phase of this run, for the cuts of depth in PERF.md


@contextlib.contextmanager
def timed(phase):
    """Adds the block's wall seconds to ``PHASE_S[phase]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_S[phase] = PHASE_S.get(phase, 0.0) + time.perf_counter() - t0


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases to run (default: all, which the result line needs)")
    ap.add_argument("--seed", type=int, default=0, help="seed of serve-cb's and serve-stream's per-request budgets")
    ap.add_argument("--eval-rows", type=int, default=EVAL_ROWS,
                    help="rows of eval-retriever's f32 run (the published test set has 200,000)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES) - set(EXTRA_PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    started = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from dalm_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    peaks = peaks_for(torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    build.build_all(KERNEL_SOURCES)  # one nvcc per source, started together
    print(f"[build] kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
    for name in KERNEL_SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    for name in ("flash_fwd_wgmma", "flash_bwd_wgmma"):  # K4's D-256 wgmma instances: no spill, no serialised wgmma
        log = build.build_log(name)
        for fn, info in ptxas_counts(log).items():
            if re.search(r"fa_(fwd|bwd)_wgmma_kernelILi256E", fn):
                print(f"[build] {name}: D-256 instance {fn}: {info['line']}; {info['used']}", flush=True)
                check(info["spill"] == 0, f"ptxas spilled {info['spill']} bytes in {fn}")
                check(not any("Performance Loss" in ln and fn in ln for ln in log.splitlines()),
                      f"ptxas serialised the wgmma of {fn}")

    gen = torch.Generator(device=device).manual_seed(0)
    kernels = {}
    if "small" in phases:
        with timed("small"):
            small_pipeline_agrees(device)
            small_quant_agrees(device)
    base_pipe = None
    if "serve" in phases:
        with timed("serve"):
            base_pipe = serve_phase(device, np.random.default_rng(0), peaks, kernels)
    k5_launches, cb_launches, stream_launches, int4_pipe = {}, {}, {}, None
    http_launches, refresh_launches, adapter_launches, stream_s = {}, {}, {}, None
    if base_pipe is None and {"serve-q", "serve-cb", "serve-stream", "serve-http", "serve-refresh",
                              "profile-serve"} & set(phases):
        from dalm_tpu_torch.serve import RagPipeline

        base_pipe = RagPipeline.from_pretrained("bge-large", "llama2-7b", corpus(16384, np.random.default_rng(0)),
                                                dtype="bfloat16", device=device, max_passage_len=128,
                                                max_prompt_len=256, max_new_tokens=64, embed_batch=256)
    if "serve-q" in phases:
        with timed("serve-q"):
            k5_launches, _, int4_pipe = serve_q_phase(device, np.random.default_rng(0), base_pipe)
    if int4_pipe is None and {"serve-cb", "serve-stream", "serve-http", "profile-serve"} & set(phases):
        int4_pipe = int4_pipeline(device, base_pipe)
    if "serve-cb" in phases:
        with timed("serve-cb"):
            cb_launches, _ = serve_cb_phase(device, int4_pipe, args.seed)
    if "serve-stream" in phases:
        with timed("serve-stream"):
            stream_launches, stream_out = serve_stream_phase(device, int4_pipe, args.seed)
            stream_s = stream_out["d_s"]
    if "serve-http" in phases:
        with timed("serve-http"):
            http_launches, _ = serve_http_phase(device, int4_pipe, args.seed, stream_s)
    if "profile-serve" in phases:
        with timed("profile-serve"):
            profile_serve_phase(device, int4_pipe)
    if "serve-refresh" in phases:
        with timed("serve-refresh"):
            refresh_launches, _ = serve_refresh_phase(device, base_pipe)
    passages = base_pipe.passages if base_pipe is not None else None
    del base_pipe, int4_pipe
    gc.collect()
    torch.cuda.empty_cache()
    if "serve-adapter" in phases:  # a 7B of its own: after the serve cell's pipelines are freed
        with timed("serve-adapter"):
            adapter_launches, _ = serve_adapter_phase(device, passages or corpus(16384, np.random.default_rng(0)))
            gc.collect()
            torch.cuda.empty_cache()
    llama31_launches = {}
    if "serve-llama31" in phases:  # an 8B of its own, likewise
        with timed("serve-llama31"):
            llama31_launches, _ = serve_llama31_phase(device, passages or corpus(16384, np.random.default_rng(0)),
                                                      peaks, smi)
    moe_launches, mla_launches = {}, {}
    if "serve-moe" in phases:  # a 30B of its own, after the 8B is freed
        with timed("serve-moe"), cut_depth("serve-moe"):
            moe_launches, _ = serve_moe_phase(device, passages or corpus(16384, np.random.default_rng(0)), peaks,
                                              smi)
    if "serve-mla" in phases:
        with timed("serve-mla"):
            mla_launches, _ = serve_mla_phase(device, passages or corpus(16384, np.random.default_rng(0)), peaks, smi)
    if "k3" in phases:
        with timed("k3"):
            cases, reps = k3_phase(gen, device, peaks)
            print(json.dumps({"k3_cases": cases}), flush=True)
            for mode, entry in reps.items():  # the modes the serving path does not run, at N = 1M, k = 4
                kernels[entry["name"]] = dict(entry, launches=kernels.get("_k3_launches", {}).get(mode, 0))
    kernel_ms, eval_cases, eval_launches = {}, [], {}
    if "k2" in phases:
        with timed("k2"):
            cases, main_entry = k2_phase(gen, device, peaks)
            print(json.dumps({"k2_cases": cases}), flush=True)
            kernels["rowquant"] = main_entry
            kernel_ms.update({("rowquant", e["K"]): e["ms"] for e in cases if e["case"].startswith(f"R={M_TRAIN} ")})
    if "k1" in phases:
        with timed("k1"):
            cases, mains = k1_phase(gen, device, peaks)
            cal_cases, cal_mains = k1_cal_phase(gen, device, peaks)
            print(json.dumps({"k1_cases": cases + cal_cases}), flush=True)
            kernels.update(mains)
            kernels.update(cal_mains)
            kernel_ms.update({(e["name"], tuple(e["KN"])): e["ms"] for e in cases})
    if "grad" in phases:
        with timed("grad"):
            grad_phase(gen, device)
    if "k4" in phases:
        with timed("k4"):
            cases, mains = k4_phase(gen, device, peaks, SFT_BATCH)
            d256 = k4_d256_time(gen, device, peaks)
            print(json.dumps({"k4_cases": cases + list(d256.values())}), flush=True)
            kernels.update(mains)
            kernels.update(d256)
    if "k5" in phases:
        with timed("k5"):
            cases, mains, k5_ms = k5_phase(gen, device, peaks)
            # K5 per decode step of Llama-2-7B: 32 layers x (q, k, v, o at (4096, 4096), gate and up at (4096, 11008),
            # down at (11008, 4096)) + lm_head at (4096, 32000), each at the kernel's own time at M = 32
            per_step = {inst: 32 * (4 * k5_ms[inst, 4096, 4096, 32] + 2 * k5_ms[inst, 4096, 11008, 32]
                                    + k5_ms[inst, 11008, 4096, 32]) + k5_ms[inst, 4096, 32000, 32]
                        for inst in ("base", "groupmm", "nf4", "i8mxu", "pcol")}
            print(f"[serve-q] K5's device time per decode step (225 fused launches: 32 x (4 x (4096, 4096) + 2 x (4096, "
                  f"11008) + (11008, 4096)) + (4096, 32000), each at its [k5] time at M=32), ms by instance: "
                  + ", ".join(f"{i} {v:.3f}" for i, v in per_step.items()), flush=True)
            print(json.dumps({"k5_cases": cases}), flush=True)
            print(json.dumps({"k5_prefill": k5_prefill_phase(gen, device, peaks)}), flush=True)
            g8_recs, g8_entry = k5_group8_time(gen, device, peaks, smi)
            print(json.dumps({"k5_group8": g8_recs}), flush=True)
            kernels[K5_G8] = g8_entry
            for key, e in mains.items():
                kernels[e["name"]] = dict(e, launches=k5_launches.get(key, 0)) if "serve-q" in phases else e
    with tempfile.TemporaryDirectory() as workdir:
        if "train-small" in phases:
            with timed("train-small"):
                train_small_phase(device, workdir)
        if "train" in phases:
            with timed("train"):
                full = "k1" in phases and "k2" in phases
                _, dynamic = train_phase(device, workdir, TRAIN_BATCH, TRAIN_STEPS, kernel_ms if full else None,
                                         a8_calibrate_every=0)
                launches, flagship = train_phase(device, workdir, TRAIN_BATCH, TRAIN_STEPS, None)
                print(f"[train] step time, flagship (a8_calibrate_every=16) {flagship['avg_step_time']:.3f} s against "
                      f"a8_calibrate_every=0 {dynamic['avg_step_time']:.3f} s in the same run "
                      f"({flagship['avg_step_time'] / dynamic['avg_step_time'] - 1:+.1%}); with one calibration forward "
                      f"({flagship['calibration_s'] * 1e3:.1f} ms) every 16 steps, {flagship['amortised_step_time']:.3f} s "
                      f"({flagship['amortised_step_time'] / dynamic['avg_step_time'] - 1:+.1%})", flush=True)
                for name, n in launches.items():
                    if name == "k5_pcol_gemm":  # the scaled GEMM: its main path is serving; here the calibrated route
                        if name in kernels:
                            kernels[name]["launches_train"] = n
                    elif name in kernels and name != "k1_cal_quant[dy]":
                        kernels[name]["launches"] = n
        if "train-dycal" in phases:
            with timed("train-dycal"):
                launches = train_dycal_phase(device, workdir, TRAIN_BATCH, TRAIN_STEPS)
                if "k1_cal_quant[dy]" in kernels:
                    kernels["k1_cal_quant[dy]"]["launches"] = launches["k1_cal_quant[dy]"]
        if "train-live" in phases:
            with timed("train-live"):
                train_live_phase(device, workdir, TRAIN_BATCH, TRAIN_STEPS, k=LIVE_K)
        if "train-merge" in phases:
            with timed("train-merge"):
                train_merge_phase(device, workdir, TRAIN_BATCH, TRAIN_STEPS)
        if "train-retriever" in phases:
            with timed("train-retriever"):
                train_retriever_phase(device, workdir, TRAIN_STEPS)
        if "sft-small" in phases:
            with timed("sft-small"):
                sft_small_phase(device, workdir)
        if "sft" in phases:
            with timed("sft"):
                k4_ms = {name: kernels[name]["ms"] for name in K4_AT} if "k4" in phases else None
                launches = sft_phase(device, workdir, SFT_BATCH, SFT_STEPS, k4_ms)
                for name, n in launches.items():
                    if name in kernels:
                        kernels[name]["launches"] = n
        if "sft-gemma2" in phases:
            with timed("sft-gemma2"):
                launches, _ = sft_gemma2_phase(device, workdir, smi)
                for name, n in launches.items():
                    if name in kernels:
                        kernels[name]["launches"] = n
        if "sft-moe" in phases:
            with timed("sft-moe"):
                launches, _ = sft_moe_phase(device, workdir, smi)
                for name, n in launches.items():
                    if name in kernels:
                        kernels[name]["launches_sft_moe"] = n
        if "datagen-small" in phases:
            with timed("datagen-small"):
                datagen_small_phase(device, workdir, smi)
        if "qa-gen" in phases:
            with timed("qa-gen"):
                qa_gen_phase(device, workdir, smi)
        if "rc-pipeline" in phases:
            with timed("rc-pipeline"):
                records, _ = rc_pipeline_phase(device, workdir, smi, gen, peaks)
                kernels.update(records)
        if "families-small" in phases:
            with timed("families-small"):
                fam = families_small_phase(device, workdir, smi)
                if K5_G8 in kernels:  # its main path: Gemma3-1B int4 at 32 rows
                    kernels[K5_G8]["launches"] = fam["presets"]["gemma3-1b"]["k5_group8_launches"].get("base", 0)
        if "eval-retriever" in phases:
            with timed("eval-retriever"):
                with cut_depth("eval-retriever"):
                    by_mode, recs, _ = eval_retriever_phase(device, peaks, smi, args.eval_rows)
                eval_cases += list(recs.values())
                eval_launches["launches_eval_retriever"] = {f"fused_dot_topk[{m}]": n[m] for m, n in by_mode.items()}
        if "eval-rag" in phases:
            with timed("eval-rag"):
                with cut_depth("eval-rag"):
                    k3, _ = eval_rag_phase(device, smi)
                eval_launches["launches_eval_rag"] = {"fused_dot_topk[f32]": k3["f32"]}
        if "eval-ar" in phases:
            with timed("eval-ar"):
                with cut_depth("eval-ar"):
                    parts, rec, ar = eval_ar_phase(device, workdir, peaks, smi)
                eval_cases.append(rec)
                pipe = parts["pipeline"]
                eval_launches["launches_eval_ar"] = {
                    "fused_dot_topk[f32]": parts["eval"]["f32"] + pipe["fused_dot_topk[f32]"],
                    **{k: pipe[k] for k in ("int4_matmul[base]", "k5_prefill_dequant[base]", "k5_prefill_gemm")},
                    **parts["train_e2e"]}
                eval_launches["launches_eval_ar_retriever"] = dict(ar["train_e2e"]["by_tower"]["retriever"])
        if "cli" in phases:
            with timed("cli"):
                with cut_depth("cli"):
                    k3, _ = cli_phase(device, workdir, smi)
                eval_launches["launches_cli"] = {"fused_dot_topk[f32]": k3["f32"]}
        if eval_cases:
            print(json.dumps({"k3_eval_cases": eval_cases}), flush=True)
        if "profile" in phases:
            with timed("profile"):
                profile_phase(device, workdir, "profile", TRAIN_BATCH, TRAIN_STEPS)
        if "profile-sft" in phases:
            with timed("profile-sft"):
                profile_phase(device, workdir, "profile-sft", SFT_BATCH, SFT_STEPS)
    kernels.pop("_k3_launches", None)
    if set(phases) != set(PHASES):
        print(f"chip_smoke: ran only {phases}; no result line", flush=True)
        return 0
    k5_names = [f"int4_matmul[{i}]" for i in ("base", "groupmm", "nf4", "i8mxu", "pcol")]
    k5_names += [K5_G8, "k5_prefill_dequant[base]", "k5_prefill_dequant[nf4]", "k5_prefill_gemm", "k5_prefill_nibbles",
                 "k5_fold_gemm[groupmm]", "k5_fold_gemm[i8mxu]", "rowquant[bf16]", "k5_prefill_nibbles[int8]",
                 "k5_pcol_gemm"]
    k1_names = ["w8a8_fused", "k1_quant_prepass", "k1_weight_prepass", "k1_gemm", "k1_cal_quant", "k1_cal_quant[dy]"]
    order = ("fused_dot_topk[f32]", "fused_dot_topk[bf16]", "fused_dot_topk[int8]", "fused_dot_topk[int4]",
             "rowquant", *k1_names, "int8_gemm_kn", "int8_gemm_nt", *K4_ENTRY, *K4_F32, *K4_TF32, *K4_D256,
             *k5_names)
    for name, n in cb_launches.items():  # PR 15's main path: answer_continuous() (serve-cb (c))
        if name in kernels:
            kernels[name]["launches_serve_cb"] = n
    for name, n in stream_launches.items():  # speculative decoding and streaming (serve-stream)
        if name in kernels:
            kernels[name]["launches_serve_stream"] = n
    for key, counts in (("launches_serve_http", http_launches), ("launches_serve_refresh", refresh_launches),
                        ("launches_serve_adapter", adapter_launches),
                        ("launches_serve_llama31", llama31_launches), ("launches_serve_moe", moe_launches),
                        ("launches_serve_mla", mla_launches)):  # the rest of serving, Llama-3.1, MoE, MLA
        for name, n in counts.items():
            if name in kernels:
                kernels[name][key] = n
    for key, counts in eval_launches.items():  # the evals, the autoregressive retriever, the CLI
        for name, n in counts.items():
            if name in kernels:
                kernels[name][key] = n
    for mode in ("int8", "int4"):  # their main path: the search of a rebuilt quantised index (serve-refresh (b))
        kernels[f"fused_dot_topk[{mode}]"]["launches"] = refresh_launches[f"fused_dot_topk[{mode}]"]
    line = [kernels[name] for name in order]
    for e in line:
        check("launches" in e, f"{e['name']}: no launch count from its main path")
    for name in ("fused_dot_topk[f32]", "fused_dot_topk[int8]", "fused_dot_topk[int4]", "rowquant", *k1_names,
                 "int8_gemm_nt", "k4_fwd_wgmma", "k4_bwd_dq_wgmma",
                 "k4_bwd_dkv_wgmma", "k4_dsum", *(p[0] for p in K4_D256_PAIRS), *k5_names):
        check(kernels[name]["launches"] > 0, f"{name} was never launched on its main path")
    for name in ("int4_matmul[base]", "k5_prefill_dequant[base]", "k5_prefill_gemm", "fused_dot_topk[f32]"):
        for key in ("launches_serve_llama31", "launches_serve_moe", "launches_serve_mla"):
            check(kernels[name][key] > 0, f"{name} was never launched by {key[9:].replace('_', '-')}")
    for name in ("k4_fwd_wgmma", "k4_bwd_dq_wgmma", "k4_bwd_dkv_wgmma", "k4_dsum"):
        check(kernels[name]["launches_sft_moe"] > 0, f"{name} was never launched by sft-moe")
    for name in (*K4_TF32, "k4_dsum[f32]"):  # the pipeline's SFT in f32 at head dim 128: the tf32x3 route
        check(kernels[name]["launches_rc_pipeline"] > 0, f"{name} was never launched by rc-pipeline")
    for name in ("fused_dot_topk[f32]", "int4_matmul[base]", "k5_prefill_dequant[base]", "k5_prefill_gemm"):
        check(kernels[name]["launches_serve_stream"] > 0, f"{name} was never launched by serve-stream")
        check(kernels[name]["launches_serve_http"] > 0, f"{name} was never launched by serve-http")
        check(kernels[name]["launches_serve_adapter"] > 0, f"{name} was never launched by serve-adapter")
    check(kernels["fused_dot_topk[f32]"]["launches_serve_refresh"] > 0, "K3 f32 was never launched by serve-refresh")
    check(kernels["k5_pcol_gemm"].get("launches_train", 0) > 0, "the scaled GEMM was never launched by train")
    for mode in ("f32", "int8", "int4"):
        check(kernels[f"fused_dot_topk[{mode}]"]["launches_eval_retriever"] > 0, f"K3 {mode} never ran in eval-retriever")
    check(kernels["fused_dot_topk[f32]"]["launches_eval_rag"] > 0, "K3 never ran in eval-rag")
    check(kernels["fused_dot_topk[f32]"]["launches_eval_ar"] > 0, "K3 never ran at D 4096 in eval-ar")
    check(kernels["k1_cal_quant"]["launches_eval_ar_retriever"] > 0, "the retriever tower never took the calibrated "
                                                                    "route in eval-ar")
    print(f"[done] every phase passed in {time.perf_counter() - started:.1f} s", flush=True)
    print(f"[time] seconds by phase: {json.dumps({k: round(v, 2) for k, v in PHASE_S.items()})}", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
