#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``dalm_tpu_torch/csrc/``,
holds each against its plain PyTorch version on the card, then drives the
serving path once at full width: ``RagPipeline`` with a bge-large
retriever and a Llama-2-7B generator, random-initialised from a seed in
bf16, over a 16,384-passage synthetic corpus. Fails (non-zero exit, no
result line) without a CUDA device, without the repository beside it, or
if any phase fails.

Output: per-phase lines, one ``{"k3_cases": [...]}`` JSON line (every
K3 case measured), the card's name and power limit, one
``{"kernels": [...]}`` JSON line (one entry per K3 row storage mode, with
its launches in the main path's ``answer()``), and as the last line
``{"ok": true, "device": {...}}``.

Tolerances: K3 on exact-arithmetic inputs (small integers times powers of
two, so every partial sum is exact in f32 whatever the order) must match
the plain version exactly, ids and scores. On unit-norm float inputs and
on the pipeline's own embeddings, scores agree within 1e-5 and ids are
equal except where two rows' f64 scores lie within 1e-5 of each other
(a near tie that f32 sums in another order may resolve either way).
"""

from __future__ import annotations

import json
import string
import subprocess
import sys
import time
from pathlib import Path

NEAR_TIE = 1e-5

# Published peaks (NVIDIA data sheets; dense rates). memory B/s, f32
# CUDA-core FLOP/s, bf16 tensor-core FLOP/s. A name without "PCIe" or
# "NVL" is taken as the SXM part.
PEAKS = {
    "PCIe": (2.0e12, 51e12, 756e12),
    "NVL": (3.9e12, 60e12, 835e12),
    "SXM": (3.35e12, 67e12, 989e12),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def peaks_for(name: str) -> tuple:
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


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


def k3_record(mode, case, ms, plain_ms, lib_ms, max_err, nbytes, ops, mem_bw, op_rate):
    """One measured K3 case, in the kernels line's keys (without ``launches``).
    ``mode`` is the row storage: f32, bf16, int8 or int4."""
    t_bytes = nbytes / mem_bw * 1e3
    t_ops = ops / op_rate * 1e3
    return {
        "name": f"fused_dot_topk[{mode}]", "route": "cuda", "source": "dalm_tpu_torch/csrc/topk.cu",
        "replaces": "dalm_tpu/kernels/topk.py:130", "case": case,
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
    }


def k3_phase(gen, device, peaks):
    """K3 at N = 1,048,576 rows x D = 1024, Q = 32, all storage modes.
    Returns (one record per case, in order; {mode: its k = 4 record} for
    the modes the main path does not run)."""
    import torch

    from dalm_tpu_torch.index.dense import quantize_int4
    from dalm_tpu_torch.kernels.topk import _dequantized_rows, fused_dot_topk, fused_dot_topk_ref

    N, D, Q = 1 << 20, 1024, 32
    mem_bw, f32_rate, bf16_rate = peaks

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
              f"({entry['bound_by']}), max_abs_err {max_err}, near-tie swaps {swaps}", flush=True)
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


def main_path(device, rng):
    """bge-large + Llama-2-7B RagPipeline at full width, bf16, one timed answer()."""
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

    # K3 at the main path's own shapes.
    q, e = q_embs, pipe.index.embeddings
    ms = cuda_ms(lambda: fused_dot_topk(q, e, 4), 50)
    plain_ms = cuda_ms(lambda: fused_dot_topk_ref(q, e, 4), 20)
    lib_ms = cuda_ms(lambda: torch.topk(q @ e.T, 4), 50)
    return launches, (q, e, ms, plain_ms, lib_ms)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
    build.build("topk")
    print(f"[build] kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in build.build_log("topk").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    gen = torch.Generator(device=device).manual_seed(0)
    small_pipeline_agrees(device)
    launches, (q, e, ms, plain_ms, lib_ms) = main_path(device, np.random.default_rng(0))
    Q, D = q.shape
    N = e.shape[0]
    from dalm_tpu_torch.kernels.topk import fused_dot_topk, fused_dot_topk_ref

    ks, ki = fused_dot_topk(q, e, 4)
    rs, ri = fused_dot_topk_ref(q, e, 4)
    max_err, _ = compare_topk(ks, ki, rs, ri, q, e, None)
    nbytes = N * D * 4 + Q * D * 4 + Q * 4 * 8
    main_entry = k3_record("f32", f"main path Q={Q} N={N} D={D} k=4", ms, plain_ms, lib_ms, max_err,
                           nbytes, 2.0 * Q * N * D, peaks[0], peaks[1])
    print(f"[k3] main-path shape f32 Q={Q} N={N} D={D} k=4: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {lib_ms:.4f} ms, bound {main_entry['bound_ms']:.4f} ms ({main_entry['bound_by']})", flush=True)
    del q, e, ks, ki, rs, ri
    import gc

    gc.collect()
    torch.cuda.empty_cache()

    cases, reps = k3_phase(gen, device, peaks)
    # One entry per kernel instantiation (row storage mode): f32 at the main
    # path's shape, the others (which the main path does not run) at N = 1M,
    # k = 4. ``launches`` is each mode's count from the main path's answer().
    reps["f32"] = main_entry
    kernels = [dict(reps[m], launches=launches[m]) for m in ("f32", "bf16", "int8", "int4")]
    print(json.dumps({"k3_cases": cases}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
