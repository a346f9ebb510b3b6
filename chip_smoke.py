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
steps) and generator SFT (``train_generator`` on a synthetic chat dataset,
Llama-2-7B, LoRA r = 256 in the merge runtime, packed blocks of 2560 tokens,
batch 2, 3 optimiser steps and a validation pass, every attention call
through the flash-attention kernels); and serves again with the generator
packed to 4 bits (``RagPipeline(quantize_generator="int4", kv_quant=True)``,
every projection through the int4 kernel K5, then nf4, int4pc and the
i8mxu / groupmm variants). Fails (non-zero exit, no result line)
without a CUDA device, without the repository beside it, or if any phase
fails. ``--phases`` runs a subset while developing and prints no result line.

Phases: ``small`` (tiny pipeline, card vs CPU; and a tiny pipeline wide
enough for K5 in int4, nf4 and int4pc with the int8 KV cache), ``serve``,
``serve-q`` (the 4-bit tiers; reuses ``serve``'s bf16 pipeline when both
run), ``k3``, ``k2``, ``k1`` (K1, its three launches one by one, and the two
int8 GEMM entries), ``grad``,
``k4`` (flash attention: the forward on both routes, the wgmma kernel for
bf16 at head dim 64 / 128 and the mma.sync kernel for the rest; dq, dk/dv), ``k5`` (the five K5 instances;
K5's prefill route for base and nf4, its pre-pass and wgmma GEMM, against the
fused kernel forced on the same operands, and the two routes' crossover by
rows),
``train-small`` (tiny ``train_e2e``, card vs CPU),
``train``, ``sft-small`` (tiny ``train_generator``, card vs CPU), ``sft``;
and, only when named, ``profile`` / ``profile-sft`` (a ``torch.profiler``
trace of the RAG / SFT training steps: device busy share and the top kernels
by device time).

Output: per-phase lines, one JSON line of every measured case per kernel
phase (``k3_cases``, ``k2_cases``, ``k1_cases``, ``k4_cases``, ``k5_cases``),
the card's name and power limit, one ``{"kernels": [...]}`` JSON line (one
entry per K3 row storage mode, K2, K1 and each of its three launches (the
quantise pre-pass, the weight pre-pass, the GEMM), each GEMM entry, each K4 kernel (the
forward's wgmma route ``k4_fwd_wgmma`` and mma.sync route ``k4_fwd``, each with its own
launches, dq, dk/dv), each of the five K5 instances and the prefill route's pre-pass (base,
nf4) and GEMM, each with its launches in its
main path: ``answer()`` for K3, the ``train_e2e`` run for the int8 kernels,
the ``train_generator`` run for K4, the 4-bit tier's own ``answer()`` for each
K5 instance, every count set to 0 just before that path is driven), and as
the last line ``{"ok": true, "device": {...}}``.

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
tiny K5 pipeline's beside ``SMALL_Q_TOL``.
"""

from __future__ import annotations

import gc
import json
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


def show(tag, e):
    lib = "n/a" if e["library_ms"] is None else f"{e['library_ms']:.4f} ms"
    print(f"[{tag}] {e['name']} {e['case']}: kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, library {lib}, "
          f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}), max_abs_err {e['max_abs_err']}", flush=True)


M_TRAIN = 4608  # generator rows of one train step: batch 18 x 256 tokens
LLAMA_KN = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))  # q/k/v/o, gate/up, down, lm_head
K2_AT = "dalm_tpu/kernels/int8_matmul.py:72"
K1_AT = "dalm_tpu/kernels/int8_matmul.py:194"
DOT_AT = "dalm_tpu/kernels/int8_matmul.py:237"


def k2_phase(gen, device, peaks):
    """K2 against ``rowquant_ref``: q and s must be EQUAL (tolerance 0; the
    kernel divides and rounds as the plain version does). R = 4608 rows,
    K in {4096, 11008, 32000}, bf16 and f32, with and without the column
    scale; row 0 all zero, row 1 made of exact .5 ties. Returns
    (all records, the record at the main path's commonest shape)."""
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
                rq, rs = rowquant_ref(x, colscale)
                torch.cuda.synchronize()
                label = f"R={R} K={K} {str(dtype).split('.')[-1]}{' colscale' if colscale is not None else ''}"
                check(torch.equal(s, rs), f"k2 {label}: scales differ from the plain version")
                check(torch.equal(q, rq), f"k2 {label}: q differs from the plain version")
                if colscale is None:
                    check(float(s[0]) == 1.0 and not bool(q[0].any()), f"k2 {label}: zero row")
                    check(float(s[1]) == 1.0, f"k2 {label}: tie row scale")
                    want = torch.round(ties).clamp(-127, 127).to(torch.int8)
                    check(torch.equal(q[1], want), f"k2 {label}: ties must round half to even")
            if dtype != torch.bfloat16:
                continue
            csf = cs.reshape(-1).contiguous()
            ms = cuda_ms(lambda: rowquant(x, csf), 20)
            plain_ms = cuda_ms(lambda: rowquant_ref(x, cs), 5)

            def library():
                xf = x.float() * cs
                sc = xf.abs().amax(-1, keepdim=True) / 127.0
                return torch.round(xf / sc).clamp(-127, 127).to(torch.int8), sc

            lib_ms = cuda_ms(library, 5)
            nbytes = R * K * 2 + K * 4 + R * K + R * 4
            e = i8_record("rowquant", K2_AT, f"R={R} K={K} bf16 colscale", ms, plain_ms, lib_ms, 0.0,
                          nbytes, 4.0 * R * K, peaks, K=K)
            show("k2", e)
            entries.append(e)
            if K == 4096:
                main_entry = e
            del x
    torch.cuda.empty_cache()
    return entries, main_entry


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
         "k4_bwd_dq": "dalm_tpu/kernels/flash_attention.py:443", "k4_bwd_dkv": "dalm_tpu/kernels/flash_attention.py:461"}
# The forward's two routes (kernels/flash_attention.py:fwd_route) by their entry in the kernels line: C entry
# point and source.
K4_FWD = {"k4_fwd_wgmma": ("dalm_fa_fwd_wgmma", "dalm_tpu_torch/csrc/flash_fwd_wgmma.cu"),
          "k4_fwd": ("dalm_fa_fwd", "dalm_tpu_torch/csrc/flash_attention.cu")}
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


def k4_ops_bytes(B, H, Hk, Sq, Sk, D, esize, q_offset, causal):
    """The work the kernels NEED on these inputs: the visible share of the (Sq, Sk) scores times
    2 Sq Sk D per product (forward 2 products, either route; dq 3: s, dp, dq; dk/dv 4: s, dp, dv, dk),
    and each input read and output written once."""
    vis = 1.0
    if causal:
        rows = [min(max(q_offset + i + 1, 0), Sk) for i in range(Sq)]
        vis = sum(rows) / float(Sq * Sk)
    prod = 2.0 * B * H * Sq * Sk * D * vis
    qb, kb, stat = B * H * Sq * D * esize, B * Hk * Sk * D * esize, B * H * Sq * 4
    fwd = (2 * prod, 2 * qb + 2 * kb + stat)
    return {"k4_fwd_wgmma": fwd, "k4_fwd": fwd,
            "k4_bwd_dq": (3 * prod, 3 * qb + 2 * kb + 2 * stat),
            "k4_bwd_dkv": (4 * prod, 2 * qb + 4 * kb + 2 * stat)}


def k4_time(gen, device, peaks, B, S, label, iters):
    """Times of the kernels at (B, H = 32, S, D = 128), bf16, causal, all tokens in one segment (what a
    packed SFT block gives): the forward on both routes, each launched through its own C entry point on
    one argument block and timed in turns (wgmma, mma.sync, mma.sync, wgmma), the dq and dk/dv kernels;
    beside the plain versions, one library call (SDPA, is_causal) and the bound. Both forwards are held
    against the plain version here."""
    import torch
    import torch.nn.functional as F

    from dalm_tpu_torch.kernels import flash_attention as fa

    H = Hk = 32
    D = 128
    q, k, v, do, _, _ = k4_inputs(gen, device, torch.bfloat16, B, H, Hk, S, S, D, None)
    seg = torch.ones((B, S), dtype=torch.int32, device=device)
    kw = dict(causal=True, scale=1.0 / D ** 0.5)
    check(fa.fwd_route(q.dtype, D) == "wgmma", "k4: bf16 at D 128 must take the wgmma route")
    out, lse = fa.flash_fwd(q, k, v, seg, seg, **kw)
    ro, rl = fa.flash_fwd_ref(q, k, v, seg, seg, **kw)
    dims = fa._check("time", q, k, v, seg, seg, None, None)
    mma_out, mma_lse = torch.empty_like(out), torch.empty_like(lse)
    a_mma = fa._args(q, k, v, seg, seg, True, kw["scale"], 0, None, None, dims, out=mma_out, lse=mma_lse)
    fa._launch("dalm_fa_fwd", "fwd", a_mma, q)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, seg, seg, **kw)
    rq, rk, rv = fa.flash_bwd_ref(q, k, v, out, lse, do, seg, seg, **kw)
    torch.cuda.synchronize()
    tol = K4_TOL["bfloat16"]
    K4_SHARE[0] = 0.0
    errs = {"k4_fwd_wgmma": max(k4_err(out, ro, tol["out"], f"{label} out"),
                                k4_err(lse, rl, tol["lse"], f"{label} lse")),
            "k4_fwd": max(k4_err(mma_out, ro, tol["out"], f"{label} mma.sync out"),
                          k4_err(mma_lse, rl, tol["lse"], f"{label} mma.sync lse")),
            "k4_bwd_dq": k4_err(dq, rq, tol["grad"], f"{label} dq"),
            "k4_bwd_dkv": max(k4_err(dk, rk, tol["grad"], f"{label} dk"), k4_err(dv, rv, tol["grad"], f"{label} dv"))}
    share = K4_SHARE[0]
    del ro, rl, rq, rk, rv

    a_wg = fa._args(q, k, v, seg, seg, True, kw["scale"], 0, None, None, dims, out=out, lse=lse)
    turns = {"k4_fwd_wgmma": [], "k4_fwd": []}
    for name in ("k4_fwd_wgmma", "k4_fwd", "k4_fwd", "k4_fwd_wgmma"):
        a, entry = a_wg if name == "k4_fwd_wgmma" else a_mma, K4_FWD[name][0]
        turns[name].append(cuda_ms(lambda: fa._launch(entry, "fwd", a, q), iters))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    a = fa._args(q, k, v, seg, seg, True, kw["scale"], 0, None, None, dims, dout=do, lse=lse,
                 dsum=(do.float() * out.float()).sum(dim=-1).contiguous(), dq=dq, dk=dk, dv=dv)
    ms["k4_bwd_dq"] = cuda_ms(lambda: fa._launch("dalm_fa_bwd_dq", "dq", a, q), iters)
    ms["k4_bwd_dkv"] = cuda_ms(lambda: fa._launch("dalm_fa_bwd_dkv", "dkv", a, q), iters)
    dsum_ms = cuda_ms(lambda: (do.float() * out.float()).sum(dim=-1), iters)
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
    for name in ("k4_fwd_wgmma", "k4_fwd", "k4_bwd_dq", "k4_bwd_dkv"):
        ops, nbytes = work[name]
        t_ops, t_bytes = ops / peaks[2] * 1e3, nbytes / peaks[0] * 1e3
        fwd = name in K4_FWD
        entries[name] = {
            "name": name, "route": "cuda",
            "source": K4_FWD[name][1] if fwd else "dalm_tpu_torch/csrc/flash_attention.cu",
            "replaces": K4_AT[name], "case": label, "max_abs_err": errs[name],
            "ms": ms[name], "plain_ms": plain_f if fwd else plain_b,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_f if fwd else lib_b,
            "library_is": "SDPA forward" if fwd else "SDPA backward: dq, dk and dv in one call, "
                          "the work of k4_bwd_dq + k4_bwd_dkv + dsum together",
            "tflops": ops / ms[name] / 1e9,
        }
    entries["k4_fwd_wgmma"]["turns_ms"] = turns["k4_fwd_wgmma"]
    entries["k4_fwd"]["turns_ms"] = turns["k4_fwd"]
    lib_tflops = work["k4_fwd"][0] / lib_f / 1e9
    w, m = entries["k4_fwd_wgmma"], entries["k4_fwd"]
    print(f"[k4] {label}: forward, wgmma route {w['ms']:.4f} ms ({w['tflops']:.1f} TFLOP/s; turns "
          f"{', '.join(f'{t:.4f}' for t in turns['k4_fwd_wgmma'])}), mma.sync route {m['ms']:.4f} ms "
          f"({m['tflops']:.1f} TFLOP/s; turns {', '.join(f'{t:.4f}' for t in turns['k4_fwd'])}): the wgmma route "
          f"{m['ms'] / w['ms']:.2f}x faster; SDPA {lib_f:.4f} ms ({lib_tflops:.1f} TFLOP/s), wgmma / SDPA "
          f"{w['ms'] / lib_f:.2f}; plain {plain_f:.3f} ms; bound {w['bound_ms']:.4f} ms ({w['bound_by']}, "
          f"{work['k4_fwd'][0] / 1e9:.1f} GFLOP)", flush=True)
    print(f"[k4] {label}: backward dq {ms['k4_bwd_dq']:.4f} ms ({entries['k4_bwd_dq']['tflops']:.1f} TFLOP/s) + "
          f"dk/dv {ms['k4_bwd_dkv']:.4f} ms ({entries['k4_bwd_dkv']['tflops']:.1f} TFLOP/s) (+ dsum reduction "
          f"{dsum_ms:.4f} ms), plain (all three gradients) {plain_b:.3f} ms, SDPA backward (all three gradients, "
          f"one call, graph built outside the timing) {lib_b:.4f} ms, bounds {entries['k4_bwd_dq']['bound_ms']:.4f} "
          f"/ {entries['k4_bwd_dkv']['bound_ms']:.4f} ms; max errors {errs}, the worst row at {share:.3f} of its "
          f"bound ({tol['out']} x max(row max, {K4_FLOOR}))", flush=True)
    torch.cuda.empty_cache()
    return entries


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
    """K4 (forward, dq, dk/dv) against its plain versions on the card, every
    case in bf16 and f32 at ``K4_TOL``, each forward on its route (bf16 at D 64 /
    128 on the wgmma kernel, the rest on the mma.sync kernel, counted by route);
    fully masked rows must give out = 0, lse = -1e30 and zero gradients exactly;
    two key halves must merge into the full result; a bf16 D 128 call whose
    tensor map the driver refuses must raise without falling back. Then the
    kernels' times at the SFT shape and at the RAG trainer's. Returns (all timed
    records, the records at the SFT shape)."""
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
            dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, seg_q, seg_k, **kw)
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
            print(f"[k4] {what}: B={B} H={H} Hk={Hk} Sq={Sq} Sk={Sk} D={D}, forward on the {route} route; max errors "
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

    # K3 at the main path's own shapes.
    q, e = q_embs, pipe.index.embeddings
    ms = cuda_ms(lambda: fused_dot_topk(q, e, 4), 50)
    plain_ms = cuda_ms(lambda: fused_dot_topk_ref(q, e, 4), 20)
    lib_ms = cuda_ms(lambda: torch.topk(q @ e.T, 4), 50)
    return pipe, launches, (q, e, ms, plain_ms, lib_ms)


TRAIN_KW = dict(use_peft="both", lora_runtime="fused", int8_compute="all", a8_calibrate_every=0,
                num_warmup_steps=0, with_tracking=False)


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
              per_device_train_batch_size=4, learning_rate=1e-3, lr_scheduler_type="constant", seed=3)
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
    torch.cuda.empty_cache()


def train_phase(device, workdir, batch, steps, kernel_ms):
    """The training main path: ``train_e2e`` on a synthetic CSV, bge-large +
    Llama-2-7B at full width and depth, bf16, fused QLoRA, int8 generator
    base, ``int8_compute="all"``, dynamic per-row activation quant,
    Q/P/G = 50/128/256. Two epochs of ``steps / 2`` batches: the trainer's
    throughput meter leaves the first epoch (warm-up) out of its average.
    Returns the launches of each int8 kernel in that run."""
    import gc

    import numpy as np
    import torch

    from dalm_tpu_torch.kernels import int8_matmul as im
    from dalm_tpu_torch.train import train_e2e

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
            for k, v in getattr(setup.rag, sub).state_dict().items() if f"{sub}.{k}" not in setup.state.params
        }

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counted = {"rowquant": im.rowquant, "w8a8_fused": im.w8a8_fused, "k1_quant_prepass": im.quant_prepass,
               "k1_weight_prepass": im.weight_prepass, "k1_gemm": im.fold_gemm, "int8_gemm_kn": im.int8_gemm_kn,
               "int8_gemm_nt": im.int8_gemm_nt}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = train_e2e(csv_path, "bge-large", "llama2-7b", dtype="bfloat16", use_bnb="generator",
                    query_max_len=50, passage_max_len=128, generator_max_len=256,
                    per_device_train_batch_size=batch, num_train_epochs=2, seed=0,
                    retriever_tokenizer="byte@30522", generator_tokenizer="byte@32000",
                    device=device, setup_hook=snapshot, **TRAIN_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_steps = out["steps"]
    check(n_steps == 2 * per_epoch and n_steps >= 3, f"took {n_steps} optimiser steps")
    for key in ("final_loss", "final_retriever_loss", "final_generator_loss"):
        check(np.isfinite(out[key]), f"train: {key} is not finite")

    setup = held["setup"]
    layers = setup.rag.generator_config.num_layers
    # Per step: every packed linear (7 per layer + lm_head) once forward and
    # the layers' once more in the checkpointed recompute, each call K1's
    # three launches; in the backward one K2 + one dx GEMM per linear whose
    # input needs a gradient (all but layer 0's q/k/v, which read the frozen
    # embeddings).
    k1 = (14 * layers + 1) * n_steps
    want = {"rowquant": (7 * layers - 2) * n_steps, "w8a8_fused": k1, "k1_quant_prepass": k1,
            "k1_weight_prepass": k1, "k1_gemm": k1, "int8_gemm_kn": 0, "int8_gemm_nt": (7 * layers - 2) * n_steps}
    check(launches == want, f"train: launches {launches}, the layer count predicts {want}")
    unchanged = [k for k, p in setup.state.params.items() if torch.equal(p.detach(), held["trainable"][k])]
    check(not unchanged, f"train: {len(unchanged)} trainable tensors did not change, e.g. {unchanged[:3]}")
    for sub in ("retriever", "generator"):
        for k, v in getattr(setup.rag, sub).state_dict().items():
            name = f"{sub}.{k}"
            if name in held["frozen"]:
                check(v.double().sum().item() == held["frozen"][name], f"train: frozen {name} changed")
    per_step = {k: v // n_steps for k, v in launches.items()}
    print(f"[train] bge-large + llama2-7b ({layers} layers), batch {batch}, Q/P/G 50/128/256, bf16, fused QLoRA, "
          f"int8 generator base, int8_compute=all: {n_steps} optimiser steps in {wall:.1f} s (init included); "
          f"step time {out['avg_step_time']:.3f} s = {out['samples_per_sec']:.2f} samples/s (second epoch); "
          f"losses total/retriever/generator {out['final_loss']:.4f}/{out['final_retriever_loss']:.4f}/"
          f"{out['final_generator_loss']:.4f}; peak memory {peak_gib:.2f} GiB; launches per step {per_step}; "
          f"{len(held['trainable'])} trainable tensors all changed, {len(held['frozen'])} frozen unchanged", flush=True)
    if kernel_ms:
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
    return launches



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
    forward launches and 2 dq and 2 dk/dv launches a step."""
    import numpy as np
    import torch

    from dalm_tpu_torch.kernels.flash_attention import flash_attention
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
        card = train_generator(model_dir, data, max_train_blocks=4 * steps, device=device, setup_hook=give, **kw)
        launches = dict(flash_attention.launches)
        check(card["steps"] == cpu["steps"] == steps, f"sft-small: took {card['steps']} steps, wanted {steps}")
        for key in ("final_loss", "eval_loss"):
            check(np.isfinite(card[key]), f"sft-small: {key} is not finite")
            worst = max(worst, abs(card[key] - cpu[key]))
            check(abs(card[key] - cpu[key]) <= SFT_SMALL_TOL, f"sft-small step {steps}: {key} {card[key]} vs CPU {cpu[key]}")
        layers = base.cfg.num_layers
        evals = launches["fwd"] - 2 * layers * steps  # the validation pass at the end: one forward per layer and batch
        check(launches["dq"] == launches["dkv"] == layers * steps and evals > 0 and evals % layers == 0,
              f"sft-small step {steps}: K4 launches {launches}")
        print(f"[sft-small] {steps} step(s): card loss {card['final_loss']:.6f} / eval {card['eval_loss']:.6f}, CPU "
              f"{cpu['final_loss']:.6f} / {cpu['eval_loss']:.6f}; K4 launches {launches} "
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
    the launches of the K4 kernels in that run: the forward by route, dq, dk/dv."""
    import gc

    import numpy as np
    import torch

    from dalm_tpu_torch.kernels.flash_attention import flash_attention, flash_fwd
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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_generator("llama2-7b", data, per_device_train_batch_size=batch, per_device_eval_batch_size=batch,
                          max_train_blocks=batch * steps, device=device, setup_hook=snapshot, **SFT_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = dict(flash_attention.launches), dict(flash_fwd.routes)
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
    # recompute, one dq and one dk/dv launch in the backward; per validation batch one forward a layer.
    eval_batches = len(range(0, len(setup.valid_blocks) - batch + 1, batch))
    want = {"fwd": 2 * layers * n_steps + layers * eval_batches, "dq": layers * n_steps, "dkv": layers * n_steps}
    check(eval_batches >= 1 and launches == want, f"sft: K4 launches {launches}, {layers} layers predict {want}")
    check(routes == {"wgmma": want["fwd"], "mma": 0}, f"sft: forward launches by route {routes}: every one of the "
          f"{want['fwd']} bf16 D {cfg.hidden_size // cfg.num_heads} forwards must take the wgmma route")
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
          f"peak memory {peak_gib:.2f} GiB; K4 launches per step fwd {2 * layers} dq {layers} dkv {layers} "
          f"(+ {layers} fwd per validation batch), total {launches}, the forward's by route {routes}; "
          f"{len(held['trainable'])} LoRA factors all "
          f"changed, {len(held['frozen'])} base tensors unchanged", flush=True)
    if k4_ms:
        k4 = (2 * k4_ms["k4_fwd_wgmma"] + k4_ms["k4_bwd_dq"] + k4_ms["k4_bwd_dkv"]) * layers
        print(f"[sft] one step = {step_s * 1e3:.0f} ms; K4 at its measured times x launches = {k4:.0f} ms "
              f"({100 * k4 / (step_s * 1e3):.1f}% of the step); the rest is the torch.matmul projections, the "
              f"LoRA merges, norms, rope, loss, optimiser and host (see --phases profile-sft)", flush=True)
    held.clear()
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    return {"k4_fwd_wgmma": routes["wgmma"], "k4_fwd": routes["mma"], "k4_bwd_dq": launches["dq"],
            "k4_bwd_dkv": launches["dkv"]}


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


def k5_prefill_phase(gen, device, peaks):
    """The prefill route beyond the Llama shapes: base and nf4 on ragged shapes (M from M_PREFILL up, N no
    multiple of 128, groups 16-128) against the plain version, counted per route; the two routes timed by rows
    at two Llama shapes (the crossover that sets M_PREFILL). Returns the crossover records."""
    import torch

    from dalm_tpu_torch.kernels import int4_matmul as k5
    from dalm_tpu_torch.models import quant

    worst = {}
    for M, K, N, group in ((k5.M_PREFILL, 1024, 136, 64), (300, 2048, 1000, 128), (1000, 11008, 264, 16),
                           (8192, 4096, 136, 32), (8192, 11008, 11008, 16)):
        w = torch.randn((K, N), generator=gen, device=device) * 0.02
        for inst, qz in (("base", quant.quantize_tensor_int4), ("nf4", quant.quantize_tensor_nf4)):
            d = qz(w, group)
            check(K // d["scale4"].shape[0] == group, f"k5 prefill: group {group} at K={K}")
            x = (torch.randn((M, K), generator=gen, device=device) * 0.5).to(torch.bfloat16)
            x[0] = 0
            before = k5.int4_matmul_fwd.route_launches[inst, "prefill"]
            y = k5.int4_matmul_fwd(x, d["q4"], d["scale4"], inst)
            ry = k5.int4_matmul_fwd_ref(x, d["q4"], d["scale4"], inst)
            torch.cuda.synchronize()
            check(k5.int4_matmul_fwd.route_launches[inst, "prefill"] == before + 1, f"k5 prefill {inst}: route not taken")
            check(tuple(y.shape) == (M, N) and not bool(y[0].any()), f"k5 prefill {inst}: shape / zero row")
            worst[inst] = max(worst.get(inst, 0.0), k5_err(y, ry, inst)[1])
            del x, y, ry
        del w
    print(f"[k5] prefill route on ragged shapes (M {k5.M_PREFILL}-8192, N 136-11008, groups 16-128, bf16): base and "
          f"nf4 within their tolerance; worst share of the bound {worst}", flush=True)

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    crossover = []
    for K, N in ((4096, 4096), (11008, 4096)):
        d = quant.quantize_tensor_int4(torch.randn((K, N), generator=gen, device=device) * 0.02)
        group = K // d["scale4"].shape[0]
        wt = torch.empty((N, K), dtype=torch.bfloat16, device=device)
        row = []
        for M in (32, 64, 128, 192, 256, 384, 512, 1024, 2048):
            x = (torch.randn((M, K), generator=gen, device=device) * 0.5).to(torch.bfloat16)
            out = torch.empty((M, N), dtype=torch.bfloat16, device=device)
            splits = k5._splits(M, N, K // 2, group, "base", sms)
            ws = torch.empty((splits, M, N), dtype=torch.float32, device=device) if splits > 1 else None
            fused = cuda_ms(lambda: k5.launch("base", x, None, d["q4"], d["scale4"], group, splits, ws, out), 20)
            pre = cuda_ms(lambda: (k5.launch_dequant(d["q4"], d["scale4"], group, False, wt),
                                   k5.launch_gemm(x, wt, out)), 20)
            row.append({"M": M, "fused_ms": fused, "prefill_ms": pre})
        first = next((r["M"] for r in row if r["prefill_ms"] < r["fused_ms"]), None)
        crossover.append({"K": K, "N": N, "group": group, "rows": row, "prefill_faster_from_M": first})
        print(f"[k5] crossover K={K} N={N} (base, bf16), ms fused / prefill by M: "
              + ", ".join(f"{r['M']}: {r['fused_ms']:.4f} / {r['prefill_ms']:.4f}" for r in row)
              + f"; prefill faster from M = {first}; M_PREFILL = {k5.M_PREFILL}", flush=True)
        del d, wt

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
                # the kernels alone on operands prepared once (K2's rowquant for i8mxu / pcol outside the timing),
                # then the wrapper as the model calls it (checks, allocation, K2)
                g_arg = K if inst == "pcol" else group
                route = k5._route(x, inst)
                splits = k5._splits(M, N, K // 2, g_arg, inst, sms)
                a, xs = k5.rowquant(x) if inst in ("i8mxu", "pcol") else (x, None)
                o = torch.empty((M, N), dtype=x.dtype, device=device)
                ws = torch.empty((splits, M, N), dtype=torch.float32, device=device) if splits > 1 else None
                ms = cuda_ms(lambda: k5.launch(inst, a, xs, q4, s4, g_arg, splits, ws, o), iters)
                # the fused kernel's own output, also where int4_matmul_fwd took the prefill route above
                fused_err, fused_share = k5_err(o, ry, inst)
                del ry
                extra = {}
                if route == "prefill":
                    extra, prefill_records = prefill_timing(k5, quant, x, d, fmt, inst, group, w_bf16[fmt], o, ms,
                                                            peaks)
                    extra.update(prefill_max_abs_err=max_err, prefill_worst_share_of_tolerance=share)
                    entries.extend(prefill_records)
                    if (K, N) == (4096, 4096):
                        for r in prefill_records:
                            mains.setdefault(r["name"], r)
                wrapper_ms = cuda_ms(lambda: k5.int4_matmul_fwd(x, q4, s4, inst), iters)
                plain_ms = cuda_ms(lambda: k5.int4_matmul_fwd_ref(x, q4, s4, inst), 2)
                wb = w_bf16[fmt]
                lib_ms = cuda_ms(lambda: x @ wb, iters)
                deq_ms = cuda_ms(lambda: x @ quant.dequantize_tensor_int4(d, torch.bfloat16), max(iters // 5, 2))
                nbytes = a.numel() * a.element_size() + (M * 4 if xs is not None else 0) + q4.numel() + s4.numel() * 4 + M * N * 2
                ops = 2.0 * M * K * N
                t_bytes, t_ops = nbytes / mem_bw * 1e3, ops / (int8_rate if inst in ("i8mxu", "pcol") else bf16_rate) * 1e3
                e = {"name": f"int4_matmul[{inst}]", "route": "cuda", "source": "dalm_tpu_torch/csrc/int4_matmul.cu",
                     "replaces": K5_AT[inst], "case": f"M={M} K={K} N={N} group={group if inst != 'pcol' else K} bf16",
                     "max_abs_err": fused_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": lib_ms,
                     "library_is": "x @ W_bf16 (torch.matmul on the weight dequantised beforehand: the bf16 tier)",
                     "dequant_matmul_ms": deq_ms, "wrapper_ms": wrapper_ms, "splits": splits,
                     "worst_share_of_tolerance": fused_share, "k5_route": route, **extra}
                show("k5", e)
                print(f"[k5]   route {route}; through int4_matmul_fwd (checks, allocation{', K2' if xs is not None else ''}): "
                      f"{wrapper_ms:.4f} ms; K split in {splits}", flush=True)
                entries.append(e)
                ms_at[inst, K, N, M] = ms
                del a, xs, o, ws
                if (K, N, M) == (4096, 4096, 32):
                    mains[inst] = e
            print(f"[k5]   M={M} K={K} N={N}: x @ dequantize_tensor_int4(...) (dequant + cuBLAS) "
                  f"{entries[-1]['dequant_matmul_ms']:.4f} ms (int4pc weights)", flush=True)
            del x, xf
        del fmts, w_bf16
        torch.cuda.empty_cache()
    return entries, mains, ms_at


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
    int4pc, and int4 with ``DEFAULT_VARIANT`` i8mxu and groupmm; the last-position logits of each tier against
    the bf16 generator's; a sampled ``answer()`` that repeats. Returns the K5 launches of each instance in its
    own ``answer()`` and the decode times."""
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
        saved = k5._kernel_feasible, k5._pcol_feasible
        if fallback:
            k5._kernel_feasible = k5._pcol_feasible = lambda *a: False
        try:
            return q.generator(p_ids, p_mask, logits_last_only=True).float()
        finally:
            k5._kernel_feasible, k5._pcol_feasible = saved

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
        k5.prefill_dequant.launches = dict.fromkeys(k5.PREFILL_INSTANCES, 0)
        k5.prefill_gemm.launches = 0
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
        prefill route for base / nf4, the rest (lm_head at 32 rows, 63 decode forwards) on the fused kernel."""
        routes = k5.int4_matmul_fwd.route_launches
        pre = 7 * layers if inst in k5.PREFILL_INSTANCES else 0
        got = {r: routes[inst, r] for r in k5.ROUTES}
        check(got == {"prefill": pre, "fused": want - pre} and sum(routes.values()) == want,
              f"serve-q {label}: K5 routes {got}, want {pre} prefill and {want - pre} fused")
        dq = k5.prefill_dequant.launches
        check(dq == {i: pre if i == inst else 0 for i in k5.PREFILL_INSTANCES} and k5.prefill_gemm.launches == pre,
              f"serve-q {label}: prefill kernels launched {dq}, {k5.prefill_gemm.launches} times, want {pre} each")
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
    launches["base"] = routes["fused"]  # the fused kernel's own launches; the prefill route's are the new kernels
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
    first = build_greedy_generate(gen, 1, eos_token_id=q.g_tok.eos_token_id, pad_token_id=q.g_tok.pad_token_id or 0)
    first(p_ids, p_mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first(p_ids, p_mask)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    m_prefill = k5.M_PREFILL
    k5.M_PREFILL = 1 << 30  # the same prefill with every projection on the fused kernel
    try:
        first(p_ids, p_mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first(p_ids, p_mask)
        torch.cuda.synchronize()
        prefill_fused_s = time.perf_counter() - t0
    finally:
        k5.M_PREFILL = m_prefill
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
            launches[variant] = check_routes(variant, variant)["fused"]
            err, err_fb = logit_err(q, variant)
        finally:
            k5.DEFAULT_VARIANT = "base"
        check(counts[variant] == want and sum(counts.values()) == want, f"serve-q {variant}: K5 launches {counts}")
        check(k2 == (want if variant == "i8mxu" else 0), f"serve-q {variant}: {k2} K2 launches")
        out[f"{variant}_answer_s"] = dt
        print(f"[serve-q] int4 with DEFAULT_VARIANT={variant}: answer() {dt:.3f} s; K5 {variant} launches "
              f"{counts[variant]}, K2 {k2}; logits relative error {err:.4f} against bf16, {err_fb:.4f} against "
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
    del s, q, gen, first
    gc.collect()
    torch.cuda.empty_cache()

    for fmt, inst in (("nf4", "nf4"), ("int4pc", "pcol")):
        q, build_s = tier_pipeline(fmt)
        _, dt, counts, k2 = counted_answer(q)
        check(counts[inst] == want and sum(counts.values()) == want, f"serve-q {fmt}: K5 launches {counts}")
        routes = check_routes(inst, fmt)
        if inst == "nf4":
            launches["k5_prefill_dequant[nf4]"] = k5.prefill_dequant.launches["nf4"]
        err, err_fb = logit_err(q, inst)
        launches[inst] = routes["fused"]
        out[f"{fmt}_answer_s"] = dt
        print(f"[serve-q] {fmt} + int8 KV cache: built in {build_s:.2f} s; answer() {dt:.3f} s (first, not warmed); "
              f"K5 {inst} launches {counts[inst]} (by route {routes}), K2 {k2}; logits relative error {err:.4f} against bf16, "
              f"{err_fb:.4f} against x @ dequant(W)", flush=True)
        del q
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[serve-q] last-position logits, relative error by K5 instance (against bf16, against the same tier "
          f"through x @ dequant(W)): {rels}; bounds {K5_LOGIT_BOUND_BF16} and {K5_LOGIT_BOUND}", flush=True)
    for inst, (err, err_fb) in rels.items():
        check(err <= K5_LOGIT_BOUND_BF16, f"serve-q {inst}: logits relative error {err} against bf16")
        check(inst == "int8" or err_fb <= K5_LOGIT_BOUND[inst],
              f"serve-q {inst}: logits relative error {err_fb} against x @ dequant(W)")
    return launches, out


def serve_phase(device, rng, peaks, kernels):
    """The serving main path, then K3 against its plain version at that path's
    own shapes. Fills ``kernels`` with the f32 record and the launch counts
    of every row storage mode. Returns the bf16 pipeline."""
    import gc

    import torch

    from dalm_tpu_torch.kernels.topk import fused_dot_topk, fused_dot_topk_ref

    pipe, launches, (q, e, ms, plain_ms, lib_ms) = serve_path(device, rng)
    Q, D = q.shape
    N = e.shape[0]
    ks, ki = fused_dot_topk(q, e, 4)
    rs, ri = fused_dot_topk_ref(q, e, 4)
    max_err, _ = compare_topk(ks, ki, rs, ri, q, e, None)
    nbytes = N * D * 4 + Q * D * 4 + Q * 4 * 8
    entry = k3_record("f32", f"main path Q={Q} N={N} D={D} k=4", ms, plain_ms, lib_ms, max_err,
                      nbytes, 2.0 * Q * N * D, peaks[0], peaks[1])
    print(f"[k3] main-path shape f32 Q={Q} N={N} D={D} k=4: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {lib_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms ({entry['bound_by']})", flush=True)
    kernels["fused_dot_topk[f32]"] = dict(entry, launches=launches["f32"])
    kernels["_k3_launches"] = launches
    del q, e, ks, ki, rs, ri
    gc.collect()
    torch.cuda.empty_cache()
    return pipe


KERNEL_SOURCES = ("topk", "int8_matmul", "flash_attention", "flash_fwd_wgmma", "int4_matmul", "int4_prefill")
TRAIN_BATCH = 18
TRAIN_STEPS = 4
SFT_BATCH = 2
SFT_STEPS = 3
PHASES = ("small", "serve", "serve-q", "k3", "k2", "k1", "grad", "k4", "k5", "train-small", "train", "sft-small", "sft")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases to run (default: all, which the result line needs)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES) - {"profile", "profile-sft"})
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
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    gen = torch.Generator(device=device).manual_seed(0)
    kernels = {}
    if "small" in phases:
        small_pipeline_agrees(device)
        small_quant_agrees(device)
    base_pipe = None
    if "serve" in phases:
        base_pipe = serve_phase(device, np.random.default_rng(0), peaks, kernels)
    k5_launches = {}
    if "serve-q" in phases:
        if base_pipe is None:
            from dalm_tpu_torch.serve import RagPipeline

            base_pipe = RagPipeline.from_pretrained("bge-large", "llama2-7b", corpus(16384, np.random.default_rng(0)),
                                                    dtype="bfloat16", device=device, max_passage_len=128,
                                                    max_prompt_len=256, max_new_tokens=64, embed_batch=256)
        k5_launches, _ = serve_q_phase(device, np.random.default_rng(0), base_pipe)
    del base_pipe
    gc.collect()
    torch.cuda.empty_cache()
    if "k3" in phases:
        cases, reps = k3_phase(gen, device, peaks)
        print(json.dumps({"k3_cases": cases}), flush=True)
        for mode, entry in reps.items():  # the modes the serving path does not run, at N = 1M, k = 4
            kernels[entry["name"]] = dict(entry, launches=kernels.get("_k3_launches", {}).get(mode, 0))
    kernel_ms = {}
    if "k2" in phases:
        cases, main_entry = k2_phase(gen, device, peaks)
        print(json.dumps({"k2_cases": cases}), flush=True)
        kernels["rowquant"] = main_entry
        kernel_ms.update({("rowquant", e["K"]): e["ms"] for e in cases})
    if "k1" in phases:
        cases, mains = k1_phase(gen, device, peaks)
        print(json.dumps({"k1_cases": cases}), flush=True)
        kernels.update(mains)
        kernel_ms.update({(e["name"], tuple(e["KN"])): e["ms"] for e in cases})
    if "grad" in phases:
        grad_phase(gen, device)
    if "k4" in phases:
        cases, mains = k4_phase(gen, device, peaks, SFT_BATCH)
        print(json.dumps({"k4_cases": cases}), flush=True)
        kernels.update(mains)
    if "k5" in phases:
        cases, mains, _ = k5_phase(gen, device, peaks)
        print(json.dumps({"k5_cases": cases}), flush=True)
        print(json.dumps({"k5_prefill": k5_prefill_phase(gen, device, peaks)}), flush=True)
        for key, e in mains.items():
            kernels[e["name"]] = dict(e, launches=k5_launches.get(key, 0)) if "serve-q" in phases else e
    with tempfile.TemporaryDirectory() as workdir:
        if "train-small" in phases:
            train_small_phase(device, workdir)
        if "train" in phases:
            full = "k1" in phases and "k2" in phases
            launches = train_phase(device, workdir, TRAIN_BATCH, TRAIN_STEPS, kernel_ms if full else None)
            for name, n in launches.items():
                if name in kernels:
                    kernels[name]["launches"] = n
        if "sft-small" in phases:
            sft_small_phase(device, workdir)
        if "sft" in phases:
            k4_ms = {name: kernels[name]["ms"] for name in K4_AT} if "k4" in phases else None
            launches = sft_phase(device, workdir, SFT_BATCH, SFT_STEPS, k4_ms)
            for name, n in launches.items():
                if name in kernels:
                    kernels[name]["launches"] = n
        if "profile" in phases:
            profile_phase(device, workdir, "profile", TRAIN_BATCH, TRAIN_STEPS)
        if "profile-sft" in phases:
            profile_phase(device, workdir, "profile-sft", SFT_BATCH, SFT_STEPS)
    kernels.pop("_k3_launches", None)
    if set(phases) != set(PHASES):
        print(f"chip_smoke: ran only {phases}; no result line", flush=True)
        return 0
    k5_names = [f"int4_matmul[{i}]" for i in ("base", "groupmm", "nf4", "i8mxu", "pcol")]
    k5_names += ["k5_prefill_dequant[base]", "k5_prefill_dequant[nf4]", "k5_prefill_gemm"]
    k1_names = ["w8a8_fused", "k1_quant_prepass", "k1_weight_prepass", "k1_gemm"]
    order = ("fused_dot_topk[f32]", "fused_dot_topk[bf16]", "fused_dot_topk[int8]", "fused_dot_topk[int4]",
             "rowquant", *k1_names, "int8_gemm_kn", "int8_gemm_nt", "k4_fwd_wgmma", "k4_fwd", "k4_bwd_dq", "k4_bwd_dkv",
             *k5_names)
    line = [kernels[name] for name in order]
    for e in line:
        check("launches" in e, f"{e['name']}: no launch count from its main path")
    for name in ("fused_dot_topk[f32]", "rowquant", *k1_names, "int8_gemm_nt", "k4_fwd_wgmma", "k4_bwd_dq",
                 "k4_bwd_dkv", *k5_names):
        check(kernels[name]["launches"] > 0, f"{name} was never launched on its main path")
    print(f"[done] every phase passed in {time.perf_counter() - started:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
