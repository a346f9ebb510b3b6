#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``dalm_tpu_torch/csrc/`` (one
``nvcc`` per source, started together), holds each against its plain PyTorch
version on the card, and drives both main paths once at full width and
depth, bf16, random-initialised from a seed: serving (``RagPipeline`` with a
bge-large retriever and a Llama-2-7B generator over a 16,384-passage
synthetic corpus) and training (``train_e2e`` on a synthetic CSV, fused
QLoRA, int8 generator base, ``int8_compute="all"``, batch 18, 4 optimiser
steps). Fails (non-zero exit, no result line) without a CUDA device, without
the repository beside it, or if any phase fails. ``--phases`` runs a subset
while developing and prints no result line.

Phases: ``small`` (tiny pipeline, card vs CPU), ``serve``, ``k3``, ``k2``,
``k1`` (K1 and the two int8 GEMM entries), ``grad``, ``train-small`` (tiny
``train_e2e``, card vs CPU), ``train``; and, only when named, ``profile``
(a ``torch.profiler`` trace of the training steps: device busy share and the
top kernels by device time).

Output: per-phase lines, one JSON line of every measured case per kernel
phase (``k3_cases``, ``k2_cases``, ``k1_cases``), the card's name and power
limit, one ``{"kernels": [...]}`` JSON line (one entry per K3 row storage
mode, K2, K1 and each GEMM entry, each with its launches in its main path:
``answer()`` for K3, the ``train_e2e`` run for the others), and as the last
line ``{"ok": true, "device": {...}}``.

Tolerances: K3 on exact-arithmetic inputs (small integers times powers of
two, so every partial sum is exact in f32 whatever the order) must match
the plain version exactly, ids and scores. On unit-norm float inputs and
on the pipeline's own embeddings, scores agree within 1e-5 and ids are
equal except where two rows' f64 scores lie within 1e-5 of each other
(a near tie that f32 sums in another order may resolve either way). The
int8 kernels' tolerances stand in their phases' docstrings: K2 and the GEMM
entries equal, K1 equal on integer-valued inputs and within one bf16 ulp on
real-valued ones, gradients equal, tiny training losses within 2e-3.
"""

from __future__ import annotations

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
    Llama-7B shapes, M = 4608. Integer-valued activations: equal. Real-valued
    bf16 activations: within one bf16 ulp of the plain result (2^-7 relative;
    the f32 accumulators follow the same order of operations, so in practice
    equal). The GEMM entries are integer arithmetic: equal. One shape the
    feasibility rule rejects goes through ``int8_matmul`` (K2 + GEMM)."""
    import torch

    from dalm_tpu_torch.kernels import int8_matmul as im

    M = M_TRAIN
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
        err = (y.float() - ry.float()).abs()
        check(bool((err <= ry.float().abs() * 2.0 ** -7 + 1e-6).all()), f"k1 ({K},{N}): above one bf16 ulp")
        max_err = float(err.max())
        xf = x.float()
        yf, ryf = im.w8a8_fused(xf, q, scale), im.w8a8_fused_ref(xf, q, scale)
        check(bool(((yf - ryf).abs() <= ryf.abs() * 1e-6 + 1e-9).all()), f"k1 ({K},{N}) f32: above 1e-6 relative")
        del xf, yf, ryf

        ms = cuda_ms(lambda: im.w8a8_fused(x, q, scale), 10)
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
        deq_ms = cuda_ms(lambda: x @ wd, 10)
        del wd
        nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
        e = i8_record("w8a8_fused", K1_AT, f"M={M} K={K} N={N} bf16", ms, plain_ms, lib_ms, max_err,
                      nbytes, 2.0 * M * K * N, peaks, KN=[K, N], bf16_dequant_matmul_ms=deq_ms)
        show("k1", e)
        print(f"[k1]   x @ dequant(W) in bf16 (torch.matmul): {deq_ms:.4f} ms; "
              f"kernel {2.0 * M * K * N / ms / 1e9:.1f} TOP/s", flush=True)
        entries.append(e)
        if (K, N) == (4096, 4096):
            mains["w8a8_fused"] = e

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
                      M * N + K * N + M * K * 4, 2.0 * M * K * N, peaks, KN=[K, N])
        show("k1", e)
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
    return launches, (q, e, ms, plain_ms, lib_ms)


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
    for fn in (im.rowquant, im.w8a8_fused, im.int8_gemm_kn, im.int8_gemm_nt):
        fn.launches = 0
    t0 = time.perf_counter()
    out = train_e2e(csv_path, "bge-large", "llama2-7b", dtype="bfloat16", use_bnb="generator",
                    query_max_len=50, passage_max_len=128, generator_max_len=256,
                    per_device_train_batch_size=batch, num_train_epochs=2, seed=0,
                    retriever_tokenizer="byte@30522", generator_tokenizer="byte@32000",
                    device=device, setup_hook=snapshot, **TRAIN_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rowquant": im.rowquant.launches, "w8a8_fused": im.w8a8_fused.launches,
                "int8_gemm_kn": im.int8_gemm_kn.launches, "int8_gemm_nt": im.int8_gemm_nt.launches}
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
    # 0's q/k/v, which read the frozen embeddings).
    want = {"w8a8_fused": (14 * layers + 1) * n_steps, "rowquant": (7 * layers - 2) * n_steps,
            "int8_gemm_nt": (7 * layers - 2) * n_steps, "int8_gemm_kn": 0}
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
        k1 = sum(kernel_ms["w8a8_fused", kn] * n * 2 for kn, n in shapes.items()) - kernel_ms["w8a8_fused", (4096, 32000)]
        nt = sum(kernel_ms["int8_gemm_nt", kn] * n for kn, n in shapes.items()) - 3 * kernel_ms["int8_gemm_nt", (4096, 4096)]
        k2 = (kernel_ms["rowquant", 4096] * (5 * layers - 3) + kernel_ms["rowquant", 11008] * 2 * layers
              + kernel_ms["rowquant", 32000])
        step_ms = out["avg_step_time"] * 1e3
        print(f"[train] one step = {step_ms:.0f} ms; kernels at their measured times x launches: K1 {k1:.0f} ms, "
              f"dx GEMM {nt:.0f} ms, K2 {k2:.0f} ms, everything else (retriever, attention, norms, LoRA, loss, "
              f"optimiser, host) {step_ms - k1 - nt - k2:.0f} ms", flush=True)
    held.clear()
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def profile_phase(device, workdir, batch, steps):
    """Not part of the default run: ``--phases profile`` traces the training
    main path's optimiser steps with ``torch.profiler`` (CPU + CUDA
    activities, started when the trainer's setup is done) and prints the
    device's busy share of the wall time and the kernels that take most of
    the device time, per step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dalm_tpu_torch.train import train_e2e

    per_epoch = max(steps // 2, 1)
    csv_path = str(Path(workdir) / "profile.csv")
    write_csv(csv_path, batch * per_epoch, np.random.default_rng(2))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    clock = {}

    def start(setup):
        torch.cuda.synchronize()
        prof.__enter__()
        clock["t0"] = time.perf_counter()

    try:
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
    print(f"[profile] {n} steps under the profiler: wall {wall_ms / n:.0f} ms/step, device busy {busy / n:.0f} ms/step "
          f"= {100 * busy / wall_ms:.1f}% (idle {100 - 100 * busy / wall_ms:.1f}%)", flush=True)
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:25]:
        print(f"[profile] {ms / n:9.2f} ms/step {count // n:6d} launches/step  {key[:110]}", flush=True)
    del prof
    torch.cuda.empty_cache()


def serve_phase(device, rng, peaks, kernels):
    """The serving main path, then K3 against its plain version at that path's
    own shapes. Fills ``kernels`` with the f32 record and the launch counts
    of every row storage mode."""
    import gc

    import torch

    from dalm_tpu_torch.kernels.topk import fused_dot_topk, fused_dot_topk_ref

    launches, (q, e, ms, plain_ms, lib_ms) = serve_path(device, rng)
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


KERNEL_SOURCES = ("topk", "int8_matmul")
TRAIN_BATCH = 18
TRAIN_STEPS = 4
PHASES = ("small", "serve", "k3", "k2", "k1", "grad", "train-small", "train")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases to run (default: all, which the result line needs)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES) - {"profile"})
    if unknown:
        ap.error(f"unknown phases {unknown}")

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
    if "serve" in phases:
        serve_phase(device, np.random.default_rng(0), peaks, kernels)
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
    with tempfile.TemporaryDirectory() as workdir:
        if "train-small" in phases:
            train_small_phase(device, workdir)
        if "train" in phases:
            full = "k1" in phases and "k2" in phases
            launches = train_phase(device, workdir, TRAIN_BATCH, TRAIN_STEPS, kernel_ms if full else None)
            for name, n in launches.items():
                if name in kernels:
                    kernels[name]["launches"] = n
        if "profile" in phases:
            profile_phase(device, workdir, TRAIN_BATCH, TRAIN_STEPS)
    kernels.pop("_k3_launches", None)
    if set(phases) != set(PHASES):
        print(f"chip_smoke: ran only {phases}; no result line", flush=True)
        return 0
    order = ("fused_dot_topk[f32]", "fused_dot_topk[bf16]", "fused_dot_topk[int8]", "fused_dot_topk[int4]",
             "rowquant", "w8a8_fused", "int8_gemm_kn", "int8_gemm_nt")
    line = [kernels[name] for name in order]
    for e in line:
        check("launches" in e, f"{e['name']}: no launch count from its main path")
    for name in ("fused_dot_topk[f32]", "rowquant", "w8a8_fused", "int8_gemm_nt"):
        check(kernels[name]["launches"] > 0, f"{name} was never launched on its main path")
    print(smi, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
