#!/usr/bin/env python3
"""Time K3 at the serving path's shape and K2 at the train and decode shapes on one GPU, in the tree this is run
from, so that two commits can be compared on the same card in turns::

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    for t in parent change change parent; do
        d=.; [ $t = parent ] && d=build/parent
        (cd $d && python3 /path/to/this/checkout/kernel_ab.py $t)
    done

Each line is ``[ab <tag>] <kernel> <shape>: <ms>``: device time per call by CUDA graph, each call on its own copy
of its operands (together over twice the 50 MB L2, so every call reads from device memory), 3 rounds over the
copies captured once, replayed once to warm and then timed over 5 replays. K3 is the f32 index of
``RagPipeline.answer``'s search (32 queries, 16,384 rows of 1024, k 4 and 10); K2 is ``launch_rowquant`` on bf16
rows, 4608 x 4096 and 4608 x 11008 with the column scale (the int8 backward of a train step) and 32 x 4096 and
32 x 11008 without (K5's i8mxu / pcol instances at decode). Exits non-zero without a CUDA device."""

import os
import sys

import torch


def graph_ms(fns, reps: int = 3) -> float:
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
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (5 * reps * len(fns))


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())  # the tree under test, not this script's
    from dalm_tpu_torch.kernels import int8_matmul as im
    from dalm_tpu_torch.kernels import topk

    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def unit(n, d):
        x = torch.randn((n, d), generator=gen, device=dev)
        return x / x.norm(dim=1, keepdim=True)

    q = unit(32, 1024)
    index = [unit(16384, 1024) for _ in range(3)]
    for k in (4, 10):
        ms = graph_ms([lambda e=e: topk.fused_dot_topk(q, e, k) for e in index])
        print(f"[ab {tag}] K3 f32 Q=32 N=16384 D=1024 k={k}: {ms:.4f} ms", flush=True)
    del index
    for R, K, scaled in ((4608, 4096, True), (4608, 11008, True), (32, 4096, False), (32, 11008, False)):
        x = torch.randn((R, K), generator=gen, device=dev).to(torch.bfloat16)
        cs = torch.rand(K, generator=gen, device=dev) * 0.01 + 1e-4 if scaled else None
        xs = [x] + [x.clone() for _ in range(-(-100_000_000 // (R * K * 3)))]
        outs = [(torch.empty(x.shape, dtype=torch.int8, device=dev), torch.empty((R, 1), device=dev)) for _ in xs]
        ms = graph_ms([lambda a=a, o=o: im.launch_rowquant(a, cs, *o) for a, o in zip(xs, outs)])
        print(f"[ab {tag}] K2 R={R} K={K} bf16{' colscale' if scaled else ''}: {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
