"""K3: fused dot-product + exact top-k over an index's rows.

Replaces ``dalm_tpu/kernels/topk.py:fused_dot_topk`` (Pallas ``_topk_kernel``,
``_topk_kernel_q8``, ``_topk_kernel_q4`` with the shared running top-k
``_fold_and_finalize``). The kernel is hand-written CUDA for ``sm_90a``,
``csrc/topk.cu``; its header says what bounds it on an H100 (the N·D row
bytes, and at Q≈32 in f32 the FMA rate as well) and how its two-pass
design answers that. ``fused_dot_topk_ref`` is the plain PyTorch version
of the same function.

Semantics (both versions): scores are f32; int8 rows are dotted with bf16
queries and × the per-row scale after the dot; int4 rows are half-split
nibbles (byte ``r`` holds column ``r`` low and ``D/2 + r`` high, value
``nibble - 8``) × the row scale; rows ``>= num_valid`` never win; ties go
to the smaller row id; slots never filled hold score ``-inf`` and id 0.
"""

from __future__ import annotations

import ctypes

import torch

# The kernel keeps one top-k entry per lane of a warp.
MAX_K = 32
ROWS_PER_TILE = 128
DEPTH_MULTIPLE = 64
# Row storage → (the kernel's mode number, the name its launches count under).
_MODES = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16"), torch.int8: (2, "int8"), torch.uint8: (3, "int4")}


def _dequantized_rows(embeddings: torch.Tensor, int4: bool) -> torch.Tensor:
    if int4:
        p = embeddings.to(torch.int32)
        return torch.cat([(p & 0xF) - 8, ((p >> 4) & 0xF) - 8], dim=1).float()
    return embeddings.float()


def fused_dot_topk_ref(queries, embeddings, k: int, num_valid=None, scales=None, int4: bool = False):
    """Plain PyTorch K3: masked scores, a stable descending sort (smaller
    id first on ties), the first ``k``. Returns (scores (Q, k) f32,
    ids (Q, k) int32)."""
    n = embeddings.shape[0]
    num_valid = n if num_valid is None else int(num_valid)
    scores = queries.float() @ _dequantized_rows(embeddings, int4).T
    if scales is not None:
        scores = scores * scales.reshape(1, n).float()
    ids = torch.arange(n, device=scores.device)
    scores = torch.where(ids[None, :] < num_valid, scores, torch.tensor(float("-inf"), device=scores.device))
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    s, i = s[:, :k], i[:, :k].to(torch.int32)
    i = torch.where(s == float("-inf"), torch.zeros_like(i), i)
    if s.shape[1] < k:
        pad = k - s.shape[1]
        s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
        i = torch.nn.functional.pad(i, (0, pad), value=0)
    return s, i


_lib_handle = None


def _lib():
    """The built library, with its C signatures declared (once per process)."""
    global _lib_handle
    if _lib_handle is None:
        from dalm_tpu_torch.kernels import build

        lib = build.load("topk")
        lib.dalm_topk_launch.restype = ctypes.c_int
        lib.dalm_topk_launch.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        for fn in ("dalm_topk_max_k", "dalm_topk_rows_per_tile", "dalm_topk_depth_multiple"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = []
        if (lib.dalm_topk_max_k(), lib.dalm_topk_rows_per_tile(), lib.dalm_topk_depth_multiple()) != (
            MAX_K, ROWS_PER_TILE, DEPTH_MULTIPLE,
        ):
            raise RuntimeError("csrc/topk.cu and kernels/topk.py disagree on the kernel's limits")
        _lib_handle = lib
    return _lib_handle


def _check(queries, embeddings, k, scales, int4):
    if queries.device != embeddings.device or (scales is not None and scales.device != queries.device):
        raise ValueError("queries, embeddings and scales must be on one device")
    if queries.dim() != 2 or embeddings.dim() != 2:
        raise ValueError("queries must be (Q, D) and embeddings (N, D) or (N, D/2)")
    q, d = queries.shape
    n = embeddings.shape[0]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the CUDA top-k takes 1 <= k <= {MAX_K}")
    if q < 1 or n < 1:
        raise ValueError("the CUDA top-k needs at least one query and one row")
    if d % DEPTH_MULTIPLE:
        raise ValueError(f"D={d}: the CUDA top-k takes D a multiple of {DEPTH_MULTIPLE}")
    if int4 and scales is None:
        raise ValueError("int4 rows need per-row scales")
    want_cols = d // 2 if int4 else d
    if embeddings.shape[1] != want_cols:
        raise ValueError(f"embeddings are {tuple(embeddings.shape)}; expected (N, {want_cols})")
    if scales is None:
        if embeddings.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"float rows must be float32 or bfloat16, not {embeddings.dtype}")
        if queries.dtype != embeddings.dtype:
            raise TypeError("queries must have the float rows' dtype")
    else:
        want = torch.uint8 if int4 else torch.int8
        if embeddings.dtype != want:
            raise TypeError(f"quantised rows must be {want}, not {embeddings.dtype}")
        if queries.dtype != torch.bfloat16:
            raise TypeError("quantised rows take bfloat16 queries")
        if scales.dtype != torch.float32 or scales.numel() != n:
            raise TypeError("scales must be N float32 values")
    for name, t in (("queries", queries), ("embeddings", embeddings), ("scales", scales)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _chunk_rows(n: int, device: torch.device) -> int:
    """Rows per scan block: enough blocks for about four per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per = -(-n // (4 * sms))
    return max(ROWS_PER_TILE, -(-per // ROWS_PER_TILE) * ROWS_PER_TILE)


def fused_dot_topk(queries, embeddings, k: int, num_valid=None, scales=None, int4: bool = False):
    """Exact top-k inner-product search: (scores (Q, k) f32, ids (Q, k) int32).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise). Layouts: queries (Q, D); rows (N, D) float32/bfloat16,
    (N, D) int8 + (N, 1) float32 scales, or (N, D/2) uint8 half-split
    nibbles + scales with ``int4=True``."""
    if not queries.is_cuda:
        return fused_dot_topk_ref(queries, embeddings, k, num_valid, scales, int4)
    _check(queries, embeddings, k, scales, int4)
    lib = _lib()
    q, d = queries.shape
    n = embeddings.shape[0]
    num_valid = n if num_valid is None else max(0, min(int(num_valid), n))
    chunk = _chunk_rows(n, queries.device)
    n_chunks = -(-n // chunk)
    dev = queries.device
    cand_s = torch.empty((q, n_chunks, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((q, n_chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    mode, mode_name = _MODES[embeddings.dtype]
    err = lib.dalm_topk_launch(
        mode, queries.data_ptr(), embeddings.data_ptr(),
        scales.data_ptr() if scales is not None else None,
        q, n, d, num_valid, k, chunk,
        cand_s.data_ptr(), cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"topk kernel launch failed: CUDA error {err}")
    fused_dot_topk.launches[mode_name] += 1
    return out_s, out_i


# Kernel launches per row storage mode; CPU calls (the plain version) do not count.
fused_dot_topk.launches = {name: 0 for _, name in _MODES.values()}
