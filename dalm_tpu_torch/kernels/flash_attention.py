"""K4: flash attention, forward and backward.

Replaces ``dalm_tpu/kernels/flash_attention.py``: ``_flash_fwd`` (Pallas
``_fwd_kernel``), ``_flash_bwd`` (``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``)
and the ``flash_attention`` custom gradient. The kernels are hand-written
CUDA for ``sm_90a``. The forward and the backward each have three routes, by
one rule (:func:`fwd_route`, a pure function of the input type and the head
dim): for bfloat16 at head dim 64, 128 or 256 the warp-specialised TMA ring and
``wgmma`` kernels of ``csrc/flash_fwd_wgmma.cu`` (forward) and
``csrc/flash_bwd_wgmma.cu`` (dq, dk/dv); for float32 at head dim 64 or 128 the
tensor-core kernels of ``csrc/flash_tf32.cu``, every product split 3xTF32
(``hi = tf32(x)``, ``lo = tf32(x - hi)``, ``lo hi + hi lo + hi hi`` summed in
f32: about f32's accuracy); and for the rest the ``mma.sync`` kernels of
``csrc/flash_attention.cu`` (float32 products exact on the CUDA cores).
``dsum = rowsum(do * out)`` is a hand-written pre-pass of every backward route
(``csrc/flash_bwd_wgmma.cu``).
Each file's header says what bounds its kernels on an H100 and what the
design does about it.
Beside every kernel stands its plain PyTorch version (``*_ref``: dense scores
in f32), which a wrapper takes for CPU tensors only: on a CUDA tensor it
launches the kernel of its route or raises (a route never falls back to the
other).

Semantics (both versions; ``T`` is the input type, bf16 or f32):

- scores ``s = q k^T * scale`` in f32, then ``cap * tanh(s / cap)`` with
  ``softcap``, then the mask: ``causal`` keeps ``q_offset + i >= j`` (query
  row ``i`` sits ``q_offset`` positions after key 0), ``window`` keeps
  ``q_offset + i - j < window``, segment ids keep ``seg_q[i] == seg_k[j]``;
- ``out = softmax(s) v`` with the probabilities cast to ``T`` before the
  product and the normaliser summed in f32; ``lse = log sum exp(s)`` f32. A
  row with no visible key has ``out = 0`` and ``lse = NEG_INF = -1e30`` (finite,
  the neutral element of the merge of two partial results);
- GQA: ``k``/``v`` may have ``Hk`` heads, ``Hk | H``; query head ``h`` reads kv
  head ``h // (H // Hk)`` and ``dk``/``dv`` come back at ``Hk`` heads;
- backward: ``p = exp(s - lse)`` (selected to 0 where masked),
  ``ds = p (do v^T - dsum) [1 - (s / cap)^2] scale`` with
  ``dsum = rowsum(do * out)``, ``dq = ds k``, ``dk = ds^T q``, ``dv = p^T do``,
  ``ds`` and ``p`` cast to ``T`` before their products. ``out``, ``lse`` and
  ``do`` may cover more keys than ``k`` (the global values of a ring pass
  while ``k`` is one chunk): ``p`` is then the true global probability.

``flash_fwd`` / ``flash_bwd`` take the ``(B, H, S, D)`` layout of the JAX
``_flash_fwd`` / ``_flash_bwd``; ``flash_attention`` the ``(B, S, H, D)`` of the
JAX ``flash_attention``. The kernels read strides, so neither layout is ever
copied: only the last axis must be contiguous. Any ``Sq``, ``Sk`` >= 1;
``D`` a multiple of 16 up to 256 (Gemma's 256 on the ``wgmma`` route in bf16,
on ``mma.sync`` in f32). The TPU tiling arguments (``block_q``, ``block_k``,
``interpret``) are not carried over.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30  # finite: fully masked rows stay NaN-free
MAX_HEAD_DIM = 256
HEAD_DIM_MULTIPLE = 16
TILE_ROWS = 64
WGMMA_HEAD_DIMS = (64, 128, 256)
TF32_HEAD_DIMS = (64, 128)  # float32 on the tensor cores (csrc/flash_tf32.cu)

_STRIDED = ("q", "k", "v", "o", "do", "dq", "dk", "dv")


class _Args(ctypes.Structure):
    """Mirror of ``struct Args`` in ``csrc/flash_attention.cuh`` (every field 8 bytes)."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("q", "k", "v", "out", "dout", "dq", "dk", "dv",
                                        "lse", "dsum", "seg_q", "seg_k")]
        + [(f"{n}_{s}", ctypes.c_longlong) for n in _STRIDED for s in ("sb", "sh", "ss")]
        + [(n, ctypes.c_longlong) for n in ("B", "H", "Hk", "Sq", "Sk", "D",
                                            "q_offset", "window", "causal", "is_bf16")]
        + [("scale", ctypes.c_double), ("softcap", ctypes.c_double)]
    )


# C entry point (args, stream) -> the csrc/ source that holds it
_ENTRIES = {"dalm_fa_fwd": "flash_attention", "dalm_fa_bwd_dq": "flash_attention",
            "dalm_fa_bwd_dkv": "flash_attention", "dalm_fa_fwd_wgmma": "flash_fwd_wgmma",
            "dalm_fa_bwd_dq_wgmma": "flash_bwd_wgmma", "dalm_fa_bwd_dkv_wgmma": "flash_bwd_wgmma",
            "dalm_fa_dsum": "flash_bwd_wgmma", "dalm_fa_fwd_tf32": "flash_tf32",
            "dalm_fa_bwd_dq_tf32": "flash_tf32", "dalm_fa_bwd_dkv_tf32": "flash_tf32"}
# the values each library reports of its side of the contract: sizeof(Args) (all), the mma.sync tile rows
_CONTRACT = {"flash_attention": {"dalm_fa_args_bytes": ctypes.sizeof(_Args), "dalm_fa_tile_rows": TILE_ROWS},
             "flash_fwd_wgmma": {"dalm_fa_wgmma_args_bytes": ctypes.sizeof(_Args)},
             "flash_bwd_wgmma": {"dalm_fa_bwd_wgmma_args_bytes": ctypes.sizeof(_Args)},
             "flash_tf32": {"dalm_fa_tf32_args_bytes": ctypes.sizeof(_Args)}}
_libs: dict = {}


def _lib(name: str):
    """The built library ``csrc/<name>.cu``, with its C signatures declared (once per process)."""
    if name not in _libs:
        from dalm_tpu_torch.kernels import build

        lib = build.load(name)
        for fn in (e for e, n in _ENTRIES.items() if n == name):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        if name == "flash_bwd_wgmma":  # encodes the backward's tensor maps, launches nothing
            lib.dalm_fa_bwd_wgmma_maps.restype = ctypes.c_int
            lib.dalm_fa_bwd_wgmma_maps.argtypes = [ctypes.c_void_p]
        for fn, want in _CONTRACT[name].items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = []
            if getattr(lib, fn)() != want:
                raise RuntimeError(f"csrc/{name}.cu and kernels/flash_attention.py disagree on the argument block")
        _libs[name] = lib
    return _libs[name]


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _keep_mask(Sq, Sk, seg_q, seg_k, causal, q_offset, window, device):
    """Bool keep-mask broadcastable to (B, Hk, G, Sq, Sk), or None when everything is visible."""
    keep = None
    if causal or window is not None:
        gq = q_offset + torch.arange(Sq, device=device)[:, None]
        gk = torch.arange(Sk, device=device)[None, :]
        if causal:
            keep = gq >= gk
        if window is not None:
            band = (gq - gk) < window
            keep = band if keep is None else keep & band
        keep = keep[None, None, None]
    if seg_q is not None:
        same = (seg_q[:, :, None] == seg_k[:, None, :])[:, None, None]
        keep = same if keep is None else keep & same
    return keep


def _scores(q, k, seg_q, seg_k, causal, scale, q_offset, window, softcap, ct=torch.float32):
    """Capped scores (B, Hk, G, Sq, Sk) in ``ct`` before masking, the keep-mask, and q grouped by kv head."""
    B, H, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hk, H // Hk, Sq, D).to(ct)
    s = (qg @ k.to(ct)[:, :, None].transpose(-1, -2)) * scale
    if softcap is not None:
        s = torch.tanh(s * (1.0 / softcap)) * softcap
    return s, _keep_mask(Sq, Sk, seg_q, seg_k, causal, q_offset, window, q.device), qg


def flash_fwd_ref(q, k, v, seg_q=None, seg_k=None, *, causal=True, scale=None, q_offset=0, window=None,
                  softcap=None):
    """Plain PyTorch K4 forward on (B, H, S, D): (out in ``q.dtype``, lse (B, H, Sq) f32)."""
    B, H, Sq, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    s, keep, _ = _scores(q, k, seg_q, seg_k, causal, scale, q_offset, window, softcap)
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))  # fully masked rows: p == 0, l == 0
    l = p.sum(dim=-1, keepdim=True)
    out = (p.to(v.dtype).float() @ v.float()[:, :, None]) / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)), torch.full_like(l, NEG_INF))
    return out.reshape(B, H, Sq, D).to(q.dtype), lse.reshape(B, H, Sq)


def dsum_ref(do, out):
    """Plain PyTorch dsum pre-pass: ``rowsum(do * out)`` in f32 (float64 for float64 inputs), (B, H, Sq) from
    (B, H, Sq, D)."""
    ct = torch.promote_types(do.dtype, torch.float32)
    return (do.to(ct) * out.to(ct)).sum(dim=-1)


def flash_bwd_ref(q, k, v, out, lse, do, seg_q=None, seg_k=None, *, causal=True, scale=None, q_offset=0,
                  window=None, softcap=None):
    """Plain PyTorch K4 backward by the formulas (no autograd): (dq, dk, dv) in the input types, the products in
    f32 (float64 inputs: in float64, the exact gradient that a test may hold an f32 kernel to where f32 rounding
    of the plain version itself is the larger error)."""
    B, H, Sq, D = q.shape
    Hk = k.shape[1]
    G = H // Hk
    ct = torch.promote_types(q.dtype, torch.float32)  # the products' type
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    s, keep, qg = _scores(q, k, seg_q, seg_k, causal, scale, q_offset, window, softcap, ct)
    p = torch.exp(s - lse.reshape(B, Hk, G, Sq, 1).to(ct))  # true softmax probabilities (global lse)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))  # selects the overflow of masked rows away
    dog = do.reshape(B, Hk, G, Sq, D).to(ct)
    dsum = dsum_ref(do, out).reshape(B, Hk, G, Sq, 1).to(ct)
    dv = (p.to(do.dtype).to(ct).transpose(-1, -2) @ dog).sum(dim=2)
    dp = dog @ v.to(ct)[:, :, None].transpose(-1, -2)
    ds = p * (dp - dsum)
    if softcap is not None:
        t = s * (1.0 / softcap)  # s is the capped value: tanh' = 1 - (s / cap)^2
        ds = ds * (1.0 - t * t)
    ds = (ds * scale).to(q.dtype).to(ct)
    dq = (ds @ k.to(ct)[:, :, None]).reshape(B, H, Sq, D)
    dk = (ds.transpose(-1, -2) @ qg).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _check(what, q, k, v, seg_q, seg_k, window, softcap, **more):
    """Raise on what the kernels do not take; returns (B, H, Hk, Sq, Sk, D)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what}: q must be (B, H, Sq, D) and k, v (B, Hk, Sk, D) of one shape")
    B, H, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k {tuple(k.shape)} do not agree")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} takes bfloat16 or float32, not {q.dtype}")
    if D % HEAD_DIM_MULTIPLE or not HEAD_DIM_MULTIPLE <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {D} must be a multiple of {HEAD_DIM_MULTIPLE} up to {MAX_HEAD_DIM}")
    if Hk < 1 or H % Hk:
        raise ValueError(f"{what}: {H} query heads are not a multiple of {Hk} kv heads")
    if min(B, Sq, Sk) < 1:
        raise ValueError(f"{what}: empty batch or sequence")
    if (seg_q is None) != (seg_k is None):
        raise ValueError(f"{what}: segment ids must be given for both q and k, or for neither")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be at least 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{what}: softcap must be positive")
    vec = 16 // q.element_size()
    for name, t in dict(q=q, k=k, v=v, **more).items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: {name} must be on the same CUDA device as q")
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, q is {q.dtype}")
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} needs a contiguous last axis and 16-byte aligned rows "
                             f"(strides {t.stride()})")
    for name, seg, n in (("seg_q", seg_q, Sq), ("seg_k", seg_k, Sk)):
        if seg is None:
            continue
        if seg.dtype != torch.int32 or tuple(seg.shape) != (B, n) or not seg.is_contiguous() or seg.device != q.device:
            raise ValueError(f"{what}: {name} must be a contiguous int32 (B, S) tensor on q's device")
    return B, H, Hk, Sq, Sk, D


def _args(q, k, v, seg_q, seg_k, causal, scale, q_offset, window, softcap, dims, **tensors) -> _Args:
    B, H, Hk, Sq, Sk, D = dims
    a = _Args()
    a.q, a.k, a.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    a.seg_q = seg_q.data_ptr() if seg_q is not None else None
    a.seg_k = seg_k.data_ptr() if seg_k is not None else None
    strided = dict(q=q, k=k, v=v)
    for field, t in tensors.items():
        setattr(a, field, t.data_ptr())
        if t.dim() == 4:
            strided[{"out": "o", "dout": "do"}.get(field, field)] = t
    for name, t in strided.items():
        for axis, s in enumerate(("sb", "sh", "ss")):
            setattr(a, f"{name}_{s}", t.stride(axis))
    a.B, a.H, a.Hk, a.Sq, a.Sk, a.D = B, H, Hk, Sq, Sk, D
    a.q_offset, a.window, a.causal = int(q_offset), int(window) if window is not None else 0, int(bool(causal))
    a.is_bf16 = int(q.dtype == torch.bfloat16)
    a.scale = float(scale)
    a.softcap = float(softcap) if softcap is not None else 0.0
    return a


def _error(err: int) -> str:
    return f"a tensor map was refused (CUresult {err - 1000})" if err >= 1000 else (
        "the driver has no tensor-map encoder" if err == 900 else f"CUDA error {err}")


def _launch(fn_name: str, counter: str, a: _Args, like: torch.Tensor) -> None:
    err = getattr(_lib(_ENTRIES[fn_name]), fn_name)(ctypes.byref(a), torch.cuda.current_stream(like.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention {counter} kernel launch failed ({fn_name}): {_error(err)}")
    flash_attention.launches[counter] += 1


def fwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The route a CUDA call takes, forward and backward alike: ``"wgmma"``
    (``csrc/flash_fwd_wgmma.cu``, ``csrc/flash_bwd_wgmma.cu``) for bfloat16 at
    head dim 64, 128 or 256, ``"tf32x3"`` (``csrc/flash_tf32.cu``) for float32
    at head dim 64 or 128, ``"mma"`` (the ``mma.sync`` kernels of
    ``csrc/flash_attention.cu``) for the rest: float32 at the other head dims and
    bfloat16 at the others (129-255 among them, which that route pads to 256)."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "tf32x3" if dtype == torch.float32 and head_dim in TF32_HEAD_DIMS else "mma"


_FWD_ENTRY = {"wgmma": "dalm_fa_fwd_wgmma", "tf32x3": "dalm_fa_fwd_tf32", "mma": "dalm_fa_fwd"}
_BWD_ENTRIES = {"wgmma": ("dalm_fa_bwd_dq_wgmma", "dalm_fa_bwd_dkv_wgmma"),
                "tf32x3": ("dalm_fa_bwd_dq_tf32", "dalm_fa_bwd_dkv_tf32"),
                "mma": ("dalm_fa_bwd_dq", "dalm_fa_bwd_dkv")}


def _empty_like(t: torch.Tensor) -> torch.Tensor:
    """An output with ``t``'s strides where ``t`` is dense (so a (B, S, H, D) caller gets
    that layout back without a copy), else contiguous."""
    out = torch.empty_like(t)
    return out if out.stride(3) == 1 else torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _seg32(seg):
    return None if seg is None else seg.to(torch.int32).contiguous()


def flash_fwd(q, k, v, seg_q=None, seg_k=None, *, causal=True, scale=None, q_offset=0, window=None, softcap=None):
    """(B, H, Sq, D) q and (B, Hk, Sk, D) k, v -> (out like q, lse (B, H, Sq) f32).
    CPU tensors take the plain version; CUDA tensors launch the kernel of
    :func:`fwd_route` (or raise)."""
    if not q.is_cuda:
        return flash_fwd_ref(q, k, v, seg_q, seg_k, causal=causal, scale=scale, q_offset=q_offset,
                             window=window, softcap=softcap)
    seg_q, seg_k = _seg32(seg_q), _seg32(seg_k)
    dims = _check("flash_fwd", q, k, v, seg_q, seg_k, window, softcap)
    B, H, _, Sq, _, D = dims
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = _empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    a = _args(q, k, v, seg_q, seg_k, causal, scale, q_offset, window, softcap, dims, out=out, lse=lse)
    route = fwd_route(q.dtype, D)
    _launch(_FWD_ENTRY[route], "fwd", a, q)
    flash_fwd.routes[route] += 1
    return out, lse


def flash_bwd(q, k, v, out, lse, do, seg_q=None, seg_k=None, *, causal=True, scale=None, q_offset=0, window=None,
              softcap=None):
    """Gradients (dq, dk, dv) of :func:`flash_fwd` for the output gradient ``do``;
    ``dk``/``dv`` at the kv head count. CPU tensors take the plain version; CUDA
    tensors launch the dsum pre-pass, then the dq and dk/dv kernels of
    :func:`fwd_route` (or raise: a ``wgmma`` call whose tensor maps the driver
    refuses raises before its first launch)."""
    if not q.is_cuda:
        return flash_bwd_ref(q, k, v, out, lse, do, seg_q, seg_k, causal=causal, scale=scale, q_offset=q_offset,
                             window=window, softcap=softcap)
    seg_q, seg_k = _seg32(seg_q), _seg32(seg_k)
    dims = _check("flash_bwd", q, k, v, seg_q, seg_k, window, softcap, out=out, do=do)
    B, H, _, Sq, _, D = dims
    if out.shape != q.shape or do.shape != q.shape or tuple(lse.shape) != (B, H, Sq):
        raise ValueError("flash_bwd: out and do must have q's shape and lse must be (B, H, Sq)")
    if lse.dtype != torch.float32 or not lse.is_cuda:
        raise TypeError("flash_bwd: lse must be a float32 CUDA tensor")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    lse = lse.contiguous()
    dsum = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = _empty_like(q), _empty_like(k), _empty_like(v)
    a = _args(q, k, v, seg_q, seg_k, causal, scale, q_offset, window, softcap, dims,
              out=out, dout=do, lse=lse, dsum=dsum, dq=dq, dk=dk, dv=dv)
    route = fwd_route(q.dtype, D)
    if route == "wgmma":
        err = _lib("flash_bwd_wgmma").dalm_fa_bwd_wgmma_maps(ctypes.byref(a))
        if err != 0:
            raise RuntimeError(f"flash attention backward: {_error(err)} (dalm_fa_bwd_wgmma_maps)")
    _launch("dalm_fa_dsum", "dsum", a, q)
    dq_entry, dkv_entry = _BWD_ENTRIES[route]
    _launch(dq_entry, "dq", a, q)
    _launch(dkv_entry, "dkv", a, q)
    flash_bwd.routes[route] += 1
    return dq, dk, dv


# --------------------------------------------------------------------------
# the differentiable op, (B, S, H, D) layout
# --------------------------------------------------------------------------

def _t(x):
    return None if x is None else x.transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, causal, scale, window, softcap, fns):
        fwd, _ = fns
        qt, kt, vt = _t(q), _t(k), _t(v)  # views: the kernels read strides
        out, lse = fwd(qt, kt, vt, seg_q, seg_k, causal=causal, scale=scale, window=window, softcap=softcap)
        ctx.save_for_backward(qt, kt, vt, out, lse, *(() if seg_q is None else (seg_q, seg_k)))
        ctx.cfg = (causal, scale, window, softcap, fns)
        return _t(out)

    @staticmethod
    def backward(ctx, do):
        qt, kt, vt, out, lse, *segs = ctx.saved_tensors
        causal, scale, window, softcap, (_, bwd) = ctx.cfg
        seg_q, seg_k = segs if segs else (None, None)
        dot = _t(do)
        if dot.stride(3) != 1:
            dot = dot.contiguous()
        dq, dk, dv = bwd(qt, kt, vt, out, lse, dot, seg_q, seg_k, causal=causal, scale=scale, window=window,
                         softcap=softcap)
        return _t(dq), _t(dk), _t(dv), None, None, None, None, None, None, None


def _apply(fns, q, k, v, segment_ids_q, segment_ids_k, causal, scale, window, softcap):
    if (segment_ids_q is None) != (segment_ids_k is None):
        raise ValueError("segment ids must be given for both q and k, or for neither")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return _FlashAttention.apply(q, k, v, _seg32(segment_ids_q), _seg32(segment_ids_k), bool(causal), scale,
                                 window, softcap, fns)


def flash_attention(q, k, v, segment_ids_q: Optional[torch.Tensor] = None,
                    segment_ids_k: Optional[torch.Tensor] = None, *, causal: bool = True,
                    scale: Optional[float] = None, window: Optional[int] = None, softcap: Optional[float] = None):
    """Flash attention on (B, S, H, D) tensors; differentiable (the backward
    launches the dsum pre-pass and the dq and dk/dv kernels).

    ``window``: sliding-window band, keys ``window`` or more positions behind
    a query are masked. ``softcap``: scores pass ``cap * tanh(s / cap)`` before
    masking. GQA: ``k``/``v`` may carry fewer heads (``Hk | H``); gradients
    come back at the kv head count. ``segment_ids_*``: (B, S) int, tokens
    attend only within their own segment (give pads a segment of their own).
    ``scale`` defaults to ``1 / sqrt(D)``."""
    return _apply((flash_fwd, flash_bwd), q, k, v, segment_ids_q, segment_ids_k, causal, scale, window, softcap)


def flash_attention_ref(q, k, v, segment_ids_q=None, segment_ids_k=None, *, causal=True, scale=None, window=None,
                        softcap=None):
    """The same function and gradient through the plain versions only, on any device."""
    return _apply((flash_fwd_ref, flash_bwd_ref), q, k, v, segment_ids_q, segment_ids_k, causal, scale, window,
                  softcap)


# Kernel launches by kernel ("fwd", "dq" and "dkv" count every route; "dsum" the pre-pass), and the forward's
# and the backward's calls by route; CPU calls (the plain versions) do not count.
flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0, "dsum": 0}
flash_fwd.routes = {"wgmma": 0, "tf32x3": 0, "mma": 0}
flash_bwd.routes = {"wgmma": 0, "tf32x3": 0, "mma": 0}
