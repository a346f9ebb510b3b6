"""K1 + K2: W8A8 int8 matmul for the frozen QLoRA base.

Replaces ``dalm_tpu/kernels/int8_matmul.py``: ``rowquant`` (Pallas
``_rowquant_kernel``, K2), ``_w8a8_fused_pallas`` (``_w8a8_fused_kernel``,
K1), the two int8 products ``_i8_dot_last`` left to the compiler, and the
``int8_matmul`` custom gradient. The kernels are hand-written CUDA for
``sm_90a``, ``csrc/int8_matmul.cu``; its header says what bounds each on an
H100 and what the design does about it. On the card K1 is three launches:
the quantise pre-pass (``quant_prepass``), the weight pre-pass into a
K-major scratch (``weight_prepass``) and an s8 ``wgmma`` GEMM that folds the
k-blocks in registers (``fold_gemm``); the int8 products run the same GEMM's
int32 instance (``int8_gemm_kn`` after the weight pre-pass), and K5's
per-column instance at prefill its scaled instance (``int8_gemm_scaled``: one
int32 sum over all of K, then the row's and the column's scale). Beside every
kernel stands its plain PyTorch version (``*_ref``), which a wrapper takes
for CPU tensors only: on a CUDA tensor it launches the kernel or raises.

Semantics (both versions):

- ``rowquant(x)``: per row of the last axis ``s = absmax / 127`` (1 for an
  all-zero row), ``q = clip(round_half_even(x / s), -127, 127)``; an optional
  ``(1, K)`` column scale multiplies ``x`` (in f32) first.
- ``w8a8_fused(x2, q, scale)``: ``x2 (M, K)`` float, ``q (K, N)`` int8,
  ``scale (1, N)`` f32. Each (row, k-block of ``bk = fit_div(K, 512)``) of
  ``x2`` is row-quantised, ``int8 x int8 -> int32`` per k-block, f32
  ``acc += float(p) * s`` in k order, ``* scale`` at the end, cast to
  ``x2.dtype``.
- ``int8_matmul(x, q, scale, bwd_int8)``: ``x @ (q * scale)`` with the fused
  form where :func:`w8a8_fused_feasible` allows, else ``rowquant`` + int8
  GEMM + rescale (the only form the JAX package runs off the TPU). Backward is straight-through:
  ``dx = (dy * scale) @ q^T``, in int8 (``rowquant`` + int8 GEMM) with
  ``bwd_int8`` or as a bf16 product without; ``q`` and ``scale`` get none.
- ``cal_quant(x, s[, colscale, want_amax])``: the calibrated-scale quantiser,
  ``clip(round_half_even(v / s), -127, 127)`` with one f32 scale ``s`` for the
  tensor, ``v = x`` or ``x * colscale``, and ``max |v|`` when asked (one read
  of x: ``csrc/int8_matmul.cu`` ``cal_quant_kernel``).
- ``int8_matmul_cal`` / ``int8_matmul_dycal``: ``x @ (q * scale)`` with a
  calibrated activation scale ``a_scale``: ``(f32(cal_quant(x) . q) * a_scale)
  * scale``, on the card the quantiser, the weight pre-pass and the scaled
  GEMM; the backward is the dynamic one, or (``_dycal``) ``dy * scale``
  quantised with the calibrated ``dy_scale``; ``a_scale``'s gradient is the
  out-of-band ``max(max |dy * scale| / 127, 1e-8)``.
"""

from __future__ import annotations

import ctypes
import math

import torch

_lib_handle = None


def _lib():
    """The built library, with its C signatures declared (once per process)."""
    global _lib_handle
    if _lib_handle is None:
        from dalm_tpu_torch.kernels import build

        lib = build.load("int8_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dalm_i8_rowquant.argtypes = [p, i, p, i, i, p, p, p]
        lib.dalm_i8_rowquant_bf16.argtypes = [p, i, p, i, i, p, p, p]
        lib.dalm_i8_act_quant.argtypes = [p, i, i, i, i, p, p, p]
        lib.dalm_i8_transpose.argtypes = [p, i, i, p, p]
        lib.dalm_i8_gemm_fold.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
        lib.dalm_i8_gemm_nt.argtypes = [p, p, i, i, i, p, p]
        lib.dalm_i8_gemm_scaled.argtypes = [p, p, p, p, i, i, i, p, p]
        lib.dalm_i8_gemm_scaled_maps.argtypes = [p, p, i, i, i]
        lib.dalm_i8_cal_quant.argtypes = [p, i, p, p, ctypes.c_longlong, i, p, p, p]
        for fn in ("dalm_i8_rowquant", "dalm_i8_rowquant_bf16", "dalm_i8_act_quant", "dalm_i8_transpose",
                   "dalm_i8_gemm_fold", "dalm_i8_gemm_nt", "dalm_i8_gemm_scaled", "dalm_i8_gemm_scaled_maps",
                   "dalm_i8_cal_quant"):
            getattr(lib, fn).restype = i
        _lib_handle = lib
    return _lib_handle


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(err: int, what: str) -> None:
    if err != 0:  # >= 900: the tensor-map encoder is missing (900) or refused a map (1000 + CUresult)
        raise RuntimeError(f"{what} kernel launch failed: error {err}")


def _check_cuda(what: str, **tensors) -> None:
    dev = None
    for name, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda or (dev is not None and t.device != dev):
            raise ValueError(f"{what}: {name} must be on the same CUDA device as the other operands")
        dev = t.device
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")


# --------------------------------------------------------------------------
# K2: per-row int8 quantiser
# --------------------------------------------------------------------------

def rowquant_ref(x: torch.Tensor, colscale: torch.Tensor | None = None, dtype: torch.dtype = torch.int8):
    """Plain PyTorch K2. Returns (q ``dtype`` ``x.shape``, s f32 ``x.shape[:-1] + (1,)``); ``dtype`` int8, or
    bfloat16 for the same values as K5's fold route takes them (exact: ``|q| <= 127``)."""
    xf = x.float()
    if colscale is not None:
        xf = xf * colscale.reshape(-1).float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    # A tensor divisor: true division on every backend (a Python scalar may
    # become a multiply by its reciprocal).
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0), torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q.to(dtype), scale


_RQ_TYPES = (torch.int8, torch.bfloat16)


def launch_rowquant(x: torch.Tensor, colscale: torch.Tensor | None, q: torch.Tensor, s: torch.Tensor) -> None:
    """One launch of K2 on checked operands into ``q`` (int8 or bfloat16, ``x.shape``) and ``s``."""
    K = x.shape[-1]
    fn = _lib().dalm_i8_rowquant if q.dtype == torch.int8 else _lib().dalm_i8_rowquant_bf16
    err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), colscale.data_ptr() if colscale is not None else None,
             x.numel() // K, K, q.data_ptr(), s.data_ptr(), _stream(x))
    _launched(err, "rowquant")
    rowquant.launches += 1
    if q.dtype == torch.bfloat16:
        rowquant.bf16_launches += 1


def rowquant(x: torch.Tensor, colscale: torch.Tensor | None = None, dtype: torch.dtype = torch.int8):
    """Symmetric per-row (last axis) int8: ``x * colscale ~= q * s``; ``q`` in ``dtype`` (int8 or bfloat16)."""
    if not x.is_cuda:
        return rowquant_ref(x, colscale, dtype)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rowquant takes float32 or bfloat16, not {x.dtype}")
    if dtype not in _RQ_TYPES:
        raise TypeError(f"rowquant writes int8 or bfloat16, not {dtype}")
    K = x.shape[-1]
    R = x.numel() // K if K else 0
    if R < 1 or K < 1:
        raise ValueError("rowquant needs at least one row and one column")
    if colscale is not None and (colscale.dtype != torch.float32 or colscale.numel() != K):
        raise TypeError("colscale must be K float32 values")
    _check_cuda("rowquant", x=x, colscale=colscale)
    q = torch.empty(x.shape, dtype=dtype, device=x.device)
    s = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    launch_rowquant(x, colscale, q, s)
    return q, s


rowquant.launches = 0  # every launch
rowquant.bf16_launches = 0  # those that wrote bfloat16


# --------------------------------------------------------------------------
# The calibrated-scale quantiser (XLA in the JAX package)
# --------------------------------------------------------------------------

def cal_quant_ref(x: torch.Tensor, s: torch.Tensor, colscale: torch.Tensor | None = None, want_amax: bool = False):
    """Plain calibrated-scale quantiser: ``v = x`` (times ``colscale`` per column, in f32), ``q = clip(round(v / s),
    -127, 127)`` int8 with ``s`` a 0-d f32 tensor; returns (q, ``max |v|`` as a 0-d f32 tensor or None)."""
    v = x.float()
    if colscale is not None:
        v = v * colscale.reshape(-1).float()
    q = torch.clamp(torch.round(v / s.float().reshape((1,) * v.dim())), -127, 127).to(torch.int8)
    return q, (v.abs().amax() if want_amax else None)


def cal_quant(x: torch.Tensor, s: torch.Tensor, colscale: torch.Tensor | None = None, want_amax: bool = False):
    """The calibrated-scale quantiser: one launch for CUDA tensors (mode "x": the forward's ``x / a_scale``;
    mode "dy": the backward's ``dy * scale / dy_scale``, ``colscale`` given), the plain version for CPU
    tensors. ``s`` stays on the device: no host read-back."""
    if not x.is_cuda:
        return cal_quant_ref(x, s, colscale, want_amax)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"cal_quant takes float32 or bfloat16, not {x.dtype}")
    if s.dtype != torch.float32 or s.numel() != 1:
        raise TypeError("cal_quant takes one float32 scale")
    K = x.shape[-1]
    n = x.numel()
    if n < 1 or n >= 2 ** 31:
        raise ValueError(f"cal_quant takes 1 to 2^31 - 1 values, not {n}")
    if colscale is not None and (colscale.dtype != torch.float32 or colscale.numel() != K):
        raise TypeError("colscale must be K float32 values")
    _check_cuda("cal_quant", x=x, colscale=colscale)
    if s.device != x.device:
        raise ValueError("cal_quant: the scale must be on the device of x")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    amax = torch.zeros((), dtype=torch.float32, device=x.device) if want_amax else None
    launch_cal_quant(x, s.reshape(1).contiguous(), colscale, q, amax)
    return q, amax


def launch_cal_quant(x: torch.Tensor, s: torch.Tensor, colscale: torch.Tensor | None, q: torch.Tensor,
                     amax: torch.Tensor | None) -> None:
    """One launch of the calibrated quantiser on checked operands into ``q`` (and the max into ``amax``, which
    the caller zeroed)."""
    err = _lib().dalm_i8_cal_quant(x.data_ptr(), int(x.dtype == torch.bfloat16), s.data_ptr(),
                                   colscale.data_ptr() if colscale is not None else None, x.numel(), x.shape[-1],
                                   q.data_ptr(), amax.data_ptr() if amax is not None else None, _stream(x))
    _launched(err, "calibrated quantiser")
    cal_quant.launches["dy" if colscale is not None else "x"] += 1


cal_quant.launches = {"x": 0, "dy": 0}


# --------------------------------------------------------------------------
# int8 x int8 -> int32 products
# --------------------------------------------------------------------------

def _int_dot_ref(a: torch.Tensor, b_kn: torch.Tensor) -> torch.Tensor:
    """Exact ``a (M, C) . b (C, N)`` of int8 operands as int32. On the CPU an
    int32 matmul; on a card (which has no integer matmul in PyTorch) f32
    matmuls over chunks of C short enough that every partial sum is exact."""
    if not a.is_cuda:
        return a.to(torch.int32) @ b_kn.to(torch.int32)
    C = a.shape[1]
    out = torch.zeros((a.shape[0], b_kn.shape[1]), dtype=torch.int32, device=a.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for c0 in range(0, C, 1024):  # 1024 * 127^2 < 2^24
            out += (a[:, c0:c0 + 1024].float() @ b_kn[c0:c0 + 1024].float()).to(torch.int32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def int8_gemm_kn_ref(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return _int_dot_ref(a, q)


def int8_gemm_nt_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _int_dot_ref(a, b.T)


def _check_gemm(what: str, a: torch.Tensor, b: torch.Tensor, contract_b_axis: int) -> None:
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2:
        raise TypeError(f"{what} takes two 2-D int8 operands")
    if a.shape[1] != b.shape[contract_b_axis]:
        raise ValueError(f"{what}: contraction sizes differ, {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.shape[1] % 16:
        raise ValueError(f"{what}: the contraction size {a.shape[1]} must be a multiple of 16")
    if contract_b_axis == 0 and b.shape[1] % 4:
        raise ValueError(f"{what}: N={b.shape[1]} must be a multiple of 4")
    if a.shape[0] < 1:
        raise ValueError(f"{what}: needs at least one row")
    _check_cuda(what, a=a, b=b)


def _launch_transpose(q: torch.Tensor, qt: torch.Tensor) -> None:
    """One launch of the weight pre-pass on checked operands: ``qt (N, K) = q (K, N)^T``."""
    K, N = q.shape
    _launched(_lib().dalm_i8_transpose(q.data_ptr(), K, N, qt.data_ptr(), _stream(q)), "weight pre-pass")
    weight_prepass.launches += 1


def _launch_gemm_i32(a: torch.Tensor, bt: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of the GEMM's int32 instance on checked operands: ``out (M, N) = a (M, C) . bt (N, C)^T``."""
    M, C = a.shape
    _launched(_lib().dalm_i8_gemm_nt(a.data_ptr(), bt.data_ptr(), M, C, bt.shape[0], out.data_ptr(), _stream(a)),
              "int8 GEMM")


def int8_gemm_kn(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``a (M, K) int8 . q (K, N) int8 -> (M, N) int32`` (the unfused forward): the weight pre-pass
    into a K-major scratch, then the GEMM's int32 instance."""
    if not a.is_cuda:
        return int8_gemm_kn_ref(a, q)
    _check_gemm("int8_gemm_kn", a, q, 0)
    K, N = q.shape
    qt = torch.empty((N, K), dtype=torch.int8, device=q.device)
    _launch_transpose(q, qt)
    out = torch.empty((a.shape[0], N), dtype=torch.int32, device=a.device)
    _launch_gemm_i32(a, qt, out)
    int8_gemm_kn.launches += 1
    return out


def int8_gemm_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, C) int8 . b (N, C)^T int8 -> (M, N) int32`` (dx of the int8 backward:
    ``b`` is the weight ``q (K, N)`` itself, contracted over its contiguous axis)."""
    if not a.is_cuda:
        return int8_gemm_nt_ref(a, b)
    _check_gemm("int8_gemm_nt", a, b, 1)
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32, device=a.device)
    _launch_gemm_i32(a, b, out)
    int8_gemm_nt.launches += 1
    return out


int8_gemm_kn.launches = 0
int8_gemm_nt.launches = 0


def int8_gemm_scaled_ref(xq: torch.Tensor, wn: torch.Tensor, xs: torch.Tensor, wscale: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain scaled GEMM: ``(f32(xq (M, K) . wn (N, K)^T) * xs (M, 1)) * wscale (N)``, each product rounded in
    f32, cast to ``dtype`` (the kernel writes bfloat16): K5 pcol's arithmetic (``int4_matmul._ref_pcol``)."""
    return ((_int_dot_ref(xq, wn.T).float() * xs) * wscale.reshape(1, -1)).to(dtype)


def check_scaled_maps(xq: torch.Tensor, wn: torch.Tensor) -> None:
    """Encode the scaled GEMM's tensor maps for these operands and launch nothing: raises where its launch would
    be refused, so a route can refuse before its first kernel runs."""
    M, K = xq.shape
    err = _lib().dalm_i8_gemm_scaled_maps(xq.data_ptr(), wn.data_ptr(), M, wn.shape[0], K)
    if err != 0:  # >= 900: the tensor-map encoder is missing (900) or refused a map (1000 + CUresult)
        raise RuntimeError(f"int8 scaled GEMM: its tensor maps were refused: error {err}")


def launch_gemm_scaled(xq: torch.Tensor, wn: torch.Tensor, xs: torch.Tensor, wscale: torch.Tensor,
                       out: torch.Tensor) -> None:
    """One launch of the scaled GEMM on checked operands into ``out (M, N)`` bfloat16."""
    M, K = xq.shape
    _launched(_lib().dalm_i8_gemm_scaled(xq.data_ptr(), wn.data_ptr(), xs.data_ptr(), wscale.data_ptr(), M,
                                         wn.shape[0], K, out.data_ptr(), _stream(xq)), "int8 scaled GEMM")
    int8_gemm_scaled.launches += 1


def int8_gemm_scaled(xq: torch.Tensor, wn: torch.Tensor, xs: torch.Tensor, wscale: torch.Tensor) -> torch.Tensor:
    """``bf16((f32(xq (M, K) . wn (N, K)^T) * xs (M, 1)) * wscale (N))``, int8 operands, f32 scales: the GEMM's
    scaled instance (K a multiple of 16, N of 2) for CUDA tensors, the plain version for CPU tensors."""
    if not xq.is_cuda:
        return int8_gemm_scaled_ref(xq, wn, xs, wscale)
    _check_gemm("int8_gemm_scaled", xq, wn, 1)
    if xs.dtype != torch.float32 or wscale.dtype != torch.float32:
        raise TypeError(f"int8_gemm_scaled takes float32 scales, not {xs.dtype} / {wscale.dtype}")
    M, N = xq.shape[0], wn.shape[0]
    if tuple(xs.shape) != (M, 1) or wscale.numel() != N or N % 2:
        raise ValueError(f"int8_gemm_scaled: xs must be ({M}, 1) and wscale hold N={N} values, N a multiple of 2; "
                         f"not {tuple(xs.shape)}, {tuple(wscale.shape)}")
    _check_cuda("int8_gemm_scaled", xq=xq, wn=wn, xs=xs, wscale=wscale)
    check_scaled_maps(xq, wn)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=xq.device)
    launch_gemm_scaled(xq, wn, xs, wscale, out)
    return out


int8_gemm_scaled.launches = 0


# --------------------------------------------------------------------------
# K1: matmul with activation quantisation per (row, k-block)
# --------------------------------------------------------------------------

def fit_div(dim: int, want: int, align: int = 128) -> int:
    """Largest multiple of ``align`` that divides ``dim`` and is <= ``want`` (0 if none)."""
    best = 0
    b = align
    while b <= dim:
        if dim % b == 0 and b <= want:
            best = b
        b += align
    return best


def w8a8_fused_feasible(M: int, K: int, N: int) -> bool:
    """The shapes the fused form takes: the reference's rule, so both packages
    pick the same form for a shape."""
    if not (fit_div(M, 512, 8) and fit_div(K, 512) and fit_div(N, 8192)):
        return False
    return fit_div(M, 512, 8) * K <= 48 * 1024 * 1024


def w8a8_fused_ref(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1, in the kernels' order of operations."""
    M, K = x2.shape
    bk = fit_div(K, 512)
    if not bk:
        raise ValueError(f"K={K} has no k-block that is a multiple of 128")
    acc = torch.zeros((M, q.shape[1]), dtype=torch.float32, device=x2.device)
    for k0 in range(0, K, bk):
        tq, ts = rowquant_ref(x2[:, k0:k0 + bk])
        acc = acc + _int_dot_ref(tq, q[k0:k0 + bk]).float() * ts
    return (acc * scale.reshape(1, -1).float()).to(x2.dtype)


def quant_prepass_ref(x2: torch.Tensor, bk: int):
    """Plain quantise pre-pass: ``xq (M, K)`` int8 and ``xs (M, K / bk)`` f32, each (row, k-block)
    of ``x2`` quantised on its own as ``rowquant`` quantises a row."""
    M, K = x2.shape
    xf = x2.float().reshape(M, K // bk, bk)
    absmax = xf.abs().amax(dim=-1)
    xs = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0), torch.ones_like(absmax))
    xq = torch.clamp(torch.round(xf / xs[..., None]), -127, 127).to(torch.int8)
    return xq.reshape(M, K), xs


def weight_prepass_ref(q: torch.Tensor) -> torch.Tensor:
    """Plain weight pre-pass: the K-major copy ``qt (N, K)`` of ``q (K, N)``."""
    return q.T.contiguous()


def fold_gemm_ref(xq: torch.Tensor, xs: torch.Tensor, qt: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Plain GEMM of the route: ``(sum over k-blocks of f32(xq_kb . qt_kb^T) * xs_kb) * scale``, k-blocks in
    order, cast to ``dtype``."""
    M, K = xq.shape
    nkb = xs.shape[1]
    bk = K // nkb
    acc = torch.zeros((M, qt.shape[0]), dtype=torch.float32, device=xq.device)
    for kb in range(nkb):
        sl = slice(kb * bk, (kb + 1) * bk)
        acc = acc + _int_dot_ref(xq[:, sl], qt[:, sl].T).float() * xs[:, kb:kb + 1]
    return (acc * scale.reshape(1, -1).float()).to(dtype)


def _launch_quant(x2: torch.Tensor, bk: int, xq: torch.Tensor, xs: torch.Tensor) -> None:
    M, K = x2.shape
    _launched(_lib().dalm_i8_act_quant(x2.data_ptr(), int(x2.dtype == torch.bfloat16), M, K, bk, xq.data_ptr(),
                                       xs.data_ptr(), _stream(x2)), "quantise pre-pass")
    quant_prepass.launches += 1


def _launch_fold(xq: torch.Tensor, xs: torch.Tensor, qt: torch.Tensor, scale: torch.Tensor,
                 out: torch.Tensor) -> None:
    M, K = xq.shape
    N = qt.shape[0]
    _launched(_lib().dalm_i8_gemm_fold(xq.data_ptr(), qt.data_ptr(), xs.data_ptr(), scale.data_ptr(), M, N, K,
                                       K // xs.shape[1], int(out.dtype == torch.bfloat16), out.data_ptr(),
                                       _stream(xq)), "K1 GEMM")
    fold_gemm.launches += 1


def quant_prepass(x2: torch.Tensor, bk: int):
    """K1's quantise pre-pass: ``(xq (M, K) int8, xs (M, K / bk) f32)``; the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if not x2.is_cuda:
        return quant_prepass_ref(x2, bk)
    if x2.dtype not in (torch.float32, torch.bfloat16) or x2.dim() != 2:
        raise TypeError(f"quant_prepass takes a 2-D float32 or bfloat16 x2, not {x2.dtype} {tuple(x2.shape)}")
    M, K = x2.shape
    if bk < 128 or bk % 128 or K % bk or M < 1:
        raise ValueError(f"quant_prepass: bk={bk} must be a multiple of 128 dividing K={K}")
    _check_cuda("quant_prepass", x2=x2)
    xq = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    xs = torch.empty((M, K // bk), dtype=torch.float32, device=x2.device)
    _launch_quant(x2, bk, xq, xs)
    return xq, xs


def weight_prepass(q: torch.Tensor) -> torch.Tensor:
    """K1's weight pre-pass: ``qt (N, K)``, the K-major copy of ``q (K, N)`` int8 (K a multiple of 16,
    N of 4); the kernel for CUDA tensors, the plain version for CPU tensors."""
    if not q.is_cuda:
        return weight_prepass_ref(q)
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError(f"weight_prepass takes a 2-D int8 weight, not {q.dtype} {tuple(q.shape)}")
    K, N = q.shape
    if K < 16 or K % 16 or N < 4 or N % 4:
        raise ValueError(f"weight_prepass: K={K} must be a multiple of 16 and N={N} of 4")
    _check_cuda("weight_prepass", q=q)
    qt = torch.empty((N, K), dtype=torch.int8, device=q.device)
    _launch_transpose(q, qt)
    return qt


def fold_gemm(xq: torch.Tensor, xs: torch.Tensor, qt: torch.Tensor, scale: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """K1's GEMM on the pre-passes' outputs, in ``dtype`` (float32 or bfloat16); the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if not xq.is_cuda:
        return fold_gemm_ref(xq, xs, qt, scale, dtype)
    if xq.dtype != torch.int8 or qt.dtype != torch.int8 or xs.dtype != torch.float32 \
            or scale.dtype != torch.float32 or dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("fold_gemm takes int8 xq and qt, float32 xs and scale, and a float32 or bfloat16 output")
    M, K = xq.shape
    N = qt.shape[0]
    nkb = xs.shape[1] if xs.dim() == 2 else 0
    if qt.shape[1] != K or tuple(xs.shape) != (M, nkb) or not nkb or K % nkb or (K // nkb) % 128 \
            or scale.numel() != N or N % 4 or M < 1:
        raise ValueError(f"fold_gemm: shapes {tuple(xq.shape)}, {tuple(xs.shape)}, {tuple(qt.shape)}, "
                         f"{tuple(scale.shape)} do not agree (k-blocks a multiple of 128, N of 4)")
    _check_cuda("fold_gemm", xq=xq, xs=xs, qt=qt, scale=scale)
    out = torch.empty((M, N), dtype=dtype, device=xq.device)
    _launch_fold(xq, xs, qt, scale, out)
    return out


quant_prepass.launches = 0
weight_prepass.launches = 0
fold_gemm.launches = 0


def w8a8_fused(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x2 (M, K) float @ q (K, N) int8 * scale (1, N)`` with per-(row, k-block) activation quantisation;
    output in ``x2.dtype``. On CUDA tensors three launches on the current stream: the quantise pre-pass,
    the weight pre-pass and the GEMM (their scratch is freed on return); one count per call."""
    if not x2.is_cuda:
        return w8a8_fused_ref(x2, q, scale)
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w8a8_fused takes float32 or bfloat16 activations, not {x2.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("w8a8_fused takes int8 weights and float32 scales")
    if x2.dim() != 2 or q.dim() != 2 or x2.shape[1] != q.shape[0] or scale.numel() != q.shape[1]:
        raise ValueError(f"w8a8_fused: shapes {tuple(x2.shape)}, {tuple(q.shape)}, {tuple(scale.shape)} do not agree")
    M, K = x2.shape
    N = q.shape[1]
    bk = fit_div(K, 512)
    if not bk or N % 4 or M < 1:
        raise ValueError(f"w8a8_fused: K={K} needs a k-block that is a multiple of 128, N={N} a multiple of 4")
    _check_cuda("w8a8_fused", x2=x2, q=q, scale=scale)
    xq = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    xs = torch.empty((M, K // bk), dtype=torch.float32, device=x2.device)
    qt = torch.empty((N, K), dtype=torch.int8, device=x2.device)
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    _launch_quant(x2, bk, xq, xs)
    _launch_transpose(q, qt)
    _launch_fold(xq, xs, qt, scale, out)
    w8a8_fused.launches += 1
    return out


w8a8_fused.launches = 0


# --------------------------------------------------------------------------
# int8_matmul with its gradient
# --------------------------------------------------------------------------

def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` with zero rows and columns appended up to ``(rows, cols)`` (itself if nothing is missing)."""
    if t.shape == (rows, cols):
        return t
    return torch.nn.functional.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _forward(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, fns) -> torch.Tensor:
    rq, fused, gemm_kn, _ = fns
    lead, K = x.shape[:-1], x.shape[-1]
    M = math.prod(lead)
    N = q.shape[1]
    x2 = x.reshape(M, K)
    if w8a8_fused_feasible(M, K, N):
        return fused(x2.contiguous(), q, scale).reshape(*lead, N)
    xq, xs = rq(x2.contiguous())
    # The GEMM takes K in multiples of 16 and N in multiples of 4: zero rows and columns leave every int32 sum
    # (and each row's absmax, taken before the padding) as they are, so padding and slicing is exact.
    Kp, Np = _round_up(K, 16), _round_up(N, 4)
    acc = gemm_kn(_pad_to(xq, M, Kp), _pad_to(q, Kp, Np))[:, :N]
    y = acc.float() * xs * scale.reshape(1, N)
    return y.to(x.dtype).reshape(*lead, N)


def _backward(dy: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, bwd_int8: bool, fns) -> torch.Tensor:
    rq, _, _, gemm_nt = fns
    lead, N = dy.shape[:-1], dy.shape[-1]
    K = q.shape[0]
    dy2 = dy.reshape(math.prod(lead), N).contiguous()
    if bwd_int8:
        # dx = (dy * scale) @ q^T: the scale is constant along the contraction.
        dq, ds = rq(dy2, scale.reshape(-1))
        Np = _round_up(N, 16)  # the contraction; zero columns add nothing, as in the forward
        dx = gemm_nt(_pad_to(dq, dq.shape[0], Np), _pad_to(q, K, Np)).float() * ds
    else:
        dyf = (dy2.float() * scale.reshape(1, N)).to(torch.bfloat16)
        if dy.dtype == torch.bfloat16:
            dx = dyf @ q.to(torch.bfloat16).T
        else:  # bf16 operands, f32 accumulation and result
            dx = dyf.float() @ q.float().T
    return dx.to(dy.dtype).reshape(*lead, K)


_KERNELS = (rowquant, w8a8_fused, int8_gemm_kn, int8_gemm_nt)
_PLAIN = (rowquant_ref, w8a8_fused_ref, int8_gemm_kn_ref, int8_gemm_nt_ref)


class _Int8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q, scale, bwd_int8, fns):
        ctx.save_for_backward(q, scale)
        ctx.bwd_int8, ctx.fns = bwd_int8, fns
        return _forward(x, q, scale, fns)

    @staticmethod
    def backward(ctx, dy):
        q, scale = ctx.saved_tensors
        return _backward(dy, q, scale, ctx.bwd_int8, ctx.fns), None, None, None, None


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, bwd_int8: bool = False) -> torch.Tensor:
    """``x (..., K) @ (q (K, N) int8 * scale (1, N))`` on the int8 path, output
    ``(..., N)`` in ``x.dtype``; straight-through gradient for ``x`` only."""
    return _Int8Matmul.apply(x, q, scale, bool(bwd_int8), _KERNELS)


def int8_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, bwd_int8: bool = False) -> torch.Tensor:
    """The same function and gradient through the plain versions only, on any device."""
    return _Int8Matmul.apply(x, q, scale, bool(bwd_int8), _PLAIN)


# --------------------------------------------------------------------------
# Calibrated activation scale (int8_matmul_cal) and calibrated dy scale (int8_matmul_dycal)
# --------------------------------------------------------------------------
#
# The counterparts of the reference's two custom_vjp functions (dalm_tpu/kernels/int8_matmul.py:310-406). The
# forward quantises x with ONE calibrated scale ``a_scale`` (a 0-d f32 tensor), so there is no absmax pass:
# ``y = (f32(xq . q) * a_scale) * scale``. ``a_scale``'s gradient is an out-of-band channel: the backward
# returns ``max(max |dy * scale| / 127, 1e-8)`` for it, the dy scale the next backward would need; it is
# computed only when ``a_scale`` requires a gradient (the trainer's probe step).

def _scaled_route(x: torch.Tensor, K: int, N: int, fns) -> bool:
    """The calibrated forward takes the weight pre-pass and the scaled GEMM (bf16 out; K a multiple of 16, N of
    4) on the card; elsewhere the int32 GEMM on padded operands and the rescale."""
    return fns[0] is cal_quant and x.is_cuda and x.dtype == torch.bfloat16 and K % 16 == 0 and N % 4 == 0


def _cal_forward(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, a_scale: torch.Tensor, fns) -> torch.Tensor:
    cq, gemm_kn, _, prepass, scaled, _ = fns
    lead, K = x.shape[:-1], x.shape[-1]
    M = math.prod(lead)
    N = q.shape[1]
    xq, _ = cq(x.reshape(M, K).contiguous(), a_scale)
    a32 = a_scale.float().reshape(1, 1)
    if _scaled_route(x, K, N, fns):
        xs = a32.expand(M, 1).contiguous()
        y = scaled(xq, prepass(q), xs, scale.reshape(-1).contiguous())
    else:
        Kp, Np = _round_up(K, 16), _round_up(N, 4)
        acc = gemm_kn(_pad_to(xq, M, Kp), _pad_to(q, Kp, Np))[:, :N]
        y = ((acc.float() * a32) * scale.reshape(1, N)).to(x.dtype)
    return y.reshape(*lead, N)


def _dy_scale_grad(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax / 127, 1e-8)`` as the reference writes it (a true division by 127)."""
    return torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)


def _dycal_backward(dy: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, dy_scale: torch.Tensor, bwd_int8: bool,
                    want_amax: bool, fns):
    """dx of the calibrated dy scale: ``q8 = clip(round(dy * scale / dy_scale))``, ``dx = f32(q8 . q^T) *
    dy_scale``, with ``max |dy * scale|`` on the same read. Returns (dx, amax or None)."""
    cq, _, gemm_nt, _, _, _ = fns
    lead, N = dy.shape[:-1], dy.shape[-1]
    K = q.shape[0]
    dy2 = dy.reshape(math.prod(lead), N).contiguous()
    if bwd_int8:
        dq, amax = cq(dy2, dy_scale, scale.reshape(-1).contiguous(), want_amax)
        Np = _round_up(N, 16)
        dx = gemm_nt(_pad_to(dq, dq.shape[0], Np), _pad_to(q, K, Np)).float() * dy_scale.float().reshape(1, 1)
    else:
        dyf = dy2.float() * scale.reshape(1, N)
        amax = dyf.abs().amax() if want_amax else None
        dyb = dyf.to(torch.bfloat16)
        dx = dyb @ q.to(torch.bfloat16).T if dy.dtype == torch.bfloat16 else dyb.float() @ q.float().T
    return dx.to(dy.dtype).reshape(*lead, K), amax


class _Int8MatmulCal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q, scale, a_scale, dy_scale, bwd_int8, fns):
        ctx.save_for_backward(q, scale, dy_scale if dy_scale is not None else scale)
        ctx.bwd_int8, ctx.fns, ctx.dycal = bwd_int8, fns, dy_scale is not None
        return _cal_forward(x, q, scale, a_scale, fns)

    @staticmethod
    def backward(ctx, dy):
        q, scale, dy_scale = ctx.saved_tensors
        want = ctx.needs_input_grad[3]
        if not ctx.needs_input_grad[0]:  # only the channel is asked for (a layer whose input is frozen)
            amax = (dy.float() * scale.reshape(-1).float()).abs().amax()
            return None, None, None, _dy_scale_grad(amax), None, None, None
        if ctx.dycal:
            dx, amax = _dycal_backward(dy, q, scale, dy_scale, ctx.bwd_int8, want, ctx.fns)
        else:
            rq, gemm_nt = ctx.fns[5], ctx.fns[2]
            dx = _backward(dy, q, scale, ctx.bwd_int8, (rq, None, None, gemm_nt))
            # the bootstrap probe's channel (no dy_scale yet): one plain reduction, only when it is asked for
            amax = (dy.float() * scale.reshape(-1).float()).abs().amax() if want else None
        return dx, None, None, (_dy_scale_grad(amax) if want else None), None, None, None


_CAL_KERNELS = (cal_quant, int8_gemm_kn, int8_gemm_nt, weight_prepass, int8_gemm_scaled, rowquant)
_CAL_PLAIN = (cal_quant_ref, int8_gemm_kn_ref, int8_gemm_nt_ref, weight_prepass_ref, int8_gemm_scaled_ref,
              rowquant_ref)


def int8_matmul_cal(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, a_scale: torch.Tensor,
                    bwd_int8: bool = False) -> torch.Tensor:
    """``x (..., K) @ (q (K, N) int8 * scale (1, N))`` with the calibrated per-tensor activation scale ``a_scale``
    (0-d f32); the backward is ``int8_matmul``'s (dynamic per-row dy quant with ``bwd_int8``), and ``a_scale``
    gets the out-of-band dy scale."""
    return _Int8MatmulCal.apply(x, q, scale, a_scale, None, bool(bwd_int8), _CAL_KERNELS)


def int8_matmul_dycal(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, a_scale: torch.Tensor,
                      dy_scale: torch.Tensor, bwd_int8: bool = True) -> torch.Tensor:
    """As :func:`int8_matmul_cal`, with the backward's ``dy * scale`` quantised by the calibrated ``dy_scale``
    (0-d f32, frozen) instead of per row."""
    return _Int8MatmulCal.apply(x, q, scale, a_scale, dy_scale, bool(bwd_int8), _CAL_KERNELS)


def int8_matmul_cal_ref(x, q, scale, a_scale, bwd_int8: bool = False):
    """:func:`int8_matmul_cal` through the plain versions only, on any device."""
    return _Int8MatmulCal.apply(x, q, scale, a_scale, None, bool(bwd_int8), _CAL_PLAIN)


def int8_matmul_dycal_ref(x, q, scale, a_scale, dy_scale, bwd_int8: bool = True):
    """:func:`int8_matmul_dycal` through the plain versions only, on any device."""
    return _Int8MatmulCal.apply(x, q, scale, a_scale, dy_scale, bool(bwd_int8), _CAL_PLAIN)
