"""K1 + K2: W8A8 int8 matmul for the frozen QLoRA base.

Replaces ``dalm_tpu/kernels/int8_matmul.py``: ``rowquant`` (Pallas
``_rowquant_kernel``, K2), ``_w8a8_fused_pallas`` (``_w8a8_fused_kernel``,
K1), the two int8 products ``_i8_dot_last`` left to the compiler, and the
``int8_matmul`` custom gradient. The kernels are hand-written CUDA for
``sm_90a``, ``csrc/int8_matmul.cu``; its header says what bounds each on an
H100 and what the design does about it. Beside every kernel stands its plain
PyTorch version (``*_ref``), which a wrapper takes for CPU tensors only: on a
CUDA tensor it launches the kernel or raises.

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
        lib.dalm_i8_w8a8_fused.argtypes = [p, i, p, p, i, i, i, i, p, p, p, p]
        lib.dalm_i8_gemm_kn.argtypes = [p, p, i, i, i, p, p]
        lib.dalm_i8_gemm_nt.argtypes = [p, p, i, i, i, p, p]
        for fn in ("dalm_i8_rowquant", "dalm_i8_w8a8_fused", "dalm_i8_gemm_kn", "dalm_i8_gemm_nt"):
            getattr(lib, fn).restype = i
        _lib_handle = lib
    return _lib_handle


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


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

def rowquant_ref(x: torch.Tensor, colscale: torch.Tensor | None = None):
    """Plain PyTorch K2. Returns (q int8 ``x.shape``, s f32 ``x.shape[:-1] + (1,)``)."""
    xf = x.float()
    if colscale is not None:
        xf = xf * colscale.reshape(-1).float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    # A tensor divisor: true division on every backend (a Python scalar may
    # become a multiply by its reciprocal).
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0), torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def rowquant(x: torch.Tensor, colscale: torch.Tensor | None = None):
    """Symmetric per-row (last axis) int8: ``x * colscale ~= q * s``."""
    if not x.is_cuda:
        return rowquant_ref(x, colscale)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rowquant takes float32 or bfloat16, not {x.dtype}")
    K = x.shape[-1]
    R = x.numel() // K if K else 0
    if R < 1 or K < 1:
        raise ValueError("rowquant needs at least one row and one column")
    if colscale is not None and (colscale.dtype != torch.float32 or colscale.numel() != K):
        raise TypeError("colscale must be K float32 values")
    _check_cuda("rowquant", x=x, colscale=colscale)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    err = _lib().dalm_i8_rowquant(
        x.data_ptr(), int(x.dtype == torch.bfloat16), colscale.data_ptr() if colscale is not None else None,
        R, K, q.data_ptr(), s.data_ptr(), _stream(x))
    _launched(err, "rowquant")
    rowquant.launches += 1
    return q, s


rowquant.launches = 0


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


def int8_gemm_kn(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``a (M, K) int8 . q (K, N) int8 -> (M, N) int32`` (the unfused forward)."""
    if not a.is_cuda:
        return int8_gemm_kn_ref(a, q)
    _check_gemm("int8_gemm_kn", a, q, 0)
    M, K = a.shape
    N = q.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    _launched(_lib().dalm_i8_gemm_kn(a.data_ptr(), q.data_ptr(), M, K, N, out.data_ptr(), _stream(a)), "int8_gemm_kn")
    int8_gemm_kn.launches += 1
    return out


def int8_gemm_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, C) int8 . b (N, C)^T int8 -> (M, N) int32`` (dx of the int8 backward:
    ``b`` is the weight ``q (K, N)`` itself, contracted over its contiguous axis)."""
    if not a.is_cuda:
        return int8_gemm_nt_ref(a, b)
    _check_gemm("int8_gemm_nt", a, b, 1)
    M, C = a.shape
    N = b.shape[0]
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    _launched(_lib().dalm_i8_gemm_nt(a.data_ptr(), b.data_ptr(), M, C, N, out.data_ptr(), _stream(a)), "int8_gemm_nt")
    int8_gemm_nt.launches += 1
    return out


int8_gemm_kn.launches = 0
int8_gemm_nt.launches = 0


# --------------------------------------------------------------------------
# K1: matmul with in-kernel activation quantisation
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
    """Plain PyTorch K1, in the kernel's order of operations."""
    M, K = x2.shape
    bk = fit_div(K, 512)
    if not bk:
        raise ValueError(f"K={K} has no k-block that is a multiple of 128")
    acc = torch.zeros((M, q.shape[1]), dtype=torch.float32, device=x2.device)
    for k0 in range(0, K, bk):
        tq, ts = rowquant_ref(x2[:, k0:k0 + bk])
        acc = acc + _int_dot_ref(tq, q[k0:k0 + bk]).float() * ts
    return (acc * scale.reshape(1, -1).float()).to(x2.dtype)


def w8a8_fused(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x2 (M, K) float @ q (K, N) int8 * scale (1, N)`` with per-(row, k-block)
    activation quantisation inside the kernel; output in ``x2.dtype``."""
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
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    xq = torch.empty((M, K), dtype=torch.int8, device=x2.device)  # the kernel's scratch
    xs = torch.empty((M, K // bk), dtype=torch.float32, device=x2.device)
    err = _lib().dalm_i8_w8a8_fused(
        x2.data_ptr(), int(x2.dtype == torch.bfloat16), q.data_ptr(), scale.data_ptr(),
        M, K, N, bk, xq.data_ptr(), xs.data_ptr(), out.data_ptr(), _stream(x2))
    _launched(err, "w8a8_fused")
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
