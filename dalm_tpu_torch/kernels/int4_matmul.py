"""K5: the int4 weight-dequant matmul of the 4-bit serving tiers.

Replaces ``dalm_tpu/kernels/int4_matmul.py``: ``_int4_matmul_fwd_pallas``
(the float variants and nf4, ``pallas_call`` at ``:496``; the ``i8mxu``
variant at ``:464``), ``_int4pc_matmul_fwd_pallas`` (``:299``) and the
``int4_matmul`` custom gradient. The kernel is hand-written CUDA for
``sm_90a``, ``csrc/int4_matmul.cu``: one template, five instances; its header
says what bounds it on an H100 and what the design does about it. Beside it
stand the plain PyTorch versions (``*_ref``), which the wrapper takes for CPU
tensors only: on a CUDA tensor it launches the kernel or raises.

``x2 (M, K) @ W`` with ``q4 (K/2, N)`` uint8 in the half-split layout of
``models/quant.py`` (packed row r = K-row r in the low nibble, K-row K/2 + r in
the high one) and ``scale4 (K/group, N)`` f32 (``(1, N)`` for pcol). Output in
``x2.dtype``. Instances, as the reference's variants compute:

- ``base`` (variants "base" and "floorsplit", which give the same values by
  construction): ``bf16(x) @ bf16(f32(nib - 8) * scale[g])``, f32 sums;
- ``nf4``: the same with ``NF4_CODEBOOK[nib] * absmax[g]``;
- ``groupmm`` (variants "groupmm" and "decomp", an exact algebraic rewrite of
  groupmm): per group ``p = bf16(x) @ bf16(nib - 8)`` in f32, then
  ``acc += p_lo * s_lo[g] + p_hi * s_hi[g]`` in group order;
- ``i8mxu``: ``xq, xs = rowquant(x)`` (K2); per group int8 x int8 -> int32
  products, ``acc += f32(p_lo) * s_lo[g] + f32(p_hi) * s_hi[g]``; ``acc * xs``;
- ``pcol``: ``xq, xs = rowquant(x)``; int32 sums over all of K;
  ``(f32(acc) * xs) * s``.

``int4_matmul`` routes as the reference does (``:553-593``): a shape that
``_kernel_feasible`` / ``_pcol_feasible`` rejects, or whose N is not a
multiple of 8 (the kernels' column pairs), takes ``x @ dequant(W)`` in
``x.dtype`` on any device; an admitted one takes the instance named by
``nf4`` / ``pcol`` or else by ``DEFAULT_VARIANT`` (read from
``DALM_INT4_VARIANT`` at import, looked up at every call). The JAX package
runs the kernel only on a TPU and dequantises everywhere else.

On the card ``int4_matmul_fwd`` has two routes (``_route``). ``"fused"``:
the one-launch kernel of ``csrc/int4_matmul.cu``, which dequantises inside its
product loop (decode's few rows, float32 activations, groupmm / i8mxu / pcol).
``"prefill"``: bfloat16 activations of base or nf4 with at least ``M_PREFILL``
rows take ``csrc/int4_prefill.cu``, a pre-pass that writes the weight once as
bf16 ``Wt (N, K)`` into a scratch (``prefill_dequant``) and a wgmma / TMA GEMM
``x @ Wt^T`` (``prefill_gemm``); the same values up to the order of the f32 sums.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from dalm_tpu_torch.kernels.int8_matmul import _int_dot_ref, rowquant, rowquant_ref
from dalm_tpu_torch.models.quant import dequantize_tensor_int4, nf4_codebook

VARIANTS = ("base", "groupmm", "decomp", "floorsplit", "i8mxu", "nf4")
# variant name -> kernel instance; "pcol" is chosen by the storage, not by name
INSTANCE = {"base": "base", "floorsplit": "base", "groupmm": "groupmm", "decomp": "groupmm",
            "i8mxu": "i8mxu", "nf4": "nf4", "pcol": "pcol"}
INSTANCES = ("base", "groupmm", "nf4", "i8mxu", "pcol")
_MODE = {name: i for i, name in enumerate(INSTANCES)}  # the C side's mode numbers

DEFAULT_VARIANT = os.environ.get("DALM_INT4_VARIANT", "base")
if DEFAULT_VARIANT not in VARIANTS:
    raise ValueError(f"DALM_INT4_VARIANT={DEFAULT_VARIANT!r} not in {sorted(VARIANTS)}")

TILE_HALF = 32  # packed rows per k-step of the kernel (64 K values: 32 low, 32 high)

ROUTES = ("fused", "prefill")
PREFILL_INSTANCES = ("base", "nf4")  # the instances that scale the weight before the product
# Rows from which bf16 base / nf4 take the prefill route: the crossover of the two routes measured on an
# H100 80GB HBM3 at 700 W (chip_smoke.py's k5 phase, "[k5] crossover"; PERF.md section 6): the fused kernel is
# faster at 128 rows, the prefill route from 192 on, at (K, N) = (4096, 4096) and (11008, 4096). Decode's 32
# rows stay below it.
M_PREFILL = 192

_lib_handle = None
_prefill_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from dalm_tpu_torch.kernels import build

        lib = build.load("int4_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dalm_i4_matmul.argtypes = [i, i, p, p, p, p, i, i, i, i, i, p, p, p]
        lib.dalm_i4_matmul.restype = i
        _lib_handle = lib
    return _lib_handle


def _prefill_lib():
    global _prefill_handle
    if _prefill_handle is None:
        from dalm_tpu_torch.kernels import build

        lib = build.load("int4_prefill")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dalm_i4_dequant_t.argtypes = [i, p, p, i, i, i, p, p]
        lib.dalm_i4_dequant_t.restype = i
        lib.dalm_bf16_gemm_nt.argtypes = [p, p, i, i, i, p, p]
        lib.dalm_bf16_gemm_nt.restype = i
        _prefill_handle = lib
    return _prefill_handle


# --------------------------------------------------------------------------
# The reference's routing rule
# --------------------------------------------------------------------------

def _fit(dim: int, want: int) -> int:
    b = min(want, dim)
    while b > 1 and dim % b:
        b //= 2
    return max(b, 1)


def _kernel_feasible(half: int, group: int) -> bool:
    """The reference's rule (``:553-565``): some multiple of ``8 * group`` that
    is also a multiple of 128 divides K/2."""
    unit = 8 * group
    t = unit
    while t <= half:
        if half % t == 0 and t % 128 == 0:
            return True
        t += unit
    return False


def _pcol_feasible(half: int, n: int) -> bool:
    bn = _fit(n, 512)
    return half % 128 == 0 and (bn % 128 == 0 or bn == n)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _nibbles(q4: torch.Tensor) -> tuple:
    return (q4 & 0xF).long(), (q4 >> 4).long()


def _ref_float(x2: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor, nf4: bool) -> torch.Tensor:
    """base / nf4: the weight is formed in f32, rounded to bf16, and multiplied
    with bf16(x) in f32."""
    lo, hi = _nibbles(q4)
    if nf4:
        cb = nf4_codebook(q4.device)
        q = torch.cat([cb[lo], cb[hi]], dim=0)
    else:
        q = torch.cat([lo - 8, hi - 8], dim=0).float()
    w = (q * torch.repeat_interleave(scale4, x2.shape[1] // scale4.shape[0], dim=0)).to(torch.bfloat16)
    return (x2.to(torch.bfloat16).float() @ w.float()).to(x2.dtype)


def _fold_groups(xl: torch.Tensor, xh: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor) -> torch.Tensor:
    """``acc += p_lo * s_lo[g] + p_hi * s_hi[g]`` over the groups in order, each
    ``p`` the f32 product of one group's columns of ``xl`` / ``xh`` (M, K/2) and
    its ``nib - 8`` rows. The products are batched a few groups at a time."""
    M, half = xl.shape
    G = scale4.shape[0] // 2
    g = half // G
    N = q4.shape[1]
    lo, hi = _nibbles(q4)
    wl = (lo - 8).float().reshape(G, g, N)
    wh = (hi - 8).float().reshape(G, g, N)
    xl, xh = xl.reshape(M, G, g).transpose(0, 1), xh.reshape(M, G, g).transpose(0, 1)
    acc = torch.zeros((M, N), dtype=torch.float32, device=xl.device)
    step = max((1 << 27) // max(M * N, 1), 1)
    for g0 in range(0, G, step):
        pl, ph = torch.bmm(xl[g0:g0 + step], wl[g0:g0 + step]), torch.bmm(xh[g0:g0 + step], wh[g0:g0 + step])
        for j in range(pl.shape[0]):
            acc = acc + (pl[j] * scale4[g0 + j] + ph[j] * scale4[G + g0 + j])
    return acc


def _ref_groupmm(x2, q4, scale4):
    half = q4.shape[0]
    xb = x2.to(torch.bfloat16).float()
    return _fold_groups(xb[:, :half], xb[:, half:], q4, scale4).to(x2.dtype)


def _ref_i8mxu(x2, q4, scale4):
    """int8 products are exact in f32 (a group's |sum| stays below 2^24)."""
    half = q4.shape[0]
    xq, xs = rowquant_ref(x2)
    xf = xq.float()
    return (_fold_groups(xf[:, :half], xf[:, half:], q4, scale4) * xs).to(x2.dtype)


def _ref_pcol(x2, q4, scale4):
    lo, hi = _nibbles(q4)
    w = torch.cat([lo - 8, hi - 8], dim=0).to(torch.int8)
    xq, xs = rowquant_ref(x2)
    return ((_int_dot_ref(xq, w).float() * xs) * scale4).to(x2.dtype)


def int4_matmul_fwd_ref(x2: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor, instance: str) -> torch.Tensor:
    """Plain PyTorch K5, in the instance's order of operations."""
    if instance in ("base", "nf4"):
        return _ref_float(x2, q4, scale4, instance == "nf4")
    if instance == "groupmm":
        return _ref_groupmm(x2, q4, scale4)
    if instance == "i8mxu":
        return _ref_i8mxu(x2, q4, scale4)
    if instance == "pcol":
        return _ref_pcol(x2, q4, scale4)
    raise ValueError(f"unknown K5 instance {instance!r}; one of {INSTANCES}")


def prefill_dequant_ref(q4: torch.Tensor, scale4: torch.Tensor, nf4: bool = False) -> torch.Tensor:
    """Plain pre-pass: the weight ``bf16(f32(decode(nib)) * scale[g])`` as ``Wt (N, K)``."""
    return _dequant(q4, scale4, torch.bfloat16, nf4).T.contiguous()


def prefill_gemm_ref(x2: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Plain GEMM: ``bf16(x2) @ Wt^T`` with f32 sums, in ``x2.dtype``."""
    return (x2.to(torch.bfloat16).float() @ wt.float().T).to(x2.dtype)


# --------------------------------------------------------------------------
# The kernels
# --------------------------------------------------------------------------

def _check_weight(q4: torch.Tensor, scale4: torch.Tensor, instance: str, K: int) -> int:
    """Raise on a packed weight the kernels do not take; returns the group (K for pcol)."""
    if instance not in INSTANCES:
        raise ValueError(f"unknown K5 instance {instance!r}; one of {INSTANCES}")
    if q4.dtype != torch.uint8 or scale4.dtype != torch.float32:
        raise TypeError(f"int4_matmul takes uint8 q4 and float32 scale4, not {q4.dtype} / {scale4.dtype}")
    if q4.dim() != 2 or scale4.dim() != 2:
        raise ValueError("int4_matmul: q4 and scale4 must be 2-D")
    half, N = q4.shape
    if K != 2 * half or scale4.shape[1] != N:
        raise ValueError(f"int4_matmul: shapes K={K}, {tuple(q4.shape)}, {tuple(scale4.shape)} do not agree")
    if half % TILE_HALF or N % 8:
        raise ValueError(f"int4_matmul: needs K/2 a multiple of {TILE_HALF} and N a multiple of 8 (K={K}, N={N})")
    if instance == "pcol":
        if scale4.shape[0] != 1:
            raise ValueError("int4_matmul: the per-column instance takes scale4 (1, N)")
        return K
    rows = scale4.shape[0]
    group = K // rows if rows and K % rows == 0 else 0
    if not group or half % group or group % 16:
        raise ValueError(f"int4_matmul: scale4 has {rows} rows: the group must divide K/2 = {half} "
                         f"and be a multiple of 16")
    return group


def _check_cuda(device, what: str = "int4_matmul", **tensors) -> None:
    for name, t in tensors.items():
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{what}: {name} must be on the same CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")


def _check(x2: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor, instance: str) -> int:
    """Raise on anything the kernel does not take; returns the group (K for pcol)."""
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int4_matmul takes float32 or bfloat16 activations, not {x2.dtype}")
    if x2.dim() != 2:
        raise ValueError("int4_matmul: x2 must be 2-D")
    if x2.shape[0] < 1:
        raise ValueError("int4_matmul: needs M >= 1")
    group = _check_weight(q4, scale4, instance, x2.shape[1])
    _check_cuda(x2.device, x2=x2, q4=q4, scale4=scale4)
    return group


def _splits(M: int, N: int, half: int, group: int, instance: str, sms: int) -> int:
    """How many slices of K/2 the launch runs side by side (1 unless the output
    tiles alone leave the SMs idle, as at decode's M = 32). Where the scales
    fold per group (groupmm, i8mxu) a slice holds whole groups."""
    tiles = -(-M // 64) * -(-N // 128)
    want = -(-2 * sms // tiles)
    if want <= 1:
        return 1
    unit = TILE_HALF
    if instance in ("groupmm", "i8mxu"):
        unit = TILE_HALF * group // math.gcd(TILE_HALF, group)
    units = half // unit
    return max(d for d in range(1, min(want, units) + 1) if units % d == 0)


def launch(instance: str, a: torch.Tensor, xs, q4: torch.Tensor, scale4: torch.Tensor, group: int, splits: int,
           ws, out: torch.Tensor) -> None:
    """One launch of the kernel on checked operands: ``a`` is x (M, K), or xq (M, K) int8 with its row scales
    ``xs`` for i8mxu / pcol; ``ws`` the (splits, M, N) f32 scratch when ``splits > 1``; writes ``out``."""
    M, K = a.shape
    N = q4.shape[1]
    err = _lib().dalm_i4_matmul(
        _MODE[instance], int(out.dtype == torch.bfloat16), a.data_ptr(), xs.data_ptr() if xs is not None else None,
        q4.data_ptr(), scale4.data_ptr(), M, K, N, group, splits, ws.data_ptr() if ws is not None else None,
        out.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4_matmul[{instance}] kernel launch failed: CUDA error {err}")


def fused(x2: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor, instance: str, group: int) -> torch.Tensor:
    """The fused route on operands ``_check`` passed (``group`` is what it returned), whatever ``_route`` says:
    K2's ``rowquant`` for i8mxu and pcol, then one launch of ``csrc/int4_matmul.cu``."""
    M = x2.shape[0]
    half, N = q4.shape
    splits = _splits(M, N, half, group, instance, torch.cuda.get_device_properties(x2.device).multi_processor_count)
    a, xs = (rowquant(x2) if instance in ("i8mxu", "pcol") else (x2, None))
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=x2.device) if splits > 1 else None
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    launch(instance, a, xs, q4, scale4, group, splits, ws, out)
    return out


def launch_dequant(q4: torch.Tensor, scale4: torch.Tensor, group: int, nf4: bool, wt: torch.Tensor) -> None:
    """One launch of the pre-pass on checked operands: writes ``wt (N, K)`` bf16."""
    half, N = q4.shape
    err = _prefill_lib().dalm_i4_dequant_t(int(nf4), q4.data_ptr(), scale4.data_ptr(), half, N, group, wt.data_ptr(),
                                           torch.cuda.current_stream(q4.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4 prefill pre-pass launch failed: CUDA error {err}")
    prefill_dequant.launches["nf4" if nf4 else "base"] += 1


def launch_gemm(x2: torch.Tensor, wt: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of the GEMM on checked operands: ``out (M, N) = x2 (M, K) @ wt (N, K)^T``, all bf16."""
    M, K = x2.shape
    N = wt.shape[0]
    err = _prefill_lib().dalm_bf16_gemm_nt(x2.data_ptr(), wt.data_ptr(), M, N, K, out.data_ptr(),
                                           torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:  # >= 900: the tensor-map encoder is missing (900) or refused a map (1000 + CUresult)
        raise RuntimeError(f"bf16 wgmma GEMM launch failed: error {err}")
    prefill_gemm.launches += 1


def prefill_dequant(q4: torch.Tensor, scale4: torch.Tensor, nf4: bool = False) -> torch.Tensor:
    """The prefill route's pre-pass: ``Wt (N, K)`` bf16 from ``q4 (K/2, N)`` and ``scale4 (K/group, N)``;
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if not q4.is_cuda:
        return prefill_dequant_ref(q4, scale4, nf4)
    half, N = q4.shape
    group = _check_weight(q4, scale4, "nf4" if nf4 else "base", 2 * half)
    _check_cuda(q4.device, "prefill_dequant", q4=q4, scale4=scale4)
    wt = torch.empty((N, 2 * half), dtype=torch.bfloat16, device=q4.device)
    launch_dequant(q4, scale4, group, nf4, wt)
    return wt


def prefill_gemm(x2: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """The prefill route's GEMM: ``x2 (M, K) @ wt (N, K)^T``, bf16 in and out, f32 sums; the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if not x2.is_cuda:
        return prefill_gemm_ref(x2, wt)
    if x2.dtype != torch.bfloat16 or wt.dtype != torch.bfloat16:
        raise TypeError(f"prefill_gemm takes bfloat16 x2 and wt, not {x2.dtype} / {wt.dtype}")
    if x2.dim() != 2 or wt.dim() != 2 or wt.shape[1] != x2.shape[1] or x2.shape[0] < 1 or x2.shape[1] % 64 \
            or wt.shape[0] % 8:
        raise ValueError(f"prefill_gemm: needs x2 (M, K), wt (N, K) with M >= 1, K a multiple of 64 and N of 8, "
                         f"not {tuple(x2.shape)}, {tuple(wt.shape)}")
    _check_cuda(x2.device, "prefill_gemm", x2=x2, wt=wt)
    M, N = x2.shape[0], wt.shape[0]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x2.device)
    launch_gemm(x2, wt, out)
    return out


prefill_dequant.launches = dict.fromkeys(PREFILL_INSTANCES, 0)
prefill_gemm.launches = 0


def _route(x2: torch.Tensor, instance: str) -> str:
    """The route a CUDA call takes: ``"prefill"`` for bf16 base / nf4 with at least ``M_PREFILL`` rows."""
    if instance in PREFILL_INSTANCES and x2.dtype == torch.bfloat16 and x2.shape[0] >= M_PREFILL:
        return "prefill"
    return "fused"


def int4_matmul_fwd(x2: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor, instance: str) -> torch.Tensor:
    """One K5 instance on ``x2 (M, K)``: on CUDA tensors the route ``_route`` picks (the fused kernel, after
    K2's ``rowquant`` for i8mxu and pcol, or the pre-pass and the GEMM), the plain version for CPU tensors."""
    if not x2.is_cuda:
        return int4_matmul_fwd_ref(x2, q4, scale4, instance)
    group = _check(x2, q4, scale4, instance)
    route = _route(x2, instance)
    if route == "prefill":  # the scratch Wt is freed when prefill_gemm returns
        out = prefill_gemm(x2, prefill_dequant(q4, scale4, instance == "nf4"))
    else:
        out = fused(x2, q4, scale4, instance, group)
    int4_matmul_fwd.launches[instance] += 1
    int4_matmul_fwd.route_launches[instance, route] += 1
    return out


int4_matmul_fwd.launches = dict.fromkeys(INSTANCES, 0)
int4_matmul_fwd.route_launches = {(i, r): 0 for i in INSTANCES for r in ROUTES}


# --------------------------------------------------------------------------
# int4_matmul with its gradient
# --------------------------------------------------------------------------

def _dequant(q4, scale4, dtype, nf4: bool) -> torch.Tensor:
    d = {"q4": q4, "scale4": scale4}
    if nf4:
        d["nf4"] = None
    return dequantize_tensor_int4(d, dtype)


def _forward(x, q4, scale4, nf4, pcol, fwd):
    lead, K = x.shape[:-1], x.shape[-1]
    half, N = q4.shape
    x2 = x.reshape(math.prod(lead), K)
    if pcol:
        feasible, instance = _pcol_feasible(half, N), "pcol"
    else:
        feasible = _kernel_feasible(half, K // scale4.shape[0])
        instance = "nf4" if nf4 else INSTANCE[DEFAULT_VARIANT]
    if feasible and N % 8 == 0:
        y = fwd(x2.contiguous(), q4, scale4, instance)
    else:  # the reference's own fallback
        y = x2 @ _dequant(q4, scale4, x.dtype, nf4 and not pcol)
    return y.reshape(*lead, N)


class _Int4Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q4, scale4, nf4, pcol, fwd):
        ctx.save_for_backward(q4, scale4)
        ctx.nf4 = nf4 and not pcol
        return _forward(x, q4, scale4, nf4, pcol, fwd)

    @staticmethod
    def backward(ctx, dy):
        # Frozen storage: only dx flows, dx = bf16(dy) @ bf16(W)^T in f32 (the reference's XLA product).
        q4, scale4 = ctx.saved_tensors
        w = _dequant(q4, scale4, torch.bfloat16, ctx.nf4)
        dx = (dy.to(torch.bfloat16).float() @ w.float().T).to(dy.dtype)
        dscale = torch.zeros_like(scale4) if ctx.needs_input_grad[2] else None
        return dx, None, dscale, None, None, None


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor, nf4: bool = False,
                pcol: bool = False) -> torch.Tensor:
    """``x (..., K) @ dequant(q4, scale4)`` -> ``(..., N)`` in ``x.dtype``, with
    K5 where the reference's rule admits the shape; gradient for ``x`` only."""
    return _Int4Matmul.apply(x, q4, scale4, bool(nf4), bool(pcol), int4_matmul_fwd)


def int4_matmul_ref(x: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor, nf4: bool = False,
                    pcol: bool = False) -> torch.Tensor:
    """The same routing and gradient through the plain versions only, on any device."""
    return _Int4Matmul.apply(x, q4, scale4, bool(nf4), bool(pcol), int4_matmul_fwd_ref)
