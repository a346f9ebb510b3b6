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

``int4_matmul`` takes the instance named by ``nf4`` / ``pcol`` or else by
``DEFAULT_VARIANT`` (read from ``DALM_INT4_VARIANT`` at import, looked up at
every call). On CPU tensors it routes as the reference does (``:553-593``): a
shape that ``_kernel_feasible`` / ``_pcol_feasible`` rejects (Mosaic's
128-lane tiles), or whose N is not a multiple of 8, takes ``x @ dequant(W)`` in
``x.dtype``, the rest the instance's plain version. On CUDA tensors that rule
does not bind: every shape goes to ``int4_matmul_fwd``, which launches the
kernels wherever their own geometry (``_check``, ``_route``) takes the shape
(Gemma3-1B's K 1,152 at group 8, Phi-3's int4pc lm_head at N 32,064, which the
reference's rule rejects, among them) and raises where it does not. The JAX
package runs the kernel only on a TPU and dequantises everywhere else.

On the card ``int4_matmul_fwd`` has four routes (``_route``). ``"fused"``:
the decode kernel of ``csrc/int4_matmul.cu`` (decode's few rows, float32
activations; base / nf4 at a group of 8 on instances of their own), one launch a call: it dequantises the nibbles in registers into a
swapped product (the weight is the 16-row operand, the x rows the narrow one),
reads them through a TMA ring fed by a producer warp (cp.async where TMA cannot
take the rows), and sums the slices of a split K in a thread-block cluster
(``_splits`` picks the geometry). Bfloat16
activations with at least ``M_PREFILL`` rows take ``csrc/int4_prefill.cu``:
``"prefill"`` for base and nf4, a pre-pass that writes the weight once as bf16
``Wt (N, K)`` into a scratch (``prefill_dequant``) and a wgmma / TMA GEMM
``x @ Wt^T`` (``prefill_gemm``), the same values up to the order of the f32
sums; ``"fold"`` for groupmm and i8mxu, a pre-pass that writes the bare
nibbles ``Wn = nib - 8`` (``prefill_nibbles``; no scale, so one scratch serves
both) and a wgmma / TMA GEMM that folds each group's two products with their
scales in registers, in group order (``prefill_fold``). i8mxu's operand is
K2's output written as bf16 (``rowquant(x, dtype=torch.bfloat16)``, exact),
so its products are exact in f32 and the route equals the plain version bit
for bit; groupmm's differ from it only in the order of each group's f32 sums.
``"int8"`` for pcol: K2's ``rowquant`` (int8), the nibble pre-pass writing
``nib - 8`` as int8 (``prefill_nibbles(q4, torch.int8)``) and the s8 ``wgmma``
/ TMA GEMM of ``csrc/int8_matmul.cu`` whose epilogue applies the row's and the
column's scale to one int32 sum over all of K (``int8_gemm_scaled``): the
plain version's arithmetic, so the route equals it bit for bit.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import NamedTuple

import torch

from dalm_tpu_torch.kernels.int8_matmul import (_int_dot_ref, check_scaled_maps, launch_gemm_scaled,
                                                 launch_rowquant, rowquant, rowquant_ref)
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

TILE_HALF = 32  # K/2 must be a multiple of this (the reference's blocks; every route's kernels take it)
# The fused kernel's geometry (csrc/int4_matmul.cu): a k-step is 16 packed rows (16 K values of each half), a
# block's output tile TILE_M rows by TILE_N columns, at most MAX_CLUSTER slices of K/2 in one cluster.
K_STEP = 16
# The base / nf4 instances for groups that are a multiple of FUSED_GROUP_MIN but not of K_STEP (Gemma3-1B's K 1,152
# packs at 8) scale each 8-row half of a k-step with its own group's row.
FUSED_GROUP_MIN = 8
TILE_M = 32
TILE_N = 128
MAX_CLUSTER = 8

ROUTES = ("fused", "prefill", "fold", "int8")
# The route of each instance for bfloat16 activations from M_PREFILL rows on: base and nf4 scale the weight before
# the product, groupmm and i8mxu after it, per group; pcol after one int8 product over all of K.
PREFILL_ROUTE = {"base": "prefill", "nf4": "prefill", "groupmm": "fold", "i8mxu": "fold", "pcol": "int8"}
PREFILL_INSTANCES = tuple(PREFILL_ROUTE)
SCALED_INSTANCES = tuple(i for i, r in PREFILL_ROUTE.items() if r == "prefill")  # prefill_dequant's decodes
FOLD_INSTANCES = tuple(i for i, r in PREFILL_ROUTE.items() if r == "fold")
FOLD_GROUPS = (16, 32, 64, 128)  # the fold GEMM's instances (a group of 16 k16 steps is 1, 2, 4 or 8 products)
_DQ_MODE = {"base": 0, "nf4": 1, "nibbles": 2, "nibbles_i8": 3}  # dalm_i4_dequant_t's modes
# Rows from which bf16 activations take the prefill route (base / nf4), the fold route (groupmm / i8mxu) or the
# int8 route (pcol). Set at 192 from the crossovers with the first, mma.sync fused kernel; re-measured against the
# rebuilt decode kernel (chip_smoke.py's k5 phase, "[k5] crossover", device time by CUDA graph, H100 80GB HBM3 at
# 700 W; PERF.md section 7): at (K, N) = (4096, 4096) and (11008, 4096) the prefill route is now faster from 384
# rows, the fold route from 384-512 and the int8 route from 512-1024. Kept at 192: prefill's 8192 rows and decode's
# 32 take the same routes either way; between 192 and 512 rows the routes cost up to 1.64x the fused kernel.
M_PREFILL = 192

_lib_handle = None
_prefill_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from dalm_tpu_torch.kernels import build

        lib = build.load("int4_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dalm_i4_matmul.argtypes = [i, i, p, p, p, p, i, i, i, i, i, p, p]
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
        lib.dalm_i4_fold_maps.argtypes = [p, p, p, i, i, i, i]
        lib.dalm_i4_fold_maps.restype = i
        lib.dalm_i4_fold_gemm.argtypes = [i, p, p, p, p, i, i, i, i, p, p]
        lib.dalm_i4_fold_gemm.restype = i
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


def _nibble_weights(q4: torch.Tensor) -> tuple:
    """The unscaled ``nib - 8`` of both halves, (K/2, N) f32 each."""
    lo, hi = _nibbles(q4)
    return (lo - 8).float(), (hi - 8).float()


def _fold_groups(xl: torch.Tensor, xh: torch.Tensor, wl: torch.Tensor, wh: torch.Tensor,
                 scale4: torch.Tensor) -> torch.Tensor:
    """``acc += p_lo * s_lo[g] + p_hi * s_hi[g]`` over the groups in order, each
    ``p`` the f32 product of one group's columns of ``xl`` / ``xh`` (M, K/2) and
    its rows of ``wl`` / ``wh`` (K/2, N), the unscaled ``nib - 8``. The products
    are batched a few groups at a time."""
    M, half = xl.shape
    G = scale4.shape[0] // 2
    g = half // G
    N = wl.shape[1]
    wl, wh = wl.reshape(G, g, N), wh.reshape(G, g, N)
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
    return _fold_groups(xb[:, :half], xb[:, half:], *_nibble_weights(q4), scale4).to(x2.dtype)


def _ref_i8mxu(x2, q4, scale4):
    """int8 products are exact in f32 (a group's |sum| stays below 2^24)."""
    half = q4.shape[0]
    xq, xs = rowquant_ref(x2)
    xf = xq.float()
    return (_fold_groups(xf[:, :half], xf[:, half:], *_nibble_weights(q4), scale4) * xs).to(x2.dtype)


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


def prefill_nibbles_ref(q4: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain nibble pre-pass: ``Wn (N, K)`` in ``dtype`` (bfloat16 or int8), ``Wn[n][k] = nib(k, n) - 8``, no
    scale."""
    lo, hi = _nibbles(q4)
    return torch.cat([lo - 8, hi - 8], dim=0).to(dtype).T.contiguous()


def prefill_fold_ref(a: torch.Tensor, wn: torch.Tensor, scale4: torch.Tensor, xs: torch.Tensor | None = None,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain fold GEMM: ``_fold_groups`` of ``bf16(a) (M, K)`` and ``wn (N, K)`` with ``scale4``, times the rows'
    scales ``xs (M, 1)`` where given (i8mxu: ``a`` is K2's output), in ``dtype`` (the kernel writes bfloat16)."""
    half = wn.shape[1] // 2
    af, w = a.to(torch.bfloat16).float(), wn.float().T
    acc = _fold_groups(af[:, :half], af[:, half:], w[:half], w[half:], scale4)
    return (acc if xs is None else acc * xs).to(dtype)


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
    if not group or half % group:
        raise ValueError(f"int4_matmul: scale4 has {rows} rows: the group must divide K/2 = {half}")
    if group % K_STEP and instance not in SCALED_INSTANCES:
        raise ValueError(f"int4_matmul[{instance}]: a group of {group} is no multiple of {K_STEP}: the fused and "
                         f"the fold kernels fold whole k-steps")
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


class Geometry(NamedTuple):
    """The fused kernel's launch: ``splits`` slices of K/2 of ``slice_rows`` packed rows each, run as one
    thread-block cluster per output tile, over a grid of (N / TILE_N, M / TILE_M, splits) blocks."""
    splits: int
    slice_rows: int
    grid: tuple


def _splits(M: int, N: int, half: int, group: int, instance: str, sms: int) -> Geometry:
    """The fused kernel's cluster and slice geometry. Each block owns a TILE_M x TILE_N output tile and one slice
    of K/2; a slice is a whole number of k-steps (of whole groups where the scales fold per group: groupmm,
    i8mxu; base / nf4 scale each weight, so a group of 8 still splits on k-steps), at most MAX_CLUSTER slices (the
    portable cluster size). Where the tiles alone give every SM a block,
    one slice; else the fewest slices that give every SM two blocks (``N / TILE_N x M / TILE_M x splits >= 2
    sms``), or the most if none does. (Chosen by timing every split on an H100 at the Llama-2-7B shapes: fewer,
    longer blocks wait on their ring's latency; more slices pay for more epilogues.)"""
    tiles = (-(-N // TILE_N), -(-M // TILE_M))
    if tiles[0] * tiles[1] >= sms:
        return Geometry(1, half, (*tiles, 1))
    unit = K_STEP
    if instance in ("groupmm", "i8mxu"):
        unit = K_STEP * group // math.gcd(K_STEP, group)
    fits = [d for d in range(1, MAX_CLUSTER + 1) if (half // unit) % d == 0]
    splits = next((d for d in fits if tiles[0] * tiles[1] * d >= 2 * sms), fits[-1])
    return Geometry(splits, half // splits, (*tiles, splits))


_sms: dict = {}


def _sm_count(device: torch.device) -> int:
    """The device's SM count, looked up once per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def launch(instance: str, a: torch.Tensor, xs, q4: torch.Tensor, scale4: torch.Tensor, group: int,
           out: torch.Tensor) -> None:
    """One launch of the fused kernel on checked operands (counted in ``fused.launches[instance]``, and in
    ``fused.group8_launches[instance]`` too where base / nf4 take their instance for groups of 8): ``a`` is x
    (M, K), or xq (M, K) int8 with its row scales ``xs`` for i8mxu / pcol; writes ``out``."""
    M, K = a.shape
    N = q4.shape[1]
    geo = _splits(M, N, K // 2, group, instance, _sm_count(a.device))
    err = _lib().dalm_i4_matmul(
        _MODE[instance], int(out.dtype == torch.bfloat16), a.data_ptr(), xs.data_ptr() if xs is not None else None,
        q4.data_ptr(), scale4.data_ptr(), M, K, N, group, geo.splits, out.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4_matmul[{instance}] kernel launch failed: CUDA error {err}")
    fused.launches[instance] += 1
    if instance in SCALED_INSTANCES and group % K_STEP:
        fused.group8_launches[instance] += 1


def fused(x2: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor, instance: str, group: int) -> torch.Tensor:
    """The fused route on operands ``_check`` passed (``group`` is what it returned), whatever ``_route`` says:
    K2's ``rowquant`` for i8mxu and pcol, then one launch of ``csrc/int4_matmul.cu``."""
    a, xs = (rowquant(x2) if instance in ("i8mxu", "pcol") else (x2, None))
    out = torch.empty((x2.shape[0], q4.shape[1]), dtype=x2.dtype, device=x2.device)
    launch(instance, a, xs, q4, scale4, group, out)
    return out


fused.launches = dict.fromkeys(INSTANCES, 0)
fused.group8_launches = dict.fromkeys(SCALED_INSTANCES, 0)  # the base / nf4 instances for groups of 8


def launch_dequant(q4: torch.Tensor, scale4: torch.Tensor, group: int, nf4: bool, wt: torch.Tensor) -> None:
    """One launch of the pre-pass on checked operands: writes ``wt (N, K)`` bf16."""
    half, N = q4.shape
    err = _prefill_lib().dalm_i4_dequant_t(_DQ_MODE["nf4" if nf4 else "base"], q4.data_ptr(), scale4.data_ptr(),
                                           half, N, group, wt.data_ptr(),
                                           torch.cuda.current_stream(q4.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4 prefill pre-pass launch failed: CUDA error {err}")
    prefill_dequant.launches["nf4" if nf4 else "base"] += 1


def launch_nibbles(q4: torch.Tensor, wn: torch.Tensor) -> None:
    """One launch of the pre-pass in an unscaled mode on checked operands: writes ``wn (N, K)`` = nib - 8 in
    ``wn``'s type, bfloat16 (counted in ``prefill_nibbles.launches``) or int8 (in ``.int8_launches``)."""
    half, N = q4.shape
    i8 = wn.dtype == torch.int8
    err = _prefill_lib().dalm_i4_dequant_t(_DQ_MODE["nibbles_i8" if i8 else "nibbles"], q4.data_ptr(), None, half, N,
                                           16, wn.data_ptr(), torch.cuda.current_stream(q4.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4 nibble pre-pass launch failed: CUDA error {err}")
    if i8:
        prefill_nibbles.int8_launches += 1
    else:
        prefill_nibbles.launches += 1


def _fold_args(a: torch.Tensor, wn: torch.Tensor, scale4: torch.Tensor) -> tuple:
    M, K = a.shape
    return M, wn.shape[0], K // 2, K // scale4.shape[0]


def check_fold_maps(a: torch.Tensor, wn: torch.Tensor, scale4: torch.Tensor) -> None:
    """Encode the fold GEMM's tensor maps for these operands and launch nothing: raises where the launch would
    be refused, so the route can refuse before its first kernel runs."""
    err = _prefill_lib().dalm_i4_fold_maps(a.data_ptr(), wn.data_ptr(), scale4.data_ptr(), *_fold_args(a, wn, scale4))
    if err != 0:  # >= 900: the tensor-map encoder is missing (900) or refused a map (1000 + CUresult)
        raise RuntimeError(f"int4 fold GEMM: its tensor maps were refused: error {err}")


def launch_fold(a: torch.Tensor, wn: torch.Tensor, scale4: torch.Tensor, xs, out: torch.Tensor) -> None:
    """One launch of the fold GEMM on checked operands: groupmm without ``xs``, i8mxu with it; writes ``out``."""
    err = _prefill_lib().dalm_i4_fold_gemm(
        int(xs is not None), a.data_ptr(), wn.data_ptr(), scale4.data_ptr(), xs.data_ptr() if xs is not None else None,
        *_fold_args(a, wn, scale4), out.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4 fold GEMM launch failed: error {err}")
    prefill_fold.launches["groupmm" if xs is None else "i8mxu"] += 1


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


def prefill_nibbles(q4: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The unscaled pre-pass: ``Wn (N, K)`` = nib - 8 from ``q4 (K/2, N)``, no scale, in bfloat16 (the fold route)
    or int8 (the int8 route); the kernel for CUDA tensors, the plain version for CPU tensors."""
    if not q4.is_cuda:
        return prefill_nibbles_ref(q4, dtype)
    if q4.dtype != torch.uint8 or q4.dim() != 2 or dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"prefill_nibbles takes a 2-D uint8 q4 and writes bfloat16 or int8, not {q4.dtype} of "
                        f"{q4.dim()} dimensions into {dtype}")
    half, N = q4.shape
    if half % TILE_HALF or N % 8 or not half or not N:
        raise ValueError(f"prefill_nibbles: needs K/2 a multiple of {TILE_HALF} and N a multiple of 8 "
                         f"(K/2={half}, N={N})")
    _check_cuda(q4.device, "prefill_nibbles", q4=q4)
    wn = torch.empty((N, 2 * half), dtype=dtype, device=q4.device)
    launch_nibbles(q4, wn)
    return wn


def prefill_fold(a: torch.Tensor, wn: torch.Tensor, scale4: torch.Tensor, xs: torch.Tensor | None = None):
    """The fold route's GEMM: ``a (M, K)`` bf16 (groupmm: x; i8mxu: K2's output as bf16, with its row scales
    ``xs (M, 1)``), ``wn (N, K)`` from the nibble pre-pass, ``scale4 (K/group, N)``; bf16 out. The kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if not a.is_cuda:
        return prefill_fold_ref(a, wn, scale4, xs)
    if a.dtype != torch.bfloat16 or wn.dtype != torch.bfloat16 or scale4.dtype != torch.float32 or (
            xs is not None and xs.dtype != torch.float32):
        raise TypeError(f"prefill_fold takes bfloat16 a and wn, float32 scale4 and xs, not {a.dtype} / {wn.dtype} / "
                        f"{scale4.dtype}" + (f" / {xs.dtype}" if xs is not None else ""))
    if a.dim() != 2 or wn.dim() != 2 or scale4.dim() != 2 or a.shape[0] < 1 or wn.shape[1] != a.shape[1]:
        raise ValueError(f"prefill_fold: needs a (M, K) and wn (N, K), not {tuple(a.shape)}, {tuple(wn.shape)}")
    M, K = a.shape
    N, half = wn.shape[0], K // 2
    rows = scale4.shape[0]
    group = K // rows if rows and K % rows == 0 else 0
    if K % 64 or N % 8 or scale4.shape[1] != N or group not in FOLD_GROUPS or half % group:
        raise ValueError(f"prefill_fold: needs K a multiple of 64, N of 8 and scale4 (K/group, N) with a group in "
                         f"{FOLD_GROUPS} that divides K/2, not K={K}, N={N}, scale4 {tuple(scale4.shape)}")
    if xs is not None and tuple(xs.shape) != (M, 1):
        raise ValueError(f"prefill_fold: xs must be ({M}, 1), not {tuple(xs.shape)}")
    _check_cuda(a.device, "prefill_fold", a=a, wn=wn, scale4=scale4, **({"xs": xs} if xs is not None else {}))
    check_fold_maps(a, wn, scale4)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    launch_fold(a, wn, scale4, xs, out)
    return out


def fold(x2: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor, instance: str) -> torch.Tensor:
    """The fold route on bf16 operands ``_check`` passed, groupmm or i8mxu: (K2's ``rowquant`` into bf16 for
    i8mxu,) the nibble pre-pass and the fold GEMM, on one stream. Every scratch is allocated and the GEMM's tensor
    maps encoded before the first launch, so a refused map raises before any kernel runs or any count moves."""
    M, K = x2.shape
    N = q4.shape[1]
    wn = torch.empty((N, K), dtype=torch.bfloat16, device=x2.device)
    if instance == "i8mxu":
        a = torch.empty((M, K), dtype=torch.bfloat16, device=x2.device)
        xs = torch.empty((M, 1), dtype=torch.float32, device=x2.device)
    else:
        a, xs = x2, None
    check_fold_maps(a, wn, scale4)
    if xs is not None:
        launch_rowquant(x2, None, a, xs)
    launch_nibbles(q4, wn)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x2.device)
    launch_fold(a, wn, scale4, xs, out)
    return out


def int8_route(x2: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor) -> torch.Tensor:
    """The int8 route on bf16 operands ``_check`` passed (pcol): K2's ``rowquant`` (int8), the nibble pre-pass in
    int8 and the scaled s8 GEMM, on one stream. Every scratch is allocated and the GEMM's tensor maps encoded before
    the first launch, so a refused map raises before any kernel runs or any count moves; the scratch ``wn`` is
    freed on return."""
    M, K = x2.shape
    N = q4.shape[1]
    xq = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    xs = torch.empty((M, 1), dtype=torch.float32, device=x2.device)
    wn = torch.empty((N, K), dtype=torch.int8, device=x2.device)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x2.device)
    check_scaled_maps(xq, wn)
    launch_rowquant(x2, None, xq, xs)
    launch_nibbles(q4, wn)
    launch_gemm_scaled(xq, wn, xs, scale4, out)
    return out


prefill_dequant.launches = dict.fromkeys(SCALED_INSTANCES, 0)
prefill_gemm.launches = 0
prefill_nibbles.launches = 0  # the bfloat16 mode's launches (the fold route)
prefill_nibbles.int8_launches = 0  # the int8 mode's (the int8 route)
prefill_fold.launches = dict.fromkeys(FOLD_INSTANCES, 0)


def _route(x2: torch.Tensor, instance: str, group: int) -> str:
    """The route a CUDA call takes: bfloat16 activations with at least ``M_PREFILL`` rows of base / nf4
    (``"prefill"``), of groupmm / i8mxu with a group in ``FOLD_GROUPS`` (``"fold"``) and of pcol (``"int8"``); the
    rest ``"fused"``. Base / nf4 at a group of 8 (a multiple of ``FUSED_GROUP_MIN`` that is no multiple of
    ``K_STEP``; Gemma3-1B's K 1,152 packs at 8) route the same way, on the fused kernel's instances for such groups.
    At a group below 8 (K/2 = 32 x an odd number packs at 4) base / nf4 take ``"prefill"`` at any M, whose pre-pass
    reads each weight's own scale row; that route takes bfloat16 activations only, so it raises for float32 ones."""
    if group % FUSED_GROUP_MIN:  # _check admits such groups for base / nf4 only
        if x2.dtype != torch.bfloat16:
            raise ValueError(f"int4_matmul[{instance}]: a group of {group} takes the prefill route, which needs "
                             f"bfloat16 activations, not {x2.dtype} (the fused kernel needs a group that is a "
                             f"multiple of {FUSED_GROUP_MIN})")
        return "prefill"
    route = PREFILL_ROUTE.get(instance)
    if route == "fold" and group not in FOLD_GROUPS:
        return "fused"
    if route and x2.dtype == torch.bfloat16 and x2.shape[0] >= M_PREFILL:
        return route
    return "fused"


def int4_matmul_fwd(x2: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor, instance: str) -> torch.Tensor:
    """One K5 instance on ``x2 (M, K)``: on CUDA tensors the route ``_route`` picks (the fused kernel, after
    K2's ``rowquant`` for i8mxu and pcol; the pre-pass and the GEMM; the fold route; or the int8 route), the plain
    version for CPU tensors."""
    if not x2.is_cuda:
        return int4_matmul_fwd_ref(x2, q4, scale4, instance)
    group = _check(x2, q4, scale4, instance)
    route = _route(x2, instance, group)
    if route == "prefill":  # the scratch Wt is freed when prefill_gemm returns
        out = prefill_gemm(x2, prefill_dequant(q4, scale4, instance == "nf4"))
    elif route == "fold":
        out = fold(x2, q4, scale4, instance)
    elif route == "int8":
        out = int8_route(x2, q4, scale4)
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
    instance = "pcol" if pcol else "nf4" if nf4 else INSTANCE[DEFAULT_VARIANT]
    if x.is_cuda:  # the kernels' own geometry: a launch or a raise
        feasible = True
    elif pcol:
        feasible = _pcol_feasible(half, N) and N % 8 == 0
    else:
        feasible = _kernel_feasible(half, K // scale4.shape[0]) and N % 8 == 0
    if feasible:
        y = fwd(x2.contiguous(), q4, scale4, instance)
    else:  # the reference's product off a TPU where its rule rejects the shape
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
    """``x (..., K) @ dequant(q4, scale4)`` -> ``(..., N)`` in ``x.dtype``: K5 on CUDA tensors (or a raise), on CPU
    tensors K5's plain version where the reference's rule admits the shape; gradient for ``x`` only."""
    return _Int4Matmul.apply(x, q4, scale4, bool(nf4), bool(pcol), int4_matmul_fwd)


def int4_matmul_ref(x: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor, nf4: bool = False,
                    pcol: bool = False) -> torch.Tensor:
    """The same routing and gradient through the plain versions only, on any device."""
    return _Int4Matmul.apply(x, q4, scale4, bool(nf4), bool(pcol), int4_matmul_fwd_ref)
