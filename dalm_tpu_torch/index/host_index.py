"""Host-RAM exact index and the tiered (device + host spill) index
(counterpart of ``dalm_tpu/index/host_index.py``).

The spill tier of retrieval: a corpus beyond the device's memory budget
keeps its overflow rows in host memory (or memory-mapped from disk), and
``native/host_topk.cpp`` scans them: exact inner products over blocks of
rows, OpenMP across blocks, a small heap per (thread, query), ties to the
smaller id. ``TieredIndex`` merges that tier's winners with the device
tier's (``DenseIndex``, K3): both are exact, so the top k of the union is
the global answer.

The scan is a C++ library with a plain C interface, loaded with ``ctypes``.
It builds at first use with ``g++`` into
``build/dalm_tpu_torch/host_topk-<hash>/``, beside the CUDA kernels' builds;
the hash covers the source, the flags and the CPU's instruction-set flags,
since ``-march=native`` code built on one machine may not run on another. A
missing compiler or a failed build raises: ``use_native=False`` asks for the
numpy plain version instead, which the tests hold the scan against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from dalm_tpu_torch.index.dense import DenseIndex
from dalm_tpu_torch.kernels.build import BUILD_ROOT

SOURCE = Path(__file__).resolve().parent.parent / "native" / "host_topk.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lib_handle: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _cpu_flags() -> bytes:
    """The instruction-set flags of this machine's CPU, as ``/proc/cpuinfo`` lists them (empty where it does not)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def build() -> Path:
    """Compile ``native/host_topk.cpp`` unless it is built already; returns the .so path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_flags())
    lib = BUILD_ROOT / f"host_topk-{h.hexdigest()[:16]}" / "libhost_topk.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host scan cannot be built (pass use_native=False for numpy)")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
    (lib.parent / "build.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"host scan build failed (g++ exit {res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib


def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (once per process, from any thread)."""
    global _lib_handle
    with _lib_lock:
        if _lib_handle is None:
            lib = ctypes.CDLL(str(build()))
            f32p, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
            lib.dalm_host_topk.argtypes = [f32p, i64, i64, f32p, i64, i64, f32p, ctypes.POINTER(ctypes.c_int32)]
            lib.dalm_host_topk.restype = None
            lib.omp_get_max_threads.argtypes = []  # from the OpenMP runtime the library links
            lib.omp_get_max_threads.restype = ctypes.c_int
            _lib_handle = lib
        return _lib_handle


def scan_threads() -> int:
    """The threads the native scan spreads its blocks over (OpenMP's ``omp_get_max_threads``)."""
    return int(_lib().omp_get_max_threads())


def host_topk_ref(embeddings: np.ndarray, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version: every score, then a stable sort (ties to the smaller id)."""
    scores = queries @ embeddings.T
    ids = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, ids, axis=1), ids.astype(np.int32)


class HostDenseIndex:
    """Exact inner-product search over a host-resident (N, D) float32 matrix."""

    def __init__(self, embeddings: np.ndarray, use_native: bool = True):
        if isinstance(embeddings, np.memmap) and embeddings.dtype == np.float32 and embeddings.flags.c_contiguous:
            self.embeddings = embeddings  # left to the OS to page in: no copy in RAM
        else:
            self.embeddings = np.ascontiguousarray(embeddings, np.float32)
        if self.embeddings.ndim != 2:
            raise ValueError(f"embeddings must be (N, D), not {self.embeddings.shape}")
        self.use_native = use_native
        if use_native:
            _lib()  # built and loaded now: a failed build raises here

    @classmethod
    def from_memmap(cls, path: str, num_rows: int, dim: int, use_native: bool = True) -> "HostDenseIndex":
        """Rows memory-mapped from a raw float32 file, for corpora beyond RAM on a fast disk."""
        return cls(np.memmap(path, dtype=np.float32, mode="r", shape=(num_rows, dim)), use_native=use_native)

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k: (scores (Q, k) float32, ids (Q, k) int32), k at most N."""
        queries = np.ascontiguousarray(queries, np.float32)
        n, d = self.embeddings.shape
        if queries.ndim != 2 or queries.shape[1] != d:
            raise ValueError(f"queries must be (Q, {d}), not {queries.shape}")
        k = min(k, n)
        if not self.use_native:
            return host_topk_ref(self.embeddings, queries, k)
        nq = queries.shape[0]
        out_scores = np.empty((nq, k), np.float32)
        out_ids = np.empty((nq, k), np.int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        _lib().dalm_host_topk(  # a memmap passes its pages' address as an array does
            self.embeddings.ctypes.data_as(f32p), n, d, queries.ctypes.data_as(f32p), nq, k,
            out_scores.ctypes.data_as(f32p), out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out_scores, out_ids


class TieredIndex:
    """Rows [0, hbm_rows) in a ``DenseIndex`` on the device, rows [hbm_rows, N) in a ``HostDenseIndex``. Both
    tiers are exact, so the global top k is the top k of their union."""

    def __init__(self, device_index: DenseIndex, host_index: Optional[HostDenseIndex], hbm_rows: int):
        self.device_index = device_index
        self.host_index = host_index
        self.hbm_rows = hbm_rows

    @classmethod
    def build(cls, embeddings: np.ndarray, hbm_budget_rows: Optional[int] = None, device=None,
              **kw) -> "TieredIndex":
        """The first ``hbm_budget_rows`` rows (all when None) go to the device (``DenseIndex.build(...,
        device=device, **kw)``), the rest stay on the host. The port has one device, so there is no mesh."""
        n = len(embeddings)
        hbm_rows = n if hbm_budget_rows is None else min(hbm_budget_rows, n)
        device_index = DenseIndex.build(embeddings[:hbm_rows], device=device, **kw)
        host_index = HostDenseIndex(embeddings[hbm_rows:]) if hbm_rows < n else None
        return cls(device_index, host_index, hbm_rows)

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k over both tiers: (scores, ids) numpy arrays, ids global."""
        d_scores, d_ids = self.device_index.search(queries, k)
        if self.host_index is None:
            return d_scores, d_ids
        h_scores, h_ids = self.host_index.search(queries, k)
        scores = np.concatenate([d_scores, h_scores], axis=1)
        ids = np.concatenate([d_ids, h_ids + self.hbm_rows], axis=1)
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k]  # ties keep the smaller (device-tier) id first
        return np.take_along_axis(scores, order, axis=1), np.take_along_axis(ids, order, axis=1)
