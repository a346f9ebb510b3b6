"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, into ``build/dalm_tpu_torch/`` beside the
package, under a directory keyed by a hash of the sources, so a fresh
checkout builds once and later calls reuse it. A missing ``nvcc`` or a
failed build raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dalm_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # threads of one process share a build's temporary file name


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built (set CUDA_HOME)")
    return found


def _paths(name: str) -> tuple:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"
    return CSRC / f"{name}.cu", out_dir / f"lib{name}.so", out_dir / "build.log"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless it is built already; returns the .so path."""
    return build_all([name])[0]


def build_all(names) -> list:
    """Compile several sources at once, one ``nvcc`` process each, all started
    together; returns their .so paths in order."""
    jobs, libs = [], []
    for name in names:
        src, lib, log = _paths(name)
        libs.append(lib)
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log_f = open(log, "w")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=log_f, stderr=subprocess.STDOUT)
        jobs.append((name, proc, log_f, tmp, lib, log))
    failed = []
    for name, proc, log_f, tmp, lib, log in jobs:
        rc = proc.wait()
        log_f.close()
        if rc != 0:
            failed.append(f"kernel build failed: {name} (nvcc exit {rc}):\n{log.read_text()}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``, if this process or an earlier one
    built it."""
    _, _, log = _paths(name)
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process, from any thread."""
    with _load_lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]
