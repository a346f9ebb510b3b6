"""The port's host-RAM spill index against the JAX package, on the CPU.

``HostDenseIndex`` (``dalm_tpu_torch/index/host_index.py``) with the
native scan (the port's copy of ``host_topk.cpp``, built with ``g++`` into
``build/``) and with its numpy plain version, against
``dalm_tpu.index.host_index.HostDenseIndex`` and an exact oracle
(``tests/index/test_host_index.py`` counterparts): ids equal, scores within
1e-4 relative (f32 sums of 64 products in another order). Ties go to the
smaller id; memory-mapped rows; the scan across several OpenMP threads in a
process of its own; ``TieredIndex`` against the JAX ``TieredIndex`` on a
one-device mesh. A failed build raises and never turns into numpy.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from dalm_tpu.core.mesh import MeshConfig, make_mesh
from dalm_tpu.index.host_index import HostDenseIndex as JaxHostDenseIndex
from dalm_tpu.index.host_index import TieredIndex as JaxTieredIndex
from dalm_tpu_torch.index import host_index
from dalm_tpu_torch.index.host_index import HostDenseIndex, TieredIndex, host_topk_ref, scan_threads


def _oracle(queries, embs, k):
    full = queries @ embs.T
    ids = np.argsort(-full, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(full, ids, axis=1), ids


@pytest.mark.parametrize("use_native", [True, False])
def test_host_index_matches_reference(use_native):
    rng = np.random.default_rng(0)
    embs = rng.normal(size=(5000, 64)).astype(np.float32)
    queries = rng.normal(size=(9, 64)).astype(np.float32)
    scores, ids = HostDenseIndex(embs, use_native=use_native).search(queries, 10)
    j_scores, j_ids = JaxHostDenseIndex(embs, use_native=use_native).search(queries, 10)
    o_scores, o_ids = _oracle(queries, embs, 10)
    assert scores.dtype == np.float32 and ids.dtype == np.int32
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_allclose(scores, j_scores, rtol=1e-4)
    np.testing.assert_allclose(scores, o_scores, rtol=1e-4)


@pytest.mark.parametrize("use_native", [True, False])
def test_host_index_ties_prefer_smaller_id(use_native):
    embs = np.ones((100, 8), np.float32)
    queries = np.ones((2, 8), np.float32)
    _, ids = HostDenseIndex(embs, use_native=use_native).search(queries, 5)
    np.testing.assert_array_equal(ids, np.tile(np.arange(5), (2, 1)))
    _, j_ids = JaxHostDenseIndex(embs, use_native=use_native).search(queries, 5)
    np.testing.assert_array_equal(ids, j_ids)


def test_host_index_k_above_rows_and_bad_queries():
    rng = np.random.default_rng(4)
    embs = rng.normal(size=(6, 16)).astype(np.float32)
    queries = rng.normal(size=(3, 16)).astype(np.float32)
    scores, ids = HostDenseIndex(embs).search(queries, 10)
    j_scores, j_ids = JaxHostDenseIndex(embs).search(queries, 10)
    assert ids.shape == (3, 6)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_allclose(scores, j_scores, rtol=1e-5)
    with pytest.raises(ValueError, match="queries"):
        HostDenseIndex(embs).search(queries[:, :8], 2)


def test_host_index_memmap(tmp_path):
    rng = np.random.default_rng(1)
    embs = rng.normal(size=(1000, 32)).astype(np.float32)
    path = tmp_path / "embs.bin"
    embs.tofile(path)
    idx = HostDenseIndex.from_memmap(str(path), 1000, 32)
    assert isinstance(idx.embeddings, np.memmap)  # no copy in RAM
    queries = rng.normal(size=(3, 32)).astype(np.float32)
    scores, ids = idx.search(queries, 5)
    j_scores, j_ids = JaxHostDenseIndex.from_memmap(str(path), 1000, 32).search(queries, 5)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(ids, _oracle(queries, embs, 5)[1])
    np.testing.assert_allclose(scores, j_scores, rtol=1e-4)


def test_host_index_multithreaded_matches_plain():
    """OMP_NUM_THREADS=4 in a process of its own (OpenMP reads it when it starts), with torch imported first as
    in any process of the port: more than 4 blocks of 4096 rows, so the per-thread lists and their merge run."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import numpy as np, torch
from dalm_tpu_torch.index.host_index import HostDenseIndex, host_topk_ref, scan_threads
rng = np.random.default_rng(7)
embs = rng.normal(size=(20000, 48)).astype(np.float32)
queries = rng.normal(size=(5, 48)).astype(np.float32)
scores, ids = HostDenseIndex(embs).search(queries, 10)
r_scores, r_ids = host_topk_ref(embs, queries, 10)
np.testing.assert_array_equal(ids, r_ids)
np.testing.assert_allclose(scores, r_scores, rtol=1e-4)
print("THREADS", scan_threads())
"""
    env = dict(os.environ, OMP_NUM_THREADS="4")
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "THREADS 4" in out.stdout
    assert scan_threads() >= 1


def test_tiered_index_matches_reference():
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    rng = np.random.default_rng(2)
    embs = rng.normal(size=(500, 32)).astype(np.float32)
    queries = rng.normal(size=(6, 32)).astype(np.float32)
    tiered = TieredIndex.build(embs, hbm_budget_rows=300, device="cpu")
    assert tiered.hbm_rows == 300 and tiered.host_index is not None and tiered.host_index.use_native
    scores, ids = tiered.search(queries, 10)
    j_scores, j_ids = JaxTieredIndex.build(mesh, embs, hbm_budget_rows=300).search(queries, 10)
    o_scores, o_ids = _oracle(queries, embs, 10)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_allclose(scores, j_scores, rtol=1e-4)
    np.testing.assert_allclose(scores, o_scores, rtol=1e-4)
    whole = TieredIndex.build(embs, device="cpu")  # no budget: every row on the device, no host tier
    assert whole.host_index is None
    np.testing.assert_array_equal(whole.search(queries, 10)[1], o_ids)


def test_tiered_index_ties_and_small_device_tier():
    """Equal rows on both tiers: the union keeps the smaller ids; k above the device tier's rows."""
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    embs = np.ones((12, 8), np.float32)
    queries = np.ones((2, 8), np.float32)
    scores, ids = TieredIndex.build(embs, hbm_budget_rows=3, device="cpu").search(queries, 6)
    j_scores, j_ids = JaxTieredIndex.build(mesh, embs, hbm_budget_rows=3).search(queries, 6)
    np.testing.assert_array_equal(ids, np.tile(np.arange(6), (2, 1)))
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(scores, j_scores)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "host_topk.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(host_index, "SOURCE", bad)
    monkeypatch.setattr(host_index, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(host_index, "_lib_handle", None)
    embs = np.ones((4, 8), np.float32)
    with pytest.raises(RuntimeError, match="host scan build failed"):
        HostDenseIndex(embs)
    monkeypatch.setattr(host_index.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        HostDenseIndex(embs)
    plain = HostDenseIndex(embs, use_native=False)  # the plain version asks for no build
    np.testing.assert_array_equal(plain.search(np.ones((1, 8), np.float32), 2)[1], host_topk_ref(
        embs, np.ones((1, 8), np.float32), 2)[1])
