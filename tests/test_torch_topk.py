"""K3 in the port (dalm_tpu_torch/kernels/topk.py, index/dense.py) against the
JAX package: the plain version ``fused_dot_topk_ref`` against the Pallas
kernel run in interpret mode, and ``DenseIndex`` against
``ShardedDenseIndex``. Ids must be equal; scores agree within 1e-5 (f32
sums in another order, on unit-norm embeddings, so |score| <= ~1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.core.mesh import MeshConfig, make_mesh
from dalm_tpu.index.dense import ShardedDenseIndex
from dalm_tpu.kernels.topk import fused_dot_topk as jax_fused_dot_topk
from dalm_tpu_torch.index.dense import DenseIndex, quantize_int4, quantize_int8
from dalm_tpu_torch.kernels.topk import (BLOCKS_PER_SM, MAX_K, QUERIES_PER_TILE, ROWS_PER_TILE, _geometry,
                                         block_tiles, fused_dot_topk_ref)

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores

ATOL = 1e-5


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _inputs(mode, rows, d=64, q=5, seed=0):
    """(jax args, torch args) for one storage mode on the same data."""
    rng = np.random.default_rng(seed)
    e, qs = _unit(rng, rows, d), _unit(rng, q, d)
    if mode == "f32":
        return (jnp.asarray(qs), jnp.asarray(e), {}), (torch.from_numpy(qs), torch.from_numpy(e), {})
    packed, scale = quantize_int4(e) if mode == "int4" else quantize_int8(e)
    q16 = torch.from_numpy(qs).to(torch.bfloat16)
    jax_args = (jnp.asarray(qs, jnp.bfloat16), jnp.asarray(packed), {"scales": jnp.asarray(scale), "int4": mode == "int4"})
    torch_args = (q16, torch.from_numpy(packed), {"scales": torch.from_numpy(scale), "int4": mode == "int4"})
    return jax_args, torch_args


def _compare(mode, rows, k, num_valid, block_rows=128):
    (jq, je, jkw), (tq, te, tkw) = _inputs(mode, rows)
    js, ji = jax_fused_dot_topk(jq, je, k, num_valid=num_valid, block_rows=block_rows, interpret=True, **jkw)
    ts, ti = fused_dot_topk_ref(tq, te, k, num_valid=num_valid, **tkw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["f32", "int8", "int4"])
@pytest.mark.parametrize("k", [1, 4, 10])
def test_ref_matches_pallas_num_valid(mode, k):
    _compare(mode, rows=300, k=k, num_valid=137)


@pytest.mark.parametrize("mode", ["f32", "int8", "int4"])
def test_ref_matches_pallas_all_valid(mode):
    _compare(mode, rows=256, k=4, num_valid=None)


@pytest.mark.parametrize("mode", ["f32", "int8", "int4"])
def test_ref_matches_pallas_k_above_rows(mode):
    """k > N (and k > num_valid): unfilled slots are (-inf, 0) in both."""
    _compare(mode, rows=8, k=10, num_valid=6, block_rows=8)


def test_ref_ties_go_to_smaller_id():
    """Duplicated rows tie exactly; the smaller row id wins in both."""
    rng = np.random.default_rng(3)
    base = _unit(rng, 4, 64)
    e = np.concatenate([base, base, base[::-1], base], axis=0)  # 16 rows, each scored 4 times
    q = _unit(rng, 3, 64)
    js, ji = jax_fused_dot_topk(jnp.asarray(q), jnp.asarray(e), 10, block_rows=8, interpret=True)
    ts, ti = fused_dot_topk_ref(torch.from_numpy(q), torch.from_numpy(e), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=ATOL)
    # and the rule itself: among equal scores ids ascend
    s, i = ts.numpy(), ti.numpy()
    for row_s, row_i in zip(s, i):
        for a in range(len(row_s) - 1):
            if row_s[a] == row_s[a + 1]:
                assert row_i[a] < row_i[a + 1]


@pytest.mark.parametrize("quantize", [False, "int8", "int4"])
def test_dense_index_matches_sharded_index(quantize):
    rng = np.random.default_rng(11)
    e, q = _unit(rng, 40, 64), _unit(rng, 6, 64)
    ref = ShardedDenseIndex.build(make_mesh(MeshConfig()), e, quantize=quantize)
    js, ji = ref.search(q, 5)
    index = DenseIndex.build(e, quantize=quantize, device="cpu")
    ts, ti = index.search(q, 5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=ATOL)


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseIndex.build(np.ones((4, 64), np.float32))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n", [1, 127, 128, 16384, (1 << 20) - 12345])
@pytest.mark.parametrize("q", [1, 32, 40])
def test_kernel_geometry_covers_every_row_once(q, n, sms):
    """K3's launch geometry: every row of every query tile lies in exactly one block's range of whole 128-row tiles,
    every block has work, the blocks fill the card where there are rows enough, and each query's candidates (a list
    of k from each block) stay bounded."""
    q_tiles, nb = _geometry(q, n, sms)
    assert q_tiles == -(-q // QUERIES_PER_TILE)
    tiles = -(-n // ROWS_PER_TILE)
    ranges = [block_tiles(b, nb, tiles) for b in range(nb)]
    assert all(len(r) >= 1 for r in ranges)
    assert [t for r in ranges for t in r] == list(range(tiles))  # contiguous, in block order, each tile once
    rows = [row for r in ranges for t in r for row in range(t * ROWS_PER_TILE, min((t + 1) * ROWS_PER_TILE, n))]
    assert rows == list(range(n))
    assert nb <= tiles and nb * q_tiles <= BLOCKS_PER_SM * sms + q_tiles - 1
    assert nb * MAX_K <= -(-BLOCKS_PER_SM * sms // q_tiles) * MAX_K
    if tiles >= BLOCKS_PER_SM * sms:
        assert nb * q_tiles >= BLOCKS_PER_SM * sms


def test_kernel_geometry_without_rows():
    """num_valid = 0: one block a query tile, with no tile to scan, still writes (and merges) empty lists."""
    assert _geometry(40, 0, 132) == (2, 1)
    assert list(block_tiles(0, 1, 0)) == []


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x's top 11 significant bits (sign, exponent, 10 mantissa bits), as the tensor core reads an f32 operand."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _scores_3xtf32(q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The f32 mode's arithmetic: hi = tf32(x), lo = x - hi (exact) for both operands, of which the products read
    tf32(lo); lo.hi' + hi.lo' + hi.hi' (lo.lo' dropped). Each product of two TF32 values is exact in f32; the sums
    here are taken in f64."""
    qh, eh = _tf32(q), _tf32(e)
    ql, el = _tf32(q - qh), _tf32(e - eh)
    d = torch.float64
    return (ql.to(d) @ eh.to(d).T + qh.to(d) @ el.to(d).T + qh.to(d) @ eh.to(d).T).float()


def test_3xtf32_is_exact_on_grid_and_within_tolerance_on_unit_rows():
    """K3's f32 rows run 3xTF32 on the card. On values of at most 11 significant bits (the card checks' grid data)
    lo is 0 and the score equals the exact one; on unit-norm rows at D 1024 the top-k equals the plain version's
    ids, with scores within 1e-5."""
    rng = np.random.default_rng(5)
    gq = torch.from_numpy(rng.integers(-8, 9, (6, 1024)).astype(np.float32) / 16)
    ge = torch.from_numpy(rng.integers(-8, 9, (500, 1024)).astype(np.float32) / 16)
    assert torch.equal(_tf32(ge), ge) and torch.equal(_tf32(gq), gq)
    assert torch.equal(_scores_3xtf32(gq, ge), (gq.double() @ ge.double().T).float())
    q, e = torch.from_numpy(_unit(rng, 8, 1024)), torch.from_numpy(_unit(rng, 4000, 1024))
    scores = _scores_3xtf32(q, e)
    assert float((scores.double() - q.double() @ e.double().T).abs().max()) < 1e-6
    for k in (1, 10, 32):
        s, i = torch.sort(scores, dim=1, descending=True, stable=True)
        rs, ri = fused_dot_topk_ref(q, e, k)
        np.testing.assert_array_equal(i[:, :k].numpy(), ri.numpy())
        np.testing.assert_allclose(s[:, :k].numpy(), rs.numpy(), rtol=0, atol=ATOL)
