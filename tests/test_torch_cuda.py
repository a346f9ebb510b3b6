"""The port's hand-written kernels on the card, against their plain versions.

These tests need a CUDA device and skip without one. They import no JAX
(the machine with the card has none), so run them there without the
JAX-side conftest::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from dalm_tpu_torch.index.dense import quantize_int4, quantize_int8
from dalm_tpu_torch.kernels import flash_attention as fa
from dalm_tpu_torch.kernels import int4_matmul as k5
from dalm_tpu_torch.kernels import int8_matmul as im
from dalm_tpu_torch.kernels.topk import fused_dot_topk, fused_dot_topk_ref
from dalm_tpu_torch.models import quant

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(mode, rows, d, q, device, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((rows, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    if mode in ("f32", "bf16"):
        dt = torch.float32 if mode == "f32" else torch.bfloat16
        return torch.from_numpy(qs).to(device, dt), torch.from_numpy(e).to(device, dt), {}
    packed, scale = quantize_int4(e) if mode == "int4" else quantize_int8(e)
    return (
        torch.from_numpy(qs).to(device, torch.bfloat16),
        torch.from_numpy(packed).to(device),
        {"scales": torch.from_numpy(scale).to(device), "int4": mode == "int4"},
    )


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "int4"])
def test_kernel_matches_ref_on_card(cuda, mode):
    """Ids equal; scores within 1e-5 (f32 sums in another order, unit-norm rows)."""
    q, e, kw = _inputs(mode, rows=1000, d=128, q=40, device=cuda)
    before = fused_dot_topk.launches[mode]
    for k in (1, 4, 10, 32):
        s, i = fused_dot_topk(q, e, k, num_valid=777, **kw)
        rs, ri = fused_dot_topk_ref(q, e, k, num_valid=777, **kw)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(i.cpu().numpy(), ri.cpu().numpy())
        np.testing.assert_allclose(s.cpu().numpy(), rs.cpu().numpy(), rtol=0, atol=1e-5)
    assert fused_dot_topk.launches[mode] == before + 4


def test_kernel_k_above_rows_and_ties(cuda):
    """Unfilled slots are (-inf, 0); duplicated rows go to the smaller id."""
    q, e, _ = _inputs("f32", rows=6, d=64, q=3, device=cuda)
    s, i = fused_dot_topk(q, e, 10, num_valid=4)
    rs, ri = fused_dot_topk_ref(q, e, 10, num_valid=4)
    assert torch.equal(i, ri) and torch.equal(s.isinf(), rs.isinf())
    dup = e.repeat(300, 1).contiguous()  # 1800 rows, each value 300 times
    s, i = fused_dot_topk(q, dup, 32)
    rs, ri = fused_dot_topk_ref(q, dup, 32)
    assert torch.equal(i, ri)


def test_kernel_wrapper_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((2, 64), device=cuda)
    e = torch.zeros((10, 64), device=cuda)
    with pytest.raises(ValueError, match="k=33"):
        fused_dot_topk(q, e, 33)
    with pytest.raises(ValueError, match="multiple of 64"):
        fused_dot_topk(q[:, :48].contiguous(), e[:, :48].contiguous(), 4)
    with pytest.raises(TypeError):
        fused_dot_topk(q.to(torch.bfloat16), e, 4)


def _grid_inputs(mode, rows, d, q, device, seed=0):
    """Exact-arithmetic K3 inputs: float values are integers in [-8, 8] / 16 (every sum exact in f32 in any
    order, and with many ties), quantised rows random codes with positive scales."""
    g = torch.Generator(device=device).manual_seed(seed)
    qs = torch.randint(-8, 9, (q, d), generator=g, device=device).float() / 16
    if mode in ("f32", "bf16"):
        dt = torch.float32 if mode == "f32" else torch.bfloat16
        e = torch.randint(-8, 9, (rows, d), generator=g, device=device).float() / 16
        return qs.to(dt), e.to(dt), {}
    scales = torch.rand((rows, 1), generator=g, device=device) + 0.5
    if mode == "int8":
        e = torch.randint(-127, 128, (rows, d), generator=g, device=device, dtype=torch.int8)
    else:
        e = torch.randint(0, 256, (rows, d // 2), generator=g, device=device, dtype=torch.uint8)
    return qs.to(torch.bfloat16), e, {"scales": scales, "int4": mode == "int4"}


def _assert_topk_near_ties(s, i, rs, ri, q, e, kw):
    """Scores within 1e-5 of the plain version's; ids equal except where the two rows' f64 scores lie within 1e-5
    of each other (a near tie that f32 sums in another order may resolve either way)."""
    assert torch.equal(s.isinf(), rs.isinf())
    fin = torch.isfinite(rs)
    assert float((s - rs).abs()[fin].max()) <= 1e-5
    bad = (i != ri) & fin
    if bool(bad.any()):
        from dalm_tpu_torch.kernels.topk import _dequantized_rows

        rows = _dequantized_rows(e, kw.get("int4", False)).double()
        qi, kj = bad.nonzero(as_tuple=True)
        sg = (rows[i[qi, kj].long()] * q.double()[qi]).sum(1)
        sw = (rows[ri[qi, kj].long()] * q.double()[qi]).sum(1)
        if kw.get("scales") is not None:
            sc = kw["scales"].reshape(-1).double()
            sg, sw = sg * sc[i[qi, kj].long()], sw * sc[ri[qi, kj].long()]
        assert bool(((sg - sw).abs() <= 1e-5).all())


@pytest.mark.parametrize("q", [32, 40])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "int4"])
def test_topk_persistent_blocks_match_ref_on_card(cuda, mode, q):
    """K3 at N 50,000, D 1024: several tiles a block and one or two query tiles. Unit-norm rows (the plain version
    within 1e-5, near-tie swaps only) and grid rows (equal, ids and scores), k 1 / 4 / 10 / 32, with num_valid in
    the middle of a tile; one launch a call."""
    n, d = 50_000, 1024
    before = fused_dot_topk.launches[mode]
    calls = 0
    for make in (_inputs, _grid_inputs):
        qs, e, kw = make(mode, n, d, q, cuda)
        for k in (1, 4, 10, 32):
            for nv in (None, n - 77):
                s, i = fused_dot_topk(qs, e, k, num_valid=nv, **kw)
                rs, ri = fused_dot_topk_ref(qs, e, k, num_valid=nv, **kw)
                torch.cuda.synchronize()
                calls += 1
                if make is _grid_inputs:
                    assert torch.equal(i, ri) and torch.equal(s, rs)
                else:
                    _assert_topk_near_ties(s, i, rs, ri, qs.float(), e, kw)
    assert fused_dot_topk.launches[mode] == before + calls


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "int4"])
def test_topk_small_and_empty_index_on_card(cuda, mode):
    """Fewer rows than a tile, one row, and num_valid 0: unfilled slots are (-inf, 0), as in the plain version."""
    for n, nv, k in ((77, None, 10), (77, 50, 32), (1, None, 4), (300, 0, 5), (1, 0, 1)):
        qs, e, kw = _grid_inputs(mode, n, 64, 5, cuda, seed=n)
        s, i = fused_dot_topk(qs, e, k, num_valid=nv, **kw)
        rs, ri = fused_dot_topk_ref(qs, e, k, num_valid=nv, **kw)
        torch.cuda.synchronize()
        assert torch.equal(i, ri) and torch.equal(s, rs)
    assert bool((s == float("-inf")).all()) and not bool(i.any())


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_topk_duplicates_across_blocks_go_to_the_smaller_id_on_card(cuda, mode):
    """1,000 rows repeated 50 times: every row's copies lie in many blocks, and the smaller ids win the ties."""
    qs, base, kw = _grid_inputs(mode, 1000, 256, 33, cuda, seed=3)
    e = base.repeat(50, 1).contiguous()
    if kw:
        kw = dict(kw, scales=kw["scales"].repeat(50, 1).contiguous())
    for k in (4, 32):
        s, i = fused_dot_topk(qs, e, k, **kw)
        rs, ri = fused_dot_topk_ref(qs, e, k, **kw)
        torch.cuda.synchronize()
        assert torch.equal(i, ri) and torch.equal(s, rs)


def test_topk_f32_ragged_depth_and_int4_half_stage_on_card(cuda):
    """D 64 and 192: int4's packed rows (32, 96 bytes) end inside a 64-byte stage, whose zero bytes must count 0."""
    for d in (64, 192):
        for mode in ("f32", "int4"):
            qs, e, kw = _grid_inputs(mode, 3000, d, 7, cuda, seed=d)
            s, i = fused_dot_topk(qs, e, 10, **kw)
            rs, ri = fused_dot_topk_ref(qs, e, 10, **kw)
            torch.cuda.synchronize()
            assert torch.equal(i, ri) and torch.equal(s, rs)


def _int8_weights(rng, k, n, device):
    q = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(device)
    scale = torch.from_numpy((rng.random((1, n)) * 1e-3 + 1e-4).astype(np.float32)).to(device)
    return q, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 4096), (3, 7, 100), (5, 11008), (1, 30)])
def test_rowquant_kernel_equals_ref_on_card(cuda, shape, dtype):
    """K2: q and s equal to the plain version (tolerance 0), with and without the column scale."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda, dtype)
    x.reshape(-1, shape[-1])[0] = 0
    cs = torch.from_numpy((rng.random(shape[-1]) * 0.01 + 1e-4).astype(np.float32)).to(cuda)
    before = im.rowquant.launches
    for colscale in (None, cs):
        q, s = im.rowquant(x, colscale)
        rq, rs = im.rowquant_ref(x, colscale)
        torch.cuda.synchronize()
        assert torch.equal(q, rq) and torch.equal(s, rs)
    assert im.rowquant.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K", [64, 100, 4096, 11008, 32000])
@pytest.mark.parametrize("R", [1, 32, 4608])
def test_rowquant_shape_grid_equals_ref_on_card(cuda, R, K, dtype):
    """K2 at the train, decode and wider shapes, ragged K included: q and s equal to the plain
    version in int8 and bf16 out, with and without the column scale, with a zero row and a row of .5 ties."""
    g = torch.Generator(device=cuda).manual_seed(R + K)
    x = torch.randn((R, K), generator=g, device=cuda)
    ties = torch.randint(-126, 127, (K,), generator=g, device=cuda).float() + 0.5
    ties[0] = 127.0  # absmax 127 -> s = 1 -> every other value / s ends in .5
    x[-1] = ties
    if R > 1:
        x[0] = 0
    x = x.to(dtype)
    cs = torch.rand(K, generator=g, device=cuda) * 0.01 + 1e-4
    before = im.rowquant.launches
    for colscale in (None, cs):
        rq, rs = im.rowquant_ref(x, colscale)
        for out in (torch.int8, torch.bfloat16):
            q, s = im.rowquant(x, colscale, dtype=out)
            torch.cuda.synchronize()
            assert torch.equal(s, rs) and torch.equal(q, rq.to(out))
    want = torch.round(ties).clamp(-127, 127).to(torch.int8)
    assert torch.equal(im.rowquant(x)[0][-1], want)
    if R > 1:
        assert float(im.rowquant(x)[1][0]) == 1.0
    assert im.rowquant.launches == before + 4 + 1 + (R > 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rowquant_tiny_and_tie_rows_equal_ref_on_card(cuda, dtype):
    """K2 on rows whose scale is subnormal or tiny, and on rows of quotients within a hair of a half-integer:
    equal to the plain version's division and rounding."""
    g = torch.Generator(device=cuda).manual_seed(7)
    K = 4096
    base = torch.randn((8, K), generator=g, device=cuda)
    rows = [base[0] * 1e-38, base[1] * 1e-40, base[2] * 1e-41, base[3] * 3e-36]  # scales subnormal, not 0
    ties = torch.randint(-126, 127, (4, K), generator=g, device=cuda).float() + 0.5
    ties[:, 0] = 127.0
    nudge = torch.tensor([1.0, 1.0 + 2 ** -20, 1.0 - 2 ** -20, 1.0 + 2 ** -23], device=cuda)
    x = torch.cat([torch.stack(rows), ties * nudge[:, None]]).to(dtype).contiguous()
    cs = torch.rand(K, generator=g, device=cuda) + 0.5
    for colscale in (None, cs):
        rq, rs = im.rowquant_ref(x, colscale)
        for out in (torch.int8, torch.bfloat16):
            q, s = im.rowquant(x, colscale, dtype=out)
            torch.cuda.synchronize()
            assert torch.equal(s, rs) and torch.equal(q, rq.to(out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mkn", [(256, 512, 384), (200, 1024, 128), (8, 128, 128), (130, 4096, 1028),
                                 (1, 11008, 136), (256, 4096, 32000)])
def test_w8a8_fused_kernel_equals_ref_on_card(cuda, mkn, dtype):
    """K1: equal to the plain version, which follows the kernels' order of
    operations (true division, two roundings in the fold); ragged M and N guarded,
    one row with bk = 256, and the lm_head's width."""
    M, K, N = mkn
    rng = np.random.default_rng(1)
    q, scale = _int8_weights(rng, K, N, cuda)
    x = torch.from_numpy((rng.standard_normal((M, K)) * 0.5).astype(np.float32)).to(cuda, dtype)
    before = im.w8a8_fused.launches
    y, ry = im.w8a8_fused(x, q, scale), im.w8a8_fused_ref(x, q, scale)
    torch.cuda.synchronize()
    assert y.dtype == dtype and torch.equal(y, ry)
    assert im.w8a8_fused.launches == before + 1


@pytest.mark.parametrize("mkn", [(128, 64, 128), (100, 4160, 1028), (4608, 4096, 512), (1, 16, 4), (1, 4096, 4096),
                                 (300, 16, 1000), (1, 16, 11008)])
def test_int8_gemm_entries_equal_ref_on_card(cuda, mkn):
    """Integer arithmetic: equal. ``kn`` contracts the strided axis of the weight, ``nt`` the contiguous one."""
    M, K, N = mkn
    rng = np.random.default_rng(2)
    q, _ = _int8_weights(rng, K, N, cuda)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8)).to(cuda)
    assert torch.equal(im.int8_gemm_kn(a, q), im.int8_gemm_kn_ref(a, q))
    qt = q.T.contiguous()  # (N, K): the nt entry contracts K of both
    assert torch.equal(im.int8_gemm_nt(a, qt), im.int8_gemm_nt_ref(a, qt))
    assert torch.equal(im.int8_gemm_nt(a, qt), im.int8_gemm_kn(a, q))


@pytest.mark.parametrize("mkn", [(300, 768, 136), (1, 11008, 4096), (4608, 4096, 1028)])
def test_k1_route_parts_equal_plain_on_card(cuda, mkn):
    """K1's three launches one by one: the quantise pre-pass equal to its plain version and to K2 on the
    (M K / bk, bk) view, the weight pre-pass equal to ``q.T.contiguous()``, the GEMM equal to its plain
    version, in both output types (tolerance 0); each counts its own launch."""
    M, K, N = mkn
    rng = np.random.default_rng(4)
    q, scale = _int8_weights(rng, K, N, cuda)
    x = torch.from_numpy((rng.standard_normal((M, K)) * 0.5).astype(np.float32)).to(cuda, torch.bfloat16)
    bk = im.fit_div(K, 512)
    before = (im.quant_prepass.launches, im.weight_prepass.launches, im.fold_gemm.launches)
    xq, xs = im.quant_prepass(x, bk)
    rq, rs = im.quant_prepass_ref(x, bk)
    kq, ks = im.rowquant(x.reshape(M * K // bk, bk))
    qt = im.weight_prepass(q)
    torch.cuda.synchronize()
    assert torch.equal(xq, rq) and torch.equal(xs, rs)
    assert torch.equal(xq.reshape(-1, bk), kq) and torch.equal(xs.reshape(-1, 1), ks)
    assert torch.equal(qt, q.T.contiguous())
    for dtype in (torch.bfloat16, torch.float32):
        y = im.fold_gemm(xq, xs, qt, scale, dtype)
        assert y.dtype == dtype and torch.equal(y, im.fold_gemm_ref(xq, xs, qt, scale, dtype))
    assert (im.quant_prepass.launches, im.weight_prepass.launches, im.fold_gemm.launches) == \
        (before[0] + 1, before[1] + 1, before[2] + 2)


@pytest.mark.parametrize("kn", [(16, 4), (48, 100), (4160, 1028), (11008, 136), (4096, 32000)])
def test_weight_prepass_equals_transpose_on_card(cuda, kn):
    """The weight pre-pass at ragged K (a multiple of 16) and N (a multiple of 4): equal to ``q.T.contiguous()``."""
    K, N = kn
    q, _ = _int8_weights(np.random.default_rng(5), K, N, cuda)
    assert torch.equal(im.weight_prepass(q), q.T.contiguous())


@pytest.mark.parametrize("mcn", [(77, 4160, 33), (1, 16, 5)])
def test_int8_gemm_nt_odd_n_on_card(cuda, mcn):
    """The dx GEMM at an odd number of output columns (its epilogue's scalar stores): equal."""
    M, C, N = mcn
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.integers(-127, 128, (M, C)).astype(np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(-127, 128, (N, C)).astype(np.int8)).to(cuda)
    before = im.int8_gemm_nt.launches
    assert torch.equal(im.int8_gemm_nt(a, b), im.int8_gemm_nt_ref(a, b))
    assert im.int8_gemm_nt.launches == before + 1


def test_k1_wrappers_reject_noncontiguous_weight(cuda):
    x = torch.zeros((8, 512), device=cuda)
    q = torch.zeros((256, 512), dtype=torch.int8, device=cuda)
    scale = torch.ones((1, 256), device=cuda)
    before = (im.w8a8_fused.launches, im.weight_prepass.launches)
    with pytest.raises(ValueError, match="contiguous"):
        im.w8a8_fused(x, q.T, scale)
    with pytest.raises(ValueError, match="contiguous"):
        im.weight_prepass(q.T)
    with pytest.raises(ValueError, match="contiguous"):
        im.int8_gemm_kn(torch.zeros((8, 512), dtype=torch.int8, device=cuda), q.T)
    with pytest.raises(ValueError, match="multiple of 128"):
        im.quant_prepass(x, 192)
    assert (im.w8a8_fused.launches, im.weight_prepass.launches) == before


@pytest.mark.parametrize("bwd_int8", [False, True])
@pytest.mark.parametrize("kn", [(512, 384), (64, 128)])
def test_int8_matmul_grad_equals_ref_on_card(cuda, kn, bwd_int8):
    """Forward and dx against the plain version's autograd: equal. (512, 384) takes K1, (64, 128) K2 + GEMM."""
    K, N = kn
    rng = np.random.default_rng(3)
    q, scale = _int8_weights(rng, K, N, cuda)
    x0 = torch.from_numpy(rng.standard_normal((2, 24, K)).astype(np.float32)).to(cuda, torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((2, 24, N)).astype(np.float32)).to(cuda, torch.bfloat16)
    outs = []
    for fn in (im.int8_matmul, im.int8_matmul_ref):
        x = x0.clone().requires_grad_()
        y = fn(x, q, scale, bwd_int8)
        y.backward(g)
        outs.append((y.detach(), x.grad))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert im.w8a8_fused_feasible(48, K, N) == (K == 512)


def test_int8_wrappers_reject_what_they_do_not_take(cuda):
    a = torch.zeros((4, 24), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        im.int8_gemm_nt(a, a)
    with pytest.raises(TypeError):
        im.rowquant(torch.zeros((2, 8), dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="k-block"):
        im.w8a8_fused(torch.zeros((8, 64), device=cuda), torch.zeros((64, 128), dtype=torch.int8, device=cuda),
                      torch.ones((1, 128), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        im.rowquant(torch.zeros((8, 16), device=cuda).T)


# K4. Tolerances row by row: |kernel - plain| <= tol * max(max |plain| over the row, 0.02), a row being the last
# axis (an lse value is a row of its own, floor 1), so that small late rows are not held to the size of the first
# ones: float32 2e-5 forward and 2e-4 gradients (the same f32 terms summed tile by tile under a running maximum);
# bfloat16 2e-2 (p and ds are rounded to bf16 against another maximum, the outputs to bf16 again), lse 1e-4
# (f32 on exact bf16 products).
K4_TOL = {torch.float32: (2e-5, 2e-5, 2e-4), torch.bfloat16: (2e-2, 1e-4, 2e-2)}
K4_CASES = {
    "causal": (2, 4, 4, 256, 256, 64, None, dict()),
    "non_causal": (2, 4, 4, 256, 256, 64, None, dict(causal=False)),
    "pad_segment": (2, 4, 4, 384, 384, 64, "pad", dict()),
    "gqa": (2, 8, 2, 256, 256, 64, None, dict()),
    "gqa_segments": (2, 8, 2, 256, 256, 64, "packed", dict()),
    "window_128": (1, 4, 4, 384, 384, 64, None, dict(window=128)),
    "window_200": (1, 4, 4, 384, 384, 64, None, dict(window=200)),
    "softcap": (2, 4, 4, 256, 256, 64, None, dict(softcap=2.0)),
    "softcap_window": (1, 4, 4, 384, 384, 64, None, dict(softcap=2.0, window=100)),
    "q_offset_128": (2, 4, 4, 128, 256, 64, None, dict(q_offset=128)),
    "q_offset_minus_128": (2, 4, 4, 256, 384, 64, None, dict(q_offset=-128)),
    "all_rows_masked": (2, 4, 2, 128, 128, 64, None, dict(q_offset=-128)),
    "d_32": (2, 2, 2, 256, 256, 32, "pad", dict()),
    "d_128": (2, 4, 2, 256, 256, 128, "pad", dict()),
    "ragged_d_48": (2, 4, 2, 200, 333, 48, None, dict(q_offset=133)),
    "sft_length_2560": (1, 2, 2, 2560, 2560, 128, "pad", dict()),
}


def _k4_inputs(name, dtype, device, case=None, seed=None):
    B, H, Hk, Sq, Sk, D, seg, opts = case or K4_CASES[name]
    rng = np.random.default_rng(sorted(K4_CASES).index(name) if seed is None else seed)

    def mk(S, heads):  # (B, H, S, D) views of (B, S, H, D) storage, as the decoder hands them over
        return torch.from_numpy(rng.standard_normal((B, S, heads, D)).astype(np.float32)).to(device, dtype).transpose(1, 2)

    q, k, v, do = mk(Sq, H), mk(Sk, Hk), mk(Sk, Hk), mk(Sq, H)
    seg_ids = None
    if seg == "pad":
        n_real = rng.integers(Sq // 3, Sq - 8, size=(B, 1))
        seg_ids = torch.from_numpy((np.arange(Sq)[None, :] < n_real).astype(np.int32)).to(device)
    elif seg == "packed":
        seg_ids = torch.from_numpy(np.sort(rng.integers(0, 3, size=(B, Sq)), axis=1).astype(np.int32)).to(device)
    return q, k, v, do, seg_ids, {"causal": True, **opts}


def _k4_close(got, want, tol, floor=0.02):
    assert bool(torch.isfinite(got.float()).all())
    g, w = got.float(), want.float()
    if w.dim() == 3:  # lse
        g, w, floor = g[..., None], w[..., None], 1.0
    share = (g - w).abs() / (tol * w.abs().amax(dim=-1, keepdim=True).clamp(min=floor))
    assert float(share.max()) <= 1.0, float(share.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(K4_CASES))
def test_flash_kernels_match_ref_on_card(cuda, name, dtype):
    q, k, v, do, seg, kw = _k4_inputs(name, dtype, cuda)
    tol_out, tol_lse, tol_grad = K4_TOL[dtype]
    before = dict(fa.flash_attention.launches)
    out, lse = fa.flash_fwd(q, k, v, seg, seg, **kw)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, seg, seg, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == {n: c + 1 for n, c in before.items()}
    ro, rl = fa.flash_fwd_ref(q, k, v, seg, seg, **kw)
    rq, rk, rv = fa.flash_bwd_ref(q, k, v, out, lse, do, seg, seg, **kw)
    _k4_close(out, ro, tol_out)
    _k4_close(lse, rl, tol_lse)
    for got, want in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.dtype == dtype and got.shape == want.shape
        _k4_close(got, want, tol_grad)
    dead = rl <= -1e29
    if name in ("q_offset_minus_128", "all_rows_masked"):
        assert bool(dead.any())
    assert bool((lse[dead] == -1e30).all()) and not bool(out[dead].any()) and not bool(dq[dead].any())
    if name == "all_rows_masked":
        assert not bool(dk.any()) and not bool(dv.any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_op_and_decoder_on_card(cuda, dtype):
    """The differentiable op in (B, S, H, D) against the plain op, and the tiny
    decoder's flash path against its matmul path at real positions."""
    import dataclasses

    from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig

    tol_out, _, tol_grad = K4_TOL[dtype]
    rng = np.random.default_rng(0)
    seg = torch.from_numpy(np.sort(rng.integers(0, 2, size=(2, 256)), axis=1).astype(np.int32)).to(cuda)
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_ref):
        r = np.random.default_rng(1)
        q, k, v = (torch.from_numpy(r.standard_normal((2, 256, h, 64)).astype(np.float32)).to(cuda, dtype).requires_grad_()
                   for h in (4, 2, 2))
        out = fn(q, k, v, seg, seg)
        (out.float() ** 2).sum().backward()
        grads.append((out.detach(), q.grad, k.grad, v.grad))
    _k4_close(grads[0][0], grads[1][0], tol_out)
    for a, b in zip(grads[0][1:], grads[1][1:]):
        _k4_close(a, b, 4 * tol_grad)

    cfg = dataclasses.replace(DecoderConfig.tiny(), dtype=dtype, attention_impl="flash")
    flash = Decoder(cfg, device=cuda)
    flash.reset_parameters(torch.Generator(device=cuda).manual_seed(0))
    plain = Decoder(dataclasses.replace(cfg, attention_impl="einsum"), device=cuda)
    plain.load_state_dict(flash.state_dict())
    ids = torch.from_numpy(rng.integers(0, 259, size=(2, 256))).to(cuda)
    mask = (torch.arange(256, device=cuda)[None, :] < torch.tensor([[200], [256]], device=cuda)).long()
    before = fa.flash_attention.launches["fwd"]
    a, b = flash(ids, mask), plain(ids, mask)
    assert fa.flash_attention.launches["fwd"] == before + cfg.num_layers
    real = mask.bool()
    # two paths through two layers, not a kernel against its plain version: held over the whole tensor
    a, b = a[real].float(), b[real].float()
    assert float((a - b).abs().max()) <= (1e-4 if dtype == torch.float32 else 3e-2) * max(1.0, float(b.abs().max()))


# The forward's wgmma route (bfloat16 at head dim 64 and 128), each case at both widths; segment ids of one
# (B, S) tensor need Sq == Sk.
WGMMA_CASES = {
    "causal_pad_segment": (2, 4, 4, 384, 384, "pad", dict()),
    "gqa_packed_segments": (2, 8, 2, 256, 256, "packed", dict()),
    "non_causal_packed": (2, 4, 4, 256, 256, "packed", dict(causal=False)),
    "window_200": (1, 4, 4, 384, 384, None, dict(window=200)),
    "softcap_window": (1, 4, 4, 384, 384, None, dict(softcap=2.0, window=100)),
    "ragged_q_offset_133": (2, 4, 2, 200, 333, None, dict(q_offset=133)),
    "q_offset_minus_128": (2, 4, 4, 256, 384, None, dict(q_offset=-128)),
    "all_rows_masked": (2, 4, 2, 128, 128, None, dict(q_offset=-128)),
}


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("name", sorted(WGMMA_CASES))
def test_flash_fwd_wgmma_route_matches_ref_on_card(cuda, name, D):
    """The wgmma forward on (B, H, S, D) views of (B, S, H, D) storage against the plain version, out in
    q's layout, fully masked rows exact; one launch, on its route."""
    B, H, Hk, Sq, Sk, seg, opts = WGMMA_CASES[name]
    q, k, v, _, seg_ids, kw = _k4_inputs(name, torch.bfloat16, cuda, (B, H, Hk, Sq, Sk, D, seg, opts),
                                         seed=sorted(WGMMA_CASES).index(name) + D)
    assert q.stride()[1:3] == (D, H * D) and fa.fwd_route(q.dtype, D) == "wgmma"
    before, fwd_before = dict(fa.flash_fwd.routes), fa.flash_attention.launches["fwd"]
    out, lse = fa.flash_fwd(q, k, v, seg_ids, seg_ids, **kw)
    torch.cuda.synchronize()
    assert fa.flash_fwd.routes == dict(before, wgmma=before["wgmma"] + 1)
    assert fa.flash_attention.launches["fwd"] == fwd_before + 1
    assert out.stride() == q.stride() and out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ro, rl = fa.flash_fwd_ref(q, k, v, seg_ids, seg_ids, **kw)
    tol_out, tol_lse, _ = K4_TOL[torch.bfloat16]
    _k4_close(out, ro, tol_out)
    _k4_close(lse, rl, tol_lse)
    dead = rl <= -1e29
    if name in ("q_offset_minus_128", "all_rows_masked"):
        assert bool(dead.any())
    assert bool((lse[dead] == -1e30).all()) and not bool(out[dead].any())


def test_flash_fwd_routes_count_on_card(cuda):
    """bf16 at D 64 / 128 launch the wgmma kernel; f32 and other head dims the mma.sync kernel; every
    launch also counts in flash_attention.launches["fwd"]."""
    calls = [(torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"), (torch.float32, 64, "mma"),
             (torch.float32, 128, "mma"), (torch.bfloat16, 32, "mma"), (torch.bfloat16, 48, "mma")]
    for dtype, D, route in calls:
        q = torch.randn((1, 2, 256, D), device=cuda).to(dtype)
        before, fwd_before = dict(fa.flash_fwd.routes), fa.flash_attention.launches["fwd"]
        out, _ = fa.flash_fwd(q, q, q)
        torch.cuda.synchronize()
        assert fa.fwd_route(dtype, D) == route
        assert fa.flash_fwd.routes == dict(before, **{route: before[route] + 1}), (dtype, D)
        assert fa.flash_attention.launches["fwd"] == fwd_before + 1
        _k4_close(out, fa.flash_fwd_ref(q, q, q)[0], K4_TOL[dtype][0])


def test_decoder_flash_path_at_head_dim_128_takes_the_wgmma_route(cuda):
    """A bf16 decoder with head dim 128: every layer's attention goes through the wgmma forward, and
    its output agrees with the matmul path at real positions."""
    import dataclasses

    from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig

    cfg = dataclasses.replace(DecoderConfig.tiny(), hidden_size=256, num_heads=2, intermediate_size=512,
                              dtype=torch.bfloat16, attention_impl="flash")
    assert cfg.hidden_size // cfg.num_heads == 128
    flash = Decoder(cfg, device=cuda)
    flash.reset_parameters(torch.Generator(device=cuda).manual_seed(0))
    plain = Decoder(dataclasses.replace(cfg, attention_impl="einsum"), device=cuda)
    plain.load_state_dict(flash.state_dict())
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, 259, size=(2, 256))).to(cuda)
    mask = (torch.arange(256, device=cuda)[None, :] < torch.tensor([[200], [256]], device=cuda)).long()
    before = dict(fa.flash_fwd.routes)
    a, b = flash(ids, mask), plain(ids, mask)
    assert fa.flash_fwd.routes == dict(before, wgmma=before["wgmma"] + cfg.num_layers)
    real = mask.bool()
    a, b = a[real].float(), b[real].float()
    assert float((a - b).abs().max()) <= 3e-2 * max(1.0, float(b.abs().max()))


def test_flash_fwd_wgmma_raises_and_never_falls_back(cuda, monkeypatch):
    """A bf16 D 128 call the wgmma kernel cannot take raises: a stride the TMA encoder refuses (2^40 bytes
    between batches, which the mma.sync kernel would take at B = 1), and a launch that fails. The mma.sync
    route is never tried."""
    k = torch.randn((1, 2, 256, 128), device=cuda).to(torch.bfloat16)
    q = k.as_strided(k.shape, (2 ** 39,) + k.stride()[1:])  # 2^39 values = 2^40 bytes
    before, fwd_before = dict(fa.flash_fwd.routes), fa.flash_attention.launches["fwd"]
    with pytest.raises(RuntimeError, match="tensor map was refused"):
        fa.flash_fwd(q, k, k)
    fa._lib("flash_fwd_wgmma")
    monkeypatch.setitem(fa._libs, "flash_fwd_wgmma", type("Lib", (), {"dalm_fa_fwd_wgmma": staticmethod(lambda a, s: 1)}))
    with pytest.raises(RuntimeError, match="dalm_fa_fwd_wgmma"):
        fa.flash_fwd(k, k, k)
    assert fa.flash_fwd.routes == before and fa.flash_attention.launches["fwd"] == fwd_before


# The backward's wgmma route (bfloat16 at head dim 64 and 128): every K4_CASES case at both widths, and GQA 32/8.
BWD_CASES = {f"{name}-d{D}": K4_CASES[name][:5] + (D,) + K4_CASES[name][6:] for name in K4_CASES for D in (64, 128)}
BWD_CASES["gqa_32_8-d128"] = (1, 32, 8, 256, 256, 128, None, dict())


@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_flash_bwd_wgmma_route_matches_ref_on_card(cuda, name):
    """The wgmma backward (the dsum pre-pass, dq, dk/dv) on (B, H, S, D) views of (B, S, H, D) storage against
    the plain version at the bf16 gradient tolerance, gradients in their inputs' layouts, fully masked rows
    exact; one call on its route, one launch of each kernel."""
    case = BWD_CASES[name]
    q, k, v, do, seg, kw = _k4_inputs(name, torch.bfloat16, cuda, case, seed=sorted(BWD_CASES).index(name))
    assert fa.fwd_route(q.dtype, case[5]) == "wgmma"
    out, lse = fa.flash_fwd(q, k, v, seg, seg, **kw)
    before, launches = dict(fa.flash_bwd.routes), dict(fa.flash_attention.launches)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, seg, seg, **kw)
    torch.cuda.synchronize()
    assert fa.flash_bwd.routes == dict(before, wgmma=before["wgmma"] + 1)
    assert fa.flash_attention.launches == dict(launches, dq=launches["dq"] + 1, dkv=launches["dkv"] + 1,
                                               dsum=launches["dsum"] + 1)
    for got, t in ((dq, q), (dk, k), (dv, v)):
        assert got.stride() == t.stride() and got.dtype == torch.bfloat16
    for got, want in zip((dq, dk, dv), fa.flash_bwd_ref(q, k, v, out, lse, do, seg, seg, **kw)):
        _k4_close(got, want, K4_TOL[torch.bfloat16][2])
    dead = lse <= -1e29
    if "q_offset_minus_128" in name or "all_rows_masked" in name:
        assert bool(dead.any())
    assert not bool(dq[dead].any())
    if "all_rows_masked" in name:
        assert not bool(dk.any()) and not bool(dv.any())


def test_flash_bwd_routes_count_on_card(cuda):
    """bf16 at D 64 / 128 launch the wgmma backward; f32 and other head dims the mma.sync pair. Either way one
    dsum, one dq and one dk/dv launch a call, counted in flash_attention.launches."""
    calls = [(torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"), (torch.float32, 64, "mma"),
             (torch.float32, 128, "mma"), (torch.bfloat16, 32, "mma"), (torch.bfloat16, 48, "mma")]
    for dtype, D, route in calls:
        q, do = (torch.randn((1, 2, 256, D), device=cuda).to(dtype) for _ in range(2))
        out, lse = fa.flash_fwd(q, q, q)
        before, launches = dict(fa.flash_bwd.routes), dict(fa.flash_attention.launches)
        grads = fa.flash_bwd(q, q, q, out, lse, do)
        torch.cuda.synchronize()
        assert fa.fwd_route(dtype, D) == route
        assert fa.flash_bwd.routes == dict(before, **{route: before[route] + 1}), (dtype, D)
        assert fa.flash_attention.launches == dict(launches, dq=launches["dq"] + 1, dkv=launches["dkv"] + 1,
                                                   dsum=launches["dsum"] + 1), (dtype, D)
        for got, want in zip(grads, fa.flash_bwd_ref(q, q, q, out, lse, do)):
            _k4_close(got, want, K4_TOL[dtype][2])


def test_flash_bwd_wgmma_raises_and_never_falls_back(cuda, monkeypatch):
    """A bf16 D 128 backward the wgmma kernels cannot take raises before its first launch (a stride the TMA
    encoder refuses: 2^40 bytes between batches, which the mma.sync pair would take at B = 1), and no count
    moves. A dq launch that fails raises too, after the dsum pre-pass it reads has run (and counted). The
    mma.sync route is never tried."""
    k, do = (torch.randn((1, 2, 256, 128), device=cuda).to(torch.bfloat16) for _ in range(2))
    out, lse = fa.flash_fwd(k, k, k)
    q = k.as_strided(k.shape, (2 ** 39,) + k.stride()[1:])  # 2^39 values = 2^40 bytes
    before, launches = dict(fa.flash_bwd.routes), dict(fa.flash_attention.launches)
    with pytest.raises(RuntimeError, match="tensor map was refused"):
        fa.flash_bwd(q, k, k, out, lse, do)
    assert fa.flash_bwd.routes == before and fa.flash_attention.launches == launches
    lib = fa._lib("flash_bwd_wgmma")
    failing = {name: getattr(lib, name) for name in ("dalm_fa_bwd_wgmma_maps", "dalm_fa_dsum", "dalm_fa_bwd_dkv_wgmma")}
    failing["dalm_fa_bwd_dq_wgmma"] = staticmethod(lambda a, s: 1)
    monkeypatch.setitem(fa._libs, "flash_bwd_wgmma", type("Lib", (), failing))
    with pytest.raises(RuntimeError, match="dalm_fa_bwd_dq_wgmma"):
        fa.flash_bwd(k, k, k, out, lse, do)
    torch.cuda.synchronize()
    assert fa.flash_bwd.routes == before
    assert fa.flash_attention.launches == dict(launches, dsum=launches["dsum"] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 48, 64, 128])
def test_dsum_kernel_equals_ref_on_card(cuda, dtype, D):
    """The dsum pre-pass on strided (B, H, S, D) views against dsum_ref: both sum D f32 products in another
    order, so within 1e-5 of each row's sum of |do out|."""
    rng = np.random.default_rng(D)
    do, out = (torch.from_numpy(rng.standard_normal((2, 333, 3, D)).astype(np.float32)).to(cuda, dtype)
               .transpose(1, 2) for _ in range(2))
    dsum = torch.full((2, 3, 333), float("nan"), device=cuda)
    dims = (2, 3, 3, 333, 333, D)
    a = fa._args(do, out, out, None, None, True, 1.0, 0, None, None, dims, out=out, dout=do, dsum=dsum)
    before = fa.flash_attention.launches["dsum"]
    fa._launch("dalm_fa_dsum", "dsum", a, do)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches["dsum"] == before + 1
    want = fa.dsum_ref(do, out)
    mag = (do.float() * out.float()).abs().sum(dim=-1)
    assert bool(((dsum - want).abs() <= 1e-5 * mag).all())


def test_decoder_flash_backward_at_head_dim_128_takes_the_wgmma_route(cuda):
    """A bf16 decoder with head dim 128: every layer's attention backward goes through the wgmma kernels, and
    the parameters' gradients agree with the matmul path's (two paths through two layers in bf16, each
    gradient tensor within 5e-2 of its norm)."""
    import dataclasses

    from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig

    cfg = dataclasses.replace(DecoderConfig.tiny(), hidden_size=256, num_heads=2, intermediate_size=512,
                              dtype=torch.bfloat16, attention_impl="flash")
    flash = Decoder(cfg, device=cuda)
    flash.reset_parameters(torch.Generator(device=cuda).manual_seed(0))
    plain = Decoder(dataclasses.replace(cfg, attention_impl="einsum"), device=cuda)
    plain.load_state_dict(flash.state_dict())
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 259, size=(2, 256))).to(cuda)
    mask = (torch.arange(256, device=cuda)[None, :] < torch.tensor([[200], [256]], device=cuda)).long()
    real = mask.bool()
    before = dict(fa.flash_bwd.routes)
    grads = []
    for model in (flash, plain):
        params = [p.requires_grad_() for p in model.parameters()]  # the base is frozen by default
        loss = (model.train_forward(ids, mask)[real].float() ** 2).mean()
        grads.append(torch.autograd.grad(loss, params, allow_unused=True))
    assert fa.flash_bwd.routes == dict(before, wgmma=before["wgmma"] + cfg.num_layers)
    names = [n for n, _ in flash.named_parameters()]
    assert any("q_proj" in n and g is not None for n, g in zip(names, grads[0]))
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert bool(torch.isfinite(a.float()).all())
        assert float((a.float() - b.float()).norm()) <= 5e-2 * max(float(b.float().norm()), 1e-6)


def test_flash_wrappers_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 2, 64, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(torch.zeros((1, 2, 64, 24), device=cuda), torch.zeros((1, 2, 64, 24), device=cuda),
                     torch.zeros((1, 2, 64, 24), device=cuda))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_fwd(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="k is"):
        fa.flash_fwd(q, q.float(), q.float())
    with pytest.raises(ValueError, match="kv heads"):
        fa.flash_fwd(torch.zeros((1, 3, 64, 32), device=cuda, dtype=torch.bfloat16), q, q)
    with pytest.raises(ValueError, match="contiguous last axis"):
        wide = torch.zeros((1, 2, 64, 64), device=cuda, dtype=torch.bfloat16)[..., ::2]
        fa.flash_fwd(wide, wide, wide)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_fwd(q, q.cpu(), q.cpu())
    with pytest.raises(ValueError, match="segment ids"):
        fa.flash_fwd(q, q, q, torch.zeros((1, 64), dtype=torch.int32, device=cuda), None)


# K5. Tolerances against the plain version, row by row (a row's largest |plain| value sets its scale): pcol equal
# (int32 sums, then the same two f32 products); i8mxu 3e-5 of the row in f32 (exact int8 products; only where the
# kernel splits K does the scale fold add its slices in another order), base / groupmm / nf4 1e-4 of the row in f32
# (the same bf16 x bf16 products summed in another order); bf16 outputs of every instance one bf16 ulp of the row's
# largest value (2^-7), as the final rounding may fall the other way.
K5_TOL = {"base": 1e-4, "groupmm": 1e-4, "nf4": 1e-4, "i8mxu": 3e-5, "pcol": 0.0}


def _k5_weights(rng, K, N, instance, device, group=64):
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.02).astype(np.float32))
    if instance == "pcol":
        d = quant.quantize_tensor_int4pc(w)
    elif instance == "nf4":
        d = quant.quantize_tensor_nf4(w, group)
    else:
        d = quant.quantize_tensor_int4(w, group)
    return d["q4"].to(device), d["scale4"].to(device)


def _k5_close(y, ry, instance):
    tol = K5_TOL[instance] if y.dtype == torch.float32 else 2.0 ** -7
    err = (y.float() - ry.float()).abs()
    bound = tol * ry.float().abs().amax(dim=1, keepdim=True)
    assert torch.isfinite(y.float()).all() and bool((err <= bound).all()), float((err - bound).max())


_LLAMA_WEIGHTS = {}


def _k5_llama_weights(K, N, instance, group, device):
    """A Llama-2-7B-sized weight in the instance's format, made on the card from a seed once per shape and kept:
    numpy would take seconds for each of the 50 cases of a shape."""
    fmt = {"pcol": "int4pc", "nf4": "nf4"}.get(instance, "int4")
    key = (K, N, fmt, group)
    if key not in _LLAMA_WEIGHTS:
        gen = torch.Generator(device=device).manual_seed(K * 7 + N)
        w = torch.randn((K, N), generator=gen, device=device) * 0.02
        d = (quant.quantize_tensor_int4pc(w) if fmt == "int4pc" else
             getattr(quant, f"quantize_tensor_{fmt}")(w, group))
        _LLAMA_WEIGHTS[key] = (d["q4"], d["scale4"])
    return _LLAMA_WEIGHTS[key]


# Decode rows at Llama-2-7B's four shapes (the packer's groups: 64, and 16 at the down-projection).
_K5_LLAMA_ROWS = [(M, K, N, 16 if K == 11008 else 64) for K, N in ((4096, 4096), (4096, 11008), (11008, 4096),
                                                                   (4096, 32000)) for M in (1, 8, 32, 64, 191)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("instance", ["base", "groupmm", "nf4", "i8mxu", "pcol"])
@pytest.mark.parametrize("mkng", [(32, 4096, 4096, 64), (32, 11008, 512, 16), (300, 512, 1000, 32),
                                  (5, 2048, 136, 128), (1, 1024, 256, 16), (200, 4096, 384, 64),
                                  (191, 1024, 264, 32)] + _K5_LLAMA_ROWS)
def test_int4_kernel_matches_ref_on_card(cuda, instance, mkng, dtype):
    """Each K5 instance against its plain version: decode rows (K split across a cluster), ragged M and N, groups
    16-128, and Llama-2-7B's four shapes at M 1-191. Where int4_matmul_fwd takes another route (bf16 from M_PREFILL
    rows: the prefill route for base / nf4, the fold route for groupmm / i8mxu), the fused kernel is held to the
    plain version on the same rows as well."""
    M, K, N, group = mkng
    rng = np.random.default_rng(4)
    if (M, K, N, group) in _K5_LLAMA_ROWS:
        q4, scale4 = _k5_llama_weights(K, N, instance, group, cuda)
    else:
        q4, scale4 = _k5_weights(rng, K, N, instance, cuda, group)
    x = torch.from_numpy((rng.standard_normal((M, K)) * 0.5).astype(np.float32)).to(cuda, dtype)
    x[0] = 0
    before = k5.int4_matmul_fwd.launches[instance]
    y, ry = k5.int4_matmul_fwd(x, q4, scale4, instance), k5.int4_matmul_fwd_ref(x, q4, scale4, instance)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (M, N) and not y[0].any()
    _k5_close(y, ry, instance)
    assert k5.int4_matmul_fwd.launches[instance] == before + 1
    if k5._route(x, instance, group) != "fused":
        _k5_close(k5.fused(x, q4, scale4, instance, k5._check(x, q4, scale4, instance)), ry, instance)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("instance", ["base", "groupmm", "nf4", "i8mxu", "pcol"])
@pytest.mark.parametrize("kn", [(4096, 4096), (11008, 4096)], ids=["4096x4096", "11008x4096"])
def test_int4_fused_is_one_launch_and_repeats_on_card(cuda, instance, kn, dtype):
    """A fused-route call at decode's 32 rows launches the kernel once (its own counter moves by one, beside the
    route's; K2 once more for i8mxu / pcol) with its K split across a cluster, and two calls on the same inputs give
    the same bits (the slices are summed in slice order, no atomics)."""
    K, N = kn
    group = 16 if K == 11008 else 64
    q4, scale4 = _k5_llama_weights(K, N, instance, group, cuda)
    x = torch.from_numpy((np.random.default_rng(21).standard_normal((32, K)) * 0.5).astype(np.float32)).to(cuda, dtype)
    assert k5._route(x, instance, group) == "fused"
    assert k5._splits(32, N, K // 2, K if instance == "pcol" else group, instance, k5._sm_count(cuda)).splits > 1
    before = (dict(k5.fused.launches), dict(k5.int4_matmul_fwd.route_launches), im.rowquant.launches)
    y = k5.int4_matmul_fwd(x, q4, scale4, instance)
    after = (dict(k5.fused.launches), dict(k5.int4_matmul_fwd.route_launches), im.rowquant.launches)
    y2 = k5.int4_matmul_fwd(x, q4, scale4, instance)
    torch.cuda.synchronize()
    assert after[0] == dict(before[0], **{instance: before[0][instance] + 1})
    assert after[1] == {**before[1], (instance, "fused"): before[1][instance, "fused"] + 1}
    assert after[2] == before[2] + (instance in ("i8mxu", "pcol"))
    assert torch.equal(y, y2)
    _k5_close(y, k5.int4_matmul_fwd_ref(x, q4, scale4, instance), instance)


@pytest.mark.parametrize("instance,case", [("i8mxu", "random"), ("i8mxu", "cancelling"), ("pcol", "random"),
                                           ("pcol", "ones_neg"), ("pcol", "ones_pos")])
def test_int4_fused_int8_exact_at_extremes_on_card(cuda, instance, case):
    """The fused kernel at decode's 32 rows, K = 11008 (eight slices of 688 packed rows), at the extremes of its
    operands: K2's values all +-127 (rows of +-1) against nibbles of -8 and 7 with power-of-two scales. pcol's int32
    sums are exact; i8mxu's folds add multiples of the scales that f32 holds exactly, so both equal their plain
    versions bit for bit. ``cancelling`` (i8mxu, group 16): each group's sums climb to 8 x 127 x 7 and end at a
    small integer; ``ones_neg`` / ``ones_pos`` (pcol): rows of ones against every nibble -8 / 7, nothing
    cancelling: every int32 sum is 11008 x 127 x 8 (or 7)."""
    M, K, N = 32, 11008, 264
    rng = np.random.default_rng(22)
    if instance == "i8mxu":
        q4, scale4 = _extreme_weights(rng, K, N, 16, cuda, case == "cancelling")
    else:
        bits = rng.choice(np.array([0, 15], dtype=np.uint8), size=(K, N)) if case == "random" else \
            np.full((K, N), 0 if case == "ones_neg" else 15, dtype=np.uint8)
        q4 = torch.from_numpy(bits[:K // 2] | (bits[K // 2:] << 4)).to(cuda)
        scale4 = torch.from_numpy((2.0 ** rng.integers(-8, -4, size=(1, N))).astype(np.float32)).to(cuda)
    signs = rng.choice(np.array([-1.0, 1.0], np.float32), size=(M, K)) if case == "random" else \
        np.ones((M, K), np.float32)
    x = torch.from_numpy(signs).to(cuda, torch.bfloat16)
    assert bool((im.rowquant(x)[0].abs() == 127).all())
    assert k5._route(x, instance, 16 if instance == "i8mxu" else K) == "fused"
    y, ry = k5.int4_matmul_fwd(x, q4, scale4, instance), k5.int4_matmul_fwd_ref(x, q4, scale4, instance)
    torch.cuda.synchronize()
    assert torch.equal(y, ry)


def test_int4_fused_raises_and_never_falls_back(cuda, monkeypatch):
    """A refused launch raises, and no count of the fused kernel or its route moves: no plain version runs."""
    q4, scale4 = _k5_weights(np.random.default_rng(23), 1024, 256, "base", cuda)
    x = torch.zeros((32, 1024), dtype=torch.bfloat16, device=cuda)

    class _Refusing:
        def dalm_i4_matmul(self, *args):
            return 1

    k5._lib()
    before = (dict(k5.fused.launches), dict(k5.int4_matmul_fwd.route_launches))
    monkeypatch.setattr(k5, "_lib_handle", _Refusing())
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        k5.int4_matmul_fwd(x, q4, scale4, "base")
    assert (dict(k5.fused.launches), dict(k5.int4_matmul_fwd.route_launches)) == before


@pytest.mark.parametrize("fmt", ["int4", "nf4", "int4pc"])
def test_int4_matmul_grad_on_card(cuda, fmt):
    """int4_matmul against the plain version's autograd: forward within K5_TOL (bf16), dx equal (both
    bf16(dy) @ bf16(W)^T in f32), no gradient into the storage but zeros for a scale that asks for one."""
    rng = np.random.default_rng(5)
    instance = {"int4": "base", "nf4": "nf4", "int4pc": "pcol"}[fmt]
    q4, scale4 = _k5_weights(rng, 512, 384, instance, cuda)
    scale4.requires_grad_()
    x0 = torch.from_numpy(rng.standard_normal((2, 24, 512)).astype(np.float32)).to(cuda, torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((2, 24, 384)).astype(np.float32)).to(cuda, torch.bfloat16)
    outs = []
    for fn in (k5.int4_matmul, k5.int4_matmul_ref):
        x = x0.clone().requires_grad_()
        y = fn(x, q4, scale4, fmt == "nf4", fmt == "int4pc")
        y.backward(g)
        outs.append((y.detach(), x.grad, scale4.grad.clone()))
        scale4.grad = None
    torch.cuda.synchronize()
    _k5_close(outs[0][0].reshape(48, 384), outs[1][0].reshape(48, 384), instance)
    assert torch.equal(outs[0][1], outs[1][1]) and not outs[0][2].any()


def test_int4_wrapper_rejects_what_it_does_not_take(cuda):
    q4 = torch.zeros((128, 256), dtype=torch.uint8, device=cuda)
    s = torch.ones((4, 256), device=cuda)
    x = torch.zeros((8, 256), device=cuda)
    with pytest.raises(ValueError, match="do not agree"):
        k5.int4_matmul_fwd(torch.zeros((8, 255), device=cuda), q4, s, "base")  # odd K
    with pytest.raises(ValueError, match="multiple of 8"):
        k5.int4_matmul_fwd(x, q4[:, :254].contiguous(), s[:, :254].contiguous(), "base")  # N % 4
    with pytest.raises(ValueError, match="contiguous"):
        k5.int4_matmul_fwd(torch.zeros((256, 8), device=cuda).T, q4, s, "base")
    with pytest.raises(TypeError):
        k5.int4_matmul_fwd(x.half(), q4, s, "base")
    with pytest.raises(TypeError):
        k5.int4_matmul_fwd(x, q4.to(torch.int8), s, "base")
    with pytest.raises(ValueError, match="group"):
        k5.int4_matmul_fwd(x, q4, torch.ones((3, 256), device=cuda), "groupmm")  # the group does not divide K/2
    with pytest.raises(ValueError, match="group"):
        k5.int4_matmul_fwd(x, q4, torch.ones((32, 256), device=cuda), "base")  # group 8
    with pytest.raises(ValueError, match="CUDA"):
        k5.int4_matmul_fwd(x, q4.cpu(), s, "base")
    with pytest.raises(ValueError, match="unknown"):
        k5.int4_matmul_fwd(x, q4, s, "decomp")


# K5's prefill route (csrc/int4_prefill.cu). The pre-pass equals its plain version bit for bit (the same f32
# product, rounded once to bf16). The GEMM and the route within K5_TOL of the plain versions: bf16 outputs, one
# bf16 ulp of the row's largest value (2^-7), as the f32 sums run in another order and the rounding may fall the
# other way.

def _k5_dict(q4, scale4, nf4):
    d = {"q4": q4, "scale4": scale4}
    if nf4:
        d["nf4"] = None
    return d


@pytest.mark.parametrize("nf4", [False, True], ids=["int4", "nf4"])
@pytest.mark.parametrize("kng", [(256, 8, 16), (512, 136, 32), (2048, 4096, 64), (4096, 264, 128), (11008, 4096, 16)])
def test_prefill_dequant_equals_ref_on_card(cuda, kng, nf4):
    """The pre-pass against dequantize_tensor_int4(..., bf16).T: equal, groups 16-128, ragged N and K/2."""
    K, N, group = kng
    q4, scale4 = _k5_weights(np.random.default_rng(6), K, N, "nf4" if nf4 else "base", cuda, group)
    assert K // scale4.shape[0] == group
    key = "nf4" if nf4 else "base"
    before = k5.prefill_dequant.launches[key]
    wt = k5.prefill_dequant(q4, scale4, nf4)
    torch.cuda.synchronize()
    want = quant.dequantize_tensor_int4(_k5_dict(q4, scale4, nf4), torch.bfloat16).T
    assert wt.shape == (N, K) and wt.dtype == torch.bfloat16 and wt.is_contiguous()
    assert torch.equal(wt, want)
    assert k5.prefill_dequant.launches[key] == before + 1


@pytest.mark.parametrize("mnk", [(64, 128, 64), (1, 8, 64), (129, 264, 192), (300, 136, 1024), (1000, 4096, 512),
                                 (8192, 4096, 4096)])
def test_prefill_gemm_matches_ref_on_card(cuda, mnk):
    """The wgmma GEMM: one tile, then ragged M and N, then a prefill shape."""
    M, N, K = mnk
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(cuda, torch.bfloat16)
    wt = torch.from_numpy((rng.standard_normal((N, K)) * 0.05).astype(np.float32)).to(cuda, torch.bfloat16)
    out = torch.full((M, N), float("nan"), dtype=torch.bfloat16, device=cuda)
    k5.launch_gemm(x, wt, out)
    torch.cuda.synchronize()
    _k5_close(out, k5.prefill_gemm_ref(x, wt), "base")


@pytest.mark.parametrize("instance", ["base", "nf4"])
@pytest.mark.parametrize("mkng", [(64, 512, 136, 32), (300, 1024, 4096, 64), (1000, 4096, 11008, 128),
                                  (8192, 11008, 4096, 16), (8192, 4096, 136, 64), (300, 2048, 11008, 16)])
def test_int4_prefill_route_matches_ref_on_card(cuda, instance, mkng):
    """int4_matmul_fwd on bf16 rows takes the prefill route from M_PREFILL rows on, within K5_TOL of the plain
    version, counted per route; the route's two kernels called directly agree at every M."""
    M, K, N, group = mkng
    rng = np.random.default_rng(8)
    q4, scale4 = _k5_weights(rng, K, N, instance, cuda, group)
    x = torch.from_numpy((rng.standard_normal((M, K)) * 0.5).astype(np.float32)).to(cuda, torch.bfloat16)
    x[0] = 0
    route = "prefill" if M >= k5.M_PREFILL else "fused"
    assert k5._route(x, instance, group) == route
    routes = dict(k5.int4_matmul_fwd.route_launches)
    dq, gemm = dict(k5.prefill_dequant.launches), k5.prefill_gemm.launches
    y, ry = k5.int4_matmul_fwd(x, q4, scale4, instance), k5.int4_matmul_fwd_ref(x, q4, scale4, instance)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == (M, N) and not y[0].any()
    _k5_close(y, ry, instance)
    assert k5.int4_matmul_fwd.route_launches[instance, route] == routes[instance, route] + 1
    taken = int(route == "prefill")
    assert k5.prefill_dequant.launches[instance] == dq[instance] + taken and k5.prefill_gemm.launches == gemm + taken
    _k5_close(k5.prefill_gemm(x, k5.prefill_dequant(q4, scale4, instance == "nf4")), ry, instance)


def test_prefill_wrappers_reject_what_they_do_not_take(cuda):
    x = torch.zeros((8, 128), dtype=torch.bfloat16, device=cuda)
    wt = torch.zeros((16, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        k5.prefill_gemm(x.float(), wt)
    with pytest.raises(ValueError, match="multiple of 64"):
        k5.prefill_gemm(x[:, :96].contiguous(), wt[:, :96].contiguous())
    with pytest.raises(ValueError, match="multiple of 64"):
        k5.prefill_gemm(x, wt[:12])
    with pytest.raises(ValueError, match="contiguous"):
        k5.prefill_gemm(torch.zeros((128, 8), dtype=torch.bfloat16, device=cuda).T, wt)
    with pytest.raises(ValueError, match="CUDA"):
        k5.prefill_gemm(x, wt.cpu())
    q4 = torch.zeros((64, 100), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        k5.prefill_dequant(q4, torch.ones((8, 100), device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        k5.prefill_dequant(q4[:, :96].contiguous(), torch.ones((8, 96)))


# K5's fold route (groupmm and i8mxu at prefill, csrc/int4_prefill.cu): the nibble pre-pass equals its plain
# version bit for bit (nib - 8 is exact in bf16); i8mxu equals its plain version bit for bit (K2's values as bf16
# times nib - 8 are integers, a group's |sum| <= group * 127 * 8 < 2^24, so the f32 products are exact, and the
# fold runs in the same order with the same roundings); groupmm within K5_TOL (bf16 outputs: one bf16 ulp of the
# row's largest value, as each group's f32 sums run in another order).

@pytest.mark.parametrize("kn", [(256, 8), (512, 136), (2048, 4096), (11008, 1000)])
def test_prefill_nibbles_equals_ref_on_card(cuda, kn):
    """The unscaled pre-pass against prefill_nibbles_ref: equal, ragged N and K/2."""
    K, N = kn
    q4, _ = _k5_weights(np.random.default_rng(11), K, N, "groupmm", cuda, 16)
    before = k5.prefill_nibbles.launches
    wn = k5.prefill_nibbles(q4)
    torch.cuda.synchronize()
    assert wn.shape == (N, K) and wn.dtype == torch.bfloat16 and wn.is_contiguous()
    assert torch.equal(wn, k5.prefill_nibbles_ref(q4))
    assert k5.prefill_nibbles.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(300, 4096), (3, 7, 100), (1, 30)])
def test_rowquant_bf16_output_equals_ref_on_card(cuda, shape, dtype):
    """K2 writing bf16: the values equal rowquant_ref's int8 ones as bf16, the scales equal."""
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(shape).astype(np.float32)).to(cuda, dtype)
    before = im.rowquant.launches
    q, s = im.rowquant(x, dtype=torch.bfloat16)
    rq, rs = im.rowquant_ref(x)
    torch.cuda.synchronize()
    assert q.dtype == torch.bfloat16 and torch.equal(q, rq.to(torch.bfloat16)) and torch.equal(s, rs)
    assert torch.equal(q, im.rowquant_ref(x, dtype=torch.bfloat16)[0]) and im.rowquant.launches == before + 1


@pytest.mark.parametrize("instance", ["groupmm", "i8mxu"])
@pytest.mark.parametrize("mkng", [(192, 512, 136, 16), (300, 1024, 1000, 32), (1000, 2048, 136, 64),
                                  (257, 4096, 1000, 128), (1000, 11008, 136, 16), (640, 11008, 1000, 16),
                                  (8192, 4096, 136, 64)])
def test_fold_route_matches_ref_on_card(cuda, instance, mkng):
    """int4_matmul_fwd on bf16 rows takes the fold route from M_PREFILL rows on: i8mxu equal to its plain version,
    groupmm within K5_TOL; counted per route and per launch; the route's kernels called one by one agree."""
    M, K, N, group = mkng
    rng = np.random.default_rng(13)
    q4, scale4 = _k5_weights(rng, K, N, instance, cuda, group)
    assert K // scale4.shape[0] == group
    x = torch.from_numpy((rng.standard_normal((M, K)) * 0.5).astype(np.float32)).to(cuda, torch.bfloat16)
    x[0] = 0
    assert M >= k5.M_PREFILL and k5._route(x, instance, group) == "fold"
    routes, nib, fold = dict(k5.int4_matmul_fwd.route_launches), k5.prefill_nibbles.launches, dict(k5.prefill_fold.launches)
    k2 = im.rowquant.launches
    y, ry = k5.int4_matmul_fwd(x, q4, scale4, instance), k5.int4_matmul_fwd_ref(x, q4, scale4, instance)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == (M, N) and not y[0].any()
    if instance == "i8mxu":
        assert torch.equal(y, ry)
    else:
        _k5_close(y, ry, instance)
    assert k5.int4_matmul_fwd.route_launches[instance, "fold"] == routes[instance, "fold"] + 1
    assert sum(k5.int4_matmul_fwd.route_launches.values()) == sum(routes.values()) + 1
    assert k5.prefill_nibbles.launches == nib + 1
    assert k5.prefill_fold.launches == dict(fold, **{instance: fold[instance] + 1})
    assert im.rowquant.launches == k2 + (instance == "i8mxu")
    wn = k5.prefill_nibbles(q4)
    xq, xs = im.rowquant(x, dtype=torch.bfloat16) if instance == "i8mxu" else (x, None)
    y2 = k5.prefill_fold(xq, wn, scale4, xs)
    torch.cuda.synchronize()
    assert torch.equal(y2, y)
    if instance == "i8mxu":
        assert torch.equal(y2, k5.prefill_fold_ref(xq, wn, scale4, xs))


def _extreme_weights(rng, K, N, group, device, cancel):
    """q4 of nibbles 0 and 15 only (nib - 8 = -8 or 7) with positive power-of-two scales. ``cancel``: in each group
    and column the first half of the rows +7, the rest -8, so the running sums climb to group / 2 * 127 * 7 and end
    at a small integer (exact in bf16)."""
    half = K // 2
    if cancel:
        bits = np.zeros((K, N), dtype=np.uint8)
        r = np.arange(K) % group
        bits[r < group // 2] = 15
    else:
        bits = rng.choice(np.array([0, 15], dtype=np.uint8), size=(K, N))
    q4 = torch.from_numpy(bits[:half] | (bits[half:] << 4)).to(device)
    scale4 = torch.from_numpy((2.0 ** rng.integers(-8, -4, size=(K // group, N))).astype(np.float32)).to(device)
    return q4, scale4


@pytest.mark.parametrize("cancel", [False, True], ids=["random", "cancelling"])
@pytest.mark.parametrize("group", [16, 64])
def test_fold_route_i8mxu_exact_at_extremes_on_card(cuda, group, cancel):
    """The exactness the fold route rests on: K2's values all +-127 (rows of +-1) against nibbles of -8 and 7, the
    largest products a group can hold (|p| up to group * 127 * 8), equal to the plain version bit for bit; with
    the cancelling weights every output is a small integer times a power of two, so a product that lost a low bit
    inside the tensor cores would show."""
    M, K, N = 256, 2048, 264
    rng = np.random.default_rng(14)
    q4, scale4 = _extreme_weights(rng, K, N, group, cuda, cancel)
    signs = np.ones((M, K), np.float32) if cancel else rng.choice(np.array([-1.0, 1.0], np.float32), size=(M, K))
    x = torch.from_numpy(signs).to(cuda, torch.bfloat16)
    xq, xs = im.rowquant(x, dtype=torch.bfloat16)
    assert bool((xq.abs() == 127).all())
    y, ry = k5.int4_matmul_fwd(x, q4, scale4, "i8mxu"), k5.int4_matmul_fwd_ref(x, q4, scale4, "i8mxu")
    fold = k5.prefill_fold(xq, k5.prefill_nibbles(q4), scale4)  # groupmm's kernel on the same operands: no xs
    torch.cuda.synchronize()
    assert torch.equal(y, ry)
    assert torch.equal(fold, k5.prefill_fold_ref(xq, k5.prefill_nibbles_ref(q4), scale4))


class _FailingLib:
    """The built int4_prefill library with some of its entries replaced."""

    def __init__(self, lib, **entries):
        self._lib, self._entries = lib, entries

    def __getattr__(self, name):
        return self._entries.get(name) or getattr(self._lib, name)


@pytest.mark.parametrize("instance", ["groupmm", "i8mxu"])
def test_fold_route_raises_and_never_falls_back(cuda, monkeypatch, instance):
    """A refused tensor map raises before the route's first launch: no count moves (route, K2, pre-pass, GEMM). A
    fold GEMM launch that fails raises after the pre-pass has run. Neither the fused kernel nor a plain version is
    tried."""
    rng = np.random.default_rng(15)
    q4, scale4 = _k5_weights(rng, 1024, 256, instance, cuda, 16)
    x = torch.from_numpy(rng.standard_normal((256, 1024)).astype(np.float32)).to(cuda, torch.bfloat16)

    def counts():
        return (dict(k5.int4_matmul_fwd.route_launches), dict(k5.int4_matmul_fwd.launches), im.rowquant.launches,
                k5.prefill_nibbles.launches, dict(k5.prefill_fold.launches))

    lib = k5._prefill_lib()
    before = counts()
    monkeypatch.setattr(k5, "_prefill_handle", _FailingLib(lib, dalm_i4_fold_maps=lambda *a: 1001))
    with pytest.raises(RuntimeError, match="tensor maps were refused"):
        k5.int4_matmul_fwd(x, q4, scale4, instance)
    with pytest.raises(RuntimeError, match="tensor maps were refused"):
        k5.prefill_fold(x, k5.prefill_nibbles_ref(q4).to(cuda), scale4)
    assert counts() == before
    monkeypatch.setattr(k5, "_prefill_handle", _FailingLib(lib, dalm_i4_fold_gemm=lambda *a: 1))
    with pytest.raises(RuntimeError, match="fold GEMM launch failed"):
        k5.int4_matmul_fwd(x, q4, scale4, instance)
    torch.cuda.synchronize()
    after = counts()
    assert after[:2] == before[:2] and after[2] == before[2] + (instance == "i8mxu")
    assert after[3] == before[3] + 1 and after[4] == before[4]


def test_fold_wrappers_reject_what_they_do_not_take(cuda):
    q4 = torch.zeros((64, 96), dtype=torch.uint8, device=cuda)
    s = torch.ones((8, 96), device=cuda)
    a = torch.zeros((8, 128), dtype=torch.bfloat16, device=cuda)
    wn = torch.zeros((96, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        k5.prefill_nibbles(q4.to(torch.int8))
    with pytest.raises(ValueError, match="multiple of 8"):
        k5.prefill_nibbles(q4[:, :92].contiguous())
    with pytest.raises(ValueError, match="multiple of 32"):
        k5.prefill_nibbles(q4[:48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        k5.prefill_nibbles(torch.zeros((96, 64), dtype=torch.uint8, device=cuda).T)
    with pytest.raises(TypeError):
        k5.prefill_fold(a.float(), wn, s)
    with pytest.raises(TypeError):
        k5.prefill_fold(a, wn, s.double())
    with pytest.raises(ValueError, match="group"):
        k5.prefill_fold(a, wn, torch.ones((16, 96), device=cuda))  # group 8
    with pytest.raises(ValueError, match="group"):
        k5.prefill_fold(a, wn, torch.ones((3, 96), device=cuda))
    with pytest.raises(ValueError, match="multiple of 64"):
        k5.prefill_fold(a[:, :96].contiguous(), wn[:, :96].contiguous(), s[:6].contiguous())
    with pytest.raises(ValueError, match="xs"):
        k5.prefill_fold(a, wn, s, torch.ones((8,), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        k5.prefill_fold(torch.zeros((128, 8), dtype=torch.bfloat16, device=cuda).T, wn, s)
    with pytest.raises(ValueError, match="CUDA"):
        k5.prefill_fold(a, wn.cpu(), s)
    with pytest.raises(TypeError):
        im.rowquant(a, dtype=torch.float16)


# K5 pcol's int8 route (K2 writing int8, csrc/int4_prefill.cu's int8 nibble pre-pass, csrc/int8_matmul.cu's scaled
# GEMM): every launch equals its plain version bit for bit (integer sums, then the plain version's two f32 products),
# and so does the route.

@pytest.mark.parametrize("kn", [(256, 8), (512, 136), (2048, 4096), (11008, 1000)])
def test_prefill_nibbles_int8_equals_ref_on_card(cuda, kn):
    """The int8 mode of the unscaled pre-pass against prefill_nibbles_ref(q4, int8): equal, ragged N and K/2."""
    K, N = kn
    q4, _ = _k5_weights(np.random.default_rng(16), K, N, "pcol", cuda)
    before = (k5.prefill_nibbles.launches, k5.prefill_nibbles.int8_launches)
    wn = k5.prefill_nibbles(q4, torch.int8)
    torch.cuda.synchronize()
    assert wn.shape == (N, K) and wn.dtype == torch.int8 and wn.is_contiguous()
    assert torch.equal(wn, k5.prefill_nibbles_ref(q4, torch.int8))
    assert torch.equal(wn.to(torch.bfloat16), k5.prefill_nibbles(q4))  # the bf16 mode's values
    assert (k5.prefill_nibbles.launches, k5.prefill_nibbles.int8_launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("mnk", [(64, 128, 64), (1, 8, 16), (129, 266, 192), (300, 136, 1024), (1000, 4096, 512),
                                 (8192, 4096, 4096), (200, 1000, 11008)])
def test_int8_gemm_scaled_equals_ref_on_card(cuda, mnk):
    """The scaled instance of the s8 GEMM against int8_gemm_scaled_ref: equal; ragged M, N (even, no multiple of 8
    at 266) and K (16, and 192: a multiple of 16, not of the ring's 128-deep slot)."""
    M, N, K = mnk
    rng = np.random.default_rng(17)
    xq = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8)).to(cuda)
    wn = torch.from_numpy(rng.integers(-8, 8, (N, K)).astype(np.int8)).to(cuda)
    xs = torch.from_numpy((rng.random((M, 1)) * 0.01 + 1e-4).astype(np.float32)).to(cuda)
    ws = torch.from_numpy((rng.random((1, N)) * 0.01 + 1e-4).astype(np.float32)).to(cuda)
    before = im.int8_gemm_scaled.launches
    y = im.int8_gemm_scaled(xq, wn, xs, ws)
    torch.cuda.synchronize()
    assert y.shape == (M, N) and y.dtype == torch.bfloat16
    assert torch.equal(y, im.int8_gemm_scaled_ref(xq, wn, xs, ws))
    assert im.int8_gemm_scaled.launches == before + 1


@pytest.mark.parametrize("mkn", [(192, 512, 136), (300, 1024, 1000), (1000, 2048, 264), (257, 4096, 1000),
                                 (1000, 11008, 136), (640, 11008, 1000), (8192, 4096, 136)])
def test_pcol_int8_route_equals_ref_on_card(cuda, mkn):
    """int4_matmul_fwd on bf16 rows takes pcol's int8 route from M_PREFILL rows on: equal to its plain version,
    counted per route and per launch (K2, the int8 pre-pass, the scaled GEMM); the route's kernels called one by
    one give the same output."""
    M, K, N = mkn
    rng = np.random.default_rng(18)
    q4, scale4 = _k5_weights(rng, K, N, "pcol", cuda)
    x = torch.from_numpy((rng.standard_normal((M, K)) * 0.5).astype(np.float32)).to(cuda, torch.bfloat16)
    x[0] = 0
    assert M >= k5.M_PREFILL and k5._route(x, "pcol", K) == "int8"

    def counts():
        return (dict(k5.int4_matmul_fwd.route_launches), im.rowquant.launches, k5.prefill_nibbles.int8_launches,
                im.int8_gemm_scaled.launches, k5.prefill_nibbles.launches)

    before = counts()
    y, ry = k5.int4_matmul_fwd(x, q4, scale4, "pcol"), k5.int4_matmul_fwd_ref(x, q4, scale4, "pcol")
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == (M, N) and not y[0].any()
    assert torch.equal(y, ry)
    after = counts()
    assert after[0]["pcol", "int8"] == before[0]["pcol", "int8"] + 1
    assert sum(after[0].values()) == sum(before[0].values()) + 1
    assert after[1:] == (before[1] + 1, before[2] + 1, before[3] + 1, before[4])
    xq, xs = im.rowquant(x)
    y2 = im.int8_gemm_scaled(xq, k5.prefill_nibbles(q4, torch.int8), xs, scale4)
    torch.cuda.synchronize()
    assert torch.equal(y2, y)


@pytest.mark.parametrize("case", ["random", "ones_neg", "ones_pos"])
def test_pcol_int8_route_exact_at_extremes_on_card(cuda, case):
    """The route at the extremes of its operands, K = 11008: K2's values all +-127 (rows of +-1) against nibbles of
    -8 and 7; with rows of ones and every nibble -8 (or 7) nothing cancels and every int32 sum is 11008 * 127 * 8
    (or * 7). Equal to the plain version bit for bit."""
    M, K, N = 256, 11008, 264
    rng = np.random.default_rng(19)
    if case == "random":
        bits = rng.choice(np.array([0, 15], dtype=np.uint8), size=(K, N))
        signs = rng.choice(np.array([-1.0, 1.0], np.float32), size=(M, K))
    else:
        bits = np.full((K, N), 0 if case == "ones_neg" else 15, dtype=np.uint8)
        signs = np.ones((M, K), np.float32)
    q4 = torch.from_numpy(bits[:K // 2] | (bits[K // 2:] << 4)).to(cuda)
    scale4 = torch.from_numpy((2.0 ** rng.integers(-8, -4, size=(1, N))).astype(np.float32)).to(cuda)
    x = torch.from_numpy(signs).to(cuda, torch.bfloat16)
    xq, _ = im.rowquant(x)
    assert bool((xq.abs() == 127).all())
    y, ry = k5.int4_matmul_fwd(x, q4, scale4, "pcol"), k5.int4_matmul_fwd_ref(x, q4, scale4, "pcol")
    torch.cuda.synchronize()
    assert torch.equal(y, ry)


def test_pcol_int8_route_raises_and_never_falls_back(cuda, monkeypatch):
    """A refused tensor map raises before the route's first launch: no count moves (route, K2, pre-pass, GEMM). A
    GEMM launch that fails raises after K2 and the pre-pass have run. Neither the fused kernel nor a plain version
    is tried."""
    rng = np.random.default_rng(20)
    q4, scale4 = _k5_weights(rng, 1024, 256, "pcol", cuda)
    x = torch.from_numpy(rng.standard_normal((256, 1024)).astype(np.float32)).to(cuda, torch.bfloat16)

    def counts():
        return (dict(k5.int4_matmul_fwd.route_launches), dict(k5.int4_matmul_fwd.launches), im.rowquant.launches,
                k5.prefill_nibbles.int8_launches, im.int8_gemm_scaled.launches)

    lib = im._lib()
    before = counts()
    monkeypatch.setattr(im, "_lib_handle", _FailingLib(lib, dalm_i8_gemm_scaled_maps=lambda *a: 1001))
    with pytest.raises(RuntimeError, match="tensor maps were refused"):
        k5.int4_matmul_fwd(x, q4, scale4, "pcol")
    xq, xs = im.rowquant_ref(x)
    with pytest.raises(RuntimeError, match="tensor maps were refused"):
        im.int8_gemm_scaled(xq, k5.prefill_nibbles_ref(q4, torch.int8), xs, scale4)
    assert counts() == before
    monkeypatch.setattr(im, "_lib_handle", _FailingLib(lib, dalm_i8_gemm_scaled=lambda *a: 1))
    with pytest.raises(RuntimeError, match="scaled GEMM kernel launch failed"):
        k5.int4_matmul_fwd(x, q4, scale4, "pcol")
    torch.cuda.synchronize()
    after = counts()
    assert after[:2] == before[:2] and after[2:] == (before[2] + 1, before[3] + 1, before[4])


def test_scaled_wrappers_reject_what_they_do_not_take(cuda):
    xq = torch.zeros((8, 128), dtype=torch.int8, device=cuda)
    wn = torch.zeros((96, 128), dtype=torch.int8, device=cuda)
    xs = torch.ones((8, 1), device=cuda)
    ws = torch.ones((1, 96), device=cuda)
    with pytest.raises(TypeError):
        k5.prefill_nibbles(torch.zeros((64, 96), dtype=torch.uint8, device=cuda), torch.float16)
    with pytest.raises(TypeError):
        im.int8_gemm_scaled(xq.float(), wn, xs, ws)
    with pytest.raises(TypeError):
        im.int8_gemm_scaled(xq, wn, xs.double(), ws)
    with pytest.raises(ValueError, match="contraction"):
        im.int8_gemm_scaled(xq, wn[:, :64].contiguous(), xs, ws)
    with pytest.raises(ValueError, match="multiple of 16"):
        im.int8_gemm_scaled(xq[:, :120].contiguous(), wn[:, :120].contiguous(), xs, ws)
    with pytest.raises(ValueError, match="xs"):
        im.int8_gemm_scaled(xq, wn, torch.ones((8,), device=cuda), ws)
    with pytest.raises(ValueError, match="multiple of 2"):
        im.int8_gemm_scaled(xq, wn[:95].contiguous(), xs, ws[:, :95].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        im.int8_gemm_scaled(torch.zeros((128, 8), dtype=torch.int8, device=cuda).T, wn, xs, ws)
    with pytest.raises(ValueError, match="CUDA"):
        im.int8_gemm_scaled(xq, wn.cpu(), xs, ws)


def test_int4_matmul_ragged_n_on_card(cuda):
    """N = 100 is no multiple of 8: the routing sends it to x @ dequant(W) on the card as on the CPU, within
    K5_TOL of the CPU route (bf16), and K5 is not launched."""
    rng = np.random.default_rng(9)
    d = quant.quantize_tensor_int4(torch.from_numpy((rng.standard_normal((256, 100)) * 0.02).astype(np.float32)), 16)
    assert d["q4"].shape == (128, 100) and d["scale4"].shape == (16, 100) and k5._kernel_feasible(128, 16)
    x = torch.from_numpy(rng.standard_normal((32, 256)).astype(np.float32)).to(torch.bfloat16)
    before = dict(k5.int4_matmul_fwd.launches)
    y = k5.int4_matmul(x.to(cuda), d["q4"].to(cuda), d["scale4"].to(cuda))
    torch.cuda.synchronize()
    assert k5.int4_matmul_fwd.launches == before and y.shape == (32, 100)
    _k5_close(y.cpu(), k5.int4_matmul(x, d["q4"], d["scale4"]), "base")


@pytest.mark.parametrize("bwd_int8", [False, True])
def test_int8_matmul_padded_shapes_on_card(cuda, bwd_int8):
    """K = 100, N = 102 (no multiples of 16 and 4): the unfused branch pads with zeros for the GEMMs and slices;
    forward equal to the CPU route (exact int32 sums, the same f32 products), dx equal with the int8 backward and
    within 1e-6 of the largest value with the f32 one (another order of f32 sums)."""
    rng = np.random.default_rng(10)
    x0 = torch.from_numpy(rng.standard_normal((2, 3, 100)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (100, 102)).astype(np.int8))
    scale = torch.from_numpy((rng.random((1, 102)) * 0.01 + 1e-3).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 3, 102)).astype(np.float32))
    assert not im.w8a8_fused_feasible(6, 100, 102)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        x = x0.to(dev).requires_grad_()
        y = im.int8_matmul(x, q.to(dev), scale.to(dev), bwd_int8)
        y.backward(g.to(dev))
        outs.append((y.detach().cpu(), x.grad.cpu()))
    assert torch.equal(outs[0][0], outs[1][0])
    if bwd_int8:
        assert torch.equal(outs[0][1], outs[1][1])
    else:
        assert (outs[0][1] - outs[1][1]).abs().max() <= 1e-6 * outs[1][1].abs().max()


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("storage", ["bf16", "int8"])
def test_per_row_cache_write_on_card(cuda, storage, S):
    """The decoder's per-row cache write on CUDA tensors equals the same write on the CPU bit for bit, slots at
    or past the end of the buffer dropped (no out-of-range index reaches the card)."""
    from dalm_tpu_torch.models.decoder import _cache_write

    g = torch.Generator().manual_seed(S)
    B, L, H, D = 4, 10, 2, 8
    if storage == "bf16":
        cache = {n: torch.randn((B, L, H, D), generator=g).to(torch.bfloat16) for n in ("k", "v")}
        new = {n: torch.randn((B, S, H, D), generator=g) for n in ("k", "v")}
    else:
        cache = {"k": torch.randint(-127, 128, (B, L, H, D), generator=g, dtype=torch.int8),
                 "k_scale": torch.rand((B, L, H), generator=g)}
        new = {"k": torch.randint(-127, 128, (B, S, H, D), generator=g, dtype=torch.int8),
               "k_scale": torch.rand((B, S, H), generator=g)}
    index = torch.tensor([0, 5, L - 1, L + 3])
    want = {n: t.clone() for n, t in cache.items()}
    _cache_write(want, new, index, S)
    got = {n: t.to(cuda) for n, t in cache.items()}
    _cache_write(got, {n: t.to(cuda) for n, t in new.items()}, index.to(cuda), S)
    torch.cuda.synchronize()
    for n in cache:
        assert torch.equal(got[n].cpu(), want[n]), n


def _engine_decoder(device):
    """A 4-bit generator with the int8 KV cache, wide enough for K5 (hidden 256, intermediate 512), bf16."""
    import dataclasses

    from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
    from dalm_tpu_torch.models.qlora import pack_module

    cfg = dataclasses.replace(DecoderConfig.tiny(), hidden_size=256, num_heads=4, intermediate_size=512,
                              dtype=torch.bfloat16, kv_quant=True)
    dec = Decoder(cfg, device="cpu")
    dec.reset_parameters(torch.Generator().manual_seed(1))
    dec = dec.to(device)
    pack_module(dec, "int4")
    return dec.eval()


@pytest.mark.parametrize("method", ["generate", "generate_fused"])
def test_engine_matches_lockstep_on_card(cuda, method):
    """The continuous-batching engine on the card, K5 at admission (4 x 64 rows: the prefill route) and at
    decode (4 rows: the fused kernel): one wave of 4 prompts equals the lockstep generate token for token, and
    12 prompts with budgets recycling the 4 slots equal the lockstep generate in batches of 4 (the same shapes),
    each cut at its budget."""
    from dalm_tpu_torch.models.decode_engine import DecodeEngine
    from dalm_tpu_torch.models.generate import build_greedy_generate

    dec = _engine_decoder(cuda)
    B, P, N, max_new = 4, 64, 12, 12
    rng = np.random.default_rng(3)
    ids = np.zeros((N, P), np.int64)
    mask = np.zeros((N, P), np.int64)
    for i in range(N):
        real = int(rng.integers(8, P + 1))
        ids[i, P - real:] = rng.integers(0, 256, size=real)
        mask[i, P - real:] = 1
    lockstep = build_greedy_generate(dec, max_new)
    lock = np.concatenate([lockstep(torch.as_tensor(ids[i:i + B], device=cuda),
                                    torch.as_tensor(mask[i:i + B], device=cuda)).cpu().numpy()
                           for i in range(0, N, B)])
    eng = DecodeEngine(dec, num_slots=B, max_prompt_len=P, max_new_tokens=max_new, decode_chunk=4)
    before = dict(k5.int4_matmul_fwd.route_launches)
    assert getattr(eng, method)(ids[:B], mask[:B]) == [[int(t) for t in row] for row in lock[:B]]
    budgets = rng.integers(2, max_new + 1, size=N)
    got = getattr(eng, method)(ids, mask, budgets=budgets)
    assert got == [[int(t) for t in lock[i, :budgets[i]]] for i in range(N)]
    moved = {r: k5.int4_matmul_fwd.route_launches["base", r] - before["base", r] for r in ("fused", "prefill")}
    assert moved["fused"] > 0 and moved["prefill"] > 0, moved


@pytest.mark.parametrize("rows,route", [(4, "fused"), (32, "prefill")])
def test_verify_forward_k5_routes_on_card(cuda, rows, route):
    """A speculative verify pass (gamma 8: S = 9 tokens a row) through the decoder's per-row cache index on a
    4-bit generator: M = rows x 9 = 36 takes K5's fused kernel and M = 288 the prefill route, as in a serving run
    (M_PREFILL = 192). Every projection's K5 output within K5_TOL (bf16) of its plain version on the same
    operands; the logits are finite."""
    from dalm_tpu_torch.models.speculative import prompt_lookup

    dec = _engine_decoder(cuda)
    G, P = 8, 32
    g = torch.Generator(device=cuda).manual_seed(rows)
    ids = torch.randint(3, 256, (rows, P), generator=g, device=cuda)
    mask = torch.ones_like(ids)
    cache = dec.init_kv_cache(rows, P + 4 + G + 1)
    slot_mask = torch.ones((rows, P + 4 + G + 1), dtype=torch.long, device=cuda)
    dec(ids, slot_mask, kv_cache=cache, cache_index=0, logits_last_only=True)
    q_end = torch.full((rows,), P - 1, dtype=torch.long, device=cuda)
    draft = prompt_lookup(ids, q_end, torch.zeros_like(q_end), G, 2)
    calls, fwd = [], k5.int4_matmul_fwd

    def recording(x2, q4, scale4, instance):
        calls.append((x2.clone(), q4, scale4, instance, k5._route(x2, instance, x2.shape[1] // scale4.shape[0])))
        return fwd(x2, q4, scale4, instance)

    recording.launches, recording.route_launches = fwd.launches, fwd.route_launches
    k5.int4_matmul_fwd = recording
    try:
        logits, _ = dec(torch.cat([ids[:, -1:], draft], dim=1), slot_mask,
                        positions=q_end[:, None] + torch.arange(G + 1, device=cuda), kv_cache=cache,
                        cache_index=q_end)
    finally:
        k5.int4_matmul_fwd = fwd
    assert torch.isfinite(logits.float()).all()
    assert len(calls) == 7 * dec.cfg.num_layers + 1
    for x2, q4, scale4, instance, got_route in calls:
        assert x2.shape[0] == rows * (G + 1) and got_route == route
        _k5_close(fwd(x2, q4, scale4, instance), k5.int4_matmul_fwd_ref(x2, q4, scale4, instance), instance)


def test_speculative_writes_stay_below_the_cache_end_on_card(cuda, monkeypatch):
    """The lockstep speculative generate and the engine's two schedules on the card (4-bit generator, int8 KV
    cache): no verify window writes at or past L, so the per-row write never clamps, and the schedules give
    the lockstep's tokens (every one at M = 4 x 9 rows on the fused kernel)."""
    from dalm_tpu_torch.models import decoder as decoder_module
    from dalm_tpu_torch.models.decode_engine import DecodeEngine
    from dalm_tpu_torch.models.speculative import build_speculative_generate

    dec = _engine_decoder(cuda)
    B, P, G, max_new = 4, 48, 8, 20
    rng = np.random.default_rng(5)
    ids = np.zeros((B, P), np.int64)
    mask = np.zeros((B, P), np.int64)
    for i in range(B):
        real = int(rng.integers(16, P + 1))
        ids[i, P - real:] = np.tile(rng.integers(3, 256, size=3), P)[:real]
        mask[i, P - real:] = 1
    seen, write = [], decoder_module._cache_write

    def recording(cache, new_vals, cache_index, S):
        if torch.is_tensor(cache_index) and S > 1:
            seen.append((int(cache_index.max()) + S, cache[next(iter(new_vals))].shape[1]))
        return write(cache, new_vals, cache_index, S)

    monkeypatch.setattr(decoder_module, "_cache_write", recording)
    want, passes = build_speculative_generate(dec, max_new, gamma=G, return_stats=True)(
        torch.as_tensor(ids, device=cuda), torch.as_tensor(mask, device=cuda))
    want = [[int(t) for t in row] for row in want.cpu().numpy()]
    eng = DecodeEngine(dec, num_slots=B, max_prompt_len=P, max_new_tokens=max_new, speculative_gamma=G)
    assert eng.generate(ids, mask) == want
    assert eng.generate_fused(ids, mask) == want
    assert seen and all(end <= L for end, L in seen), max(end - L for end, L in seen)
    assert int(passes.min()) < max_new - 1  # the repetitive prompts had drafts accepted


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "int4"])
def test_topk_one_query_on_card(cuda, mode):
    """K3 at Q = 1 (a streaming session retrieves one query at a time) over N 16,384 x D 1024, k 4: the plain
    version's ids and scores (near-tie swaps only); one launch a call."""
    before = fused_dot_topk.launches[mode]
    qs, e, kw = _inputs(mode, 16384, 1024, 1, cuda)
    s, i = fused_dot_topk(qs, e, 4, **kw)
    rs, ri = fused_dot_topk_ref(qs, e, 4, **kw)
    torch.cuda.synchronize()
    _assert_topk_near_ties(s, i, rs, ri, qs.float(), e, kw)
    assert fused_dot_topk.launches[mode] == before + 1


def _card_pipeline(cuda, **kw):
    from dalm_tpu_torch.serve import RagPipeline

    passages = [f"passage about topic {i} with unique content {i}" for i in range(300)]
    return RagPipeline.from_pretrained("tiny", "tiny", passages, device=cuda, **dict(
        dict(max_passage_len=48, max_prompt_len=96, max_new_tokens=8, embed_batch=64), **kw))


@pytest.mark.parametrize("quantize", [False, "int8", "int4"])
def test_topk_after_refresh_on_card(cuda, quantize):
    """A card pipeline refreshed with new retriever weights (every tensor moved by seeded noise): a float index swept
    by the refresher at slice 64 (a ragged last slice), an int8 / int4 index rebuilt. The rows equal a fresh
    embedding of the corpus; K3 in the index's mode on them equals its plain version (near ties aside), and each
    search is one counted call."""
    pipe = _card_pipeline(cuda, index_quantize=quantize)
    g = torch.Generator(device=cuda).manual_seed(3)
    new = {k: v + 0.1 * v.float().std() * torch.randn(v.shape, generator=g, device=cuda) if v.numel() > 1 else v
           for k, v in pipe.retriever.state_dict().items()}
    old_rows = pipe.index.embeddings
    pipe.refresh(new, slice_size=64)
    assert pipe.index.embeddings is not old_rows
    texts = [f"#passage# {p}" for p in pipe.passages]
    fresh = pipe._embed_texts(texts, pipe.max_passage_len)
    if not quantize:
        assert float((pipe.index.embeddings - fresh).abs().max()) <= 1e-6
    queries = pipe._embed_texts([f"#query# what is topic {i}" for i in range(12)], pipe.max_passage_len)
    mode = {False: "f32", "int8": "int8", "int4": "int4"}[quantize]
    kw = {} if not quantize else {"scales": pipe.index.scales, "int4": pipe.index.int4}
    q = queries if not quantize else queries.to(torch.bfloat16)
    e = pipe.index.embeddings
    before = fused_dot_topk.launches[mode]
    s, i = fused_dot_topk(q, e, 5, **kw)
    rs, ri = fused_dot_topk_ref(q, e, 5, **kw)
    torch.cuda.synchronize()
    _assert_topk_near_ties(s, i, rs, ri, q.float(), e, kw)
    _, ids = pipe.index.search(queries, 5)
    assert fused_dot_topk.launches[mode] == before + 2
    np.testing.assert_array_equal(ids, i.cpu().numpy())


def test_host_scan_matches_numpy_at_spill_size(cuda):
    """The native host scan over 262,144 x 1024 f32 rows (1 GiB), 8 queries, k 10: ids equal to numpy's stable
    sort, near ties aside; scores within 1e-5 on unit-norm rows."""
    from dalm_tpu_torch.index.host_index import HostDenseIndex, host_topk_ref, scan_threads

    rng = np.random.default_rng(11)
    e = rng.standard_normal((262144, 1024), dtype=np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    qs = rng.standard_normal((8, 1024), dtype=np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    s, i = HostDenseIndex(e).search(qs, 10)
    rs, ri = host_topk_ref(e, qs, 10)
    assert scan_threads() >= 1
    np.testing.assert_allclose(s, rs, rtol=0, atol=1e-5)
    for r, c in zip(*np.nonzero(i != ri)):
        assert abs(float(e[i[r, c]].astype(np.float64) @ qs[r]) - float(e[ri[r, c]].astype(np.float64) @ qs[r])) <= 1e-5


def test_http_server_counts_every_search_on_card(cuda):
    """The HTTP server over a card pipeline, 4 slots, 8 client threads with two requests each to /answer and /stream
    under a short switch interval: every response equals the decode of its own request's tokens, and K3's count
    moves by exactly one a request (its counter is read and written under a lock by the request threads). Then a
    client hangs up on /stream after its first chunk, with each decode chunk slowed to 0.1 s: its request stops
    before its budget and its slot comes back."""
    import json
    import re
    import socket
    import struct
    import sys
    import threading
    import time
    import urllib.request

    from dalm_tpu_torch.server_http import RagHTTPServer

    pipe = _card_pipeline(cuda, max_new_tokens=48)
    srv = RagHTTPServer(pipe, port=0, num_slots=4, decode_chunk=4)
    handles, submit = {}, srv.session.submit

    def recording(query, top_k=4, budget=None):
        handles[query] = submit(query, top_k=top_k, budget=budget)
        return handles[query]

    srv.session.submit = recording
    srv.start_background()
    results, errors = {}, []

    def client(c):
        for j, route in enumerate(("answer", "stream")):
            query = f"what is topic {c * 2 + j}"
            req = urllib.request.Request(f"http://{srv.host}:{srv.port}/{route}", method="POST",
                                         data=json.dumps({"query": query, "top_k": 3}).encode())
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    body = r.read()
                results[query] = json.loads(body)["answer"] if route == "answer" else body.decode("utf-8")
            except Exception as exc:  # noqa: BLE001 - reported by the assertion below
                errors.append(exc)

    interval = sys.getswitchinterval()
    before = fused_dot_topk.launches["f32"]
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        sys.setswitchinterval(interval)
        eng, chunk = srv.session._server.engine, srv.session._server.engine._decode_chunk
        eng._decode_chunk = lambda *a: (time.sleep(0.1), chunk(*a))[1]
        body = json.dumps({"query": "what is topic 99"}).encode()
        with socket.create_connection((srv.host, srv.port), timeout=120) as s:
            s.sendall(f"POST /stream HTTP/1.1\r\nHost: x\r\nConnection: close\r\nContent-Length: {len(body)}\r\n\r\n"
                      .encode() + body)
            got = b""
            while not re.search(rb"\r\n\r\n[0-9A-F]+\r\n.", got, re.S):
                got += s.recv(1)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        gone = handles["what is topic 99"]._handle.result(timeout=120)
        deadline = time.monotonic() + 60
        while srv.session._server.free_slots != 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.session._server.free_slots == 4 and 0 < len(gone) < 48
    finally:
        sys.setswitchinterval(interval)
        srv.shutdown()
    assert not errors and not any(t.is_alive() for t in threads) and len(results) == 16
    assert fused_dot_topk.launches["f32"] == before + 17
    for query, got in results.items():
        text = pipe.g_tok.decode(handles[query]._handle.result(), skip_special_tokens=True).split("#answer#")[0]
        assert got == (text.strip() if int(query.split()[-1]) % 2 == 0 else text)
