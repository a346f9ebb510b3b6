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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("instance", ["base", "groupmm", "nf4", "i8mxu", "pcol"])
@pytest.mark.parametrize("mkng", [(32, 4096, 4096, 64), (32, 11008, 512, 16), (300, 512, 1000, 32),
                                  (5, 2048, 136, 128), (1, 1024, 256, 16), (200, 4096, 384, 64),
                                  (191, 1024, 264, 32)])
def test_int4_kernel_matches_ref_on_card(cuda, instance, mkng, dtype):
    """Each K5 instance against its plain version: decode rows (K split across blocks), ragged M and N, groups 16-128.
    Where int4_matmul_fwd takes the prefill route (bf16 base / nf4 from M_PREFILL rows), the fused kernel is held to
    the plain version on the same rows as well."""
    M, K, N, group = mkng
    rng = np.random.default_rng(4)
    q4, scale4 = _k5_weights(rng, K, N, instance, cuda, group)
    x = torch.from_numpy((rng.standard_normal((M, K)) * 0.5).astype(np.float32)).to(cuda, dtype)
    x[0] = 0
    before = k5.int4_matmul_fwd.launches[instance]
    y, ry = k5.int4_matmul_fwd(x, q4, scale4, instance), k5.int4_matmul_fwd_ref(x, q4, scale4, instance)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (M, N) and not y[0].any()
    _k5_close(y, ry, instance)
    assert k5.int4_matmul_fwd.launches[instance] == before + 1
    if k5._route(x, instance) == "prefill":
        _k5_close(k5.fused(x, q4, scale4, instance, k5._check(x, q4, scale4, instance)), ry, instance)


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
    assert k5._route(x, instance) == route
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
