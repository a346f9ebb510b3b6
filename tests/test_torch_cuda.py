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
from dalm_tpu_torch.kernels import int8_matmul as im
from dalm_tpu_torch.kernels.topk import fused_dot_topk, fused_dot_topk_ref

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
@pytest.mark.parametrize("mkn", [(256, 512, 384), (200, 1024, 128), (8, 128, 128), (130, 4096, 1028)])
def test_w8a8_fused_kernel_equals_ref_on_card(cuda, mkn, dtype):
    """K1: equal to the plain version, which follows the kernel's order of
    operations (true division, two roundings in the fold); ragged M and N guarded."""
    M, K, N = mkn
    rng = np.random.default_rng(1)
    q, scale = _int8_weights(rng, K, N, cuda)
    x = torch.from_numpy((rng.standard_normal((M, K)) * 0.5).astype(np.float32)).to(cuda, dtype)
    before = im.w8a8_fused.launches
    y, ry = im.w8a8_fused(x, q, scale), im.w8a8_fused_ref(x, q, scale)
    torch.cuda.synchronize()
    assert y.dtype == dtype and torch.equal(y, ry)
    assert im.w8a8_fused.launches == before + 1


@pytest.mark.parametrize("mkn", [(128, 64, 128), (100, 4160, 1028), (4608, 4096, 512), (1, 16, 4)])
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


def _k4_inputs(name, dtype, device):
    B, H, Hk, Sq, Sk, D, seg, opts = K4_CASES[name]
    rng = np.random.default_rng(sorted(K4_CASES).index(name))

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
