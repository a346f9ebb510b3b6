"""The port's K4 module (``dalm_tpu_torch/kernels/flash_attention.py``) against
the JAX package's (``dalm_tpu/kernels/flash_attention.py``) on the CPU: numpy
inputs from a seed go through the Pallas kernels in interpret mode (as
``tests/kernels/test_flash_attention.py`` runs them) and through the port's
plain PyTorch versions, which a CPU tensor takes.

Tolerances (float32 on both sides): forward ``out`` and ``lse`` within 2e-5
(the Pallas kernel sums tile by tile under a running maximum, the plain
version densely: the same terms in another order), gradients within 3e-4
(sums of up to 384 products of O(1) terms; the JAX package's own tests use
2e-4 to 3e-4 against their oracle). Fully masked rows must be EXACT: out 0,
lse -1e30, gradients 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.kernels import flash_attention as J
from dalm_tpu_torch.kernels import flash_attention as T

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores

FWD_TOL, GRAD_TOL = 2e-5, 3e-4
BLK = dict(block_q=128, block_k=128, interpret=True)

# name -> (B, H, Hk, Sq, Sk, D, seg kind, kernel options)
CASES = {
    "causal": (2, 2, 2, 256, 256, 64, None, dict()),
    "non_causal": (2, 2, 2, 256, 256, 64, None, dict(causal=False)),
    "segments_with_pad_segment": (2, 2, 2, 384, 384, 32, "pad", dict()),
    "packed_segments": (2, 2, 2, 256, 256, 32, "packed", dict()),
    "gqa_8_2": (1, 8, 2, 256, 256, 32, None, dict()),
    "gqa_8_2_segments": (1, 8, 2, 256, 256, 32, "packed", dict()),
    "window_128": (1, 2, 2, 384, 384, 32, None, dict(window=128)),
    "window_200": (1, 2, 2, 384, 384, 32, None, dict(window=200)),
    "softcap": (1, 2, 2, 256, 256, 32, None, dict(softcap=2.0)),
    "softcap_window": (1, 2, 2, 384, 384, 32, None, dict(softcap=2.0, window=100)),
    "q_offset_128": (2, 2, 2, 128, 256, 32, None, dict(q_offset=128)),
    "q_offset_minus_128": (2, 2, 2, 256, 384, 32, None, dict(q_offset=-128)),
    "all_rows_masked": (1, 2, 1, 128, 128, 32, None, dict(q_offset=-128)),
    "d_32": (1, 2, 2, 256, 256, 32, "pad", dict()),
    "d_64": (1, 2, 2, 256, 256, 64, "pad", dict()),
    "d_128": (1, 2, 1, 256, 256, 128, "pad", dict()),
}
# flash_attention (the differentiable op) has no q_offset and square sequences
OP_CASES = [k for k, c in CASES.items() if "q_offset" not in c[7]]


def _inputs(name):
    """q, k, v, do in the internal (B, H, S, D) layout and segment ids, as numpy."""
    B, H, Hk, Sq, Sk, D, seg, opts = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    mk = lambda S, h: rng.standard_normal((B, h, S, D)).astype(np.float32)  # noqa: E731
    q, k, v, do = mk(Sq, H), mk(Sk, Hk), mk(Sk, Hk), mk(Sq, H)
    seg_ids = None
    if seg == "pad":  # a real segment 1, then pads as segment 0
        n_real = rng.integers(Sq // 3, Sq - 8, size=(B, 1))
        seg_ids = (np.arange(Sq)[None, :] < n_real).astype(np.int32)
    elif seg == "packed":
        seg_ids = np.sort(rng.integers(0, 3, size=(B, Sq)), axis=1).astype(np.int32)
    return q, k, v, do, seg_ids, dict(opts)


def _tt(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=0, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_fwd_matches_pallas(name):
    q, k, v, _, seg, opts = _inputs(name)
    jseg = None if seg is None else jnp.asarray(seg)
    jo, jl = J._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jseg, jseg, **opts, **BLK)
    tq, tk, tv, tseg = _tt(q, k, v, seg)
    to, tl = T.flash_fwd(tq, tk, tv, tseg, tseg, **{"causal": True, **opts})
    assert to.dtype == torch.float32 and tl.dtype == torch.float32 and tuple(tl.shape) == q.shape[:3]
    _close(to.numpy(), jo, FWD_TOL, f"{name} out")
    dead = np.asarray(jl) <= -1e29
    _close(np.where(dead, 0.0, tl.numpy()), np.where(dead, 0.0, np.asarray(jl)), FWD_TOL, f"{name} lse")
    # rows with no visible key: exactly the merge's neutral element on both sides
    assert np.array_equal(tl.numpy() <= -1e29, dead)
    assert (tl.numpy()[dead] == np.float32(T.NEG_INF)).all() and not to.numpy()[dead].any()
    if name in ("q_offset_minus_128", "all_rows_masked"):
        assert dead.any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_bwd_matches_pallas(name):
    """Both backward functions get the SAME out and lse (the Pallas forward's)."""
    q, k, v, do, seg, opts = _inputs(name)
    jseg = None if seg is None else jnp.asarray(seg)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jo, jl = J._flash_fwd(jq, jk, jv, jseg, jseg, **opts, **BLK)
    jg = J._flash_bwd(jq, jk, jv, jo, jl, jdo, jseg, jseg, **opts, **BLK)
    tq, tk, tv, tdo, tseg, to, tl = _tt(q, k, v, do, seg, jo, jl)
    tg = T.flash_bwd(tq, tk, tv, to, tl, tdo, tseg, tseg, **{"causal": True, **opts})
    for which, a, b in zip(("dq", "dk", "dv"), tg, jg):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a.numpy(), b, GRAD_TOL, f"{name} {which}")
    dead = np.asarray(jl) <= -1e29
    assert not tg[0].numpy()[dead].any()  # no gradient into a query that saw nothing
    if name == "all_rows_masked":
        assert not tg[1].numpy().any() and not tg[2].numpy().any()


@pytest.mark.parametrize("name", OP_CASES)
def test_flash_attention_forward_and_gradients_match_pallas(name):
    """The differentiable op in the public (B, S, H, D) layout, gradients of sum(out^2)."""
    import jax

    q, k, v, _, seg, opts = _inputs(name)
    q, k, v = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    jseg = None if seg is None else jnp.asarray(seg)

    def loss(q_, k_, v_):
        return jnp.sum(J.flash_attention(q_, k_, v_, jseg, jseg, **opts, **BLK) ** 2)

    jo = J.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jseg, jseg, **opts, **BLK)
    jg = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t.requires_grad_() for t in _tt(q, k, v))
    (tseg,) = _tt(seg)
    before = dict(T.flash_attention.launches)
    to = T.flash_attention(tq, tk, tv, tseg, tseg, **opts)
    (to ** 2).sum().backward()
    assert T.flash_attention.launches == before  # a CPU tensor takes the plain version: no launch is counted
    _close(to.detach().numpy(), jo, FWD_TOL, f"{name} out")
    for which, t, g in zip(("dq", "dk", "dv"), (tq, tk, tv), jg):
        assert tuple(t.grad.shape) == tuple(g.shape)
        _close(t.grad.numpy(), g, 2 * GRAD_TOL, f"{name} {which}")  # the loss doubles the output gradient


@pytest.mark.parametrize("name", ["causal", "gqa_8_2_segments", "softcap_window"])
def test_plain_backward_equals_autograd_of_a_dense_oracle(name):
    """The backward is written by the formulas; autograd of an independent dense
    softmax must give the same gradients."""
    q, k, v, _, seg, opts = _inputs(name)
    q, k, v = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    (tseg,) = _tt(seg)
    grads = []
    for fn in ("op", "oracle"):
        tq, tk, tv = (t.requires_grad_() for t in _tt(q, k, v))
        if fn == "op":
            out = T.flash_attention_ref(tq, tk, tv, tseg, tseg, **opts)
        else:
            S, H, Hk, D = tq.shape[1], tq.shape[2], tk.shape[2], tq.shape[3]
            kr, vr = tk.repeat_interleave(H // Hk, dim=2), tv.repeat_interleave(H // Hk, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", tq, kr) / D ** 0.5
            if opts.get("softcap"):
                s = torch.tanh(s / opts["softcap"]) * opts["softcap"]
            i = torch.arange(S)
            keep = (i[:, None] >= i[None, :])
            if opts.get("window"):
                keep = keep & (i[:, None] - i[None, :] < opts["window"])
            keep = keep[None, None]
            if tseg is not None:
                keep = keep & (tseg[:, None, :, None] == tseg[:, None, None, :])
            p = torch.softmax(torch.where(keep, s, torch.tensor(-1e30)), dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", torch.where(keep, p, torch.tensor(0.0)), vr)
        (out ** 2).sum().backward()
        grads.append((out.detach(), tq.grad, tk.grad, tv.grad))
    for a, b in zip(*grads):
        _close(a.numpy(), b.numpy(), GRAD_TOL, name)


def test_merge_identity_of_two_key_halves():
    """Splitting the keys and merging the (out, lse) pairs reproduces full
    attention, and agrees with the Pallas kernel's halves."""
    q, k, v, _, _, _ = _inputs("causal")
    tq, tk, tv = _tt(q, k, v)
    full, lse_full = T.flash_fwd(tq, tk, tv, causal=True)
    o1, l1 = T.flash_fwd(tq, tk[:, :, :128], tv[:, :, :128], causal=True, q_offset=0)
    o2, l2 = T.flash_fwd(tq, tk[:, :, 128:], tv[:, :, 128:], causal=True, q_offset=-128)
    jo2, jl2 = J._flash_fwd(jnp.asarray(q), jnp.asarray(k[:, :, 128:]), jnp.asarray(v[:, :, 128:]),
                            causal=True, q_offset=-128, **BLK)
    _close(o2.numpy(), jo2, FWD_TOL, "second half out")
    assert np.array_equal(l2.numpy() <= -1e29, np.asarray(jl2) <= -1e29)
    m = torch.maximum(l1, l2)
    w1, w2 = torch.exp(l1 - m), torch.exp(l2 - m)
    merged = (o1 * w1[..., None] + o2 * w2[..., None]) / torch.clamp(w1 + w2, min=1e-30)[..., None]
    _close(merged.numpy(), full.numpy(), FWD_TOL, "merged out")
    _close((m + torch.log(torch.clamp(w1 + w2, min=1e-30))).numpy(), lse_full.numpy(), FWD_TOL, "merged lse")


def test_bwd_with_a_global_lse_over_a_key_chunk():
    """``out``, ``lse`` and ``do`` may cover more keys than ``k``: the two chunks'
    dq add up to the full dq, and each chunk's dk/dv is the full one's slice."""
    q, k, v, do, _, _ = _inputs("causal")
    tq, tk, tv, tdo = _tt(q, k, v, do)
    out, lse = T.flash_fwd(tq, tk, tv, causal=True)
    dq, dk, dv = T.flash_bwd(tq, tk, tv, out, lse, tdo, causal=True)
    dq1, dk1, dv1 = T.flash_bwd(tq, tk[:, :, :128], tv[:, :, :128], out, lse, tdo, causal=True, q_offset=0)
    dq2, dk2, dv2 = T.flash_bwd(tq, tk[:, :, 128:], tv[:, :, 128:], out, lse, tdo, causal=True, q_offset=-128)
    _close((dq1 + dq2).numpy(), dq.numpy(), GRAD_TOL, "dq")
    _close(torch.cat([dk1, dk2], dim=2).numpy(), dk.numpy(), GRAD_TOL, "dk")
    _close(torch.cat([dv1, dv2], dim=2).numpy(), dv.numpy(), GRAD_TOL, "dv")
    jg = J._flash_bwd(jnp.asarray(q), jnp.asarray(k[:, :, 128:]), jnp.asarray(v[:, :, 128:]), jnp.asarray(out.numpy()),
                      jnp.asarray(lse.numpy()), jnp.asarray(do), causal=True, q_offset=-128, **BLK)
    for a, b in zip((dq2, dk2, dv2), jg):
        _close(a.numpy(), b, GRAD_TOL, "second chunk vs Pallas")


def test_bf16_casts_follow_the_reference():
    """bf16 inputs: p and ds are rounded to bf16 before their products, out and
    the gradients come back in bf16, lse in f32. Against the Pallas kernel in
    interpret mode within 2e-2 (bf16 has 8 bits; the kernel rounds p against a
    running maximum, the plain version against the final one)."""
    q, k, v, do, seg, _ = _inputs("packed_segments")
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jseg = jnp.asarray(seg)
    jo, jl = J._flash_fwd(jq, jk, jv, jseg, jseg, **BLK)
    tq, tk, tv, tdo = (t.to(torch.bfloat16) for t in _tt(q, k, v, do))
    (tseg,) = _tt(seg)
    to, tl = T.flash_fwd(tq, tk, tv, tseg, tseg, causal=True)
    assert to.dtype == torch.bfloat16 and tl.dtype == torch.float32
    _close(to.float().numpy(), np.asarray(jo.astype(jnp.float32)), 2e-2, "bf16 out")
    _close(tl.numpy(), jl, 1e-4, "bf16 lse")
    jg = J._flash_bwd(jq, jk, jv, jo, jl, jdo, jseg, jseg, **BLK)
    tout = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(torch.bfloat16)
    tg = T.flash_bwd(tq, tk, tv, tout, torch.from_numpy(np.array(jl)), tdo, tseg, tseg, causal=True)
    for which, a, b in zip(("dq", "dk", "dv"), tg, jg):
        assert a.dtype == torch.bfloat16
        _close(a.float().numpy(), np.asarray(b.astype(jnp.float32)), 2e-2, f"bf16 {which}")


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="segment ids"):
        T.flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2), torch.zeros(1, 8, dtype=torch.int32), None)
    assert sorted(T.flash_attention.launches) == ["dkv", "dq", "dsum", "fwd"]
    # the argument block mirrors the C struct: 12 pointers, 24 strides, 10 integers, 2 doubles, 8 bytes each
    import ctypes

    assert ctypes.sizeof(T._Args) == 8 * (12 + 24 + 10 + 2)
    # _check is what a CUDA call goes through; on CPU tensors it must name the device
    with pytest.raises(ValueError, match="CUDA"):
        T._check("flash_fwd", q, q, q, None, None, None, None)
    for bad, err in ((torch.zeros(1, 2, 8, 24), "head dim"), (torch.zeros(1, 2, 8, 272), "head dim")):
        with pytest.raises(ValueError, match=err):
            T._check("flash_fwd", bad, bad, bad, None, None, None, None)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        T._check("flash_fwd", q.half(), q.half(), q.half(), None, None, None, None)
    with pytest.raises(ValueError, match="kv heads"):
        T._check("flash_fwd", torch.zeros(1, 3, 8, 16), q, q, None, None, None, None)


ROUTE_CASES = [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"), (torch.float32, 64, "tf32x3"),
    (torch.float32, 128, "tf32x3"), (torch.bfloat16, 32, "mma"), (torch.bfloat16, 48, "mma"),
    (torch.bfloat16, 80, "mma"), (torch.bfloat16, 112, "mma"), (torch.bfloat16, 256, "wgmma"),
    (torch.float32, 256, "mma"), (torch.bfloat16, 192, "mma"), (torch.bfloat16, 240, "mma"),
    (torch.float32, 32, "mma"), (torch.float32, 96, "mma"),
]
# the C entry points of each (direction, route) live in this csrc/ source
ROUTE_SOURCE = {("fwd", "wgmma"): "flash_fwd_wgmma", ("fwd", "mma"): "flash_attention",
                ("bwd", "wgmma"): "flash_bwd_wgmma", ("bwd", "mma"): "flash_attention",
                ("fwd", "tf32x3"): "flash_tf32", ("bwd", "tf32x3"): "flash_tf32"}


@pytest.mark.parametrize(
    "direction,dtype,D,route",
    [("fwd", *c) for c in ROUTE_CASES] + [("bwd", *c) for c in ROUTE_CASES],
    ids=[f"dtype{i}-{D}-{r}" for i, (_, D, r) in enumerate(ROUTE_CASES)]
    + [f"bwd-{str(t).split('.')[-1]}-{D}-{r}" for t, D, r in ROUTE_CASES])
def test_forward_route_rule(direction, dtype, D, route):
    """The route on the card is a pure function of the type and the head dim, one rule for the forward and
    the backward: the wgmma kernels for bf16 at D 64 / 128 / 256, the 3xTF32 tensor-core kernels for f32 at
    D 64 / 128, the mma.sync kernels for the rest (f32 at the other head dims, bf16 at 129-255). Each route's
    entry points (the backward's dq and dk/dv) live in its own source."""
    assert T.fwd_route(dtype, D) == route
    assert T.fwd_route(dtype, D) == T.fwd_route(dtype, D)
    entries = (T._FWD_ENTRY[route],) if direction == "fwd" else T._BWD_ENTRIES[route]
    assert len(entries) == (1 if direction == "fwd" else 2)
    assert {T._ENTRIES[e] for e in entries} == {ROUTE_SOURCE[direction, route]}


@pytest.mark.parametrize("D", [64, 128, 256])
def test_cpu_bf16_forward_takes_the_plain_version(D):
    """On CPU tensors the wrappers are the plain versions, bit for bit, forward and backward, on a route
    the card would take with the wgmma kernels; no launch and no route is counted."""
    rng = np.random.default_rng(D)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 200, h, D)).astype(np.float32)).to(torch.bfloat16)
                   .transpose(1, 2) for h in (4, 2, 2, 4))
    seg = torch.from_numpy(np.sort(rng.integers(0, 3, size=(2, 200)), axis=1).astype(np.int32))
    fwd_routes, bwd_routes = dict(T.flash_fwd.routes), dict(T.flash_bwd.routes)
    launches = dict(T.flash_attention.launches)
    kw = dict(causal=True, softcap=2.0, window=150)
    out, lse = T.flash_fwd(q, k, v, seg, seg, **kw)
    ro, rl = T.flash_fwd_ref(q, k, v, seg, seg, **kw)
    assert T.fwd_route(q.dtype, D) == "wgmma"
    assert torch.equal(out, ro) and torch.equal(lse, rl) and out.dtype == torch.bfloat16
    grads = T.flash_bwd(q, k, v, out, lse, do, seg, seg, **kw)
    refs = T.flash_bwd_ref(q, k, v, out, lse, do, seg, seg, **kw)
    for g, r in zip(grads, refs):
        assert torch.equal(g, r) and g.dtype == torch.bfloat16
    assert T.flash_fwd.routes == fwd_routes and T.flash_bwd.routes == bwd_routes
    assert T.flash_attention.launches == launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dsum_ref_matches_the_jax_formula(dtype):
    """The plain version of the dsum pre-pass against the JAX ``_flash_bwd``'s dsum
    (``jnp.einsum("bhsd,bhsd->bhs", do f32, out f32)``, ``dalm_tpu/kernels/flash_attention.py:390``) on the
    same seeded inputs, rounded to ``dtype`` on both sides and summed in f32: within 1e-5 of each row's
    sum of |do out| (D f32 products summed in another order), shape (B, H, Sq), f32."""
    rng = np.random.default_rng(7)
    do, out = (rng.standard_normal((2, 3, 37, 128)).astype(np.float32) for _ in range(2))
    jdo, jout = (jnp.asarray(x, getattr(jnp, dtype)) for x in (do, out))
    want = np.asarray(jnp.einsum("bhsd,bhsd->bhs", jdo.astype(jnp.float32), jout.astype(jnp.float32)))
    tdo, tout = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (do, out))
    got = T.dsum_ref(tdo.transpose(1, 2).contiguous().transpose(1, 2), tout)  # strided do, as the op hands it over
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, 37)
    mag = (tdo.float() * tout.float()).abs().sum(dim=-1).numpy()
    assert (np.abs(got.numpy() - want) <= 1e-5 * mag).all()


# --------------------------------------------------------------------------
# the tf32x3 route's arithmetic (csrc/flash_tf32.cu), emulated on the CPU
# --------------------------------------------------------------------------

def _tf32(x):
    """cvt.rna.tf32.f32: the f32 value rounded to 10 mantissa bits, to nearest (ties away from zero: half an ulp
    added to the magnitude bits, then the 13 low bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """a @ b as the kernels take it: each operand split into hi = tf32(x) and lo = tf32(x - hi), then
    lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b) in f32 (each tf32 x tf32 product is exact in f32)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _fwd_formula(q, k, v, seg_q, seg_k, causal, scale, q_offset, window, softcap, mm):
    """flash_fwd_ref's formulas with both products taken by ``mm``, in the inputs' type."""
    B, H, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hk, H // Hk, Sq, D)
    s = mm(qg, k[:, :, None].transpose(-1, -2)) * scale
    if softcap is not None:
        s = torch.tanh(s * (1.0 / softcap)) * softcap
    keep = T._keep_mask(Sq, Sk, seg_q, seg_k, causal, q_offset, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, T.NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    out = mm(p, v[:, :, None]) / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)), torch.full_like(l, T.NEG_INF))
    return out.reshape(B, H, Sq, D), lse.reshape(B, H, Sq)


def _bwd_formula(q, k, v, out, lse, do, seg_q, seg_k, causal, scale, q_offset, window, softcap, mm):
    """flash_bwd_ref's formulas with their five products (s, dp, dv, dq, dk) taken by ``mm``, p and ds operands
    like any other, in the inputs' type; dsum = rowsum(do out)."""
    B, H, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    G = H // Hk
    qg, dog = q.reshape(B, Hk, G, Sq, D), do.reshape(B, Hk, G, Sq, D)
    s = mm(qg, k[:, :, None].transpose(-1, -2)) * scale
    if softcap is not None:
        s = torch.tanh(s * (1.0 / softcap)) * softcap
    keep = T._keep_mask(Sq, Sk, seg_q, seg_k, causal, q_offset, window, q.device)
    p = torch.exp(s - lse.reshape(B, Hk, G, Sq, 1))
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))
    dp = mm(dog, v[:, :, None].transpose(-1, -2))
    ds = p * (dp - (do * out).sum(dim=-1).reshape(B, Hk, G, Sq, 1))
    if softcap is not None:
        t = s * (1.0 / softcap)
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    dv = mm(p.transpose(-1, -2), dog).sum(dim=2)
    dq = mm(ds, k[:, :, None]).reshape(B, H, Sq, D)
    dk = mm(ds.transpose(-1, -2), qg).sum(dim=2)
    return dq, dk, dv


def _row_share(got, want, tol, floor):
    """The largest |got - want| / (tol * max(max |want| of its row, floor)), rows the last axis (lse: each value)."""
    if want.dim() == 3:
        got, want, floor = got[..., None], want[..., None], 1.0
    return float(((got - want).abs() / (tol * want.abs().amax(dim=-1, keepdim=True).clamp(min=floor))).max())


def test_tf32_rounding_and_split():
    """The emulated cvt.rna.tf32: 10 mantissa bits, ties away from zero, exact on values it can hold; hi + lo
    within 2^-22 of x over a million normal f32 values of every sign and scale."""
    one = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 0.75])
    assert _tf32(one).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10), 1.0, 0.75]
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal(1 << 20) * 10.0 ** rng.integers(-6, 6, 1 << 20)).astype(np.float32))
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all()) and bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()) <= 2.0 ** -22


# B, H, Hk, Sq, Sk, seg kind, options: causal throughout
TF32_CASES = {
    "gqa_window_segments": (1, 4, 2, 300, 300, "packed", dict(window=100)),
    "softcap_ragged_q_offset": (2, 4, 1, 97, 229, None, dict(softcap=20.0, q_offset=132)),
}


@pytest.mark.parametrize("name", sorted(TF32_CASES))
def test_tf32x3_arithmetic_meets_the_float32_tolerance(name):
    """The tf32x3 route's arithmetic (every product of the forward and the backward split 3xTF32, p and ds too),
    emulated in f32 on the CPU at D 128 on a causal, windowed, segmented GQA shape and a softcapped ragged one:
    within K4's float32 tolerance of the exact formulas (float64), row by row as chip_smoke.py holds the kernels
    (out and lse 2e-5, gradients 2e-4 of max(row max, 0.02); an lse value is a row of its own, floor 1); so is the
    plain f32 version. A single TF32 pass misses the forward's bound."""
    B, H, Hk, Sq, Sk, seg, opts = TF32_CASES[name]
    D = 128
    rng = np.random.default_rng(sorted(TF32_CASES).index(name) + 40)
    mk = lambda S, h: torch.from_numpy(rng.standard_normal((B, h, S, D)).astype(np.float32))  # noqa: E731
    q, k, v, do = mk(Sq, H), mk(Sk, Hk), mk(Sk, Hk), mk(Sq, H)
    seg_q = seg_k = None
    if seg == "packed":
        seg_k = torch.from_numpy(np.sort(rng.integers(0, 3, size=(B, Sk)), axis=1).astype(np.int32))
        seg_q = seg_k[:, :Sq].contiguous()
    kw = dict(causal=True, scale=1.0 / D ** 0.5, q_offset=opts.get("q_offset", 0), window=opts.get("window"),
              softcap=opts.get("softcap"))
    assert T.fwd_route(torch.float32, D) == "tf32x3"
    f64 = [t.double() for t in (q, k, v)]
    xo, xl = _fwd_formula(*f64, seg_q, seg_k, **kw, mm=torch.matmul)
    eo, el = _fwd_formula(q, k, v, seg_q, seg_k, **kw, mm=_mm3)
    po, pl = T.flash_fwd_ref(q, k, v, seg_q, seg_k, **kw)
    for got in ((eo, el), (po, pl)):
        assert _row_share(got[0].double(), xo, 2e-5, 0.02) <= 1.0 and _row_share(got[1].double(), xl, 2e-5, 1.0) <= 1.0
    exact = _bwd_formula(*f64, po.double(), pl.double(), do.double(), seg_q, seg_k, **kw, mm=torch.matmul)
    emus = _bwd_formula(q, k, v, po, pl, do, seg_q, seg_k, **kw, mm=_mm3)
    plain = T.flash_bwd_ref(q, k, v, po, pl, do, seg_q, seg_k, **kw)
    for got, want, ref in zip(emus, exact, plain):
        assert got.shape == want.shape == ref.shape and got.dtype == torch.float32
        assert _row_share(got.double(), want, 2e-4, 0.02) <= 1.0 and _row_share(ref.double(), want, 2e-4, 0.02) <= 1.0
    one = _fwd_formula(q, k, v, seg_q, seg_k, **kw, mm=lambda a, b: _tf32(a) @ _tf32(b))[0]
    assert _row_share(one.double(), xo, 2e-5, 0.02) > 1.0
