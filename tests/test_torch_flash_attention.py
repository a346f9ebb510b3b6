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
    assert sorted(T.flash_attention.launches) == ["dkv", "dq", "fwd"]
    # the argument block mirrors the C struct: 12 pointers, 24 strides, 10 integers, 2 doubles, 8 bytes each
    import ctypes

    assert ctypes.sizeof(T._Args) == 8 * (12 + 24 + 10 + 2)
    # _check is what a CUDA call goes through; on CPU tensors it must name the device
    with pytest.raises(ValueError, match="CUDA"):
        T._check("flash_fwd", q, q, q, None, None, None, None)
    for bad, err in ((torch.zeros(1, 2, 8, 24), "head dim"), (torch.zeros(1, 2, 8, 256), "head dim")):
        with pytest.raises(ValueError, match=err):
            T._check("flash_fwd", bad, bad, bad, None, None, None, None)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        T._check("flash_fwd", q.half(), q.half(), q.half(), None, None, None, None)
    with pytest.raises(ValueError, match="kv heads"):
        T._check("flash_fwd", torch.zeros(1, 3, 8, 16), q, q, None, None, None, None)


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"), (torch.float32, 64, "mma"),
    (torch.float32, 128, "mma"), (torch.bfloat16, 32, "mma"), (torch.bfloat16, 48, "mma"),
    (torch.bfloat16, 80, "mma"), (torch.bfloat16, 112, "mma"),
])
def test_forward_route_rule(dtype, D, route):
    """The forward's route on the card is a pure function of the type and the head dim: the wgmma kernel
    for bf16 at D 64 / 128, the mma.sync kernel for the rest."""
    assert T.fwd_route(dtype, D) == route
    assert T.fwd_route(dtype, D) == T.fwd_route(dtype, D)


@pytest.mark.parametrize("D", [64, 128])
def test_cpu_bf16_forward_takes_the_plain_version(D):
    """On CPU tensors the wrapper is the plain version, bit for bit, on a route the card would take with
    the wgmma kernel; no launch is counted."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 200, h, D)).astype(np.float32)).to(torch.bfloat16)
               .transpose(1, 2) for h in (4, 2, 2))
    seg = torch.from_numpy(np.sort(rng.integers(0, 3, size=(2, 200)), axis=1).astype(np.int32))
    routes, launches = dict(T.flash_fwd.routes), dict(T.flash_attention.launches)
    kw = dict(causal=True, softcap=2.0, window=150)
    out, lse = T.flash_fwd(q, k, v, seg, seg, **kw)
    ro, rl = T.flash_fwd_ref(q, k, v, seg, seg, **kw)
    assert T.fwd_route(q.dtype, D) == "wgmma"
    assert torch.equal(out, ro) and torch.equal(lse, rl) and out.dtype == torch.bfloat16
    assert T.flash_fwd.routes == routes and T.flash_attention.launches == launches
