"""The port's K1/K2 module (``dalm_tpu_torch/kernels/int8_matmul.py``) against
the JAX package's (``dalm_tpu/kernels/int8_matmul.py``) on the CPU: the plain
PyTorch versions against the Pallas kernels in interpret mode and against
the XLA formulations, on the same numpy inputs.

Tolerances: the row quantiser is integer-exact and its scales are one f32
division, so q and s must be EQUAL (one stated exception: the interpreted
Pallas kernel on bf16 input). The fused matmul folds f32 partial sums
in the same k-block order on both sides: equal in f32 with one k-block, one
f32 ulp per k-block with more (XLA may fuse the multiply-add), and the JAX
test's own 5e-3 of the largest value for bf16 inputs. ``int8_matmul`` forward/backward: 1e-5 relative to the
largest value (f32 sums in another order inside the rescale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.kernels import int8_matmul as J
from dalm_tpu.models.layers import FlexLinear as JaxFlexLinear
from dalm_tpu_torch.kernels import int8_matmul as T
from dalm_tpu_torch.models.layers import FlexLinear

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _weights(rng, k, n):
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    absmax = np.abs(w).max(axis=0, keepdims=True)
    ws = np.where(absmax > 0, absmax / np.float32(127.0), 1.0).astype(np.float32)
    q = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
    return w, q, ws


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 256), (8, 128), (24, 384)])
def test_rowquant_ref_equals_pallas_and_xla(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x[0] = 0.0  # an all-zero row takes scale 1
    x[1] = np.arange(shape[1]) % 127 + 0.5  # absmax 126.5: exercises rounding near ties
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tq, ts = T.rowquant(_to_torch(jx))
    jq, js = J._rowquant_xla(jx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    pq, ps = J._rowquant_pallas(jx, interpret=True)
    if dtype == "float32":
        np.testing.assert_array_equal(tq.numpy(), np.asarray(pq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(ps))
    else:
        # On bf16 input the interpreted kernel's absmax / 127 comes out one
        # f32 ulp off the true quotient on some rows (the XLA form and the
        # port give the true one), which can move a q that sat on a tie by one.
        np.testing.assert_allclose(ts.numpy(), np.asarray(ps), rtol=1.2e-7, atol=0)
        assert np.abs(tq.numpy().astype(np.int32) - np.asarray(pq, np.int32)).max() <= 1
    assert float(ts[0]) == 1.0 and not tq[0].any()


def test_rowquant_leading_axes_ties_and_colscale():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 100)).astype(np.float32)  # unaligned: the XLA form on the JAX side
    tq, ts = T.rowquant(torch.from_numpy(x))
    jq, js = J.rowquant(jnp.asarray(x))
    assert tq.shape == (3, 5, 100) and ts.shape == (3, 5, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # exact .5 ties round half to even, as jnp.round does
    ties = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]], np.float32)
    q, s = T.rowquant(torch.from_numpy(ties))
    assert float(s) == 1.0
    np.testing.assert_array_equal(q.numpy(), [[127, 0, 2, 2, 0, -2, -2, 126]])
    # the column scale multiplies in f32 before the quantiser (the backward's dy * scale)
    cs = (rng.random((1, 100)) * 0.01 + 1e-4).astype(np.float32)
    q2, s2 = T.rowquant(torch.from_numpy(x), torch.from_numpy(cs).reshape(-1))
    jq2, js2 = J._rowquant_xla(jnp.asarray(x) * jnp.asarray(cs))
    np.testing.assert_array_equal(q2.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(js2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_fused_ref_matches_pallas_interpret(dtype):
    """The shape of tests/models/test_int8_matmul.py's per-tile oracle test."""
    rng = np.random.default_rng(0)
    M, K, N = 16, 512, 384
    x = jnp.asarray(rng.standard_normal((M, K)) * 0.5, getattr(jnp, dtype))
    _, q, ws = _weights(rng, K, N)
    jout = np.asarray(J._w8a8_fused_pallas(x, jnp.asarray(q), jnp.asarray(ws), True), np.float32)
    tout = _np(T.w8a8_fused(_to_torch(x), torch.from_numpy(q), torch.from_numpy(ws)))
    if dtype == "float32":
        np.testing.assert_array_equal(tout, jout)
    else:
        # bf16 input: the interpreted kernel's scales sit one f32 ulp off on some
        # rows (see the row quantiser's test), which flips a q on a tie and moves
        # an output by one quantisation step of one product. Held to the JAX
        # package's own bound for this kernel against its oracle, 5e-3 of the
        # largest value; all but a few outputs are within a bf16 ulp.
        assert np.abs(tout - jout).max() <= 5e-3 * np.abs(jout).max()
        close = np.abs(tout - jout) <= 2.0 ** -7 * np.abs(jout) + 1e-6
        assert close.mean() > 0.98


def test_w8a8_fused_ref_two_k_blocks_and_true_matmul():
    rng = np.random.default_rng(1)
    M, K, N = 8, 1024, 128  # bk = 512: two k-blocks, each with its own row scales
    x = (rng.standard_normal((M, K)) * 0.5).astype(np.float32)
    x[:, 512:] *= 30.0  # a k-block of another magnitude
    w, q, ws = _weights(rng, K, N)
    assert T.fit_div(K, 512) == 512
    jout = np.asarray(J._w8a8_fused_pallas(jnp.asarray(x), jnp.asarray(q), jnp.asarray(ws), True))
    tout = T.w8a8_fused(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(ws)).numpy()
    # XLA may contract acc + p * s into one fused multiply-add, the port
    # rounds twice: at most an ulp of the f32 accumulator per k-block.
    np.testing.assert_allclose(tout, jout, rtol=1e-6, atol=1e-6)
    true = x @ (q.astype(np.float32) * ws)
    assert np.abs(tout - true).max() / np.abs(true).max() < 0.02  # activation-quant error


@pytest.mark.parametrize("M", [1, 8, 96, 512, 4608, 1000])
@pytest.mark.parametrize("K", [64, 128, 4096, 4160, 11008])
@pytest.mark.parametrize("N", [64, 384, 4096, 11008, 32000])
def test_feasibility_rule_equals_jax(M, K, N):
    assert T.w8a8_fused_feasible(M, K, N) == J._w8a8_fused_feasible(M, K, N)
    assert T.fit_div(K, 512) == J._fit_div(K, 512)
    assert T.fit_div(M, 512, 8) == J._fit_div(M, 512, 8)


@pytest.mark.parametrize("lead", [(8,), (2, 4)])
@pytest.mark.parametrize("bwd_int8", [False, True])
def test_int8_matmul_forward_and_grad_match_jax(bwd_int8, lead):
    """Off the TPU the JAX package runs K2's XLA form + an int8 dot; N = 64 is
    a shape the feasibility rule rejects, so the port takes that form too."""
    rng = np.random.default_rng(3)
    K, N = 128, 64
    assert not T.w8a8_fused_feasible(int(np.prod(lead)), K, N)
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    g = rng.standard_normal(lead + (N,)).astype(np.float32)
    _, q, ws = _weights(rng, K, N)

    def f(xj):
        return jnp.sum(J.int8_matmul(xj, jnp.asarray(q), jnp.asarray(ws), bwd_int8) * g)

    jy = J.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(ws), bwd_int8)
    jdx = jax.grad(f)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tq, tws = torch.from_numpy(q), torch.from_numpy(ws).requires_grad_()
    ty = T.int8_matmul(tx, tq, tws, bwd_int8)
    (ty * torch.from_numpy(g)).sum().backward()
    assert ty.shape == lead + (N,) and ty.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=0, atol=1e-5 * np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=0, atol=1e-5 * np.abs(np.asarray(jdx)).max())
    assert tws.grad is None  # frozen storage takes no gradient
    # straight-through: close to the exact dequantised product's gradient
    exact = g @ (q.astype(np.float32) * ws).T
    assert np.abs(tx.grad.numpy() - exact).max() / np.abs(exact).max() < (0.06 if bwd_int8 else 0.03)


def test_int8_matmul_takes_the_fused_form_where_feasible():
    rng = np.random.default_rng(4)
    M, K, N = 8, 256, 128
    assert T.w8a8_fused_feasible(M, K, N)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    _, q, ws = _weights(rng, K, N)
    q, ws = torch.from_numpy(q), torch.from_numpy(ws)
    assert torch.equal(T.int8_matmul(x, q, ws), T.w8a8_fused_ref(x, q, ws))
    assert torch.equal(T.int8_matmul_ref(x, q, ws), T.w8a8_fused_ref(x, q, ws))
    assert not T.w8a8_fused_feasible(M, 64, N)
    xs = x[:, :64].contiguous()
    xq, s = T.rowquant_ref(xs)
    want = (T.int8_gemm_kn_ref(xq, q[:64]).float() * s * ws).to(torch.float32)
    assert torch.equal(T.int8_matmul(xs, q[:64].contiguous(), ws), want)


def test_int8_gemm_refs_and_cpu_calls_count_no_launch():
    rng = np.random.default_rng(5)
    a = rng.integers(-127, 128, (5, 48)).astype(np.int8)
    b = rng.integers(-127, 128, (48, 12)).astype(np.int8)
    before = (T.rowquant.launches, T.w8a8_fused.launches, T.int8_gemm_kn.launches, T.int8_gemm_nt.launches)
    kn = T.int8_gemm_kn(torch.from_numpy(a), torch.from_numpy(b))
    nt = T.int8_gemm_nt(torch.from_numpy(a), torch.from_numpy(np.ascontiguousarray(b.T)))
    T.rowquant(torch.zeros(2, 8))
    want = a.astype(np.int32) @ b.astype(np.int32)
    assert kn.dtype == torch.int32
    np.testing.assert_array_equal(kn.numpy(), want)
    np.testing.assert_array_equal(nt.numpy(), want)
    np.testing.assert_array_equal(np.asarray(J._i8_dot_last(jnp.asarray(a), jnp.asarray(b), 0)), want)
    after = (T.rowquant.launches, T.w8a8_fused.launches, T.int8_gemm_kn.launches, T.int8_gemm_nt.launches)
    assert after == before  # the plain versions are not launches


@pytest.mark.parametrize("storage", ["int8", "bf16", "kernel"])
@pytest.mark.parametrize("int8_compute", ["none", "fwd", "all"])
def test_flexlinear_quant_and_lora_match_jax(int8_compute, storage):
    """y and dx of one layer with packed storage + LoRA + bias against the
    flax layer on the same collections (a shape that takes K2 + GEMM on both
    sides). 1e-5 of the largest value."""
    rng = np.random.default_rng(6)
    K, N, r = 128, 64, 4
    x = rng.standard_normal((2, 5, K)).astype(np.float32)
    g = rng.standard_normal((2, 5, N)).astype(np.float32)
    w, q, ws = _weights(rng, K, N)
    bias = rng.standard_normal(N).astype(np.float32) * 0.1
    lora = {"a": rng.standard_normal((K, r)).astype(np.float32) * 0.1,
            "b": rng.standard_normal((r, N)).astype(np.float32) * 0.1}
    layer = FlexLinear(K, N, use_bias=True, int8_compute=int8_compute)
    variables = {"params": {"bias": bias}, "lora": lora}
    if storage == "kernel":
        variables["params"]["kernel"] = w
        state = {"kernel": w}
    else:
        layer.to_packed(storage)
        variables["quant"] = {"q": q, "scale": ws} if storage == "int8" else {"w": jnp.asarray(w, jnp.bfloat16)}
        state = {"q": q, "scale": ws} if storage == "int8" else {"w": np.asarray(variables["quant"]["w"], np.float32)}
    layer.add_lora(r)
    layer.load_state_dict({**{k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                           "bias": torch.from_numpy(bias), "a": torch.from_numpy(lora["a"]),
                           "b": torch.from_numpy(lora["b"])})
    jlayer = JaxFlexLinear(N, use_bias=True, int8_compute=int8_compute)

    def f(xj):
        return jnp.sum(jlayer.apply(variables, xj) * g)

    jy = jlayer.apply(variables, jnp.asarray(x))
    jdx = jax.grad(f)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    ty = layer(tx)
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=0, atol=1e-5 * np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=0, atol=1e-5 * np.abs(np.asarray(jdx)).max())
    assert layer.a.grad is not None and layer.b.grad is not None


def test_flexlinear_rejects_what_is_not_ported():
    with pytest.raises(ValueError, match="int8_compute"):
        FlexLinear(8, 8, int8_compute="bwd")
    with pytest.raises(ValueError, match="storage"):
        FlexLinear(8, 8).to_packed("int3")


@pytest.mark.parametrize("bwd_int8", [False, True])
def test_int8_matmul_pads_ragged_widths_like_jax(bwd_int8):
    """K = 100 and N = 102 are no multiples of the GEMMs' 16 and 4: the unfused branch pads with zeros and slices,
    which leaves every int32 sum and row scale as it is; forward and dx against the JAX package (its XLA form takes
    any width) within 1e-5 of the largest value, as above."""
    rng = np.random.default_rng(6)
    K, N = 100, 102
    x = rng.standard_normal((2, 3, K)).astype(np.float32)
    g = rng.standard_normal((2, 3, N)).astype(np.float32)
    _, q, ws = _weights(rng, K, N)
    shapes = []

    def kn(a, b):
        shapes.append((a.shape, b.shape))
        return T.int8_gemm_kn_ref(a, b)

    def nt(a, b):
        shapes.append((a.shape, b.shape))
        return T.int8_gemm_nt_ref(a, b)

    fns = (T.rowquant_ref, T.w8a8_fused_ref, kn, nt)
    tx = torch.from_numpy(x).requires_grad_()
    ty = T._Int8Matmul.apply(tx, torch.from_numpy(q), torch.from_numpy(ws), bwd_int8, fns)
    (ty * torch.from_numpy(g)).sum().backward()
    assert shapes[0] == ((6, 112), (112, 104))  # K to 112, N to 104
    if bwd_int8:
        assert shapes[1] == ((6, 112), (100, 112))  # dx contracts N, padded to 112
    assert ty.shape == (2, 3, N) and tx.grad.shape == (2, 3, K)

    def f(xj):
        return jnp.sum(J.int8_matmul(xj, jnp.asarray(q), jnp.asarray(ws), bwd_int8) * g)

    jy = J.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(ws), bwd_int8)
    jdx = jax.grad(f)(jnp.asarray(x))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=0, atol=1e-5 * np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=0, atol=1e-5 * np.abs(np.asarray(jdx)).max())
    assert torch.equal(ty, T.int8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(ws), bwd_int8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mkn", [(5, 48, 12), (33, 256, 136), (8, 1024, 30)])
def test_int8_gemm_scaled_ref_equals_jax_int8_form(mkn, dtype):
    """The scaled GEMM's plain version against the JAX package's int8 product (``_i8_dot_last``) and the same two
    f32 products, row scale then column scale: equal (tolerance 0; the int32 sums are exact, then two roundings in
    the same order). The CPU wrapper is the plain version and counts no launch."""
    M, K, N = mkn
    rng = np.random.default_rng(sum(mkn))
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wn = rng.integers(-8, 8, (N, K)).astype(np.int8)
    xs = (rng.random((M, 1)) * 0.01 + 1e-4).astype(np.float32)
    ws = (rng.random((1, N)) * 0.01 + 1e-4).astype(np.float32)
    jacc = J._i8_dot_last(jnp.asarray(xq), jnp.asarray(np.ascontiguousarray(wn.T)), 0)
    want = np.asarray(((jacc.astype(jnp.float32) * jnp.asarray(xs)) * jnp.asarray(ws)).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32), np.float32)
    args = (torch.from_numpy(xq), torch.from_numpy(wn), torch.from_numpy(xs), torch.from_numpy(ws))
    got = T.int8_gemm_scaled_ref(*args, dtype=dtype)
    assert got.dtype == dtype and tuple(got.shape) == (M, N)
    np.testing.assert_array_equal(_np(got), want)
    before = T.int8_gemm_scaled.launches
    assert torch.equal(T.int8_gemm_scaled(*args), T.int8_gemm_scaled_ref(*args))
    assert T.int8_gemm_scaled.launches == before


@pytest.mark.parametrize("case", ["random", "extreme_neg", "extreme_pos"])
def test_int8_gemm_scaled_ref_equals_k5_pcol_plain(case):
    """K2 -> the int8 nibble pre-pass -> the scaled GEMM, in their plain versions, equal K5's plain pcol
    (``int4_matmul._ref_pcol``) bit for bit, at K = 11008 (the down-projection): random operands, and the extremes,
    K2's values all +-127 against nibbles of -8 (or 7) everywhere, signs that do not cancel, so the int32 sums reach
    11008 * 127 * 8 = 11,184,128."""
    from dalm_tpu_torch.kernels import int4_matmul as k5
    from dalm_tpu_torch.models import quant

    M, K, N = 6, 11008, 24
    rng = np.random.default_rng(31)
    if case == "random":
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16)
        d = quant.quantize_tensor_int4pc(torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32) * 0.02))
        q4, s4 = d["q4"], d["scale4"]
    else:
        x = torch.ones((M, K), dtype=torch.bfloat16)
        nib = 0 if case == "extreme_neg" else 15
        q4 = torch.full((K // 2, N), nib | (nib << 4), dtype=torch.uint8)
        s4 = torch.from_numpy((2.0 ** rng.integers(-8, -4, size=(1, N))).astype(np.float32))
    xq, xs = T.rowquant_ref(x)
    got = T.int8_gemm_scaled_ref(xq, k5.prefill_nibbles_ref(q4, torch.int8), xs, s4)
    assert got.dtype == torch.bfloat16 and torch.equal(got, k5._ref_pcol(x, q4, s4))
    if case != "random":
        acc = T._int_dot_ref(xq, k5.prefill_nibbles_ref(q4, torch.int8).T)
        assert bool((xq == 127).all()) and int(acc.abs().max()) == K * 127 * (8 if case == "extreme_neg" else 7)


# K1's route on the card is three launches: the quantise pre-pass, the weight pre-pass and the GEMM with the
# k-block fold. Their plain versions are checked here: composed, they must be K1.

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [768, 1280])
def test_quant_prepass_ref_equals_rowquant_on_the_block_view(K, dtype):
    """Each (row, k-block) quantised on its own is K2 on the (M K / bk, bk) view of x2: equal bytes and scales
    (tolerance 0), with an all-zero block and a block of .5 ties."""
    rng = np.random.default_rng(7)
    M, bk = 6, T.fit_div(K, 512)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0, :bk] = 0
    x[1, bk:2 * bk] = rng.integers(-126, 127, bk) + 0.5
    x[1, bk] = 127.0  # absmax 127 -> s = 1 -> every other value ends in .5
    x2 = torch.from_numpy(x).to(dtype)
    xq, xs = T.quant_prepass(x2, bk)
    assert xq.shape == (M, K) and xq.dtype == torch.int8 and xs.shape == (M, K // bk) and xs.dtype == torch.float32
    rq, rs = T.rowquant_ref(x2.reshape(M * K // bk, bk))
    assert torch.equal(xq.reshape(-1, bk), rq) and torch.equal(xs.reshape(-1, 1), rs)
    assert float(xs[0, 0]) == 1.0 and not bool(xq[0, :bk].any())
    assert float(xs[1, 1]) == 1.0


def test_weight_prepass_ref_is_the_k_major_copy():
    q = torch.from_numpy(np.random.default_rng(8).integers(-127, 128, (48, 20)).astype(np.int8))
    qt = T.weight_prepass(q)
    assert qt.shape == (20, 48) and qt.is_contiguous() and torch.equal(qt, q.T.contiguous())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [768, 1280])
def test_k1_route_composition_equals_w8a8_fused_ref_and_pallas(K, dtype):
    """Quantise pre-pass -> weight pre-pass -> int dot per k-block -> fold -> weight scale, composed from the plain
    versions: equal to ``w8a8_fused_ref`` (tolerance 0) at bk = 384 (K = 768, two k-blocks) and bk = 256 (K = 1280,
    five), each k-block of another magnitude; against the Pallas kernel in interpret mode the bounds of the tests
    above: one f32 ulp of the largest value per k-block in f32 (XLA may fuse the multiply-add), the JAX package's
    5e-3 of the largest value in bf16 (its interpreted scales sit an f32 ulp off on some rows)."""
    rng = np.random.default_rng(9)
    M, N = 16, 384
    bk = T.fit_div(K, 512)
    assert (bk, K // bk) == {768: (384, 2), 1280: (256, 5)}[K] and bk == J._fit_div(K, 512)
    xn = rng.standard_normal((M, K)) * 0.5
    for kb in range(K // bk):
        xn[:, kb * bk:(kb + 1) * bk] *= 4.0 ** kb
    x = jnp.asarray(xn, getattr(jnp, dtype))
    _, q, ws = _weights(rng, K, N)
    tx, tq, tws = _to_torch(x), torch.from_numpy(q), torch.from_numpy(ws)
    xq, xs = T.quant_prepass_ref(tx, bk)
    route = T.fold_gemm_ref(xq, xs, T.weight_prepass_ref(tq), tws, tx.dtype)
    assert route.dtype == tx.dtype and torch.equal(route, T.w8a8_fused_ref(tx, tq, tws))
    jout = np.asarray(J._w8a8_fused_pallas(x, jnp.asarray(q), jnp.asarray(ws), True), np.float32)
    tout = _np(route)
    if dtype == "float32":
        np.testing.assert_allclose(tout, jout, rtol=0, atol=(K // bk) * 2.0 ** -23 * np.abs(jout).max())
    else:
        assert np.abs(tout - jout).max() <= 5e-3 * np.abs(jout).max()


def test_k1_route_cpu_calls_count_no_launch():
    """On CPU tensors each part of the route is its plain version, and nothing counts a launch."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((4, 768)).astype(np.float32))
    _, q, ws = _weights(rng, 768, 8)
    q, ws = torch.from_numpy(q), torch.from_numpy(ws)
    counts = (T.quant_prepass, T.weight_prepass, T.fold_gemm, T.w8a8_fused)
    before = [f.launches for f in counts]
    xq, xs = T.quant_prepass(x, T.fit_div(768, 512))
    y = T.fold_gemm(xq, xs, T.weight_prepass(q), ws, torch.float32)
    assert torch.equal(y, T.w8a8_fused(x, q, ws)) and xs.shape == (4, 2)
    assert [f.launches for f in counts] == before
