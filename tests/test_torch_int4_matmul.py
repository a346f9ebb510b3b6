"""The port's K5 (``kernels/int4_matmul.py``) and 4-bit quantisers against the
JAX package's, on the CPU, from the same numpy weights and activations.

Tolerances: the quantisers' bytes and scales are EQUAL. The plain K5 versions
against the reference's Pallas kernels in interpret mode, per row of the
output: float32 activations within 1e-5 of the row's largest value (the same
f32 products summed in another order; "decomp" recovers groupmm's products
algebraically from more f32 terms), bfloat16 activations within one bf16 ulp
of it (2^-7: the output is rounded to bf16 and may fall the other way).
Gradients (f32): 1e-5 of the largest value. ``FlexLinear`` at widths the
reference's rule rejects (both sides dequantise): 1e-6; at widths it admits
(the port's plain kernel, bf16 operands, against the reference's f32 XLA
dequant off the TPU): 1e-2 of the row's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.kernels import int4_matmul as jk5
from dalm_tpu.models import quant as jquant
from dalm_tpu.models.layers import FlexLinear as JaxFlexLinear
from dalm_tpu_torch.kernels import int4_matmul as k5
from dalm_tpu_torch.models import quant
from dalm_tpu_torch.models.layers import FlexLinear

QUANTISERS = {"int4": "quantize_tensor_int4", "int4pc": "quantize_tensor_int4pc", "nf4": "quantize_tensor_nf4"}


def _weights(seed, K, N, scale=0.02):
    return (np.random.default_rng(seed).standard_normal((K, N)) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_rows_close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = rel * np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= bound).all(), float((np.abs(got - want) - bound).max())


@pytest.mark.parametrize("fmt", sorted(QUANTISERS))
@pytest.mark.parametrize("kn", [(96, 40), (11008, 16), (256, 64), (4096, 24)])
def test_quantisers_equal_jax(fmt, kn):
    """Bytes, scales and markers equal; K = 96 and the 7B down-projection's K/2 = 5504 take the group fallbacks."""
    w = _weights(0, *kn, scale=0.05)
    w[:, 3] = 0.0  # a zero column takes scale 1
    t, j = getattr(quant, QUANTISERS[fmt])(torch.from_numpy(w)), getattr(jquant, QUANTISERS[fmt])(jnp.asarray(w))
    assert sorted(t) == sorted(j)
    for k in t:
        a, b = t[k].numpy(), np.asarray(j[k])
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all(), k
    np.testing.assert_array_equal(quant.dequantize_tensor_int4(t).numpy(), np.asarray(jquant.dequantize_tensor_int4(j)))
    if fmt != "int4pc":
        assert kn[0] // t["scale4"].shape[0] == jquant._int4_group(kn[0] // 2) == quant._int4_group(kn[0] // 2)
    if kn[0] == 11008 and fmt != "int4pc":
        assert t["scale4"].shape[0] == 11008 // 16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(k5.VARIANTS) + ["pcol"])
def test_plain_k5_matches_pallas_interpret(variant, dtype):
    """Every variant name's plain version against the reference's Pallas kernel, interpreted."""
    M, K, N = 16, 1024, 256
    w = _weights(1, K, N)
    x = (np.random.default_rng(2).standard_normal((M, K)) * 0.5).astype(np.float32)
    x[0] = 0.0
    fmt = "int4pc" if variant == "pcol" else "nf4" if variant == "nf4" else "int4"
    d = getattr(jquant, QUANTISERS[fmt])(jnp.asarray(w))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    if variant == "pcol":
        want = jk5._int4pc_matmul_fwd_pallas(jx, d["q4"], d["scale4"], block_k=256, block_n=128, interpret=True)
    else:
        want = jk5._int4_matmul_fwd_pallas(jx, d["q4"], d["scale4"], block_k=256, block_n=128, interpret=True,
                                            variant=variant)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = k5.int4_matmul_fwd_ref(tx, _t(d["q4"]), _t(d["scale4"]), k5.INSTANCE[variant])
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N) and not got[0].any()
    _assert_rows_close(got.float().numpy(), np.asarray(want, np.float32), 1e-5 if dtype == "float32" else 2.0 ** -7)


def test_decomp_equals_groupmm_port():
    """The reference's decomp kernel is an algebraic rewrite of groupmm: the port runs groupmm for it."""
    w = _weights(3, 512, 128)
    x = (np.random.default_rng(4).standard_normal((8, 512)) * 0.5).astype(np.float32)
    d = jquant.quantize_tensor_int4(jnp.asarray(w))
    want = jk5._int4_matmul_fwd_pallas(jnp.asarray(x), d["q4"], d["scale4"], block_k=256, block_n=128,
                                        interpret=True, variant="decomp")
    got = k5.int4_matmul_fwd_ref(torch.from_numpy(x), _t(d["q4"]), _t(d["scale4"]), "groupmm")
    assert k5.INSTANCE["decomp"] == "groupmm" and k5.INSTANCE["floorsplit"] == "base"
    _assert_rows_close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("fmt", sorted(QUANTISERS))
def test_int4_matmul_grad_matches_custom_vjp(fmt):
    """Forward, dx and the zero storage gradient against the reference's custom_vjp (kernel interpreted)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 256)).astype(np.float32)
    g = rng.standard_normal((2, 4, 128)).astype(np.float32)
    d = getattr(jquant, QUANTISERS[fmt])(jnp.asarray(_weights(6, 256, 128, 0.05)))
    nf4, pcol = fmt == "nf4", fmt == "int4pc"

    def f(xx, s):
        return jnp.sum(jk5.int4_matmul(xx, d["q4"], s, True, nf4, pcol) * g)

    jy = jk5.int4_matmul(jnp.asarray(x), d["q4"], d["scale4"], True, nf4, pcol)
    jdx, jds = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), d["scale4"])
    tx = torch.from_numpy(x).requires_grad_()
    ts = _t(d["scale4"]).requires_grad_()
    ty = k5.int4_matmul(tx, _t(d["q4"]), ts, nf4, pcol)
    (ty * torch.from_numpy(g)).sum().backward()
    _assert_rows_close(ty.detach().numpy(), jy, 1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=0, atol=1e-5 * np.abs(np.asarray(jdx)).max())
    assert not np.asarray(jds).any() and ts.grad is not None and not ts.grad.any()


def test_feasibility_rule_and_routing(monkeypatch):
    """The reference's rule (tests/kernels/test_int4_matmul.py:220-243), and which path each shape takes."""
    assert not k5._kernel_feasible(32, 64) and not k5._kernel_feasible(64, 64)
    assert not k5._pcol_feasible(32, 256) and not k5._pcol_feasible(96, 256)
    assert k5._kernel_feasible(2048, 64) and k5._kernel_feasible(2048, 128)
    assert not k5._kernel_feasible(5504, 64) and k5._kernel_feasible(5504, 16)
    assert k5._pcol_feasible(2048, 4096) and k5._pcol_feasible(5504, 4096)
    for half, group in ((32, 64), (64, 64), (2048, 64), (5504, 16), (128, 16), (256, 32)):
        assert k5._kernel_feasible(half, group) == jk5._kernel_feasible(half, group)
    for half, n in ((32, 256), (96, 256), (2048, 4096), (5504, 4096), (128, 1000)):
        assert k5._pcol_feasible(half, n) == jk5._pcol_feasible(half, n)

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
    d = quant.quantize_tensor_int4(torch.from_numpy(_weights(8, 256, 64)))
    # admitted (K/2 = 128, group 16): the plain kernel of the default variant
    assert torch.equal(k5.int4_matmul(x, d["q4"], d["scale4"]), k5.int4_matmul_fwd_ref(x, d["q4"], d["scale4"], "base"))
    monkeypatch.setattr(k5, "DEFAULT_VARIANT", "i8mxu")
    assert torch.equal(k5.int4_matmul(x, d["q4"], d["scale4"]), k5.int4_matmul_fwd_ref(x, d["q4"], d["scale4"], "i8mxu"))
    dn = quant.quantize_tensor_nf4(torch.from_numpy(_weights(8, 256, 64)))  # nf4 overrides the variant
    assert torch.equal(k5.int4_matmul(x, dn["q4"], dn["scale4"], nf4=True),
                       k5.int4_matmul_fwd_ref(x, dn["q4"], dn["scale4"], "nf4"))
    # rejected (K/2 = 32): x @ dequant(W) in x's type
    small = quant.quantize_tensor_int4(torch.from_numpy(_weights(9, 64, 32)))
    xs = x[:, :64]
    assert torch.equal(k5.int4_matmul(xs, small["q4"], small["scale4"]), xs @ quant.dequantize_tensor_int4(small))
    with pytest.raises(ValueError, match="unknown"):
        k5.int4_matmul_fwd_ref(x, d["q4"], d["scale4"], "decomp")


def _jax_flex(w, x, fmt, lora=None):
    d = getattr(jquant, QUANTISERS[fmt])(jnp.asarray(w))
    variables = {"params": {}, "quant": dict(d)}
    if lora is not None:
        variables["lora"] = {"a": jnp.asarray(lora[0]), "b": jnp.asarray(lora[1])}
    return d, np.asarray(JaxFlexLinear(w.shape[1]).apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("fmt", sorted(QUANTISERS))
@pytest.mark.parametrize("kn", [(64, 96), (256, 128)])
def test_flexlinear_q4_matches_jax(fmt, kn):
    K, N = kn
    rng = np.random.default_rng(10)
    w = _weights(11, K, N, 0.05)
    x = rng.standard_normal((2, 5, K)).astype(np.float32)
    lora = ((rng.standard_normal((K, 4)) * 0.1).astype(np.float32), (rng.standard_normal((4, N)) * 0.1).astype(np.float32))
    d, want = _jax_flex(w, x, fmt, lora)
    layer = FlexLinear(K, N)
    group = None if fmt == "int4pc" else K // d["scale4"].shape[0]
    layer.to_packed(fmt, group=group)
    layer.add_lora(4)
    layer.load_state_dict({**{k: _t(v) for k, v in d.items()}, "a": torch.from_numpy(lora[0]),
                           "b": torch.from_numpy(lora[1])})
    got = layer(torch.from_numpy(x)).detach().numpy()
    assert sorted(layer.state_dict()) == sorted(list(d) + ["a", "b"])
    feasible = k5._pcol_feasible(K // 2, N) if fmt == "int4pc" else k5._kernel_feasible(K // 2, group)
    assert feasible == (K == 256)
    _assert_rows_close(got, want, 1e-2 if feasible else 1e-6)


@pytest.mark.parametrize("group", [16, 32, 64, 128])
@pytest.mark.parametrize("fmt", ["int4", "nf4"])
def test_prefill_dequant_ref_equals_jax_dequant(fmt, group):
    """The prefill route's plain pre-pass, Wt (N, K) bf16, bit-equal to the JAX package's _dequant_xla in bf16,
    transposed (K/2 = 1024 keeps every group from 16 to 128)."""
    K, N = 2048, 24
    d = getattr(jquant, QUANTISERS[fmt])(jnp.asarray(_weights(11, K, N)), group)
    assert K // d["scale4"].shape[0] == group
    want = np.asarray(jk5._dequant_xla(d["q4"], d["scale4"], jnp.bfloat16, fmt == "nf4")).astype(np.float32).T
    got = k5.prefill_dequant_ref(_t(d["q4"]), _t(d["scale4"]), fmt == "nf4")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (N, K) and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the CPU wrapper is the plain version, and counts no launch
    before = dict(k5.prefill_dequant.launches)
    assert torch.equal(k5.prefill_dequant(_t(d["q4"]), _t(d["scale4"]), fmt == "nf4"), got)
    assert k5.prefill_dequant.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("instance", ["base", "nf4"])
def test_prefill_gemm_ref_matches_fused_ref(instance, dtype):
    """Pre-pass then GEMM, in their plain versions, against K5's plain version: the same bf16 operands and f32
    sums, so within 1e-6 of the row's largest value in f32 (another order of sums) and one bf16 ulp in bf16."""
    M, K, N = 40, 1024, 136
    fmt = "nf4" if instance == "nf4" else "int4"
    d = getattr(quant, QUANTISERS[fmt])(torch.from_numpy(_weights(12, K, N)), 32)
    x = torch.from_numpy((np.random.default_rng(13).standard_normal((M, K)) * 0.5).astype(np.float32))
    x = x.to(getattr(torch, dtype))
    gemm = k5.prefill_gemm_ref(x, k5.prefill_dequant_ref(d["q4"], d["scale4"], instance == "nf4"))
    before = k5.prefill_gemm.launches
    assert torch.equal(k5.prefill_gemm(x, k5.prefill_dequant(d["q4"], d["scale4"], instance == "nf4")), gemm)
    assert k5.prefill_gemm.launches == before
    want = k5.int4_matmul_fwd_ref(x, d["q4"], d["scale4"], instance)
    assert gemm.dtype == x.dtype and gemm.shape == want.shape
    _assert_rows_close(gemm.float().numpy(), want.float().numpy(), 1e-6 if dtype == "float32" else 2.0 ** -7)


def test_prefill_routing_rule():
    """The card's route by rows, activation type and instance; on the CPU every route is the plain version."""
    bf = torch.zeros((k5.M_PREFILL, 64), dtype=torch.bfloat16)
    assert 32 < k5.M_PREFILL <= 8192  # decode's 32 rows stay on the fused kernel, prefill's 8192 do not
    assert k5.PREFILL_INSTANCES == ("base", "nf4")
    for inst in k5.INSTANCES:
        assert k5._route(bf, inst) == ("prefill" if inst in ("base", "nf4") else "fused")
        assert k5._route(bf[:-1], inst) == "fused"
        assert k5._route(bf.float(), inst) == "fused"
    assert set(k5.int4_matmul_fwd.route_launches) == {(i, r) for i in k5.INSTANCES for r in k5.ROUTES}
    d = quant.quantize_tensor_int4(torch.from_numpy(_weights(14, 256, 64)))
    x = torch.from_numpy(np.random.default_rng(15).standard_normal((k5.M_PREFILL, 256)).astype(np.float32))
    x = x.to(torch.bfloat16)
    before = dict(k5.int4_matmul_fwd.route_launches)
    assert torch.equal(k5.int4_matmul_fwd(x, d["q4"], d["scale4"], "base"),
                       k5.int4_matmul_fwd_ref(x, d["q4"], d["scale4"], "base"))
    assert k5.int4_matmul_fwd.route_launches == before


@pytest.mark.parametrize("pcol", [False, True])
def test_routing_rejects_n_not_multiple_of_8(pcol):
    """N = 100 passes the reference's rules (the group rule ignores N; pcol's admits a block of all N) but not the
    kernels' column pairs: every device takes x @ dequant(W), as the JAX package does off the TPU."""
    w = _weights(16, 256, 100)
    d = (quant.quantize_tensor_int4pc if pcol else quant.quantize_tensor_int4)(torch.from_numpy(w))
    assert (k5._pcol_feasible(128, 100) if pcol else k5._kernel_feasible(128, 256 // d["scale4"].shape[0]))
    x = torch.from_numpy(np.random.default_rng(17).standard_normal((32, 256)).astype(np.float32))
    calls = []
    y = k5._forward(x, d["q4"], d["scale4"], False, pcol, lambda *a: calls.append(a))
    assert not calls and torch.equal(y, x @ quant.dequantize_tensor_int4(d))
    jd = (jquant.quantize_tensor_int4pc if pcol else jquant.quantize_tensor_int4)(jnp.asarray(w))
    jy = jk5.int4_matmul(jnp.asarray(x.numpy()), jd["q4"], jd["scale4"], False, False, pcol)
    _assert_rows_close(y.numpy(), jy, 1e-5)
