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
from dalm_tpu.kernels import int8_matmul as jim
from dalm_tpu.models import quant as jquant
from dalm_tpu.models.layers import FlexLinear as JaxFlexLinear
from dalm_tpu_torch.kernels import int4_matmul as k5
from dalm_tpu_torch.kernels import int8_matmul as im
from dalm_tpu_torch.models import quant
from dalm_tpu_torch.models.layers import FlexLinear

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores

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
    """The card's route by rows, activation type, instance and group; on the CPU every route is the plain version."""
    bf = torch.zeros((k5.M_PREFILL, 64), dtype=torch.bfloat16)
    assert 32 < k5.M_PREFILL <= 8192  # decode's 32 rows stay on the fused kernel, prefill's 8192 do not
    assert k5.PREFILL_INSTANCES == ("base", "nf4", "groupmm", "i8mxu", "pcol")
    assert k5.ROUTES == ("fused", "prefill", "fold", "int8")
    want = {"base": "prefill", "nf4": "prefill", "groupmm": "fold", "i8mxu": "fold", "pcol": "int8"}
    for inst in k5.INSTANCES:
        for group in (16, 32, 64, 128):
            assert k5._route(bf, inst, group) == want[inst]
            assert k5._route(bf[:-1], inst, group) == "fused"
            assert k5._route(bf.float(), inst, group) == "fused"
    for variant in ("groupmm", "decomp", "i8mxu"):  # decomp runs groupmm's instance, and takes its route
        inst = k5.INSTANCE[variant]
        assert k5._route(bf, inst, 64) == "fold" and k5._route(bf[:32], inst, 64) == "fused"
        assert k5._route(bf, inst, 48) == "fused" and k5._route(bf, inst, 256) == "fused"  # no fold GEMM instance
    assert k5._route(bf, "base", 48) == "prefill" and k5._route(bf, "pcol", 256) == "int8"
    # a group that is no multiple of the fused kernel's k-step (Gemma3-1B's K 1,152 packs at 8): base and nf4 at a
    # group of 8 route as at any other group, on the fused kernel's instances for groups of 8; below 8 they take the
    # prefill route at any M, with bfloat16 activations only; groupmm and i8mxu are refused
    q4, s8 = torch.zeros((576, 64), dtype=torch.uint8), torch.ones((144, 64))
    for inst in ("base", "nf4"):
        assert k5._check_weight(q4, s8, inst, 1152) == 8
        assert k5._route(bf[:1], inst, 8) == "fused" and k5._route(bf, inst, 8) == "prefill"
        assert k5._route(bf.float(), inst, 8) == "fused"
        assert k5._check_weight(q4, torch.ones((288, 64)), inst, 1152) == 4
        assert k5._route(bf[:1], inst, 4) == "prefill" and k5._route(bf, inst, 4) == "prefill"
        with pytest.raises(ValueError, match="bfloat16"):
            k5._route(bf.float(), inst, 4)
    for inst in ("groupmm", "i8mxu"):
        with pytest.raises(ValueError, match="group of 8"):
            k5._check_weight(q4, s8, inst, 1152)
    assert set(k5.int4_matmul_fwd.route_launches) == {(i, r) for i in k5.INSTANCES for r in k5.ROUTES}
    d = quant.quantize_tensor_int4(torch.from_numpy(_weights(14, 256, 64)))
    x = torch.from_numpy(np.random.default_rng(15).standard_normal((k5.M_PREFILL, 256)).astype(np.float32))
    x = x.to(torch.bfloat16)
    dp = quant.quantize_tensor_int4pc(torch.from_numpy(_weights(14, 256, 64)))
    before = dict(k5.int4_matmul_fwd.route_launches)
    for inst, w in (("base", d), ("groupmm", d), ("i8mxu", d), ("pcol", dp)):
        assert torch.equal(k5.int4_matmul_fwd(x, w["q4"], w["scale4"], inst),
                           k5.int4_matmul_fwd_ref(x, w["q4"], w["scale4"], inst))
    assert k5.int4_matmul_fwd.route_launches == before


GEMMA3_N = (1024, 256, 6912)  # Gemma3-1B's q, k / v and gate / up at K 1,152, packed at group 8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("M", [1, 32, 191, 192])
def test_group_8_route_check_and_geometry(M, dtype):
    """Base / nf4 at Gemma3-1B's group of 8: the packer gives K 1,152 that group; ``_check`` admits the weight (it
    gets as far as asking for the card); ``_route`` sends bfloat16 below ``M_PREFILL`` and float32 at every M to the
    fused kernel's instances for groups of 8, bfloat16 from ``M_PREFILL`` to the prefill route; ``_splits`` cuts K/2 =
    576 into whole 16-row k-steps (no whole groups needed: those instances scale each weight), at most 8 slices, a
    grid that covers the tiles. On the CPU the wrapper is the plain version and counts nothing."""
    K = 1152
    d = quant.quantize_tensor_int4(torch.from_numpy(_weights(21, K, 64)))
    group = K // d["scale4"].shape[0]
    assert group == quant._int4_group(K // 2) == jquant._int4_group(K // 2) == 8
    x = torch.from_numpy(np.random.default_rng(M).standard_normal((M, K)).astype(np.float32)).to(dtype)
    for inst in ("base", "nf4"):
        assert k5._check_weight(d["q4"], d["scale4"], inst, K) == 8
        with pytest.raises(ValueError, match="CUDA"):
            k5._check(x, d["q4"], d["scale4"], inst)
        want = "prefill" if dtype == torch.bfloat16 and M >= k5.M_PREFILL else "fused"
        assert k5._route(x, inst, group) == want
    for inst in ("groupmm", "i8mxu"):
        with pytest.raises(ValueError, match="group of 8"):
            k5._check(x, d["q4"], d["scale4"], inst)
    for N in GEMMA3_N:
        for sms in (132, 114):
            geo = k5._splits(M, N, K // 2, group, "base", sms)
            assert geo == k5._splits(M, N, K // 2, group, "nf4", sms)
            assert 1 <= geo.splits <= k5.MAX_CLUSTER and geo.splits * geo.slice_rows == K // 2
            assert geo.slice_rows % k5.K_STEP == 0
            assert geo.grid == (-(-N // k5.TILE_N), -(-M // k5.TILE_M), geo.splits)
    before = (dict(k5.fused.launches), dict(k5.fused.group8_launches), dict(k5.int4_matmul_fwd.route_launches))
    for inst in ("base", "nf4"):
        dn = quant.quantize_tensor_nf4(torch.from_numpy(_weights(21, K, 64))) if inst == "nf4" else d
        assert torch.equal(k5.int4_matmul_fwd(x, dn["q4"], dn["scale4"], inst),
                           k5.int4_matmul_fwd_ref(x, dn["q4"], dn["scale4"], inst))
    assert (dict(k5.fused.launches), dict(k5.fused.group8_launches),
            dict(k5.int4_matmul_fwd.route_launches)) == before


LLAMA_KN = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))  # q/k/v/o, gate/up, down, lm_head


@pytest.mark.parametrize("M", [1, 8, 32, 64, 191])
@pytest.mark.parametrize("kn", LLAMA_KN, ids=lambda kn: f"{kn[0]}x{kn[1]}")
def test_fused_geometry_rule(kn, M):
    """The fused kernel's cluster and slice geometry at Llama-2-7B's shapes (the group the packer gives each, 16 at
    the down-projection): the slices divide K/2 into whole k-steps, into whole groups where the scales fold per
    group (groupmm, i8mxu), at most 8 of them (one portable cluster); the grid covers the tiles; at decode's 32
    rows it gives each of 132 SMs a block. A pure function: the same answer every call, on any device."""
    K, N = kn
    half = K // 2
    group = quant._int4_group(half)
    assert group == (16 if K == 11008 else 64)
    for inst in k5.INSTANCES:
        g = K if inst == "pcol" else group
        for sms in (132, 114):
            geo = k5._splits(M, N, half, g, inst, sms)
            assert geo == k5._splits(M, N, half, g, inst, sms)
            assert 1 <= geo.splits <= k5.MAX_CLUSTER == 8
            assert geo.splits * geo.slice_rows == half and geo.slice_rows % k5.K_STEP == 0
            if inst in ("groupmm", "i8mxu"):
                assert geo.slice_rows % group == 0
            assert geo.grid == (-(-N // k5.TILE_N), -(-M // k5.TILE_M), geo.splits)
            if M == 32:
                assert geo.grid[0] * geo.grid[1] * geo.grid[2] >= sms
    # the fewest slices that cover the SMs: one more tile row (M 33) never asks for more slices
    assert k5._splits(33, N, half, group, "base", 132).splits <= k5._splits(32, N, half, group, "base", 132).splits


@pytest.mark.parametrize("group", [16, 32, 64, 128])
def test_prefill_nibbles_ref_equals_jax_dequant_at_unit_scales(group):
    """The fold route's plain pre-pass, Wn (N, K) bf16 = nib - 8, equals the JAX package's dequantize_tensor_int4
    with every scale 1, transposed; the CPU wrapper is the plain version and counts no launch."""
    K, N = 2048, 24
    d = jquant.quantize_tensor_int4(jnp.asarray(_weights(17, K, N)), group)
    assert K // d["scale4"].shape[0] == group
    want = np.asarray(jquant.dequantize_tensor_int4({"q4": d["q4"], "scale4": jnp.ones_like(d["scale4"])})).T
    got = k5.prefill_nibbles_ref(_t(d["q4"]))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (N, K) and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), want)
    before = k5.prefill_nibbles.launches
    assert torch.equal(k5.prefill_nibbles(_t(d["q4"])), got) and k5.prefill_nibbles.launches == before


@pytest.mark.parametrize("kn", [(2048, 24), (256, 8), (11008, 16)])
def test_prefill_nibbles_int8_ref_equals_jax_pcol_nibbles(kn):
    """The int8 route's plain pre-pass, Wn (N, K) int8 = nib - 8, equals the JAX package's dequantize_tensor_int4 of
    an int4pc weight with its scales set to 1, transposed: the low nibbles in columns [0, K/2), the high ones in
    [K/2, K), as the reference pcol kernel pairs them with x's two halves; the CPU wrapper is the plain version and
    counts no launch."""
    K, N = kn
    d = jquant.quantize_tensor_int4pc(jnp.asarray(_weights(21, K, N)))
    want = np.asarray(jquant.dequantize_tensor_int4({"q4": d["q4"], "scale4": jnp.ones_like(d["scale4"])})).T
    q4 = _t(d["q4"])
    got = k5.prefill_nibbles_ref(q4, torch.int8)
    assert got.dtype == torch.int8 and tuple(got.shape) == (N, K) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int8))
    half = K // 2
    assert torch.equal(got[:, :half], ((q4 & 0xF).to(torch.int8) - 8).T)
    assert torch.equal(got[:, half:], ((q4 >> 4).to(torch.int8) - 8).T)
    before = (k5.prefill_nibbles.launches, k5.prefill_nibbles.int8_launches)
    assert torch.equal(k5.prefill_nibbles(q4, torch.int8), got)
    assert (k5.prefill_nibbles.launches, k5.prefill_nibbles.int8_launches) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", [(16, 1024, 256), (37, 512, 136), (5, 2048, 264)])
def test_int8_route_plain_matches_pallas_interpret(mkn, dtype):
    """pcol's int8 route in its plain versions (K2 writing int8, the nibble pre-pass writing int8, the scaled GEMM)
    against the reference's pcol Pallas kernel, interpreted: float32 within 1e-5 of the row's largest value,
    bfloat16 within one bf16 ulp of it (2^-7), as the plain K5 is held; and equal to the port's own plain pcol
    (``_ref_pcol``) bit for bit. Ragged M and N (136 and 264: no multiple of 128)."""
    M, K, N = mkn
    x = (np.random.default_rng(22).standard_normal((M, K)) * 0.5).astype(np.float32)
    x[0] = 0.0
    d = jquant.quantize_tensor_int4pc(jnp.asarray(_weights(23, K, N)))
    want = jk5._int4pc_matmul_fwd_pallas(jnp.asarray(x, getattr(jnp, dtype)), d["q4"], d["scale4"], block_k=256,
                                          block_n=128, interpret=True)
    tx, q4, s4 = torch.from_numpy(x).to(getattr(torch, dtype)), _t(d["q4"]), _t(d["scale4"])
    xq, xs = im.rowquant_ref(tx)
    got = im.int8_gemm_scaled_ref(xq, k5.prefill_nibbles_ref(q4, torch.int8), xs, s4, dtype=tx.dtype)
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N) and not got[0].any()
    _assert_rows_close(got.float().numpy(), np.asarray(want, np.float32), 1e-5 if dtype == "float32" else 2.0 ** -7)
    assert torch.equal(got, k5._ref_pcol(tx, q4, s4))
    if dtype == "bfloat16":  # the CPU wrappers are the plain versions, and count nothing
        before = (im.rowquant.launches, k5.prefill_nibbles.int8_launches, im.int8_gemm_scaled.launches)
        xq2, xs2 = im.rowquant(tx)
        assert torch.equal(im.int8_gemm_scaled(xq2, k5.prefill_nibbles(q4, torch.int8), xs2, s4), got)
        assert (im.rowquant.launches, k5.prefill_nibbles.int8_launches, im.int8_gemm_scaled.launches) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [16, 64])
@pytest.mark.parametrize("instance", ["groupmm", "i8mxu"])
def test_fold_route_plain_matches_pallas_interpret(instance, group, dtype):
    """The fold route's plain versions (nibble pre-pass, K2 in bf16 for i8mxu, fold GEMM) against the reference's
    Pallas kernel of the same variant, interpreted: float32 within 1e-5 of the row's largest value (the same f32
    products and folds; groupmm's products summed in another order), bfloat16 within one bf16 ulp of it (2^-7).
    i8mxu equals the port's own plain K5 bit for bit (integer products, the same fold)."""
    M, K, N = 16, 1024, 256
    x = (np.random.default_rng(18).standard_normal((M, K)) * 0.5).astype(np.float32)
    x[0] = 0.0
    d = jquant.quantize_tensor_int4(jnp.asarray(_weights(19, K, N)), group)
    assert K // d["scale4"].shape[0] == group
    want = jk5._int4_matmul_fwd_pallas(jnp.asarray(x, getattr(jnp, dtype)), d["q4"], d["scale4"], block_k=256,
                                        block_n=128, interpret=True, variant=instance)
    tx, q4, s4 = torch.from_numpy(x).to(getattr(torch, dtype)), _t(d["q4"]), _t(d["scale4"])
    wn = k5.prefill_nibbles_ref(q4)
    if instance == "i8mxu":
        a, xs = im.rowquant_ref(tx, dtype=torch.bfloat16)
    else:
        a, xs = tx, None
    got = k5.prefill_fold_ref(a, wn, s4, xs, dtype=tx.dtype)
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N) and not got[0].any()
    _assert_rows_close(got.float().numpy(), np.asarray(want, np.float32), 1e-5 if dtype == "float32" else 2.0 ** -7)
    if instance == "i8mxu":
        assert torch.equal(got, k5.int4_matmul_fwd_ref(tx, q4, s4, "i8mxu"))
    before = dict(k5.prefill_fold.launches)
    assert torch.equal(k5.prefill_fold(a, wn, s4, xs), k5.prefill_fold_ref(a, wn, s4, xs))  # bf16 out, like the kernel
    assert k5.prefill_fold.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rowquant_bf16_output_plain(dtype):
    """K2's bf16 output type in its plain version: rowquant_ref's int8 values as bf16 (exact), the scales equal,
    and both equal the JAX package's rowquant; the CPU wrapper is the plain version and counts no launch."""
    x = (np.random.default_rng(20).standard_normal((7, 300)) * 3).astype(np.float32)
    x[0] = 0.0
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = im.rowquant_ref(tx)
    qb, sb = im.rowquant_ref(tx, dtype=torch.bfloat16)
    assert qb.dtype == torch.bfloat16 and torch.equal(qb, q.to(torch.bfloat16)) and torch.equal(sb, s)
    assert torch.equal(qb.to(torch.int8), q)  # |q| <= 127: exact in bf16
    jq, js = jim.rowquant(jnp.asarray(x, getattr(jnp, dtype)))
    np.testing.assert_array_equal(qb.float().numpy(), np.asarray(jq, np.float32))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(js))
    before = (im.rowquant.launches, im.rowquant.bf16_launches)
    got = im.rowquant(tx, dtype=torch.bfloat16)
    assert torch.equal(got[0], qb) and torch.equal(got[1], sb)
    assert (im.rowquant.launches, im.rowquant.bf16_launches) == before


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
