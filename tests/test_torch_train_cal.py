"""Calibrated W8A8 against the JAX package on the CPU: the calibrated-scale
quantiser's plain version, ``int8_matmul_cal`` / ``int8_matmul_dycal`` with
their out-of-band ``a_scale`` channel, ``FlexLinear``'s calibrated branches and
amax hook, and ``train_e2e`` with ``a8_calibrate_every`` and ``a8_dy_calibrate``.

Tolerances: the quantiser EQUAL to ``jnp.clip(jnp.round(x / a_scale))`` (and its
amax equal); outputs equal and dx within 1e-6 of the largest entry (the bf16
product of ``int8_compute="fwd"`` rounds once more); the ``a_scale`` channel
equal within 1 f32 ulp. The trainers: final losses within 1e-4 after 3 steps
(observed 2e-6 calibrated, 1.6e-5 dy-calibrated: a dy that rounds the other
way moves a product by a quantisation step).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.kernels import int8_matmul as J
from dalm_tpu.models import lora as jlora
from dalm_tpu.models import qlora as jqlora
from dalm_tpu_torch import interop
from dalm_tpu_torch.kernels import int8_matmul as T
from dalm_tpu_torch.models.layers import FlexLinear
from dalm_tpu_torch.train.rag_e2e import train_e2e
from test_torch_train_e2e import SMALL, _save_tiny_bases

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores


def _operands(rng, lead=(3, 5), K=40, N=24):
    x = (rng.standard_normal(lead + (K,)) * 2).astype(np.float32)
    q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    scale = (rng.random((1, N)) * 0.01 + 1e-3).astype(np.float32)
    return x, q, scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cal_quant_plain_equals_the_references_expression(dtype):
    """Both modes bit for bit, with values that clip (a scale below the absmax) and a zero tensor."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((7, 33)) * 3).astype(np.float32)
    x[0, :4] = [1e6, -1e6, 0.5, -0.5]
    colscale = (rng.random(33) * 0.02).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    xf = np.asarray(jnp.asarray(tx.float().numpy()))
    for s in (np.float32(0.013), np.float32(np.abs(xf).max() / 127)):
        want = jnp.clip(jnp.round(jnp.asarray(xf) / s), -127, 127).astype(jnp.int8)
        got, amax = T.cal_quant(tx, torch.tensor(s))
        assert amax is None and np.array_equal(got.numpy(), np.asarray(want))
        dyf = jnp.asarray(xf) * jnp.asarray(colscale)
        want = jnp.clip(jnp.round(dyf / s), -127, 127).astype(jnp.int8)
        got, amax = T.cal_quant(tx, torch.tensor(s), torch.from_numpy(colscale), want_amax=True)
        assert np.array_equal(got.numpy(), np.asarray(want)) and float(amax) == float(jnp.max(jnp.abs(dyf)))
    got, amax = T.cal_quant(torch.zeros((4, 16)), torch.tensor(1e-8), torch.ones(16), want_amax=True)
    assert not got.any() and float(amax) == 0.0
    assert T.cal_quant.launches == {"x": 0, "dy": 0}  # CPU tensors take the plain version and count nothing


@pytest.mark.parametrize("bwd_int8", [False, True], ids=["fwd", "all"])
@pytest.mark.parametrize("kind", ["cal", "dycal"])
def test_int8_matmul_cal_and_dycal_match_jax_vjp(kind, bwd_int8):
    rng = np.random.default_rng(1)
    x, q, scale = _operands(rng)
    a = np.float32(np.abs(x).max() / 127 * 0.6)  # stale: some values clip
    dys = np.float32(0.004)
    dy = rng.standard_normal((3, 5, q.shape[1])).astype(np.float32)

    def jf(x_, a_):
        if kind == "dycal":
            return J.int8_matmul_dycal(x_, jnp.asarray(q), jnp.asarray(scale), a_, jnp.asarray(dys), bwd_int8)
        return J.int8_matmul_cal(x_, jnp.asarray(q), jnp.asarray(scale), a_, bwd_int8)

    jy, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(a))
    jdx, jda = vjp(jnp.asarray(dy))
    tx, ta = torch.tensor(x, requires_grad=True), torch.tensor(a, requires_grad=True)
    tq, ts = torch.from_numpy(q), torch.from_numpy(scale)
    ty = (T.int8_matmul_dycal(tx, tq, ts, ta, torch.tensor(dys), bwd_int8) if kind == "dycal"
          else T.int8_matmul_cal(tx, tq, ts, ta, bwd_int8))
    ty.backward(torch.from_numpy(dy))
    assert np.array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=0, atol=1e-6 * np.abs(np.asarray(jdx)).max())
    np.testing.assert_allclose(float(ta.grad), float(jda), rtol=1.2e-7, atol=0)
    # the channel is computed only when a_scale asks for a gradient
    tx2 = torch.tensor(x, requires_grad=True)
    ta2 = torch.tensor(a)
    (T.int8_matmul_cal(tx2, tq, ts, ta2, bwd_int8) if kind == "cal"
     else T.int8_matmul_dycal(tx2, tq, ts, ta2, torch.tensor(dys), bwd_int8)).backward(torch.from_numpy(dy))
    assert ta2.grad is None and torch.equal(tx2.grad, tx.grad)


def _int8_layer(q, scale, compute="all"):
    K, N = q.shape
    m = FlexLinear(K, N, int8_compute=compute)
    m.to_packed("int8")
    with torch.no_grad():
        m.q.copy_(torch.from_numpy(q))
        m.scale.copy_(torch.from_numpy(scale))
    return m


def test_a_site_used_twice_gets_the_sum_of_both_uses():
    """The retriever's layers run on the queries and on the passages in one step: their a_scale gradient is the
    SUM of both uses' amax / 127 (JAX's summed cotangent), with and without a dy scale."""
    rng = np.random.default_rng(2)
    x1, q, scale = _operands(rng)
    x2 = (rng.standard_normal(x1.shape) * 5).astype(np.float32)
    a = np.float32(0.02)
    w = rng.standard_normal((3, 5, q.shape[1])).astype(np.float32)
    for dys in (None, np.float32(0.003)):
        def jloss(a_):
            f = ((lambda x_: J.int8_matmul_cal(x_, jnp.asarray(q), jnp.asarray(scale), a_, True)) if dys is None else
                 (lambda x_: J.int8_matmul_dycal(x_, jnp.asarray(q), jnp.asarray(scale), a_, jnp.asarray(dys), True)))
            return jnp.sum(f(jnp.asarray(x1)) * w) + jnp.sum(f(jnp.asarray(x2)) * w * 3)

        want = float(jax.grad(jloss)(jnp.asarray(a)))
        single = [float(jax.grad(lambda a_, xx=xx, c=c: jnp.sum(J.int8_matmul_cal(
            jnp.asarray(xx), jnp.asarray(q), jnp.asarray(scale), a_, True) * w * c))(jnp.asarray(a)))
            for xx, c in ((x1, 1), (x2, 3))]
        assert abs(want - sum(single)) <= 1e-7 * want
        m = _int8_layer(q, scale)
        m.a_scale = torch.tensor(a).requires_grad_(True)
        if dys is not None:
            m.dy_scale = torch.tensor(dys)
        loss = (m(torch.from_numpy(x1)) * torch.from_numpy(w)).sum() + (m(torch.from_numpy(x2)) * torch.from_numpy(w) * 3).sum()
        loss.backward()
        np.testing.assert_allclose(float(m.a_scale.grad), want, rtol=2.4e-7, atol=0)


def test_flexlinear_calibrated_branches_and_amax_hook():
    rng = np.random.default_rng(3)
    x, q, scale = _operands(rng)
    x2 = x * 2
    for compute in ("fwd", "all"):
        m = _int8_layer(q, scale, compute)
        tx = torch.from_numpy(x)
        dyn = m(tx)  # no a_scale: the dynamic per-row path
        assert torch.equal(dyn, T.int8_matmul(tx, m.q, m.scale, compute == "all")) and m.amax is None
        m.record_amax = True
        m(tx), m(torch.from_numpy(x2))
        assert float(m.amax) == float(np.abs(x2).max())  # max-reduced over the calls
        m.record_amax, m.amax = False, None
        m.a_scale = torch.tensor(np.float32(0.05))
        assert torch.equal(m(tx), T.int8_matmul_cal(tx, m.q, m.scale, m.a_scale, compute == "all"))
        m.dy_scale = torch.tensor(np.float32(0.01))
        want = (T.int8_matmul_dycal(tx, m.q, m.scale, m.a_scale, m.dy_scale) if compute == "all"
                else T.int8_matmul_cal(tx, m.q, m.scale, m.a_scale, False))  # "fwd" has no int8 backward to calibrate
        assert torch.equal(m(tx), want) and m.amax is None
        assert {"a_scale", "dy_scale"} <= set(m.state_dict())


def _jax_fused_factors(bases, seed):
    init_rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    return {
        "retriever": jqlora.init_qlora_factors(jax.random.fold_in(init_rng, 23), bases["retriever"][2], jlora.LoraSpec.for_encoder()),
        "generator": jqlora.init_qlora_factors(jax.random.fold_in(init_rng, 29), bases["generator"][2], jlora.LoraSpec.for_causal_lm()),
    }


@pytest.mark.parametrize("dy", [False, True], ids=["a8_calibrate_every", "a8_dy_calibrate"])
def test_train_e2e_calibrated_matches_jax(tmp_path, toy_csv, dy):
    """a8_calibrate_every=2 over 3 steps recalibrates at micro steps 0 and 2 (and at 1 with dy calibration,
    where every step is a probe); losses against the JAX trainer from the same saved models and factors."""
    from dalm_tpu.train.rag_e2e import train_e2e as jax_train_e2e

    bases = _save_tiny_bases(str(tmp_path))
    seed = 5
    common = dict(SMALL, max_train_steps=3, seed=seed, use_peft="both", use_bnb="both", lora_runtime="fused",
                  int8_compute="all", a8_calibrate_every=2, a8_dy_calibrate=dy)
    j = jax_train_e2e(toy_csv, bases["retriever"][0], bases["generator"][0], per_device_train_batch_size=1,
                      local_negatives=False, use_dropout=False, **common)
    factors = _jax_fused_factors(bases, seed)
    seen = {}

    def hook(setup):
        for sub in ("retriever", "generator"):
            interop.load_factors(getattr(setup.rag, sub), jax.tree.map(np.asarray, factors[sub]))
        seen["rag"] = setup.rag

    calls = {"n": 0}
    real = FlexLinear.forward

    def counting(self, x):
        calls["n"] += bool(self.record_amax)
        return real(self, x)

    FlexLinear.forward = counting
    try:
        t = train_e2e(toy_csv, bases["retriever"][1], bases["generator"][1], per_device_train_batch_size=8,
                      device="cpu", setup_hook=hook, **common)
    finally:
        FlexLinear.forward = real
    assert t["steps"] == j["steps"] == 3
    for key in ("final_loss", "final_retriever_loss", "final_generator_loss"):
        assert abs(t[key] - j[key]) <= 1e-4, (key, t[key], j[key])
    sites = [m for sub in ("retriever", "generator") for m in getattr(seen["rag"], sub).modules()
             if getattr(m, "q", None) is not None]
    # calibration passes: micro steps 0 and 2 (+1 with dy); each sees every retriever layer twice, the generator's once
    n_r = sum(1 for m in seen["rag"].retriever.modules() if getattr(m, "q", None) is not None)
    n_g = len(sites) - n_r
    assert calls["n"] == (3 if dy else 2) * (2 * n_r + n_g)
    assert all(float(m.a_scale) > 0 and not m.a_scale.requires_grad for m in sites)
    assert all((m.dy_scale is not None and float(m.dy_scale) >= float(np.float32(1e-8))) == dy for m in sites)


def test_a8_dy_calibrate_needs_int8_backward_and_no_accumulation(toy_csv):
    kw = dict(SMALL, device="cpu", use_peft="both", use_bnb="both", lora_runtime="fused", a8_dy_calibrate=True,
              max_train_steps=1, per_device_train_batch_size=8)
    with pytest.raises(ValueError, match="int8_compute='all'"):
        train_e2e(toy_csv, "tiny", "tiny", int8_compute="fwd", **kw)
    with pytest.raises(ValueError, match="gradient_accumulation_steps=1"):
        train_e2e(toy_csv, "tiny", "tiny", int8_compute="all", gradient_accumulation_steps=2, **kw)
    # inert where nothing calibrates, as in the reference
    out = train_e2e(toy_csv, "tiny", "tiny", int8_compute="none", **kw)
    assert out["steps"] == 1 and np.isfinite(out["final_loss"])
