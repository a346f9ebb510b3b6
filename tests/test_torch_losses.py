"""The port's losses against the JAX package's on the CPU, values and
gradients, from the same numpy inputs. f32 both sides; tolerance 1e-5
absolute on losses of order 1-10 and 1e-5 of the largest gradient entry
(sums and logsumexp in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalm_tpu.losses import contrastive as jcon
from dalm_tpu.losses import marginalized as jmar
from dalm_tpu_torch.losses import contrastive as tcon
from dalm_tpu_torch.losses import marginalized as tmar


def _unit(rng, b, d):
    x = rng.standard_normal((b, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _gen_inputs(rng, b, l, v):
    logits = rng.standard_normal((b, l, v)).astype(np.float32) * 2
    ids = rng.integers(0, v, size=(b, l)).astype(np.int32)
    lens = rng.integers(l // 2, l + 1, size=b)
    mask = (np.arange(l)[None, :] < lens[:, None]).astype(np.int32)
    prefix = np.minimum(rng.integers(2, l, size=b), lens).astype(np.int32)
    return logits, ids, mask, prefix


def _close(t, j, scale=None):
    j = np.asarray(j)
    tol = 1e-5 * (np.abs(j).max() if scale is None else scale)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0, atol=max(tol, 1e-6))


@pytest.mark.parametrize("logit_scale", [100.0, 20.0])
def test_contrastive_loss_and_grads_match_jax(logit_scale):
    rng = np.random.default_rng(0)
    q, p = _unit(rng, 6, 32), _unit(rng, 6, 32)
    j_loss, j_sim = jcon.contrastive_loss(jnp.asarray(q), jnp.asarray(p), logit_scale)
    j_gq, j_gp = jax.grad(lambda a, b: jcon.contrastive_loss(a, b, logit_scale)[0], argnums=(0, 1))(jnp.asarray(q), jnp.asarray(p))
    tq, tp = torch.from_numpy(q).requires_grad_(), torch.from_numpy(p).requires_grad_()
    t_loss, t_sim = tcon.contrastive_loss(tq, tp, logit_scale)
    t_loss.backward()
    _close(t_loss, j_loss, 10.0)
    _close(t_sim, j_sim)
    _close(tq.grad, j_gq)
    _close(tp.grad, j_gp)
    _close(tcon.nt_xent_loss(t_sim.detach()), jcon.nt_xent_loss(j_sim), 10.0)
    _close(tcon.cosine_sim_logits(tq.detach().bfloat16(), tp.detach().bfloat16(), logit_scale),
           jcon.cosine_sim_logits(jnp.asarray(q, jnp.bfloat16), jnp.asarray(p, jnp.bfloat16), logit_scale))


def test_contrastive_loss_rejects_unported_arguments():
    q = torch.zeros(4, 8)
    with pytest.raises(NotImplementedError, match="local_negatives_block"):
        tcon.contrastive_loss(q, q, local_negatives_block=2)
    with pytest.raises(NotImplementedError, match="extra_negative_logits"):
        tcon.contrastive_loss(q, q, extra_negative_logits=torch.zeros(4, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_marginalized_loss_and_grads_match_jax(dtype):
    rng = np.random.default_rng(1)
    B, L, V = 5, 14, 40
    logits, ids, mask, prefix = _gen_inputs(rng, B, L, V)
    scores = rng.standard_normal((B, B)).astype(np.float32) * 5
    jl = jnp.asarray(logits, getattr(jnp, dtype))

    def jf(lg, sc):
        return jmar.marginalized_nll_loss(lg, ids, mask, sc, prefix)

    j_loss = jf(jl, jnp.asarray(scores))
    j_gl, j_gs = jax.grad(jf, argnums=(0, 1))(jl, jnp.asarray(scores))
    tl = torch.from_numpy(np.asarray(jl, np.float32)).to(getattr(torch, dtype)).requires_grad_()
    ts = torch.from_numpy(scores).requires_grad_()
    t_loss = tmar.marginalized_nll_loss(tl, torch.from_numpy(ids).long(), torch.from_numpy(mask).long(), ts,
                                        torch.from_numpy(prefix).long())
    t_loss.backward()
    _close(t_loss, j_loss, 10.0)
    _close(ts.grad, j_gs)
    if dtype == "float32":
        _close(tl.grad, j_gl)
    else:  # the gradient is rounded to bf16 on the way back: one bf16 ulp
        np.testing.assert_allclose(tl.grad.float().numpy(), np.asarray(j_gl, np.float32), rtol=2.0 ** -7, atol=1e-6)


def test_marginalized_loss_is_the_per_sample_definition():
    """The reference's per-sample loop, written out in numpy."""
    rng = np.random.default_rng(2)
    B, L, V = 4, 10, 12
    logits, ids, mask, prefix = _gen_inputs(rng, B, L, V)
    scores = rng.standard_normal((B, B)).astype(np.float32)
    logp = logits[:, :-1] - np.log(np.exp(logits[:, :-1]).sum(-1, keepdims=True))
    doc = np.diag(scores - np.log(np.exp(scores).sum(1, keepdims=True)))
    total, count = 0.0, 0.0
    for i in range(B):
        for t in range(L - 1):
            ll = logp[i, t, ids[i, t + 1]] + (doc[i] if t >= prefix[i] - 1 else 0.0)
            total += -ll * mask[i, t + 1]
            count += mask[i, t + 1]
    got = tmar.marginalized_nll_loss(torch.from_numpy(logits), torch.from_numpy(ids).long(),
                                     torch.from_numpy(mask).long(), torch.from_numpy(scores), torch.from_numpy(prefix).long())
    assert abs(float(got) - total / count) < 1e-4


def test_rag_e2e_loss_matches_jax():
    rng = np.random.default_rng(3)
    B, L, V = 4, 12, 30
    q, p = _unit(rng, B, 16), _unit(rng, B, 16)
    logits, ids, mask, prefix = _gen_inputs(rng, B, L, V)
    j_total, j_parts = jmar.rag_e2e_loss(jnp.asarray(q), jnp.asarray(p), jnp.asarray(logits), ids, mask, prefix)
    t_total, t_parts = tmar.rag_e2e_loss(torch.from_numpy(q), torch.from_numpy(p), torch.from_numpy(logits),
                                         torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                                         torch.from_numpy(prefix).long())
    _close(t_total, j_total, 10.0)
    assert sorted(t_parts) == sorted(j_parts)
    for k in t_parts:
        _close(t_parts[k], j_parts[k], 10.0)
