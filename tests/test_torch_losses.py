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

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores


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


@pytest.mark.parametrize("k", [1, 3])
def test_contrastive_loss_with_extra_negatives_matches_jax(k):
    """Hard negatives (B, K) extend the query->passage softmax: the (B, B + K) matrix keeps the positives at
    column i, the passage->query direction stays square; values and gradients in q, p and the extra logits."""
    rng = np.random.default_rng(4)
    B, D = 6, 16
    q, p = _unit(rng, B, D), _unit(rng, B, D)
    extra = rng.standard_normal((B, k)).astype(np.float32) * 30
    extra[0, -1] = np.finfo(np.float32).min  # a masked index row, as the live index's padding gives

    def jloss(q_, p_, e_):
        return jcon.contrastive_loss(q_, p_, 100.0, extra_negative_logits=e_)

    (jl, jsim), jvjp = jax.vjp(jloss, jnp.asarray(q), jnp.asarray(p), jnp.asarray(extra))
    jg = jvjp((jnp.ones(()), jnp.zeros_like(jsim)))
    tq, tp, te = (torch.tensor(a, requires_grad=True) for a in (q, p, extra))
    tl, tsim = tcon.contrastive_loss(tq, tp, 100.0, extra_negative_logits=te)
    tl.backward()
    assert tuple(tsim.shape) == (B, B + k)
    _close(tl, jl, scale=1.0)
    _close(tsim, jsim)
    for t, g in zip((tq, tp, te), jg):
        _close(t.grad, g)


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


# ---- losses/marginal_topk.py -----------------------------------------------------------------------------------

from dalm_tpu.losses import marginal_topk as jmtk  # noqa: E402
from dalm_tpu_torch.losses import marginal_topk as tmtk  # noqa: E402


def _segments(rng, B, K, Lq=6, Lp=9, La=7, V=30):
    q_ids = rng.integers(1, V, (B, Lq)).astype(np.int32)
    p_ids = rng.integers(1, V, (B, K, Lp)).astype(np.int32)
    a_ids = rng.integers(1, V, (B, La)).astype(np.int32)
    q_len = rng.integers(2, Lq + 1, B).astype(np.int32)
    p_len = rng.integers(1, Lp + 1, (B, K)).astype(np.int32)
    a_len = rng.integers(3, La + 1, B).astype(np.int32)
    return q_ids, q_len, p_ids, p_len, a_ids, a_len


def test_assemble_generator_inputs_equal_jax():
    rng = np.random.default_rng(7)
    args = _segments(rng, 3, 4)
    j = jmtk.assemble_generator_inputs(*map(jnp.asarray, args), pad_id=0)
    t = tmtk.assemble_generator_inputs(*(torch.from_numpy(a).long() for a in args), pad_id=0)
    for a, b in zip(t, j):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert tuple(t[0].shape) == (3, 4, 6 + 9 + 7)


@pytest.mark.parametrize("mode", ["sequence", "token"])
def test_topk_marginal_losses_and_grads_match_jax(mode):
    """Every function of the module on one assembled batch: the per-token and per-candidate log-likelihoods,
    the answer mask, the aligned gather, and both marginal losses with their gradients in the scores and the
    logits (tolerance as the module's other losses)."""
    rng = np.random.default_rng(8)
    B, K, V, marker = 3, 4, 30, 2
    q_ids, q_len, p_ids, p_len, a_ids, a_len = _segments(rng, B, K, V=V)
    ids, mask, boundary = (np.asarray(x) for x in jmtk.assemble_generator_inputs(
        *map(jnp.asarray, (q_ids, q_len, p_ids, p_len, a_ids, a_len))))
    L, A = ids.shape[2], a_ids.shape[1]
    logits = rng.standard_normal((B, K, L, V)).astype(np.float32) * 2
    scores = rng.standard_normal((B, K)).astype(np.float32) * 5
    ti, tm, tb = (torch.from_numpy(x).long() for x in (ids, mask, boundary))

    jll, jn = jmtk.answer_loglik(jnp.asarray(logits), ids, mask, boundary, marker)
    tll, tn = tmtk.answer_loglik(torch.from_numpy(logits), ti, tm, tb, marker)
    _close(tll, jll)
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    jtok, jans = jmtk.answer_token_loglik(jnp.asarray(logits), ids, mask, boundary, marker)
    ttok, tans = tmtk.answer_token_loglik(torch.from_numpy(logits), ti, tm, tb, marker)
    _close(ttok, jtok)
    assert np.array_equal(tans.numpy(), np.asarray(jans))
    jvalid = jmtk.answer_token_mask(jnp.asarray(a_len), marker, A)
    tvalid = tmtk.answer_token_mask(torch.from_numpy(a_len).long(), marker, A)
    assert np.array_equal(tvalid.numpy(), np.asarray(jvalid))
    _close(tmtk.aligned_answer_token_loglik(torch.from_numpy(logits), ti, tm, tb, marker, A),
           jmtk.aligned_answer_token_loglik(jnp.asarray(logits), ids, mask, boundary, marker, A))

    def jloss(s, lg):
        if mode == "token":
            return jmtk.topk_marginal_token_loss(s, jmtk.aligned_answer_token_loglik(lg, ids, mask, boundary, marker, A),
                                                 jvalid)
        ll, n = jmtk.answer_loglik(lg, ids, mask, boundary, marker)
        return jmtk.topk_marginal_loss(s, ll, n)

    jl, (jgs, jgl) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(scores), jnp.asarray(logits))
    ts, tl = torch.tensor(scores, requires_grad=True), torch.tensor(logits, requires_grad=True)
    if mode == "token":
        loss = tmtk.topk_marginal_token_loss(ts, tmtk.aligned_answer_token_loglik(tl, ti, tm, tb, marker, A), tvalid)
    else:
        ll, n = tmtk.answer_loglik(tl, ti, tm, tb, marker)
        loss = tmtk.topk_marginal_loss(ts, ll, n)
    loss.backward()
    _close(loss, jl, scale=1.0)
    _close(ts.grad, jgs)
    _close(tl.grad, jgl)
