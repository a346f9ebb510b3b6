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
