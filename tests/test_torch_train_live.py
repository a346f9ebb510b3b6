"""The live index, hard negatives and the true top-k marginal in ``train_e2e``
against the JAX trainer on the CPU, from the same saved tiny models and
factors: 16 rows whose passages repeat (12 unique), a refresh slice of 5 (a
sweep takes 3 ticks), 3 steps.

Tolerances: the final losses within 1e-3 (observed 4e-6 to 2.5e-4: hard
negatives and candidates are chosen by top-k over scores whose near ties
could fall either way, and the merge runtime with an int8 base rounds its
merged kernels); the live index's rows after the final sweep within 1e-4 (unit
vectors, observed 4e-5).
"""


import jax
import numpy as np
import pytest
import torch

from dalm_tpu.models import lora as jlora
from dalm_tpu.models import qlora as jqlora
from dalm_tpu_torch import interop
from dalm_tpu_torch.train import rag_e2e as trag
from dalm_tpu_torch.train.rag_e2e import train_e2e
from test_torch_train_e2e import SMALL, _save_tiny_bases

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores


@pytest.fixture(scope="module")
def repeat_csv(tmp_path_factory):
    import csv

    path = tmp_path_factory.mktemp("live") / "rows.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Question", "Abstract", "Answer"])
        for i in range(16):
            w.writerow([f"question {i} about a thing", f"passage number {i % 12} says it is {(i % 12) * 7}", f"ans {i}"])
    return str(path)


# The warm-up step of "fused-token" trains on the diagonal loss with the hard negatives alone.
CASES = {
    "fused-token": ("fused", dict(live_negatives_k=3, marginalize_k=3, marginalize_mode="token",
                                  marginalize_warmup_steps=1)),
    "merge-sequence": ("merge", dict(marginalize_k=2, marginalize_mode="sequence", marginalize_scale=10.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_e2e_live_index_matches_jax(tmp_path, repeat_csv, case):
    from dalm_tpu.train.rag_e2e import train_e2e as jax_train_e2e

    runtime, extra = CASES[case]
    bases = _save_tiny_bases(str(tmp_path))
    seed = 5
    common = dict(SMALL, max_train_steps=3, seed=seed, use_peft="both", use_bnb="both", lora_runtime=runtime,
                  int8_compute="all", a8_calibrate_every=0, live_index=True, index_refresh_slice=5, **extra)
    j = jax_train_e2e(repeat_csv, bases["retriever"][0], bases["generator"][0], per_device_train_batch_size=1,
                      local_negatives=False, use_dropout=False, **common)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    if runtime == "fused":
        factors = {"retriever": jqlora.init_qlora_factors(jax.random.fold_in(init_rng, 23), bases["retriever"][2], jlora.LoraSpec.for_encoder()),
                   "generator": jqlora.init_qlora_factors(jax.random.fold_in(init_rng, 29), bases["generator"][2], jlora.LoraSpec.for_causal_lm())}
    else:
        factors = {"retriever": jlora.init_lora_params(jax.random.fold_in(init_rng, 13), bases["retriever"][2], jlora.LoraSpec.for_encoder()),
                   "generator": jlora.init_lora_params(jax.random.fold_in(init_rng, 17), bases["generator"][2], jlora.LoraSpec.for_causal_lm())}
    seen = {}

    def hook(setup):
        for sub in ("retriever", "generator"):
            f = jax.tree.map(np.asarray, factors[sub])
            if runtime == "fused":
                interop.load_factors(getattr(setup.rag, sub), f)
            else:
                interop.load_merge_lora(getattr(setup.rag, sub), f, setup.lora_specs[sub])
        seen["processed"] = setup.processed
        seen["refresher"] = setup.refresher

    t = train_e2e(repeat_csv, bases["retriever"][1], bases["generator"][1], per_device_train_batch_size=8,
                  device="cpu", setup_hook=hook, **common)
    assert t["steps"] == j["steps"] == 3
    for key in ("final_loss", "final_retriever_loss", "final_generator_loss"):
        assert abs(t[key] - j[key]) <= 1e-3, (key, t[key], j[key])
    # 12 unique passages; 3 ticks during training finish one sweep, refresh_fully another
    assert seen["refresher"].num_passages == 12 and t["index_version"] == j["index_version"] == 2
    rows = t["live_index"].embeddings
    assert rows.shape == (12, 64) and rows.dtype == torch.float32
    np.testing.assert_allclose(rows.numpy(), np.asarray(j["live_index"].embeddings)[:12], rtol=0, atol=1e-4)
    pos = np.asarray(seen["processed"]["positive_index"])
    assert pos.tolist() == [i % 12 for i in range(16)]  # unique passages in first-seen order
    if "marginalize_k" in extra:
        assert {"marg_q_ids", "marg_q_len", "marg_a_ids", "marg_a_len"} <= set(seen["processed"].column_names)


def test_masked_scores_and_stable_topk():
    """Own positive and padding rows at the f32 minimum; ties go to the lower index, as lax.top_k's."""
    q = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    index = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.5, 0.5], [9.0, 9.0]])
    s = trag.masked_index_scores(q, index, torch.tensor([0, 2]), num_real=4, scale=2.0)
    lo = torch.finfo(torch.float32).min
    assert s.tolist() == [[lo, 2.0, 0.0, 1.0, lo], [0.0, 0.0, lo, 1.0, lo]]
    vals, idx = trag.stable_topk(s, 3)
    assert idx.tolist() == [[1, 3, 2], [3, 0, 1]] and vals[1].tolist() == [1.0, 0.0, 0.0]
    jv, ji = jax.lax.top_k(np.asarray(s.numpy()), 3)
    assert np.array_equal(np.asarray(ji), idx.numpy())


def test_live_knobs_need_the_live_index(toy_csv):
    for kw in (dict(live_negatives_k=2), dict(marginalize_k=2)):
        with pytest.raises(ValueError, match="requires live_index=True"):
            train_e2e(toy_csv, "tiny", "tiny", device="cpu", **kw)
