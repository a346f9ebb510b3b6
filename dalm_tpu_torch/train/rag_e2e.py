"""RAG-end2end joint training (counterpart of ``dalm_tpu/train/rag_e2e.py``:
its ``loss_fn`` in both runtimes, the step, the loop, calibration, the live
index and the split save).

Retriever and generator train jointly with ``loss = contrastive_weight *
symmetric NT-Xent + marginalised causal CE``; the marginalisation uses the
positive (diagonal) passage score, or, with ``marginalize_k``, the true
top-k marginal over the gold passage and ``k - 1`` passages retrieved from
the live index (``losses/marginal_topk.py``, ``marginalize_mode`` "token" or
"sequence"). Sub-models named by ``use_peft`` train only LoRA factors:

- ``lora_runtime="fused"``: a frozen packed base (int8 where ``use_bnb``
  names the sub-model too, else bf16) and factors applied as ``(x @ a) @ b``;
  with ``int8_compute`` "fwd" or "all" the int8 bases run through the
  hand-written int8 kernels (``kernels/int8_matmul.py``). With
  ``a8_calibrate_every`` (default 16) their activation scales are
  calibrated: a forward-only pass with the scales stripped (dynamic per-row
  quant) records each layer's ``max |x|``, and every step until the next
  pass quantises with ``amax / 127``. ``a8_dy_calibrate`` also calibrates the
  backward's dy scales: every step is a probe that differentiates the
  activation scales, whose out-of-band gradient is the next dy scale;
- ``lora_runtime="merge"`` (the reference's default): the base (int8 where
  ``use_bnb`` names it) plus ``W + (A @ B) * alpha / r`` formed in every
  forward.

The others train densely. ``use_dropout`` turns on the encoder's dropout
where the reference does (the merge runtime or no LoRA; a retriever with a
dropout rate), drawn from a generator seeded per micro step. ``live_index``
keeps the corpus's unique passages in a ``DenseIndex`` re-embedded by an
``AsyncIndexRefresher`` one slice a step; ``live_negatives_k`` adds the top-k
hard negatives from it to the contrastive softmax.

Differences from the reference that a caller sees:

- one process, one device (``device``, default the CUDA card; ``"cpu"`` for
  tests); ``local_negatives`` is therefore inert;
- datasets are CSV / JSON / JSON-lines files or columns (``data/loading.py``);
- checkpoints and artifacts are ``torch.save`` files; a merge-runtime base
  with ``use_bnb`` is saved int8 (``q`` / ``scale`` leaves), as the
  reference saves it;
- dropout masks come from the port's generators, not JAX's keys;
- ``profile_dir`` writes a ``torch.profiler`` Chrome trace;
- ``setup_hook``, called with the :class:`E2ESetup` after the models, the
  optimiser and the data are ready and before the first step, lets a caller
  set initial weights or factors.

With ``retriever_is_autoregressive`` the retriever is a decoder, EOS-pooled,
whose tokenizer adds EOS and pads on the left; it takes the causal-LM LoRA
spec (q_proj / v_proj) and, in the fused runtime, is packed as the generator
is. Knobs of paths that are not ported yet raise ``NotImplementedError``
naming the knob: ``mesh``, ``model_parallel > 1``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import os
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from dalm_tpu_torch.core.dtypes import parse_dtype
from dalm_tpu_torch.core.profiling import Profiler
from dalm_tpu_torch.core.tree import flatten, unflatten
from dalm_tpu_torch.data.loading import ColumnDataset, load_dataset
from dalm_tpu_torch.data.preprocess import preprocess_rag_e2e_dataset
from dalm_tpu_torch.data.tokenizer import resolve_tokenizer
from dalm_tpu_torch.device import resolve_device
from dalm_tpu_torch.index.dense import DenseIndex
from dalm_tpu_torch.index.refresh import AsyncIndexRefresher
from dalm_tpu_torch.losses import marginal_topk as mtk
from dalm_tpu_torch.losses.contrastive import contrastive_loss
from dalm_tpu_torch.losses.marginalized import marginalized_nll_loss
from dalm_tpu_torch.models import lora as lora_mod
from dalm_tpu_torch.models import qlora as qlora_mod
from dalm_tpu_torch.models.hf_loader import export_peft_if_supported
from dalm_tpu_torch.models.layers import FlexLinear
from dalm_tpu_torch.models.rag import Mode, RagE2EModel
from dalm_tpu_torch.models.registry import resolve_decoder, resolve_encoder, save_pretrained
from dalm_tpu_torch.train import checkpoints as ckpt
from dalm_tpu_torch.train.data_iter import epoch_batches, num_batches_per_epoch
from dalm_tpu_torch.train.metrics import MetricsLogger, WindowedThroughput
from dalm_tpu_torch.train.optim import make_optimizer
from dalm_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)

BATCH_COLUMNS = (
    "retriever_query_input_ids",
    "retriever_query_attention_mask",
    "retriever_passage_input_ids",
    "retriever_passage_attention_mask",
    "generator_input_input_ids",
    "generator_input_attention_mask",
    "query_passage_input_len",
)
MARG_COLUMNS = ("marg_q_ids", "marg_q_len", "marg_a_ids", "marg_a_len")
SUBS = ("retriever", "generator")


@dataclasses.dataclass
class E2ESetup:
    """Everything ``train_e2e`` builds before its first step."""

    rag: RagE2EModel
    state: TrainState
    processed: ColumnDataset
    lora_specs: Dict[str, lora_mod.LoraSpec]
    quantized_subs: set
    full_state: Dict[str, dict]  # the pre-pack state dicts of sub-models loaded from a directory
    device: torch.device
    refresher: Optional[AsyncIndexRefresher] = None


@contextlib.contextmanager
def _no_tf32():
    """f32 products at full precision on a card (the reference's ``Precision.HIGHEST``)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def masked_index_scores(q_emb: torch.Tensor, index_embs: torch.Tensor, positive_index: torch.Tensor,
                        num_real: int, scale: float = 1.0) -> torch.Tensor:
    """(B, N_index) query-vs-index scores in f32, each query's own positive and the index's padding rows at
    the f32 minimum (the reference's ``_masked_index_scores``). Stale index rows: the gradient, if any, reaches
    the query side only."""
    with _no_tf32():
        scores = (q_emb.float() @ index_embs.float().T) * float(scale)
    neg = torch.tensor(torch.finfo(torch.float32).min, device=scores.device)
    cols = torch.arange(index_embs.shape[0], device=scores.device)[None, :]
    scores = torch.where(cols >= num_real, neg, scores)
    return torch.where(cols == positive_index[:, None], neg, scores)


def stable_topk(scores: torch.Tensor, k: int) -> tuple:
    """Top-k along the last axis, ties to the lower index (``lax.top_k``'s order): (values, indices)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def cal_sites(module) -> list:
    """The layers of ``module`` that calibrate: an int8 base run through the int8 kernels."""
    return [m for m in module.modules() if isinstance(m, FlexLinear) and m.q is not None and m.int8_compute != "none"]


def _unported(name: str, value) -> None:
    raise NotImplementedError(f"{name}={value!r} is not ported yet")


def _segment_columns(dataset, g_tok, query_column_name, passage_column_name, answer_column_name, sorted_idx,
                     query_max_len, passage_max_len, generator_max_len) -> tuple:
    """Tokenised segments for the marginal's on-device prompt assembly, as the reference splits the causal
    text ``#query# {q'} #passage# {p'} #answer# {a}`` (q' and p' pre-marked) at its segment boundaries.
    Returns (row columns, unique-passage segments (ids, lengths), marker length, pad id)."""
    lq_cap = query_max_len + 16
    lp_cap = passage_max_len + 16
    la_cap = max(32, generator_max_len - query_max_len - passage_max_len)
    q_marked = [f"#query# {q}" for q in dataset[query_column_name]]
    p_marked = [f"#passage# {p}" for p in dataset[passage_column_name]]
    tq = g_tok([f"#query# {m}" for m in q_marked], padding="max_length", max_length=lq_cap, truncation=True)
    ta = g_tok([f" #answer# {a}" for a in dataset[answer_column_name]], padding="max_length", max_length=la_cap,
               truncation=True)
    tp = g_tok([f" #passage# {p_marked[i]}" for i in sorted_idx], padding="max_length", max_length=lp_cap,
               truncation=True)
    cols = {
        "marg_q_ids": tq["input_ids"], "marg_q_len": [int(sum(m)) for m in tq["attention_mask"]],
        "marg_a_ids": ta["input_ids"], "marg_a_len": [int(sum(m)) for m in ta["attention_mask"]],
    }
    segs = (np.asarray(tp["input_ids"], np.int64), np.asarray([int(sum(m)) for m in tp["attention_mask"]], np.int64))
    marker_len = len(g_tok([" #answer#"], padding=False)["input_ids"][0])
    return cols, segs, marker_len, int(getattr(g_tok, "pad_token_id", 0) or 0)


def train_e2e(
    dataset_or_path: Union[str, ColumnDataset, dict],
    retriever_name_or_path: str,
    generator_name_or_path: str,
    passage_column_name: str = "Abstract",
    query_column_name: str = "Question",
    answer_column_name: str = "Answer",
    query_max_len: int = 50,
    passage_max_len: int = 128,
    generator_max_len: int = 256,
    per_device_train_batch_size: int = 32,
    learning_rate: float = 1e-4,
    logit_scale: int = 100,
    weight_decay: float = 0.0,
    num_train_epochs: int = 1,
    max_train_steps: Optional[int] = None,
    gradient_accumulation_steps: int = 1,
    lr_scheduler_type: str = "linear",
    num_warmup_steps: int = 100,
    output_dir: Optional[str] = None,
    seed: int = 42,
    hub_model_id: Optional[str] = None,  # accepted, unused (as in the reference)
    hub_token: Optional[str] = None,  # accepted, unused (as in the reference)
    checkpointing_steps: Optional[Union[int, str]] = None,
    resume_from_checkpoint: Optional[str] = None,
    with_tracking: bool = True,
    report_to: str = "all",
    sanity_test: bool = True,
    use_peft: Optional[Union[Mode, str]] = None,
    use_bnb: Optional[Union[Mode, str]] = None,
    retriever_is_autoregressive: bool = False,
    retriever_tokenizer: str = "byte",
    generator_tokenizer: str = "byte",
    dtype: Optional[str] = None,
    mesh: Optional[object] = None,
    model_parallel: int = 1,
    use_dropout: bool = False,
    local_negatives: bool = True,
    live_index: bool = False,
    index_refresh_slice: int = 256,
    live_negatives_k: int = 0,
    marginalize_k: int = 0,
    marginalize_mode: str = "token",
    marginalize_scale: Optional[float] = None,
    marginalize_warmup_steps: int = 0,
    contrastive_weight: float = 1.0,
    lora_runtime: str = "merge",  # "merge" | "fused"
    int8_compute: str = "none",  # "fwd" | "all": int8 kernels for the fused runtime's int8 frozen bases
    a8_calibrate_every: int = 16,
    a8_dy_calibrate: bool = False,
    export_peft: bool = False,
    profile_dir: Optional[str] = None,
    profile_start_step: int = 10,
    profile_num_steps: int = 5,
    device=None,
    setup_hook: Optional[Callable[[E2ESetup], None]] = None,
) -> dict:
    """Returns {"final_loss", "final_retriever_loss", "final_generator_loss",
    "steps", "samples_per_sec", "avg_step_time"}, and with ``live_index``
    "index_version" and "live_index" (the ``DenseIndex``, fully refreshed with
    the final weights)."""
    args = {k: v for k, v in locals().items() if v is None or isinstance(v, (float, int, str, bool))}
    peft_mode = Mode(use_peft) if use_peft is not None else None
    quant_mode = Mode(use_bnb) if use_bnb is not None else None

    for name, value, inert in (("mesh", mesh, None), ("model_parallel", model_parallel, 1)):
        if value != inert:
            _unported(name, value)
    if marginalize_mode not in ("token", "sequence"):
        raise ValueError(f"marginalize_mode must be 'token' or 'sequence', got {marginalize_mode!r}")
    if int8_compute not in ("none", "fwd", "all"):
        raise ValueError(f"int8_compute must be 'none', 'fwd' or 'all', got {int8_compute!r}")
    if live_negatives_k and not live_index:
        raise ValueError("live_negatives_k > 0 requires live_index=True")
    if marginalize_k and not live_index:
        raise ValueError("marginalize_k > 0 requires live_index=True")
    fused = lora_runtime == "fused"

    dev = resolve_device(device)
    global_batch = per_device_train_batch_size

    r_tok = resolve_tokenizer(retriever_tokenizer, add_eos_token=retriever_is_autoregressive)
    if retriever_is_autoregressive:
        r_tok.padding_side = "left"
    g_tok = resolve_tokenizer(generator_tokenizer)
    compute_dtype = parse_dtype(dtype) if dtype else None
    vocab_r = -(-r_tok.vocab_size // 128) * 128
    vocab_g = -(-g_tok.vocab_size // 128) * 128
    resolve_r = resolve_decoder if retriever_is_autoregressive else resolve_encoder
    r_cfg, r_state = resolve_r(retriever_name_or_path, dtype=compute_dtype, vocab_size=vocab_r)
    g_cfg, g_state = resolve_decoder(generator_name_or_path, dtype=compute_dtype, vocab_size=vocab_g)
    if int8_compute != "none":
        # Layers without int8 storage ignore the flag, so both configs may carry it.
        r_cfg = dataclasses.replace(r_cfg, int8_compute=int8_compute)
        g_cfg = dataclasses.replace(g_cfg, int8_compute=int8_compute)

    dataset = load_dataset(dataset_or_path)
    processed = dataset.map(lambda ex: preprocess_rag_e2e_dataset(
        ex, r_tok, g_tok, query_column_name, passage_column_name, answer_column_name,
        query_max_len, passage_max_len, generator_max_len))
    qpl = np.asarray(processed["query_passage_input_len"])
    n_empty = int((qpl >= generator_max_len).sum())
    if n_empty:
        logger.warning(
            "%d/%d rows have no answer tokens inside generator_max_len=%d (prefix length >= limit): the "
            "marginalized loss is inert for them", n_empty, len(qpl), generator_max_len)

    steps_per_epoch = math.ceil(num_batches_per_epoch(len(processed), global_batch) / gradient_accumulation_steps)
    if max_train_steps is None:
        max_train_steps = num_train_epochs * steps_per_epoch
    else:
        num_train_epochs = math.ceil(max_train_steps / steps_per_epoch)

    # ---- models: LoRA where use_peft says so (packed + factors, or merged), dense elsewhere ----
    resolved = {"retriever": r_state, "generator": g_state}
    peft_subs = [s for s in SUBS if peft_mode in (Mode.BOTH, Mode(s))]
    fused_subs = peft_subs if fused else []
    lazy = {s: (dev if not (s in fused_subs and resolved[s] is None) else torch.device("meta")) for s in SUBS}
    rag = RagE2EModel(r_cfg, g_cfg, retriever_is_autoregressive=retriever_is_autoregressive, device=lazy)
    lora_specs: Dict[str, lora_mod.LoraSpec] = {}
    quantized_subs: set = set()
    full_state: Dict[str, dict] = {}
    for i, sub in enumerate(SUBS):
        module = getattr(rag, sub)
        quant_on = quant_mode in (Mode.BOTH, Mode(sub))
        init_gen = torch.Generator(device=dev).manual_seed(seed + i)
        if sub in peft_subs:
            is_clm = sub == "generator" or retriever_is_autoregressive
            spec = lora_mod.LoraSpec.for_causal_lm() if is_clm else lora_mod.LoraSpec.for_encoder()
            lora_specs[sub] = spec
            if sub in fused_subs and resolved[sub] is None:
                # Random init straight into packed storage: no full-precision tree.
                qlora_mod.init_packed_on_device(module, init_gen, spec=spec, quantize=quant_on)
            elif sub in fused_subs:
                full_state[sub] = resolved[sub]
                module.load_state_dict(resolved[sub])
                qlora_mod.pack_module(module, quantize=quant_on)
                factor_gen = torch.Generator(device=dev).manual_seed(seed + (23 if sub == "retriever" else 29))
                qlora_mod.init_module_factors(module, spec, factor_gen)
            else:
                # The merge runtime: the base as loaded (int8 where use_bnb names it) + A @ B in every forward.
                if resolved[sub] is None:
                    module.reset_parameters(init_gen)
                else:
                    full_state[sub] = resolved[sub]
                    module.load_state_dict(resolved[sub])
                factor_gen = torch.Generator(device=dev).manual_seed(seed + (13 if sub == "retriever" else 17))
                factors = lora_mod.init_lora_params(factor_gen, unflatten(dict(module.state_dict())), spec)
                if quant_on:
                    qlora_mod.pack_module(module, quantize=True, min_size=qlora_mod.MERGE_MIN_SIZE)
                lora_mod.attach_merge_lora(module, factors, spec)
                del factors
            if quant_on:
                quantized_subs.add(sub)
            leaves = ("a", "b") if sub in fused_subs else ("lora_a", "lora_b")
            for name, p in module.named_parameters():
                p.requires_grad_(name.rpartition(".")[2] in leaves)
        else:
            if quant_on:
                logger.warning("use_bnb=%s on %s without use_peft: quantization applies to frozen bases "
                               "only; ignoring", use_bnb, sub)
            if resolved[sub] is None:
                module.reset_parameters(init_gen)
            else:
                module.load_state_dict(resolved[sub])
        module.train()

    trainable = {f"{sub}.{name}": p for sub in SUBS
                 for name, p in getattr(rag, sub).named_parameters() if p.requires_grad}
    optimizer = make_optimizer(
        trainable.values(), learning_rate=learning_rate, lr_scheduler_type=str(lr_scheduler_type),
        num_warmup_steps=num_warmup_steps, total_steps=max_train_steps, weight_decay=weight_decay,
        gradient_accumulation_steps=gradient_accumulation_steps)
    state = TrainState.create(trainable, optimizer)

    # ---- the live index (and the segments of the top-k marginal) ----
    refresher = None
    num_real = 0
    marg: Dict[str, torch.Tensor] = {}
    marker_len, pad_id = 0, 0
    if live_index:
        p_ids = np.asarray(processed["retriever_passage_input_ids"], np.int64)
        p_mask = np.asarray(processed["retriever_passage_attention_mask"], np.int64)
        # passages deduplicated by token content; each row's positive is its passage's rank in index order
        _, unique_idx, inverse = np.unique(p_ids, axis=0, return_index=True, return_inverse=True)
        sorted_idx = np.sort(unique_idx)
        rank = np.empty(len(unique_idx), np.int64)
        rank[np.argsort(unique_idx)] = np.arange(len(unique_idx))
        positive_index = rank[np.asarray(inverse).reshape(-1)]
        p_ids, p_mask = p_ids[sorted_idx], p_mask[sorted_idx]
        num_real = len(p_ids)
        extra_cols = {}
        if live_negatives_k or marginalize_k:
            extra_cols["positive_index"] = positive_index.tolist()
        if marginalize_k:
            seg_cols, (gp_ids, gp_len), marker_len, pad_id = _segment_columns(
                dataset, g_tok, query_column_name, passage_column_name, answer_column_name, sorted_idx,
                query_max_len, passage_max_len, generator_max_len)
            extra_cols.update(seg_cols)
            marg = {"retr_p_ids": torch.as_tensor(p_ids, device=dev), "retr_p_mask": torch.as_tensor(p_mask, device=dev),
                    "gen_p_ids": torch.as_tensor(gp_ids, device=dev), "gen_p_len": torch.as_tensor(gp_len, device=dev)}
        if extra_cols:
            processed = ColumnDataset({**processed.columns, **extra_cols})

        def index_embed(ids, mask):
            return rag.embed_with(torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)).float()

        live = DenseIndex(torch.zeros((num_real, r_cfg.hidden_size), dtype=torch.float32, device=dev))  # zero-seeded
        refresher = AsyncIndexRefresher(live, index_embed, p_ids, p_mask, slice_size=index_refresh_slice)
        logger.info("live index: %d unique passages, slice %d", num_real, index_refresh_slice)

    setup = E2ESetup(rag, state, processed, lora_specs, quantized_subs, full_state, dev, refresher)
    if setup_hook is not None:
        setup_hook(setup)

    # ---- the loss ----
    fused_branch = fused and bool(lora_specs)
    # The reference's dropout: the encoder's, in its merge / dense branch only, where the retriever has a rate.
    dropout_on = use_dropout and getattr(r_cfg, "hidden_dropout", 0.0) > 0 and not fused_branch
    drop_gen = torch.Generator(device=dev)
    marg_scale = float(logit_scale if marginalize_scale is None else marginalize_scale)

    def hard_negative_logits(q_emb, index_embs, positive):
        scores = masked_index_scores(q_emb, index_embs, positive, num_real, scale=float(logit_scale))
        k = min(int(live_negatives_k), max(num_real - 1, 1))
        return stable_topk(scores, k)[0]

    def marginal_gen_loss(q_emb, batch, index_embs):
        pos = batch["positive_index"]
        k_extra = min(int(marginalize_k) - 1, max(num_real - 1, 0))
        if k_extra > 0:
            with torch.no_grad():  # selection only: stale index rows, no gradient through the choice
                sel = stable_topk(masked_index_scores(q_emb.detach(), index_embs, pos, num_real), k_extra)[1]
            cand = torch.cat([pos[:, None], sel], dim=1)
        else:
            cand = pos[:, None]
        B, K = cand.shape
        flat = cand.reshape(-1)
        z = rag.embed_with(marg["retr_p_ids"][flat], marg["retr_p_mask"][flat]).reshape(B, K, -1).float()
        with _no_tf32():
            s = torch.einsum("bd,bkd->bk", q_emb.float(), z) * marg_scale
        ids, attn, boundary = mtk.assemble_generator_inputs(
            batch["marg_q_ids"], batch["marg_q_len"], marg["gen_p_ids"][cand], marg["gen_p_len"][cand],
            batch["marg_a_ids"], batch["marg_a_len"], pad_id=pad_id)
        L = ids.shape[2]
        logits = rag.logits_with(ids.reshape(B * K, L), attn.reshape(B * K, L))
        logits = logits.reshape(B, K, L, -1)
        if marginalize_mode == "token":
            A = batch["marg_a_ids"].shape[1]
            ll_tok = mtk.aligned_answer_token_loglik(logits, ids, attn, boundary, marker_len, A)
            valid = mtk.answer_token_mask(batch["marg_a_len"], marker_len, A)
            return mtk.topk_marginal_token_loss(s, ll_tok, valid)
        ll, n = mtk.answer_loglik(logits, ids, attn, boundary, marker_len)
        return mtk.topk_marginal_loss(s, ll, n)

    def loss_fn(batch, index_embs, use_marg):
        gen = drop_gen if dropout_on else None
        q_emb = rag.embed_with(batch["retriever_query_input_ids"], batch["retriever_query_attention_mask"], gen)
        p_emb = rag.embed_with(batch["retriever_passage_input_ids"], batch["retriever_passage_attention_mask"], gen)
        extra = (hard_negative_logits(q_emb, index_embs, batch["positive_index"])
                 if (index_embs is not None and live_negatives_k) else None)
        retriever_loss, sim = contrastive_loss(q_emb.float(), p_emb.float(), float(logit_scale),
                                               extra_negative_logits=extra)
        if marginalize_k and use_marg:
            gen_loss = marginal_gen_loss(q_emb, batch, index_embs)
        else:
            logits = rag.logits_with(batch["generator_input_input_ids"], batch["generator_input_attention_mask"])
            gen_loss = marginalized_nll_loss(
                logits, batch["generator_input_input_ids"], batch["generator_input_attention_mask"],
                sim, batch["query_passage_input_len"])
        return float(contrastive_weight) * retriever_loss + gen_loss, retriever_loss, gen_loss

    # ---- calibrated W8A8 activation scales (a8_calibrate_every) and dy scales (a8_dy_calibrate) ----
    a8_cal_subs = sorted(quantized_subs & set(lora_specs)) if (
        a8_calibrate_every and fused and int8_compute != "none") else []
    sites = {sub: cal_sites(getattr(rag, sub)) for sub in a8_cal_subs}
    dy_probe = bool(a8_cal_subs) and a8_dy_calibrate
    if dy_probe:
        if int8_compute != "all":
            raise ValueError("a8_dy_calibrate requires int8_compute='all' (int8 backward)")
        if gradient_accumulation_steps != 1:
            raise ValueError("a8_dy_calibrate requires gradient_accumulation_steps=1: the out-of-band amax "
                             "channel would be summed across microsteps")

    @torch.no_grad()
    def recalibrate(batch):
        """A forward-only pass with the activation scales stripped (dynamic per-row quant), recording every
        calibrating layer's max |x|; the scales become max(amax / 127, 1e-8). The retriever's layers see the
        query and the passage calls, the generator's its own forward."""
        every = [m for sub in a8_cal_subs for m in sites[sub]]
        held = [m.a_scale for m in every]
        for m in every:
            m.a_scale, m.amax, m.record_amax = None, None, True
        try:
            if "retriever" in a8_cal_subs:
                rag.embed_with(batch["retriever_query_input_ids"], batch["retriever_query_attention_mask"])
                rag.embed_with(batch["retriever_passage_input_ids"], batch["retriever_passage_attention_mask"])
            if "generator" in a8_cal_subs:
                rag.logits_with(batch["generator_input_input_ids"], batch["generator_input_attention_mask"])
        finally:
            for m, old in zip(every, held):
                m.record_amax = False
                m.a_scale = (old if m.amax is None else
                             torch.clamp(m.amax / torch.full_like(m.amax, 127.0), min=1e-8))
                m.amax = None

    def probe_begin():
        for sub in a8_cal_subs:
            for m in sites[sub]:
                m.a_scale.requires_grad_(True)

    def probe_end():
        """Each site's dy scale from its activation scale's gradient (the sum over a step's uses of the site)."""
        for sub in a8_cal_subs:
            for m in sites[sub]:
                g = m.a_scale.grad if m.a_scale.grad is not None else torch.zeros_like(m.a_scale)
                m.dy_scale = torch.clamp(g.detach(), min=1e-8)
                m.a_scale.grad = None
                m.a_scale.requires_grad_(False)

    tracker = MetricsLogger(output_dir, project_name="rag_e2e_training", config=args,
                            report_to=report_to, enabled=with_tracking)
    timer = WindowedThroughput()
    profiler = Profiler(profile_dir, profile_start_step, profile_num_steps)

    start_epoch, skip_batches, completed_steps = 0, 0, 0
    micro_steps, start_steps = 0, 0
    if resume_from_checkpoint:
        path = (resume_from_checkpoint
                if isinstance(resume_from_checkpoint, str) and os.path.isdir(str(resume_from_checkpoint))
                else ckpt.latest_checkpoint(output_dir or "."))
        if path:
            state.load_state_dict(ckpt.load_state(path))
            kind, num = ckpt.parse_checkpoint_tag(path)
            if kind == "epoch":
                start_epoch = num + 1
                completed_steps = start_epoch * steps_per_epoch
            else:
                completed_steps = num
                start_epoch = completed_steps // steps_per_epoch
                skip_batches = (completed_steps % steps_per_epoch) * gradient_accumulation_steps
            start_steps = completed_steps
            logger.info("resumed from %s (epoch %d, step %d)", path, start_epoch, completed_steps)

    batch_columns = BATCH_COLUMNS + (("positive_index",) if (live_negatives_k or marginalize_k) else ()) + (
        MARG_COLUMNS if marginalize_k else ())
    checkpoint_every = int(checkpointing_steps) if str(checkpointing_steps).isdigit() else None
    # Losses stay on the device between logging points: a read-back every
    # step would serialise the host with the card.
    final = {"loss": float("nan"), "retriever": float("nan"), "generator": float("nan")}
    last = None

    def read_last():
        if last is not None:
            vals = [float(v) for v in last]  # the synchronisation point
            return {"loss": vals[0], "retriever": vals[1], "generator": vals[2]}
        return final

    for epoch in range(start_epoch, num_train_epochs):
        # Seeded per (seed, epoch), not drawn from a shared stream, so a
        # resumed run shuffles epoch e as the uninterrupted run would have.
        epoch_rng = np.random.default_rng([seed, epoch])
        loss_sum, n_in_epoch = None, 0
        timer.mark(completed_steps)
        for batch_np in epoch_batches(processed, batch_columns, global_batch, rng=epoch_rng,
                                      skip_batches=skip_batches):
            batch = {k: torch.as_tensor(np.asarray(v, np.int64), device=dev) for k, v in batch_np.items()}
            # dy calibration adds a refresh at micro step 1, as the reference does
            if a8_cal_subs and (micro_steps % max(1, int(a8_calibrate_every) * gradient_accumulation_steps) == 0
                                or (dy_probe and micro_steps == 1)):
                recalibrate(batch)
            # keyed per micro step, as the reference folds its dropout key
            drop_gen.manual_seed(((int(seed) & 0x7FFFFFFF) << 32)
                                 | (start_steps * gradient_accumulation_steps + micro_steps))
            profiler.maybe_start(completed_steps)
            index_embs = refresher.index.embeddings if (live_negatives_k or marginalize_k) else None
            in_warmup = bool(marginalize_k and marginalize_warmup_steps) and completed_steps < marginalize_warmup_steps
            probing = dy_probe and not in_warmup  # every step outside the warm-up, so dy scales are one step stale
            if probing:
                probe_begin()
            loss, r_loss, g_loss = loss_fn(batch, index_embs, not in_warmup)
            loss.backward()
            if probing:
                probe_end()
            state.apply_gradients()
            if refresher is not None:
                refresher.tick()
            last = (loss.detach(), r_loss.detach(), g_loss.detach())
            loss_sum = last[0] if loss_sum is None else loss_sum + last[0]
            n_in_epoch += 1
            micro_steps += 1
            completed_steps = start_steps + micro_steps // gradient_accumulation_steps
            profiler.maybe_stop(completed_steps)

            stepped = micro_steps % gradient_accumulation_steps == 0
            if stepped and completed_steps % 100 == 0:
                final = read_last()
                timer.mark(completed_steps)
                logger.info("epoch %d step %d loss %.4f", epoch, completed_steps, final["loss"])
                tracker.log({
                    "train/loss": final["loss"],
                    "train/retriever_contrastive_loss": final["retriever"],
                    "train/generator_marginalized_loss": final["generator"],
                }, step=completed_steps)
            if stepped and checkpoint_every and completed_steps % checkpoint_every == 0 and output_dir:
                ckpt.save_state(output_dir, f"step_{completed_steps}", state.state_dict())
                ckpt.prune_checkpoints(output_dir, keep_last=3)
                timer.mark(completed_steps)  # keep checkpoint I/O out of the throughput windows
            if completed_steps >= max_train_steps:
                break
        skip_batches = 0
        epoch_loss = float(loss_sum) / n_in_epoch if n_in_epoch else float("nan")
        final = read_last()
        timer.mark(completed_steps)
        tracker.log({"train/epoch_loss": epoch_loss, "epoch": epoch}, step=completed_steps)
        if checkpointing_steps == "epoch" and output_dir:
            ckpt.save_state(output_dir, f"epoch_{epoch}", state.state_dict())
        if completed_steps >= max_train_steps:
            break
    final = read_last()

    if output_dir:
        # Split save: {output_dir}/retriever and {output_dir}/generator. A
        # LoRA-adapted sub-model saves its base plus its adapter: the fused
        # runtime the pre-pack weights where it was loaded from a directory,
        # else the packed storage dequantised; the merge runtime its frozen
        # base as it trained on it (int8 where quantised). A dense one saves
        # its trained weights.
        for sub, cfg, tok_name, name in (("retriever", r_cfg, retriever_tokenizer, retriever_name_or_path),
                                         ("generator", g_cfg, generator_tokenizer, generator_name_or_path)):
            sub_dir = os.path.join(output_dir, sub)
            module = getattr(rag, sub)
            if sub in fused_subs:
                residual, quant, lora_tree = qlora_mod.split_state(module)
                base = full_state.get(sub) or flatten(qlora_mod.unpack_to_params(residual, quant))
                flat = qlora_mod.factors_to_flat(lora_tree, lora_specs[sub])
            elif sub in lora_specs:
                base = {k: v for k, v in module.state_dict().items()
                        if k.rpartition(".")[2] not in ("lora_a", "lora_b")}
                flat = lora_mod.merge_lora_params(module)
            else:
                save_pretrained(sub_dir, cfg, module.state_dict(), extra={"tokenizer": tok_name})
                continue
            save_pretrained(sub_dir, cfg, base, extra={"tokenizer": tok_name})
            lora_mod.save_adapter(sub_dir, flat, lora_specs[sub])
            if export_peft:
                export_peft_if_supported(sub_dir, flat, lora_specs[sub], cfg, name)
    profiler.close()
    tracker.close()
    result = {
        "final_loss": final["loss"],
        "final_retriever_loss": final["retriever"],
        "final_generator_loss": final["generator"],
        "steps": completed_steps,
        "samples_per_sec": timer.samples_per_sec(global_batch),
        "avg_step_time": timer.avg,
    }
    if refresher is not None:
        with torch.no_grad():
            refresher.refresh_fully()  # finish the sweep: the index reflects the final weights
        result["index_version"] = refresher.version
        result["live_index"] = refresher.index
    return result
