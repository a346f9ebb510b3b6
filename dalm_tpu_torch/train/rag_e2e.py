"""RAG-end2end joint training (counterpart of ``dalm_tpu/train/rag_e2e.py``,
the fused-QLoRA branch of its ``loss_fn`` and its step, loop and split save).

Retriever and generator train jointly with ``loss = contrastive_weight *
symmetric NT-Xent + marginalised causal CE``; the marginalisation uses the
positive (diagonal) passage score. Sub-models named by ``use_peft`` keep a
frozen packed base (int8 where ``use_bnb`` names them too, else bf16) and
train only their LoRA factors (``lora_runtime="fused"``); the others train
densely. With ``int8_compute`` "fwd" or "all" the int8 bases run through the
hand-written int8 kernels (``kernels/int8_matmul.py``), activations
quantised dynamically per row.

Differences from the reference that a caller sees:

- one process, one device (``device``, default the CUDA card; ``"cpu"`` for
  tests); ``local_negatives`` is therefore inert;
- datasets are CSV / JSON / JSON-lines files or columns (``data/loading.py``);
- checkpoints and artifacts are ``torch.save`` files;
- ``a8_calibrate_every`` defaults to 0 (dynamic per-row activation quant):
  the calibrated scales are not ported yet;
- ``setup_hook``, called with the :class:`E2ESetup` after the models, the
  optimiser and the data are ready and before the first step, lets a caller
  set initial weights or factors.

Knobs of paths that are not ported yet raise ``NotImplementedError`` naming
the knob: ``lora_runtime="merge"`` (with ``use_peft``), ``live_index``,
``live_negatives_k``, ``marginalize_k``, ``a8_calibrate_every > 0``,
``a8_dy_calibrate``, ``export_peft``, ``mesh``, ``model_parallel > 1``,
``retriever_is_autoregressive``, ``profile_dir``, ``use_dropout``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from dalm_tpu_torch.core.dtypes import parse_dtype
from dalm_tpu_torch.core.tree import flatten
from dalm_tpu_torch.data.loading import ColumnDataset, load_dataset
from dalm_tpu_torch.data.preprocess import preprocess_rag_e2e_dataset
from dalm_tpu_torch.data.tokenizer import resolve_tokenizer
from dalm_tpu_torch.device import resolve_device
from dalm_tpu_torch.losses.contrastive import contrastive_loss
from dalm_tpu_torch.losses.marginalized import marginalized_nll_loss
from dalm_tpu_torch.models import lora as lora_mod
from dalm_tpu_torch.models import qlora as qlora_mod
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


def _unported(name: str, value) -> None:
    raise NotImplementedError(f"{name}={value!r} is not ported yet")


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
    lora_runtime: str = "merge",  # "fused" is the ported runtime; "merge" raises with use_peft
    int8_compute: str = "none",  # "fwd" | "all": int8 kernels for the int8 frozen bases
    a8_calibrate_every: int = 0,
    a8_dy_calibrate: bool = False,
    export_peft: bool = False,
    profile_dir: Optional[str] = None,
    profile_start_step: int = 10,
    profile_num_steps: int = 5,
    device=None,
    setup_hook: Optional[Callable[[E2ESetup], None]] = None,
) -> dict:
    """Returns {"final_loss", "final_retriever_loss", "final_generator_loss",
    "steps", "samples_per_sec", "avg_step_time"}."""
    args = {k: v for k, v in locals().items() if v is None or isinstance(v, (float, int, str, bool))}
    peft_mode = Mode(use_peft) if use_peft is not None else None
    quant_mode = Mode(use_bnb) if use_bnb is not None else None

    for name, value, inert in (
        ("live_index", live_index, False), ("live_negatives_k", live_negatives_k, 0),
        ("marginalize_k", marginalize_k, 0), ("a8_calibrate_every", a8_calibrate_every, 0),
        ("a8_dy_calibrate", a8_dy_calibrate, False), ("export_peft", export_peft, False),
        ("mesh", mesh, None), ("model_parallel", model_parallel, 1),
        ("retriever_is_autoregressive", retriever_is_autoregressive, False),
        ("profile_dir", profile_dir, None), ("use_dropout", use_dropout, False),
    ):
        if value != inert:
            _unported(name, value)
    if peft_mode is not None and lora_runtime != "fused":
        _unported("lora_runtime", lora_runtime)
    if marginalize_mode not in ("token", "sequence"):
        raise ValueError(f"marginalize_mode must be 'token' or 'sequence', got {marginalize_mode!r}")
    if int8_compute not in ("none", "fwd", "all"):
        raise ValueError(f"int8_compute must be 'none', 'fwd' or 'all', got {int8_compute!r}")

    dev = resolve_device(device)
    global_batch = per_device_train_batch_size

    r_tok = resolve_tokenizer(retriever_tokenizer)
    g_tok = resolve_tokenizer(generator_tokenizer)
    compute_dtype = parse_dtype(dtype) if dtype else None
    vocab_r = -(-r_tok.vocab_size // 128) * 128
    vocab_g = -(-g_tok.vocab_size // 128) * 128
    r_cfg, r_state = resolve_encoder(retriever_name_or_path, dtype=compute_dtype, vocab_size=vocab_r)
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

    # ---- models: packed + factors where use_peft says so, dense elsewhere ----
    resolved = {"retriever": r_state, "generator": g_state}
    fused_subs = [s for s in SUBS if peft_mode in (Mode.BOTH, Mode(s))]
    lazy = {s: (dev if not (s in fused_subs and resolved[s] is None) else torch.device("meta")) for s in SUBS}
    rag = RagE2EModel(r_cfg, g_cfg, device=lazy)
    lora_specs: Dict[str, lora_mod.LoraSpec] = {}
    quantized_subs: set = set()
    full_state: Dict[str, dict] = {}
    for i, sub in enumerate(SUBS):
        module = getattr(rag, sub)
        quant_on = quant_mode in (Mode.BOTH, Mode(sub))
        init_gen = torch.Generator(device=dev).manual_seed(seed + i)
        if sub in fused_subs:
            spec = lora_mod.LoraSpec.for_causal_lm() if sub == "generator" else lora_mod.LoraSpec.for_encoder()
            lora_specs[sub] = spec
            if resolved[sub] is None:
                # Random init straight into packed storage: no full-precision tree.
                qlora_mod.init_packed_on_device(module, init_gen, spec=spec, quantize=quant_on)
            else:
                full_state[sub] = resolved[sub]
                module.load_state_dict(resolved[sub])
                qlora_mod.pack_module(module, quantize=quant_on)
                factor_gen = torch.Generator(device=dev).manual_seed(seed + (23 if sub == "retriever" else 29))
                qlora_mod.init_module_factors(module, spec, factor_gen)
            if quant_on:
                quantized_subs.add(sub)
            for name, p in module.named_parameters():
                p.requires_grad_(name.rpartition(".")[2] in ("a", "b"))
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
    setup = E2ESetup(rag, state, processed, lora_specs, quantized_subs, full_state, dev)
    if setup_hook is not None:
        setup_hook(setup)

    def loss_fn(batch):
        q_emb = rag.embed_with(batch["retriever_query_input_ids"], batch["retriever_query_attention_mask"])
        p_emb = rag.embed_with(batch["retriever_passage_input_ids"], batch["retriever_passage_attention_mask"])
        retriever_loss, sim = contrastive_loss(q_emb.float(), p_emb.float(), float(logit_scale))
        logits = rag.logits_with(batch["generator_input_input_ids"], batch["generator_input_attention_mask"])
        gen_loss = marginalized_nll_loss(
            logits, batch["generator_input_input_ids"], batch["generator_input_attention_mask"],
            sim, batch["query_passage_input_len"])
        return float(contrastive_weight) * retriever_loss + gen_loss, retriever_loss, gen_loss

    tracker = MetricsLogger(output_dir, project_name="rag_e2e_training", config=args,
                            report_to=report_to, enabled=with_tracking)
    timer = WindowedThroughput()

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
        for batch_np in epoch_batches(processed, BATCH_COLUMNS, global_batch, rng=epoch_rng,
                                      skip_batches=skip_batches):
            batch = {k: torch.as_tensor(np.asarray(v, np.int64), device=dev) for k, v in batch_np.items()}
            loss, r_loss, g_loss = loss_fn(batch)
            loss.backward()
            state.apply_gradients()
            last = (loss.detach(), r_loss.detach(), g_loss.detach())
            loss_sum = last[0] if loss_sum is None else loss_sum + last[0]
            n_in_epoch += 1
            micro_steps += 1
            completed_steps = start_steps + micro_steps // gradient_accumulation_steps

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
        # LoRA-adapted sub-model saves its full base (the pre-pack weights
        # where it was loaded from a directory, else the packed storage
        # dequantised) plus its adapter; a dense one its trained weights.
        for sub, cfg, tok_name in (("retriever", r_cfg, retriever_tokenizer),
                                   ("generator", g_cfg, generator_tokenizer)):
            sub_dir = os.path.join(output_dir, sub)
            module = getattr(rag, sub)
            if sub in lora_specs:
                residual, quant, lora_tree = qlora_mod.split_state(module)
                base = full_state.get(sub) or flatten(qlora_mod.unpack_to_params(residual, quant))
                save_pretrained(sub_dir, cfg, base, extra={"tokenizer": tok_name})
                lora_mod.save_adapter(sub_dir, qlora_mod.factors_to_flat(lora_tree, lora_specs[sub]), lora_specs[sub])
            else:
                save_pretrained(sub_dir, cfg, module.state_dict(), extra={"tokenizer": tok_name})
    tracker.close()
    return {
        "final_loss": final["loss"],
        "final_retriever_loss": final["retriever"],
        "final_generator_loss": final["generator"],
        "steps": completed_steps,
        "samples_per_sec": timer.samples_per_sec(global_batch),
        "avg_step_time": timer.avg,
    }
