"""Retriever-only contrastive training with in-batch negatives (counterpart of
``dalm_tpu/train/retriever_only.py:55-374 train_retriever``).

Queries and passages go through one encoder (bge / BERT class), mean-pooled
and L2-normalised, or with ``is_autoregressive`` one decoder, EOS-pooled (its
tokenizer adds EOS and pads on the left); the loss is the symmetric NT-Xent over the batch,
``(CE(S) + CE(S^T)) / 2`` with ``S = Q @ P^T * logit_scale``. ``use_peft``
trains LoRA factors only (r 8, alpha 16 on query / key / value; on q_proj /
v_proj for a decoder) in the merge runtime: every forward forms ``W + (A @ B) * alpha / r`` over the frozen base,
int8 where ``use_bnb`` says so (``quant.quantize_params``' rule: 2-D kernels of
at least 1024 values). ``use_dropout`` (default True, as in the reference)
turns on the encoder's dropout (a decoder has none), one stream for the queries and another for
the passages, and the scale-preserving dropout on ``A``; all are drawn from
generators seeded per micro step. Resume and ``step_k`` / ``epoch_e``
checkpoints as ``train_e2e``; the final artifacts go to
``{output_dir}/retriever``: the base plus the adapter files (and a PEFT
layout copy with ``export_peft``), or the trained weights without LoRA.

Differences from the reference that a caller sees: one process, one device
(``device``, default the CUDA card; ``"cpu"`` for tests), so
``local_negatives`` is inert; datasets are CSV / JSON / JSON-lines files or
columns; ``torch.save`` checkpoints; dropout masks from the port's
generators; ``setup_hook`` gets the :class:`RetrieverSetup` before the first
step. ``mesh`` and ``model_parallel > 1`` are not ported yet and raise
``NotImplementedError`` naming the knob.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Callable, Optional, Union

import numpy as np
import torch

from dalm_tpu_torch.core.dtypes import parse_dtype
from dalm_tpu_torch.core.profiling import Profiler
from dalm_tpu_torch.core.tree import unflatten
from dalm_tpu_torch.data.loading import ColumnDataset, load_dataset
from dalm_tpu_torch.data.preprocess import preprocess_retriever_dataset
from dalm_tpu_torch.data.tokenizer import resolve_tokenizer
from dalm_tpu_torch.device import resolve_device
from dalm_tpu_torch.losses.contrastive import contrastive_loss
from dalm_tpu_torch.models import lora as lora_mod
from dalm_tpu_torch.models import qlora as qlora_mod
from dalm_tpu_torch.models.decoder import Decoder
from dalm_tpu_torch.models.encoder import Encoder
from dalm_tpu_torch.models.hf_loader import export_peft_if_supported
from dalm_tpu_torch.models.pooling import eos_pool, mean_pool_l2
from dalm_tpu_torch.models.registry import resolve_decoder, resolve_encoder, save_pretrained
from dalm_tpu_torch.train import checkpoints as ckpt
from dalm_tpu_torch.train.data_iter import epoch_batches, num_batches_per_epoch
from dalm_tpu_torch.train.metrics import MetricsLogger, WindowedThroughput
from dalm_tpu_torch.train.optim import make_optimizer
from dalm_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)

BATCH_COLUMNS = ("query_input_ids", "query_attention_mask", "passage_input_ids", "passage_attention_mask")
LORA_LEAVES = ("lora_a", "lora_b")


@dataclasses.dataclass
class RetrieverSetup:
    """Everything ``train_retriever`` builds before its first step."""

    model: Union[Encoder, Decoder]
    state: TrainState
    lora_spec: Optional[lora_mod.LoraSpec]
    processed: ColumnDataset
    device: torch.device


def _stream_seed(seed: int, micro_step: int, stream: int) -> int:
    """The seed of one dropout stream (0: queries, 1: passages, 99: the factors) of one micro step."""
    return ((int(seed) & 0xFFFFFF) << 40) | ((int(micro_step) & 0xFFFFFFFF) << 8) | stream


def train_retriever(
    retriever_name_or_path: str,
    dataset_or_path: Union[str, ColumnDataset, dict],
    passage_column_name: str = "Abstract",
    query_column_name: str = "Question",
    query_max_len: int = 50,
    passage_max_len: int = 128,
    per_device_train_batch_size: int = 32,
    learning_rate: float = 1e-4,
    logit_scale: int = 100,
    weight_decay: float = 0.0,
    num_train_epochs: int = 1,
    max_train_steps: Optional[int] = None,
    gradient_accumulation_steps: int = 1,
    lr_scheduler_type: str = "linear",
    num_warmup_steps: int = 0,
    output_dir: Optional[str] = None,
    seed: int = 42,
    hub_model_id: Optional[str] = None,  # accepted, unused (as in the reference)
    hub_token: Optional[str] = None,  # accepted, unused (as in the reference)
    checkpointing_steps: Optional[Union[int, str]] = None,
    resume_from_checkpoint: Optional[str] = None,
    with_tracking: bool = True,
    report_to: str = "all",
    sanity_test: bool = True,
    use_peft: bool = False,
    use_bnb: bool = False,
    is_autoregressive: bool = False,
    tokenizer: str = "byte",
    dtype: Optional[str] = None,
    mesh: Optional[object] = None,
    model_parallel: int = 1,
    use_dropout: bool = True,
    local_negatives: bool = True,
    export_peft: bool = False,
    profile_dir: Optional[str] = None,
    profile_start_step: int = 10,
    profile_num_steps: int = 5,
    device=None,
    setup_hook: Optional[Callable[[RetrieverSetup], None]] = None,
) -> dict:
    """Returns {"final_loss", "steps", "samples_per_sec", "avg_step_time"}."""
    args = {k: v for k, v in locals().items() if v is None or isinstance(v, (float, int, str, bool))}
    for name, value, inert in (("mesh", mesh, None), ("model_parallel", model_parallel, 1)):
        if value != inert:
            raise NotImplementedError(f"{name}={value!r} is not ported yet")

    dev = resolve_device(device)
    global_batch = per_device_train_batch_size
    tok = resolve_tokenizer(tokenizer, add_eos_token=is_autoregressive)
    if is_autoregressive:
        tok.padding_side = "left"
    compute_dtype = parse_dtype(dtype) if dtype else None
    resolve = resolve_decoder if is_autoregressive else resolve_encoder
    cfg, init_state = resolve(retriever_name_or_path, dtype=compute_dtype, vocab_size=-(-tok.vocab_size // 128) * 128)

    dataset = load_dataset(dataset_or_path)
    processed = dataset.map(lambda ex: preprocess_retriever_dataset(
        ex, tok, query_column_name, passage_column_name, query_max_len, passage_max_len))
    if sanity_test:
        for i in range(min(2, len(processed))):
            assert len(processed["query_input_ids"][i]) == query_max_len
            assert len(processed["passage_input_ids"][i]) == passage_max_len

    steps_per_epoch = math.ceil(num_batches_per_epoch(len(processed), global_batch) / gradient_accumulation_steps)
    if max_train_steps is None:
        max_train_steps = num_train_epochs * steps_per_epoch
    else:
        num_train_epochs = math.ceil(max_train_steps / steps_per_epoch)

    model = (Decoder if is_autoregressive else Encoder)(cfg, device=dev)
    if init_state is None:
        model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    else:
        model.load_state_dict(init_state)
    lora_spec = None
    if use_peft:
        lora_spec = lora_mod.LoraSpec.for_causal_lm() if is_autoregressive else lora_mod.LoraSpec.for_encoder()
        factors = lora_mod.init_lora_params(torch.Generator(device=dev).manual_seed(seed + 7),
                                            unflatten(dict(model.state_dict())), lora_spec)
        if use_bnb:
            qlora_mod.pack_module(model, quantize=True, min_size=qlora_mod.MERGE_MIN_SIZE)
        lora_mod.attach_merge_lora(model, factors, lora_spec)
        del factors
        for name, p in model.named_parameters():
            p.requires_grad_(name.rpartition(".")[2] in LORA_LEAVES)
    elif use_bnb:
        logger.warning("use_bnb without use_peft is ignored (quantized weights are frozen)")
    model.train()
    trainable = {name: p for name, p in model.named_parameters() if p.requires_grad}
    optimizer = make_optimizer(
        trainable.values(), learning_rate=learning_rate, lr_scheduler_type=str(lr_scheduler_type),
        num_warmup_steps=num_warmup_steps, total_steps=max_train_steps, weight_decay=weight_decay,
        gradient_accumulation_steps=gradient_accumulation_steps)
    state = TrainState.create(trainable, optimizer)
    if setup_hook is not None:
        setup_hook(RetrieverSetup(model, state, lora_spec, processed, dev))

    dropout = use_dropout and getattr(cfg, "hidden_dropout", 0.0) > 0
    q_gen, p_gen = torch.Generator(device=dev), torch.Generator(device=dev)

    def embed(ids, mask, gen):
        if is_autoregressive:
            return eos_pool(model.train_forward(ids, mask, return_hidden=True), mask)
        return mean_pool_l2(model(ids, mask, dropout_generator=gen), mask)

    def loss_fn(batch, micro_step):
        if dropout:
            q_gen.manual_seed(_stream_seed(seed, micro_step, 0))
            p_gen.manual_seed(_stream_seed(seed, micro_step, 1))
        if lora_spec is not None:
            lora_mod.set_merge_dropout(model, lora_spec, _stream_seed(seed, micro_step, 99) if dropout else None)
        q = embed(batch["query_input_ids"], batch["query_attention_mask"], q_gen if dropout else None)
        p = embed(batch["passage_input_ids"], batch["passage_attention_mask"], p_gen if dropout else None)
        return contrastive_loss(q.float(), p.float(), float(logit_scale))[0]

    tracker = MetricsLogger(output_dir, project_name="peft_contrastive_training", config=args,
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

    checkpoint_every = int(checkpointing_steps) if str(checkpointing_steps).isdigit() else None
    # The loss stays on the device between logging points: a read-back every
    # step would serialise the host with the card.
    final_loss = float("nan")
    last = None
    for epoch in range(start_epoch, num_train_epochs):
        epoch_rng = np.random.default_rng([seed, epoch])  # per (seed, epoch): a resumed run shuffles alike
        loss_sum, n_in_epoch = None, 0
        timer.mark(completed_steps)
        for batch_np in epoch_batches(processed, BATCH_COLUMNS, global_batch, rng=epoch_rng,
                                      skip_batches=skip_batches):
            batch = {k: torch.as_tensor(np.asarray(v, np.int64), device=dev) for k, v in batch_np.items()}
            profiler.maybe_start(completed_steps)
            loss = loss_fn(batch, start_steps * gradient_accumulation_steps + micro_steps)
            loss.backward()
            state.apply_gradients()
            last = loss.detach()
            loss_sum = last if loss_sum is None else loss_sum + last
            n_in_epoch += 1
            micro_steps += 1
            completed_steps = start_steps + micro_steps // gradient_accumulation_steps
            profiler.maybe_stop(completed_steps)

            stepped = micro_steps % gradient_accumulation_steps == 0
            if stepped and completed_steps % 100 == 0:
                final_loss = float(last)  # the synchronisation point
                timer.mark(completed_steps)
                logger.info("epoch %d step %d loss %.4f", epoch, completed_steps, final_loss)
                tracker.log({"train/loss": final_loss}, step=completed_steps)
            if stepped and checkpoint_every and completed_steps % checkpoint_every == 0 and output_dir:
                ckpt.save_state(output_dir, f"step_{completed_steps}", state.state_dict())
                ckpt.prune_checkpoints(output_dir, keep_last=3)
                timer.mark(completed_steps)  # keep checkpoint I/O out of the throughput windows
            if completed_steps >= max_train_steps:
                break
        skip_batches = 0
        epoch_loss = float(loss_sum) / n_in_epoch if n_in_epoch else float("nan")
        if last is not None:
            final_loss = float(last)
        timer.mark(completed_steps)
        tracker.log({"train/epoch_loss": epoch_loss, "epoch": epoch}, step=completed_steps)
        if checkpointing_steps == "epoch" and output_dir:
            ckpt.save_state(output_dir, f"epoch_{epoch}", state.state_dict())
        if completed_steps >= max_train_steps:
            break
    if lora_spec is not None:
        lora_mod.set_merge_dropout(model, lora_spec, None)

    if output_dir:
        retriever_dir = os.path.join(output_dir, "retriever")
        extra = {"tokenizer": tokenizer, "is_autoregressive": is_autoregressive}
        if lora_spec is not None:
            base = {k: v for k, v in model.state_dict().items() if k.rpartition(".")[2] not in LORA_LEAVES}
            flat = lora_mod.merge_lora_params(model)
            save_pretrained(retriever_dir, cfg, base, extra=extra)
            lora_mod.save_adapter(retriever_dir, flat, lora_spec)
            if export_peft:
                export_peft_if_supported(retriever_dir, flat, lora_spec, cfg, retriever_name_or_path)
        else:
            save_pretrained(retriever_dir, cfg, model.state_dict(), extra=extra)
    profiler.close()
    tracker.close()
    return {
        "final_loss": final_loss,
        "steps": completed_steps,
        "samples_per_sec": timer.samples_per_sec(global_batch),
        "avg_step_time": timer.avg,
    }
