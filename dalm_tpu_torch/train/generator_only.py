"""Generator-only supervised fine-tuning (counterpart of
``dalm_tpu/train/generator_only.py:59 train_generator``).

- chatml formatting of ``messages`` rows and EOS-joined packing into fixed
  ``seq_length`` blocks (``packing=True``), or one right-padded sample per row
  with the loss masked to real tokens (``packing=False``);
- NEFTune noise on the embeddings (alpha 5 by default), keyed per step;
- LoRA r = 256, alpha = 512 on ``q_proj`` / ``v_proj`` over a frozen base in
  the merge runtime (``use_peft=True``): every forward forms
  ``W + (A @ B) * alpha / r`` and autograd gives dA, dB; or full-parameter
  training (``use_peft=False``);
- AdamW (weight decay 0.05) with a cosine schedule and warm-up;
- ``moe_aux_weight``: the MoE families' load-balancing value (the layer mean of
  ``models/moe.py``'s aux) added to the loss, ``loss + w · aux``;
- validation loss every ``eval_steps`` and at the end, a save per epoch and a
  ``final_checkpoint`` (``config.json`` + ``state_dict.pt`` + adapter files),
  JSON-lines metrics;
- per-layer recomputation in the backward (``gradient_checkpointing``);
- ``attention_impl="flash"`` (the hand-written K4 kernels on a card) whenever
  ``seq_length`` is a multiple of 128: the matmul path's (B, H, S, S) scores do
  not fit at the reference's sequence length.

Differences from the reference that a caller sees: one process, one device
(``device``, default the CUDA card; ``"cpu"`` for tests); the dataset is a
local ``.json`` / ``.jsonl`` file of ``messages`` rows, split by a seeded numpy
permutation (``data/sft.py``); ``lora_dropout`` is recorded in the adapter
config and, as in the reference's trainer, not applied; ``setup_hook`` gets the
:class:`SFTSetup` before the first step. Knobs of paths that are not ported
yet raise ``NotImplementedError`` naming the knob: ``context_parallel``,
``cp_layout != "contiguous"``, ``pipeline_stages > 1``, ``pp_microbatches``,
``pp_model_parallel``, ``mesh``, ``streaming``, ``local_dataset=False``. A
GPT-2 model trains its full parameters (LoRA's ``q_proj`` / ``v_proj`` targets
match none of its layers, so ``use_peft`` raises, as in the reference). ``export_peft`` also writes the adapter in PEFT
layout (``models/hf_loader.py``) beside each save; ``profile_dir`` (the
port's addition) writes a ``torch.profiler`` trace of steps
``[profile_start_step, profile_start_step + profile_num_steps)``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from dalm_tpu_torch.core.dtypes import parse_dtype
from dalm_tpu_torch.core.profiling import Profiler
from dalm_tpu_torch.core.tree import unflatten
from dalm_tpu_torch.data.sft import chars_token_ratio, create_datasets, pack_dataset, pad_dataset
from dalm_tpu_torch.data.tokenizer import resolve_tokenizer
from dalm_tpu_torch.device import resolve_device
from dalm_tpu_torch.losses.causal import causal_lm_loss
from dalm_tpu_torch.models import lora as lora_mod
from dalm_tpu_torch.models.decoder import Decoder
from dalm_tpu_torch.models.hf_loader import export_peft_if_supported
from dalm_tpu_torch.models.registry import build_decoder, resolve_decoder, save_pretrained
from dalm_tpu_torch.train.metrics import MetricsLogger, WindowedThroughput
from dalm_tpu_torch.train.optim import make_optimizer
from dalm_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)

LORA_LEAVES = ("lora_a", "lora_b")


@dataclasses.dataclass
class SFTSetup:
    """Everything ``train_generator`` builds before its first step."""

    model: Decoder
    state: TrainState
    lora_spec: Optional[lora_mod.LoraSpec]
    train_blocks: np.ndarray
    train_masks: np.ndarray
    valid_blocks: np.ndarray
    valid_masks: np.ndarray
    device: torch.device


def train_generator(
    model_name: str,
    dataset_name: str,
    local_dataset: bool = True,
    run_name: str = "generator_finetuning",
    output_dir: Optional[str] = "./generator_finetuned_model",
    log_with: Optional[str] = None,
    size_valid_set: Optional[int] = None,
    validation_split: Optional[float] = 0.05,
    shuffle_buffer: Optional[int] = None,
    num_train_epochs: int = 1,
    split: str = "train",
    streaming: bool = False,
    seq_length: int = 2600,
    num_workers: int = 4,
    eval_steps: int = 200,
    logging_steps: int = 10,
    per_device_train_batch_size: int = 1,
    per_device_eval_batch_size: int = 1,
    gradient_accumulation_steps: int = 1,
    gradient_checkpointing: bool = True,
    group_by_length: bool = False,  # accepted for parity; fixed-length rows make it moot
    packing: bool = True,
    lora_alpha: float = 512,
    lora_dropout: float = 0.05,
    lora_r: int = 256,
    learning_rate: float = 1e-4,
    lr_scheduler_type: str = "cosine",
    num_warmup_steps: int = 100,
    weight_decay: float = 0.05,
    optimizer_type: str = "adamw",  # accepted for parity; the optimiser is AdamW
    neftune_noise_alpha: float = 5,
    tokenizer: str = "byte",
    dtype: Optional[str] = None,
    mesh=None,
    use_peft: bool = True,
    seed: int = 42,
    max_train_blocks: Optional[int] = None,
    export_peft: bool = False,
    context_parallel: bool = False,
    cp_layout: str = "contiguous",
    moe_aux_weight: float = 0.0,
    pipeline_stages: int = 0,
    pp_microbatches: int = 0,
    pp_model_parallel: int = 1,
    profile_dir: Optional[str] = None,
    profile_start_step: int = 10,
    profile_num_steps: int = 5,
    device=None,
    setup_hook: Optional[Callable[[SFTSetup], None]] = None,
) -> dict:
    """Returns {"final_loss", "eval_loss", "steps", "samples_per_sec",
    "chars_per_token", "avg_step_time"}."""
    args = {k: v for k, v in locals().items() if v is None or isinstance(v, (float, int, str, bool))}
    for name, value, waits in (
        ("context_parallel", context_parallel, bool(context_parallel)),
        ("cp_layout", cp_layout, cp_layout != "contiguous"),
        ("pipeline_stages", pipeline_stages, int(pipeline_stages) > 1),
        ("pp_microbatches", pp_microbatches, int(pp_microbatches) != 0),
        ("pp_model_parallel", pp_model_parallel, int(pp_model_parallel) != 1),
        ("mesh", mesh, mesh is not None),
        ("streaming", streaming, bool(streaming)),
        ("local_dataset", local_dataset, not local_dataset),
    ):
        if waits:
            raise NotImplementedError(f"{name}={value!r} is not ported yet")

    dev = resolve_device(device)
    global_batch = per_device_train_batch_size

    tok = resolve_tokenizer(tokenizer)
    tok.padding_side = "right"
    compute_dtype = parse_dtype(dtype) if dtype else None
    vocab = -(-tok.vocab_size // 128) * 128
    cfg, init_state = resolve_decoder(model_name, dtype=compute_dtype, vocab_size=vocab)
    if cfg.vocab_size < tok.vocab_size:
        # A loaded checkpoint keeps its own embedding table; token ids beyond it
        # would index out of bounds.
        raise ValueError(
            f"model vocab_size {cfg.vocab_size} < tokenizer vocab {tok.vocab_size}: token ids would index "
            "out of bounds; use a tokenizer the checkpoint was built for")
    field_names = {f.name for f in dataclasses.fields(cfg)}  # GPT-2's config has neither knob
    if "remat" in field_names:
        cfg = dataclasses.replace(cfg, remat=bool(gradient_checkpointing))
    if seq_length % 128 == 0 and "attention_impl" in field_names:
        cfg = dataclasses.replace(cfg, attention_impl="flash")
    elif seq_length >= 1024:
        logger.warning(
            "seq_length %d is not a multiple of 128: the flash attention kernel is disabled and long "
            "sequences may exhaust device memory; prefer e.g. 2560 over 2600", seq_length)

    train_data, valid_data = create_datasets(
        dataset_name, split=split, validation_split=validation_split, size_valid_set=size_valid_set,
        streaming=streaming, shuffle_buffer=shuffle_buffer, num_workers=num_workers,
        local_dataset=local_dataset, seed=seed)
    ratio = chars_token_ratio(train_data, tok)
    logger.info("chars/token ratio: %.2f", ratio)

    if packing:
        train_blocks = pack_dataset(train_data, tok, seq_length, max_blocks=max_train_blocks)
        valid_blocks = pack_dataset(valid_data, tok, seq_length, max_blocks=256)
        train_masks, valid_masks = np.ones_like(train_blocks), np.ones_like(valid_blocks)
        if len(train_blocks) == 0:
            raise ValueError(f"dataset packs to zero {seq_length}-token blocks")
        logger.info("packed %d train / %d valid blocks of %d tokens", len(train_blocks), len(valid_blocks), seq_length)
    else:
        if group_by_length:
            logger.warning("group_by_length has no effect here: every sample is padded to seq_length")
        train_blocks, train_masks = pad_dataset(train_data, tok, seq_length, max_samples=max_train_blocks)
        valid_blocks, valid_masks = pad_dataset(valid_data, tok, seq_length, max_samples=256)
        if len(train_blocks) == 0:
            raise ValueError("dataset yields zero non-empty samples")
        logger.info("padded %d train / %d valid samples to %d tokens", len(train_blocks), len(valid_blocks), seq_length)

    steps_per_epoch = math.ceil(len(train_blocks) / global_batch / gradient_accumulation_steps)
    total_steps = steps_per_epoch * num_train_epochs

    # ---- model: frozen base + merge-runtime factors, or every parameter ----
    model = build_decoder(cfg, device=dev)
    if init_state is None:
        model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    else:
        model.load_state_dict(init_state)
    lora_spec = None
    if use_peft:
        lora_spec = lora_mod.LoraSpec(rank=lora_r, alpha=lora_alpha, dropout=lora_dropout,
                                      target_modules=lora_mod.CAUSAL_LM_TARGETS)
        factors = lora_mod.init_lora_params(torch.Generator(device=dev).manual_seed(seed + 3),
                                            unflatten(dict(model.state_dict())), lora_spec)
        lora_mod.attach_merge_lora(model, factors, lora_spec)
        del factors
        for name, p in model.named_parameters():
            p.requires_grad_(name.rpartition(".")[2] in LORA_LEAVES)
    model.train()
    trainable = {name: p for name, p in model.named_parameters() if p.requires_grad}
    optimizer = make_optimizer(
        trainable.values(), learning_rate=learning_rate, lr_scheduler_type=str(lr_scheduler_type),
        num_warmup_steps=num_warmup_steps, total_steps=total_steps, weight_decay=weight_decay,
        gradient_accumulation_steps=gradient_accumulation_steps)
    state = TrainState.create(trainable, optimizer)
    setup = SFTSetup(model, state, lora_spec, train_blocks, train_masks, valid_blocks, valid_masks, dev)
    if setup_hook is not None:
        setup_hook(setup)

    def put(blocks, masks):
        return (torch.as_tensor(np.asarray(blocks, np.int64), device=dev),
                torch.as_tensor(np.asarray(masks, np.int64), device=dev))

    noise_gen = torch.Generator(device=dev)
    alpha = float(neftune_noise_alpha)
    moe_w = float(moe_aux_weight)

    def run_validation() -> float:
        if len(valid_blocks) == 0:
            return float("nan")
        losses = []
        ebs = per_device_eval_batch_size
        for s in range(0, len(valid_blocks) - ebs + 1, ebs):
            ids, mask = put(valid_blocks[s:s + ebs], valid_masks[s:s + ebs])
            losses.append(float(causal_lm_loss(model(ids, mask), ids, mask)))  # forward(): no gradient, no noise
        return float(np.mean(losses)) if losses else float("nan")

    tracker = MetricsLogger(output_dir, project_name=run_name, config=args, report_to=log_with or "all",
                            enabled=log_with is not None or output_dir is not None)
    timer = WindowedThroughput()
    profiler = Profiler(profile_dir, profile_start_step, profile_num_steps)

    completed = 0
    # The loss stays on the device between logging points: a read-back every
    # step would serialise the host with the card.
    final_loss = float("nan")
    last = None
    timer.mark(0)
    for epoch in range(num_train_epochs):
        # per-(seed, epoch) stream: the shuffle order does not depend on where a run resumed
        order = np.random.default_rng([seed, epoch]).permutation(len(train_blocks))
        for s in range(0, len(train_blocks), global_batch):
            idx = order[s:s + global_batch]
            ids, mask = put(train_blocks[idx], train_masks[idx])
            noise_gen.manual_seed(((int(seed) & 0x7FFFFFFF) << 32) | completed)  # keyed per step
            profiler.maybe_start(completed)
            if moe_w > 0:  # loss + w * aux (generator_only.py:336-352)
                logits, moe_aux = model.train_forward(ids, mask, neftune_alpha=alpha, noise_generator=noise_gen,
                                                      return_moe_aux=True)
                loss = causal_lm_loss(logits, ids, mask) + moe_w * moe_aux
            else:
                logits = model.train_forward(ids, mask, neftune_alpha=alpha, noise_generator=noise_gen)
                loss = causal_lm_loss(logits, ids, mask)
            del logits
            loss.backward()
            state.apply_gradients()
            last = loss.detach()
            completed += 1
            profiler.maybe_stop(completed)
            if completed % logging_steps == 0:
                final_loss = float(last)  # the synchronisation point
                timer.mark(completed)
                tracker.log({"train/loss": final_loss}, step=completed)
            if eval_steps and completed % eval_steps == 0:
                val = run_validation()
                tracker.log({"eval/loss": val}, step=completed)
                logger.info("step %d eval loss %.4f", completed, val)
                timer.mark(completed)  # keep validation out of the throughput windows
        if output_dir:
            _save(output_dir, cfg, model, lora_spec, tokenizer, export_peft, model_name)
            timer.mark(completed)  # keep the save out of the throughput windows

    if last is not None:
        final_loss = float(last)
        timer.mark(completed)
    if output_dir:
        _save(os.path.join(output_dir, "final_checkpoint"), cfg, model, lora_spec, tokenizer, export_peft, model_name)
    profiler.close()
    tracker.close()
    val = run_validation()
    return {
        "final_loss": final_loss,
        "eval_loss": val,
        "steps": completed,
        "samples_per_sec": timer.samples_per_sec(global_batch),
        "chars_per_token": ratio,
        "avg_step_time": timer.avg,
    }


def _save(out_dir: str, cfg, model: Decoder, lora_spec, tokenizer_name: str, export_peft: bool = False,
          base_name: str = "") -> None:
    """The (base) model as ``config.json`` + ``state_dict.pt``; with LoRA, the
    adapter files beside the untouched base (and in PEFT layout with ``export_peft``)."""
    base = {k: v for k, v in model.state_dict().items() if k.rpartition(".")[2] not in LORA_LEAVES}
    save_pretrained(out_dir, cfg, base, extra={"tokenizer": tokenizer_name})
    if lora_spec is not None:
        flat = lora_mod.merge_lora_params(model)
        lora_mod.save_adapter(out_dir, flat, lora_spec)
        if export_peft:
            export_peft_if_supported(out_dir, flat, lora_spec, cfg, base_name)
