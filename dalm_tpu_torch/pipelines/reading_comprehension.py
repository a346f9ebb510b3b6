"""Reading-comprehension pipeline: dataset generation → generator SFT
(counterpart of ``dalm_tpu/pipelines/reading_comprehension.py``).

Run regex-based and/or LLM-based reading-comprehension generation
(``SynthMode``), merge into one shuffled dataset (``random.shuffle``), write
it, then fine-tune the generator with the port's ``train_generator`` on
``device`` (default the card).

LLM generation is checkpointed to a pickle state file recording the
processed texts, resumes after an interruption, and the state file is removed
on success; each chunk's outputs are written as JSON, so partial progress
survives.

Known difference: the JAX package saves the dataset with
``Dataset.save_to_disk(output_dataset_name)``; the port writes JSON lines,
``<output_dataset_name>.jsonl`` (or the name itself when it ends in
``.jsonl``, ``data/rc_regex.py:jsonl_path``), the file its SFT reads.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import random
from dataclasses import dataclass
from enum import Enum
from typing import Optional

from dalm_tpu_torch.data.loading import write_jsonl
from dalm_tpu_torch.data.rc_regex import RegexBasedReadingComprehension, jsonl_path
from dalm_tpu_torch.data.rc_synthetic import generate_synthetic_dataset
from dalm_tpu_torch.data.rc_utils import (
    create_domain_tokenizer_from_files,
    question_and_answer_extractor,
)
from dalm_tpu_torch.data.spm import load_piece_vocab
from dalm_tpu_torch.device import resolve_device
from dalm_tpu_torch.train.generator_only import train_generator

logger = logging.getLogger(__name__)


class SynthMode(Enum):
    REGEX = "regex"
    LLM = "llm"
    BOTH = "both"


@dataclass
class LLMKwargs:
    model_name: str
    context_length: Optional[int]
    dataset_output_path: str
    chunk: bool
    unprocessed_dataset_output_path: Optional[str] = None

    def __post_init__(self) -> None:
        if self.chunk and not self.context_length:
            raise ValueError("context_length is required for chunking")


@dataclass
class SynthKwargs:
    general_spm_path: str
    domain_spm_path: Optional[str] = None


def pipeline(
    model_name: str,
    output_dataset_name: str,
    input: str,
    model_output_dir: str,
    log_with: Optional[str] = None,
    llm_kwargs: Optional[LLMKwargs] = None,
    synth_kwargs: Optional[SynthKwargs] = None,
    csv_column: Optional[str] = None,
    title_column: Optional[str] = None,
    size_valid_set: Optional[int] = None,
    comprehension_type: SynthMode = SynthMode.REGEX,
    shuffle_buffer: Optional[int] = None,
    generation_state_file: str = "generation_state.pkl",
    num_train_epochs: int = 1,
    split: str = "train",
    streaming: bool = False,
    seq_length: int = 2600,
    num_workers: int = 4,
    eval_steps: int = 200,
    logging_steps: int = 1000,
    per_device_train_batch_size: int = 1,
    per_device_eval_batch_size: int = 1,
    gradient_accumulation_steps: int = 1,
    gradient_checkpointing: bool = True,
    group_by_length: bool = False,
    packing: bool = True,
    lora_alpha: int = 512,
    lora_dropout: float = 0.05,
    lora_r: int = 256,
    learning_rate: float = 5e-5,
    lr_scheduler_type: str = "cosine",
    num_warmup_steps: int = 0,
    weight_decay: float = 0.0,
    optimizer_type: str = "adamw",
    neftune_noise_alpha: int = 5,
    run_name: str = "rc_pipeline",
    validation_split: Optional[float] = 0.05,
    tokenizer: str = "byte",
    generate_fn=None,
    device=None,
) -> dict:
    """``train_generator``'s result. ``generate_fn`` writes the LLM tasks (default:
    a ``TorchTextGenerator`` of ``llm_kwargs.model_name`` on ``device``)."""
    if comprehension_type in (SynthMode.LLM, SynthMode.BOTH) and not llm_kwargs:
        raise ValueError("llm_kwargs is required for LLM based generation")
    device = resolve_device(device)

    in_memory_dataset: list = []

    # ---- regex-based generation -----------------------------------------
    if comprehension_type in (SynthMode.REGEX, SynthMode.BOTH):
        if not synth_kwargs:
            raise ValueError("synth_kwargs is required for regex based generation")
        if synth_kwargs.domain_spm_path:
            domain_vocab = load_piece_vocab(synth_kwargs.domain_spm_path)
        else:
            logger.warning("no domain tokenizer provided; training one from the input files")
            domain_vocab = create_domain_tokenizer_from_files(input, csv_column=csv_column)
        general_vocab = load_piece_vocab(synth_kwargs.general_spm_path)

        regex_rc = RegexBasedReadingComprehension(general_vocab, domain_vocab)
        in_memory_dataset.extend(
            {"messages": conversation}
            for _, _, conversation in regex_rc.dataset_generator(
                input, csv_column, title_column=title_column
            )
        )

    # ---- LLM-based generation (resumable) --------------------------------
    if comprehension_type in (SynthMode.LLM, SynthMode.BOTH) and llm_kwargs:
        state = {"processed_texts": [], "total_texts": 0, "texts_missed": 0}
        if generation_state_file and os.path.exists(generation_state_file):
            with open(generation_state_file, "rb") as f:
                state = pickle.load(f)
        elif generation_state_file:
            with open(generation_state_file, "wb") as f:
                pickle.dump(state, f)

        os.makedirs(llm_kwargs.dataset_output_path, exist_ok=True)
        if llm_kwargs.unprocessed_dataset_output_path:
            os.makedirs(llm_kwargs.unprocessed_dataset_output_path, exist_ok=True)

        generator = generate_synthetic_dataset(
            model_name=llm_kwargs.model_name,
            input_directory_or_file=input,
            csv_column=csv_column,
            processed_files=state["processed_texts"],
            chunk=llm_kwargs.chunk or False,
            context_length=llm_kwargs.context_length or 0,
            generate_fn=generate_fn,
            tokenizer=tokenizer,
            device=device,
        )
        for index, text_identifier, context, gen_text in generator:
            qanda = question_and_answer_extractor(gen_text, context)
            if llm_kwargs.unprocessed_dataset_output_path:
                with open(
                    os.path.join(
                        llm_kwargs.unprocessed_dataset_output_path, f"{text_identifier}_{index}.json"
                    ),
                    "w",
                ) as f:
                    json.dump(
                        {
                            "context": context,
                            "gen_text": gen_text,
                            "qanda": qanda,
                            "index": index,
                            "text_identifier": text_identifier,
                        },
                        f,
                    )
            if qanda:
                with open(
                    os.path.join(llm_kwargs.dataset_output_path, f"{text_identifier}_{index}.json"), "w"
                ) as f:
                    json.dump(qanda, f)
            else:
                state["texts_missed"] += 1
            state["processed_texts"].append(text_identifier)
            state["total_texts"] += 1
            if generation_state_file:
                with open(generation_state_file, "wb") as f:
                    pickle.dump(state, f)

        logger.info(
            "LLM RC generation: %d extracted, %d missed of %d",
            state["total_texts"] - state["texts_missed"],
            state["texts_missed"],
            state["total_texts"],
        )
        for file in os.listdir(llm_kwargs.dataset_output_path):
            with open(os.path.join(llm_kwargs.dataset_output_path, file)) as f:
                in_memory_dataset.append({"messages": json.load(f)})

    if not in_memory_dataset:
        raise ValueError("No dataset generated")

    random.shuffle(in_memory_dataset)
    dataset_path = jsonl_path(output_dataset_name)
    write_jsonl(in_memory_dataset, dataset_path)

    result = train_generator(
        model_name=model_name,
        dataset_name=dataset_path,
        num_train_epochs=num_train_epochs,
        split=split,
        size_valid_set=size_valid_set,
        streaming=streaming,
        shuffle_buffer=shuffle_buffer,
        seq_length=seq_length,
        num_workers=num_workers,
        eval_steps=eval_steps,
        logging_steps=logging_steps,
        per_device_train_batch_size=per_device_train_batch_size,
        per_device_eval_batch_size=per_device_eval_batch_size,
        gradient_accumulation_steps=gradient_accumulation_steps,
        gradient_checkpointing=gradient_checkpointing,
        group_by_length=group_by_length,
        packing=packing,
        lora_alpha=lora_alpha,
        lora_dropout=lora_dropout,
        lora_r=lora_r,
        learning_rate=learning_rate,
        lr_scheduler_type=lr_scheduler_type,
        num_warmup_steps=num_warmup_steps,
        weight_decay=weight_decay,
        optimizer_type=optimizer_type,
        output_dir=model_output_dir,
        neftune_noise_alpha=neftune_noise_alpha,
        log_with=log_with,
        local_dataset=True,
        validation_split=validation_split,
        run_name=run_name,
        tokenizer=tokenizer,
        device=device,
    )

    if generation_state_file and os.path.exists(generation_state_file):
        os.remove(generation_state_file)
    return result
