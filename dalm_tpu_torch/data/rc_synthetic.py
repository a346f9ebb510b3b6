"""LLM-based ("synthetic") reading-comprehension generation (counterpart of
``dalm_tpu/data/rc_synthetic.py``).

Prompt an instruction model to write four typed reading-comprehension tasks
(complete-the-sentence, true/false, domain-keyword framing, normal QA) per
text chunk, chunk inputs to a token budget minus the prompt's own tokens, and
parse the output through the QUESTION / ANSWER extractor into chat
conversations. Generation goes through a ``generate_fn``; without one,
``data/backends.py:TorchTextGenerator`` on ``device``. Resuming after an
interruption is the pipeline's (``pipelines/reading_comprehension.py``).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterator, List, Optional, Tuple

from dalm_tpu_torch.data.backends import GenerateFn, TorchTextGenerator
from dalm_tpu_torch.data.rc_utils import input_generator, question_and_answer_extractor, text_chunker
from dalm_tpu_torch.data.tokenizer import resolve_tokenizer

logger = logging.getLogger(__name__)

TASK_SPEC_PROMPT = (
    "You will write reading comprehension exercises. There are four task "
    "types:\n"
    "1. complete-the-sentence — blank out part of a sentence from the text "
    "and ask for the completion;\n"
    "2. true/false — state a claim and ask whether the text supports it;\n"
    "3. domain-keywords — pick distinctive terms from the text and ask for "
    "a sentence using them;\n"
    "4. normal Q&A — a long-form question testing conceptual or procedural "
    "knowledge from the text.\n\n"
    "Write exactly four tasks, one of each type, about the TEXT below. "
    "Label every question with 'QUESTION' and every answer with 'ANSWER', "
    "one pair per task, and output nothing else.\n\nTEXT: "
)

SYSTEM_MESSAGE = (
    "You are a meticulous writer of reading comprehension "
    "exercises. Output only the tasks, nothing else."
)


def gen_prompt(text: str) -> str:
    return TASK_SPEC_PROMPT + text


def generate_synthetic_data(generate_fn: GenerateFn, text: str) -> str:
    """One chunk → raw LLM output (`synthetic_based.py:79-84`)."""
    return generate_fn([gen_prompt(text)])[0]


def generate_synthetic_dataset(
    model_name: str,
    input_directory_or_file: str,
    csv_column: Optional[str],
    processed_files: List[str],
    chunk: bool,
    context_length: int,
    generation_params: Optional[Dict[str, Any]] = None,
    generate_fn: Optional[GenerateFn] = None,
    tokenizer: str = "byte",
    device=None,
) -> Iterator[Tuple[int, str, str, str]]:
    """Yields (chunk_index, file_name, chunk_text, generated_text).

    The reference's ``generate_synthetic_dataset`` (`:87-135`): files already
    in ``processed_files`` are skipped (resume support); with ``chunk`` the
    text is split to ``context_length`` minus the prompt's token count (at
    least 64). Without ``generate_fn``, a ``TorchTextGenerator`` of
    ``model_name`` on ``device`` writes the tasks.
    """
    generation_params = generation_params or {"max_new_tokens": 600}
    if generate_fn is None:
        generate_fn = TorchTextGenerator(
            model_name,
            tokenizer=tokenizer,
            max_input_tokens=context_length,
            max_new_tokens=int(generation_params.get("max_new_tokens", 600)),
            system_message=SYSTEM_MESSAGE,
            device=device,
        )

    tok = resolve_tokenizer(tokenizer)
    prompt_overhead = len(tok.encode_batch([gen_prompt("")], padding=False)["input_ids"][0])
    budget = max(context_length - prompt_overhead, 64)

    for file, text in input_generator(input_directory_or_file, csv_column):
        if file in processed_files:
            continue
        if chunk:
            for index, piece in enumerate(text_chunker(text, tok, budget)):
                yield index, file, piece, generate_synthetic_data(generate_fn, piece)
        else:
            yield 0, file, text, generate_synthetic_data(generate_fn, text)


def convert_to_chat(generated: str, context: str):
    """Raw generation → chatml conversation (or None)."""
    return question_and_answer_extractor(generated, context)
