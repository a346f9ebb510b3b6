"""Text-generation backend of the data-generation components (counterpart of
``dalm_tpu/data/backends.py``).

Generation is a callable ``prompts -> completions``, so the data layer does
not depend on a model. ``TorchTextGenerator`` runs the port's decoder with its
KV-cache greedy loop (``models/generate.py``) on the card, or on the CPU when
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional

import numpy as np
import torch

from dalm_tpu_torch.data.sft import format_chat
from dalm_tpu_torch.data.tokenizer import resolve_tokenizer
from dalm_tpu_torch.device import resolve_device
from dalm_tpu_torch.models.generate import build_greedy_generate
from dalm_tpu_torch.models.registry import build_decoder, resolve_decoder

logger = logging.getLogger(__name__)

GenerateFn = Callable[[List[str]], List[str]]


class TorchTextGenerator:
    """prompts → completions with a decoder preset or checkpoint, the
    arguments of ``JaxTextGenerator`` plus ``device`` (default the card).

    ``chat=True`` wraps prompts in chatml (what instruction-tuned models
    expect; the reference uses ``tokenizer.apply_chat_template``). Prompts are
    left-padded to ``max_input_tokens`` (truncated past it) in batches of
    ``batch_size``; a short last batch is filled with copies of its last
    prompt. The decoder, in the preset's or checkpoint's dtypes, is
    ``.model``: a preset has no weights and is random-initialised from seed 0.
    """

    def __init__(
        self,
        model_spec: str,
        tokenizer: str = "byte",
        max_input_tokens: int = 512,
        max_new_tokens: int = 512,
        batch_size: int = 8,
        chat: bool = True,
        system_message: Optional[str] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.tok = resolve_tokenizer(tokenizer)
        self.tok.padding_side = "left"
        cfg, state = resolve_decoder(model_spec)
        self.model = build_decoder(cfg, device=self.device)
        if state is None:
            logger.warning("model spec %r has no weights; random init (test mode)", model_spec)
            self.model.reset_parameters(torch.Generator(device=self.device).manual_seed(0))
        else:
            self.model.load_state_dict(state)
        self.model.eval()
        self.max_input_tokens = max_input_tokens
        self.batch_size = batch_size
        self.chat = chat
        self.system_message = system_message
        self._generate = build_greedy_generate(
            self.model, max_new_tokens,
            eos_token_id=self.tok.eos_token_id, pad_token_id=self.tok.pad_token_id or 0,
        )

    def _render(self, prompt: str) -> str:
        if not self.chat:
            return prompt
        messages = []
        if self.system_message:
            messages.append({"role": "system", "content": self.system_message})
        messages.append({"role": "user", "content": prompt})
        return format_chat(messages) + "<|im_start|>assistant\n"

    def __call__(self, prompts: List[str]) -> List[str]:
        out: List[str] = []
        rendered = [self._render(p) for p in prompts]
        for start in range(0, len(rendered), self.batch_size):
            chunk = rendered[start : start + self.batch_size]
            real = len(chunk)
            if real < self.batch_size:
                chunk = chunk + [chunk[-1]] * (self.batch_size - real)
            toks = self.tok(chunk, padding="max_length", max_length=self.max_input_tokens, truncation=True)
            ids = torch.as_tensor(np.asarray(toks["input_ids"]), dtype=torch.long, device=self.device)
            mask = torch.as_tensor(np.asarray(toks["attention_mask"]), dtype=torch.long, device=self.device)
            gen = self._generate(ids, mask).cpu().numpy()
            for i in range(real):
                out.append(self.tok.decode(gen[i], skip_special_tokens=True))
        return out
