"""RAG serving: retrieve → prompt → generate (counterpart of ``dalm_tpu/serve.py:48-241``).

The passage corpus is embedded once into a :class:`DenseIndex` on the
device; ``answer`` embeds the queries, retrieves with K3 (the CUDA top-k
kernel on the card), builds ``#query# … #passage# … #answer# `` prompts
from each query's best passage, left-pads them and decodes with the KV
cache, greedily or with a ``SamplerConfig``. Serving tiers, as in the
reference (``dalm_tpu/serve.py:65-114``): ``quantize_generator`` packs the
generator's big kernels IN PLACE into int8 (True / "int8"), or 4-bit
("int4", "nf4", "int4pc": every projection then runs on K5,
``kernels/int4_matmul.py``); ``kv_quant`` switches the generator's config to
the int8 KV cache, also in place. Continuous batching, streaming and
speculative decoding wait for later slices and raise.

Usage::

    pipe = RagPipeline.from_pretrained("bge-large", "llama2-7b", passages, dtype="bfloat16",
                                       quantize_generator="int4", kv_quant=True)
    answers = pipe.answer(["what is ..?"], top_k=4)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from dalm_tpu_torch.core.dtypes import parse_dtype
from dalm_tpu_torch.data.tokenizer import resolve_tokenizer
from dalm_tpu_torch.device import resolve_device
from dalm_tpu_torch.eval.retriever import build_embed_fn, load_retriever_for_eval
from dalm_tpu_torch.index.dense import DenseIndex
from dalm_tpu_torch.models.decoder import Decoder
from dalm_tpu_torch.models.generate import build_greedy_generate
from dalm_tpu_torch.models.qlora import pack_module
from dalm_tpu_torch.models.registry import resolve_decoder


@dataclasses.dataclass
class RagAnswer:
    query: str
    answer: str
    passages: List[str]
    scores: List[float]


class RagPipeline:
    def __init__(
        self,
        retriever,
        retriever_tok,
        generator: Decoder,
        generator_tok,
        passages: Sequence[str],
        max_passage_len: int = 128,
        max_prompt_len: int = 256,
        max_new_tokens: int = 64,
        embed_batch: int = 64,
        index_quantize: "bool | str" = False,  # True/"int8" = int8 rows, "int4" = nibble rows
        quantize_generator: "bool | str" = False,  # True/"int8" = int8; "int4", "nf4", "int4pc" = 4-bit
        kv_quant: bool = False,  # int8 KV cache (per-token/head scales)
        sampler=None,  # models.sampling.SamplerConfig; None = greedy
        speculative: bool = False,
        device=None,
    ):
        """``retriever`` (a SentenceEmbedder) and ``generator`` hold their
        weights and must already be on ``device`` (default ``cuda``).
        ``quantize_generator`` and ``kv_quant`` change ``generator`` in place."""
        if speculative:
            raise NotImplementedError("speculative decoding is not ported yet")
        self.device = resolve_device(device)
        for name, m in (("retriever", retriever), ("generator", generator)):
            if next(m.parameters()).device != self.device:
                raise ValueError(f"the {name} is not on {self.device}")
        if quantize_generator:
            pack_module(generator, quantize=quantize_generator)
        if kv_quant:
            generator.cfg = dataclasses.replace(generator.cfg, kv_quant=True)
        self.retriever = retriever
        self.r_tok = retriever_tok
        self.generator = generator
        self.g_tok = generator_tok
        self.g_tok.padding_side = "left"
        self.passages = list(passages)
        self.max_passage_len = max_passage_len
        self.max_prompt_len = max_prompt_len
        self.embed_batch = embed_batch
        self._embed = build_embed_fn(self.retriever)
        self._generate = build_greedy_generate(
            self.generator, max_new_tokens,
            eos_token_id=self.g_tok.eos_token_id,
            pad_token_id=self.g_tok.pad_token_id or 0,
            sampler=sampler,
        )
        embs = self._embed_texts([f"#passage# {p}" for p in self.passages], max_passage_len)
        self.index = DenseIndex.build(embs, quantize=index_quantize, device=self.device)

    @classmethod
    def from_pretrained(
        cls,
        retriever_path: str,
        generator_path: str,
        passages: Sequence[str],
        retriever_peft_path: Optional[str] = None,
        generator_peft_path: Optional[str] = None,
        retriever_tokenizer: str = "byte",
        generator_tokenizer: str = "byte",
        retriever_is_autoregressive: bool = False,
        dtype: Optional[str] = None,
        device=None,
        **kw,
    ) -> "RagPipeline":
        """Presets are random-initialised from fixed seeds (0 for the
        retriever, 1 for the generator); ``dtype`` sets both towers' compute dtype."""
        if generator_peft_path:
            raise NotImplementedError("PEFT adapters are not ported yet")
        dev = resolve_device(device)
        retriever, r_tok = load_retriever_for_eval(
            retriever_path, retriever_peft_path, retriever_is_autoregressive,
            dtype, retriever_tokenizer, device=dev,
        )
        g_cfg, g_state = resolve_decoder(generator_path, dtype=parse_dtype(dtype) if dtype else None)
        generator = Decoder(g_cfg, device=dev)
        if g_state is None:
            generator.reset_parameters(torch.Generator(device=dev).manual_seed(1))
        else:
            generator.load_state_dict(g_state)
        generator.eval()
        g_tok = resolve_tokenizer(generator_tokenizer)
        return cls(retriever, r_tok, generator, g_tok, passages, device=dev, **kw)

    def _embed_texts(self, texts: Sequence[str], max_len: int) -> torch.Tensor:
        """(len(texts), H) float32 embeddings on the device."""
        out = torch.empty((len(texts), self.retriever.embedding_dim), dtype=torch.float32, device=self.device)
        for start in range(0, len(texts), self.embed_batch):
            chunk = list(texts[start : start + self.embed_batch])
            toks = self.r_tok(chunk, padding="max_length", max_length=max_len, truncation=True)
            out[start : start + len(chunk)] = self._embed(
                np.asarray(toks["input_ids"]), np.asarray(toks["attention_mask"])
            ).float()
        return out

    def retrieve(self, queries: Sequence[str], top_k: int = 4):
        """→ (scores (Q, k) float32, ids (Q, k) int32) numpy arrays."""
        q_embs = self._embed_texts([f"#query# {q}" for q in queries], self.max_passage_len)
        return self.index.search(q_embs, top_k)

    def answer(self, queries: Sequence[str], top_k: int = 4) -> List[RagAnswer]:
        scores, ids = self.retrieve(queries, top_k)
        prompts = [
            f"#query# {q} #passage# {self.passages[int(ids[i, 0])]} #answer# "
            for i, q in enumerate(queries)
        ]
        toks = self.g_tok(prompts, padding="max_length", max_length=self.max_prompt_len, truncation=True)
        gen = self._generate(
            torch.as_tensor(toks["input_ids"], dtype=torch.long, device=self.device),
            torch.as_tensor(toks["attention_mask"], dtype=torch.long, device=self.device),
        ).cpu().numpy()
        results = []
        for i, q in enumerate(queries):
            text = self.g_tok.decode(gen[i], skip_special_tokens=True)
            results.append(
                RagAnswer(
                    query=q,
                    answer=text.split("#answer#")[0].strip(),
                    passages=[self.passages[int(j)] for j in ids[i]],
                    scores=[float(s) for s in scores[i]],
                )
            )
        return results
