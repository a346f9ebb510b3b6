"""RAG serving: retrieve → prompt → generate (counterpart of ``dalm_tpu/serve.py:48-300``).

The passage corpus is embedded once into a :class:`DenseIndex` on the
device; ``answer`` embeds the queries, retrieves with K3 (the CUDA top-k
kernel on the card), builds ``#query# … #passage# … #answer# `` prompts
from each query's best passage, left-pads them and decodes with the KV
cache, greedily or with a ``SamplerConfig``. Serving tiers, as in the
reference (``dalm_tpu/serve.py:65-114``): ``quantize_generator`` packs the
generator's big kernels IN PLACE into int8 (True / "int8"), or 4-bit
("int4", "nf4", "int4pc": every projection then runs on K5,
``kernels/int4_matmul.py``); ``kv_quant`` switches the generator's config to
the int8 KV cache, also in place. ``answer_continuous`` decodes through the
continuous-batching engine (``models/decode_engine.py``): a pool of slots,
each given to the next waiting query as soon as its answer ends, on the
fused schedule (``dalm_tpu/serve.py:243-300``). ``stream`` serves queries as
they arrive (``models/streaming.py``): a session whose ``submit`` retrieves
one query and returns a handle that streams its answer's tokens.
``speculative=True`` decodes with prompt-lookup speculation
(``models/speculative.py``) in ``answer``, ``answer_continuous`` and
``stream``: greedy answers are the plain ones, sampled ones follow the same
distribution. ``refresh`` loads new retriever weights and re-embeds the
corpus: a float index through the incremental refresher
(``index/refresh.py``), answering from the old rows until its swap; an int8
or int4 index is rebuilt in one pass. ``from_pretrained`` merges PEFT
adapters of either tower into its weights before the generator is packed.
``server_http.py`` serves a pipeline over HTTP.

Usage::

    pipe = RagPipeline.from_pretrained("bge-large", "llama2-7b", passages, dtype="bfloat16",
                                       quantize_generator="int4", kv_quant=True, speculative=True)
    answers = pipe.answer(["what is ..?"], top_k=4)
    many = pipe.answer_continuous(queries, top_k=4, num_slots=32)
    with pipe.stream(num_slots=32) as session:
        h = session.submit("what is ..?")
        for tok in h.tokens(): ...               # or h.answer(timeout=60)
    pipe.refresh(new_retriever.state_dict())     # re-embed the corpus with new retriever weights
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from dalm_tpu_torch.data.tokenizer import resolve_tokenizer
from dalm_tpu_torch.device import resolve_device
from dalm_tpu_torch.eval.rag import load_generator_for_eval
from dalm_tpu_torch.eval.retriever import build_embed_fn, load_retriever_for_eval
from dalm_tpu_torch.index.dense import DenseIndex
from dalm_tpu_torch.index.refresh import AsyncIndexRefresher
from dalm_tpu_torch.models.decode_engine import DecodeEngine
from dalm_tpu_torch.models.decoder import Decoder
from dalm_tpu_torch.models.generate import build_greedy_generate
from dalm_tpu_torch.models.qlora import pack_module
from dalm_tpu_torch.models.speculative import build_speculative_generate
from dalm_tpu_torch.models.streaming import StreamHandle, StreamingEngine


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
        speculative_gamma: int = 8,
        prefill_chunk: Optional[int] = None,  # blocked admission prefill (answer_continuous)
        admit_width: Optional[int] = None,  # compact admission waves (answer_continuous)
        device=None,
    ):
        """``retriever`` (a SentenceEmbedder) and ``generator`` hold their
        weights and must already be on ``device`` (default ``cuda``).
        ``quantize_generator`` and ``kv_quant`` change ``generator`` in place.
        ``speculative``: prompt-lookup speculative decoding, ``speculative_gamma``
        drafts a verify pass, in every decode path."""
        self.device = resolve_device(device)
        for name, m in (("retriever", retriever), ("generator", generator)):
            if next(m.parameters()).device != self.device:
                raise ValueError(f"the {name} is not on {self.device}")
        if kv_quant and not hasattr(generator.cfg, "kv_quant"):  # GPT-2 has no int8 cache (serve.py:86-89)
            raise ValueError("kv_quant requires a models.decoder.Decoder generator")
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
        self._max_new_tokens = max_new_tokens
        self.sampler = sampler
        self._spec_gamma = speculative_gamma if speculative else 0
        self._prefill_chunk = prefill_chunk
        self._admit_width = admit_width
        self._engine, self._engine_key = None, None
        self._embed = build_embed_fn(self.retriever)
        gen_kw = dict(eos_token_id=self.g_tok.eos_token_id, pad_token_id=self.g_tok.pad_token_id or 0,
                      sampler=sampler)
        if speculative:
            self._generate = build_speculative_generate(self.generator, max_new_tokens, gamma=speculative_gamma,
                                                        **gen_kw)
        else:
            self._generate = build_greedy_generate(self.generator, max_new_tokens, **gen_kw)
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
        retriever, 1 for the generator); ``dtype`` sets both towers' compute dtype.
        ``retriever_peft_path`` / ``generator_peft_path``: adapters saved by
        ``models.lora.save_adapter``, each merged into its tower's kernels
        (``W + scaling * A @ B``) before ``quantize_generator`` packs them."""
        dev = resolve_device(device)
        retriever, r_tok = load_retriever_for_eval(
            retriever_path, retriever_peft_path, retriever_is_autoregressive,
            dtype, retriever_tokenizer, device=dev,
        )
        generator = load_generator_for_eval(generator_path, generator_peft_path, dtype, dev, seed=1)
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

    def _prompt_tokens(self, queries: Sequence[str], ids) -> dict:
        """Left-padded generator prompts from each query's best passage."""
        prompts = [
            f"#query# {q} #passage# {self.passages[int(ids[i, 0])]} #answer# "
            for i, q in enumerate(queries)
        ]
        return self.g_tok(prompts, padding="max_length", max_length=self.max_prompt_len, truncation=True)

    def _answers(self, queries: Sequence[str], scores, ids, token_rows) -> List[RagAnswer]:
        results = []
        for i, q in enumerate(queries):
            text = self.g_tok.decode(token_rows[i], skip_special_tokens=True)
            results.append(
                RagAnswer(
                    query=q,
                    answer=text.split("#answer#")[0].strip(),
                    passages=[self.passages[int(j)] for j in ids[i]],
                    scores=[float(s) for s in scores[i]],
                )
            )
        return results

    def answer(self, queries: Sequence[str], top_k: int = 4) -> List[RagAnswer]:
        scores, ids = self.retrieve(queries, top_k)
        toks = self._prompt_tokens(queries, ids)
        gen = self._generate(
            torch.as_tensor(toks["input_ids"], dtype=torch.long, device=self.device),
            torch.as_tensor(toks["attention_mask"], dtype=torch.long, device=self.device),
        ).cpu().numpy()
        return self._answers(queries, scores, ids, gen)

    def answer_continuous(
        self,
        queries: Sequence[str],
        top_k: int = 4,
        num_slots: int = 32,
        max_new_tokens: Optional[int] = None,
        decode_chunk: int = 8,
    ) -> List[RagAnswer]:
        """``answer`` with continuous batching: ``num_slots`` decode slots, each
        recycled to a waiting query as soon as its answer ends (EOS), so short
        answers never pay for long ones. All queries are known up front, so the
        engine's fused schedule runs. The engine is kept for the next call with
        the same ``(num_slots, max_new_tokens, decode_chunk)``."""
        key = (num_slots, max_new_tokens or self._max_new_tokens, decode_chunk)
        if self._engine_key != key:  # the engine allocates its pool on first use
            self._engine = self._new_engine(*key, admit_width=self._admit_width)
            self._engine_key = key
        scores, ids = self.retrieve(queries, top_k)
        toks = self._prompt_tokens(queries, ids)
        token_lists = self._engine.generate_fused(
            np.asarray(toks["input_ids"], np.int64), np.asarray(toks["attention_mask"], np.int64)
        )
        return self._answers(queries, scores, ids, token_lists)

    def _new_engine(self, num_slots: int, max_new: int, decode_chunk: int, admit_width=None) -> DecodeEngine:
        return DecodeEngine(
            self.generator, num_slots=num_slots, max_prompt_len=self.max_prompt_len, max_new_tokens=max_new,
            eos_token_id=self.g_tok.eos_token_id, pad_token_id=self.g_tok.pad_token_id or 0,
            decode_chunk=decode_chunk, sampler=self.sampler, speculative_gamma=self._spec_gamma,
            prefill_chunk=self._prefill_chunk, admit_width=admit_width,
        )

    def stream(self, num_slots: int = 32, max_new_tokens: Optional[int] = None,
               decode_chunk: int = 8) -> "RagStreamSession":
        """Online serving: a context-managed session whose ``submit(query)`` returns at once with a handle that
        streams the answer's tokens as they decode; queries arriving mid-flight join the slot pool. The session
        has an engine of its own (``prefill_chunk`` and the sampler as the pipeline's); with ``speculative=True``
        it streams through verify rounds::

            with pipe.stream(num_slots=32) as session:
                h = session.submit("what is ..?")
                print(h.answer(timeout=60))        # or: for tok in h.tokens(): ...
        """
        return RagStreamSession(self, self._new_engine(num_slots, max_new_tokens or self._max_new_tokens,
                                                       decode_chunk))

    def refresh(self, new_retriever_state: dict, slice_size: int = 256) -> None:
        """Load ``new_retriever_state`` (a state dict of ``self.retriever``) into the retriever and re-embed the
        corpus (``dalm_tpu/serve.py:338-363``). Queries embed with the new weights at once. A float index is
        swept by an :class:`AsyncIndexRefresher` in slices of ``slice_size`` passages and serves its old rows
        until the swap; an int8 or int4 index cannot be patched row by row, so it is re-embedded and rebuilt in
        one pass."""
        self.retriever.load_state_dict(new_retriever_state)
        texts = [f"#passage# {p}" for p in self.passages]
        if self.index.scales is not None or self.index.int4:
            embs = self._embed_texts(texts, self.max_passage_len)
            quantize = "int4" if self.index.int4 else True
            self.index = DenseIndex.build(embs, quantize=quantize, device=self.device)
            return
        toks = self.r_tok(texts, padding="max_length", max_length=self.max_passage_len, truncation=True)
        AsyncIndexRefresher(self.index, self._embed, toks["input_ids"], toks["attention_mask"],
                            slice_size=slice_size).refresh_fully()


class RagStreamHandle:
    """One streaming RAG request: its retrieval context and its token stream."""

    def __init__(self, query: str, passages: List[str], scores: List[float], handle: StreamHandle, tokenizer):
        self.query = query
        self.passages = passages
        self.scores = scores
        self._handle = handle
        self._tok = tokenizer

    def tokens(self):
        """Yield generator token ids as they decode (a blocking iterator)."""
        return self._handle.tokens()

    def answer(self, timeout: Optional[float] = None) -> str:
        """Wait for the decode to finish; the answer text, parsed as ``answer()`` parses it."""
        text = self._tok.decode(self._handle.result(timeout), skip_special_tokens=True)
        return text.split("#answer#")[0].strip()

    def cancel(self) -> None:
        self._handle.cancel()

    @property
    def done(self) -> bool:
        return self._handle.done


class RagStreamSession:
    """Context-managed online RAG serving (:meth:`RagPipeline.stream`). ``submit`` is thread-safe and returns
    at once; the scheduler thread owns the decode engine and admits requests mid-flight."""

    def __init__(self, pipe: RagPipeline, engine: DecodeEngine):
        self._pipe = pipe
        self._server = StreamingEngine(engine)
        self._started = False

    def __enter__(self) -> "RagStreamSession":
        self._server.start()
        self._started = True
        return self

    def __exit__(self, *exc) -> None:
        self._server.stop(drain=True)

    def submit(self, query: str, top_k: int = 4, budget: Optional[int] = None) -> RagStreamHandle:
        """Retrieve ``query``'s passages (one query: K3 at Q = 1), build the prompt from the best one and queue
        it; ``budget`` caps its new tokens."""
        if not self._started:
            raise RuntimeError("use `with pipe.stream(...) as session:`")
        pipe = self._pipe
        # any thread may submit: grad mode and the current device are per thread
        on_device = torch.cuda.device(pipe.device) if pipe.device.type == "cuda" else contextlib.nullcontext()
        with torch.no_grad(), on_device:
            scores, ids = pipe.retrieve([query], top_k)
        toks = pipe._prompt_tokens([query], ids)
        handle = self._server.submit(np.asarray(toks["input_ids"]), np.asarray(toks["attention_mask"]), budget=budget)
        return RagStreamHandle(query, [pipe.passages[int(j)] for j in ids[0]], [float(s) for s in scores[0]],
                               handle, pipe.g_tok)
