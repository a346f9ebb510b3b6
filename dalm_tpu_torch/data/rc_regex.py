"""Regex-mined reading-comprehension generation.

The port's own copy of ``dalm_tpu/data/rc_regex.py``, the counterpart of the
reference's ``regex_based.py`` (itself derived from the public Microsoft
LMOps AdaptLLM "read" recipe): mine naturally-occurring
task instances from raw domain text with verbalizer-anchored regexes and
compose them into few-shot "reading comprehension" chatml documents.

Task types (same six): nli, common_reason (cause/effect), paraphrase,
word2text (domain-keyword framing), summarize, text_completion.

Flow per chunk of a document:
1. chunk the text to a token budget with the general tokenizer;
2. each miner scans the chunk; hits are capped per subcategory (2),
   selection and template choice seeded by ``text_id`` (reproducible);
3. demos from {nli, common_reason, paraphrase, word2text} are rendered
   as chatml QA pairs, shuffled, and prefixed with an intro line;
4. a wrapper mode is drawn — summarize-only / completion-only / both /
  neither with p = (0.4, 0.1, 0.4, 0.1) — and wraps the context + demos
  into the final conversation.

Intentional fixes vs the reference (SURVEY.md §7.4):
- every chunk of a long document yields an RC example (the reference
  formats only the last chunk — ``format_recomprehension`` sits outside
  the chunk loop, `regex_based.py:1152-1156`);
- the domain tokenizer trains on all documents (see
  ``data/spm.py``).

Templates here are first-party banks covering the same modes at
comparable richness (NLI: 19 classify + 7 generate vs the reference's
~30/7; cause-effect 9+8; paraphrase 6+8; word2text 8; summarize: 7
generate-title + 6 article-from-title + 7 untitled-summary; completion
7; 5 intro lines): classify / generate / connective-choice / relation
for NLI, cause↔effect QA, paraphrase classify+generate, keyword
framing, title tasks in BOTH directions (mirroring the reference's
two-way title bank, `regex_based.py:806-840`), summary tasks, and
text-completion.

Titles: the reference's summarize machinery supports document titles
(`regex_based.py:778-806`) but its entry point hardwires ``title=None``
(`:1132-1134`); here ``title_column`` routes a CSV title column through
``generate()`` so title tasks actually appear in generated corpora.

Randomness is the JAX package's, draw for draw: numpy's legacy global stream
(``np.random.seed`` + ``np.random.choice``) for the template modes and
``random.Random(seed)`` for the rest, so both packages pick the same templates.
``generate_rc_dataset`` returns a ``ColumnDataset`` and, given
``output_dataset_name``, writes JSON lines (``<name>.jsonl``) where the JAX
package calls ``Dataset.save_to_disk``.
"""

from __future__ import annotations

import logging
import multiprocessing
import random
import re
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from dalm_tpu_torch.data.loading import ColumnDataset, from_rows, write_jsonl
from dalm_tpu_torch.data.rc_utils import input_generator
from dalm_tpu_torch.data.segmentation import segment
from dalm_tpu_torch.data.spm import WORD_BOUNDARY, domain_keywords, load_piece_vocab

logger = logging.getLogger(__name__)

TYPES = ["nli", "common_reason", "paraphrase", "word2text", "summarize", "text_completion"]

MAX_PER_SUBCATEGORY = 2
MAX_SEQ_LEN = 2048

# A clause: ≥50 chars with no sentence-internal punctuation, ending a sentence.
_CLAUSE = r"([^.!?\n,]{50,}[.!?])"
_SENT_END = r"[.!?]\s+"


def _mk(verbalizers: List[str]) -> re.Pattern:
    alt = "|".join(re.escape(v) for v in verbalizers)
    return re.compile(
        _SENT_END + _CLAUSE + r"\s+(" + alt + r")\s*,\s+" + _CLAUSE,
        re.IGNORECASE,
    )


def chatml(question: str, answer: Optional[str] = None) -> List[Dict[str, str]]:
    msgs = [{"role": "user", "content": question}]
    if answer is not None:
        msgs.append({"role": "assistant", "content": answer})
    return msgs


class BaseMiner:
    """subcategory → regex; hits → entries; entry + seed → chatml demo."""

    subcategories: Dict[str, re.Pattern] = {}

    def mine(self, text: str, **kw) -> Dict[str, List[dict]]:
        out: Dict[str, List[dict]] = {}
        for name, pattern in self.subcategories.items():
            out[name] = [self.collect(m, name) for m in pattern.finditer(text)]
        return out

    def collect(self, match: re.Match, subcategory: str) -> dict:
        raise NotImplementedError

    def templates(self, entry: dict, seed: int) -> List[Tuple[str, str]]:
        raise NotImplementedError

    def format_demo(self, entry: dict, seed: int) -> List[Dict[str, str]]:
        rng = random.Random(seed)
        question_t, answer_t = rng.choice(self.templates(entry, seed))
        kw = self.keywords(entry)
        return chatml(question_t.format(**kw), answer_t.format(**kw))

    def keywords(self, entry: dict) -> dict:
        return entry


class NLIMiner(BaseMiner):
    subcategories = {
        "Entail": _mk(["Yes", "Therefore", "Thus", "Accordingly", "Hence", "For this reason"]),
        "Contradict": _mk(["No", "However", "But", "On the contrary", "In contrast", "Whereas"]),
        "Neutral": _mk(["Maybe", "Also", "Furthermore", "Secondly", "Additionally", "Moreover", "In addition"]),
    }
    _ANSWERS = {
        "Entail": ("Yes", "Therefore", "Entailment"),
        "Contradict": ("No", "However", "Contradictory"),
        "Neutral": ("Maybe", "Moreover", "Neutral"),
    }

    def collect(self, m, subcategory):
        return {
            "label": subcategory,
            "premise": m.group(1),
            "verbalizer": m.group(2),
            "hypothesis": m.group(3),
        }

    def keywords(self, entry):
        answer, connect, relation = self._ANSWERS[entry["label"]]
        hyp = entry["hypothesis"]
        return {
            "premise": entry["premise"],
            "hypothesis": hyp[0].upper() + hyp[1:],
            "verbalizer": entry["verbalizer"],
            "answer": answer,
            "connect_answer": connect,
            "relation_answer": relation,
            "options_": "- Yes\n- No\n- Maybe",
        }

    def templates(self, entry, seed):
        np.random.seed(seed)
        mode = np.random.choice(["generate", "classify"], p=[0.2, 0.8])
        if mode == "classify":
            return [
                ('{premise}\nGiven that sentence, can we conclude "{hypothesis}"?\n{options_}', "{answer}"),
                ("Premise: {premise}\nHypothesis: {hypothesis}\nDoes the premise support the hypothesis?", "{answer}"),
                ('Text: {premise}\nIs the statement "{hypothesis}" consistent with the text?\nAnswer:', "{answer}"),
                ('Read: {premise}\nTrue, false, or unknown — "{hypothesis}"?\n{options_}', "{answer}"),
                ('Suppose "{premise}" holds. Does it follow that "{hypothesis}"?\n{options_}', "{answer}"),
                ('If someone told you "{premise}", would "{hypothesis}" also be true?\n{options_}', "{answer}"),
                ("Statement: {premise}\nClaim: {hypothesis}\nIs the claim justified by the statement?", "{answer}"),
                ('Based only on "{premise}", is the following accurate?\n{hypothesis}\n{options_}', "{answer}"),
                ("Here is some text: {premise}\nDoes it imply this?\n{hypothesis}", "{answer}"),
                (
                    "Consider:\n(a) {premise}\n(b) {hypothesis}\nCan (b) be inferred from (a)?\n{options_}",
                    "{answer}",
                ),
                ('Given the context "{premise}", answer yes, no, or maybe:\nIs "{hypothesis}" true?', "{answer}"),
                ("Question: does the first sentence entail the second?\n1) {premise}\n2) {hypothesis}", "{answer}"),
                (
                    "Sentence A: {premise}\nSentence B: {hypothesis}\nWhich word best joins A to B — "
                    "Therefore, However, or Moreover?",
                    "{connect_answer}",
                ),
                (
                    "Pick the connective (Therefore / However / Moreover) linking:\n1. {premise}\n2. {hypothesis}",
                    "{connect_answer}",
                ),
                (
                    '"{premise}" ... "{hypothesis}"\nWhat fits in between — Therefore, However, or Moreover?',
                    "{connect_answer}",
                ),
                (
                    "Choose the best transition word for these two sentences "
                    "(Therefore / However / Moreover):\n{premise}\n{hypothesis}",
                    "{connect_answer}",
                ),
                (
                    'How are these sentences related — Entailment, Neutral, or Contradictory?\n'
                    "First: {premise}\nSecond: {hypothesis}",
                    "{relation_answer}",
                ),
                (
                    "Label the pair as Entailment, Neutral, or Contradictory.\n"
                    "Premise: {premise}\nHypothesis: {hypothesis}\nLabel:",
                    "{relation_answer}",
                ),
                (
                    'What is the logical relation between "{premise}" and "{hypothesis}" — '
                    "Entailment, Neutral, or Contradictory?",
                    "{relation_answer}",
                ),
            ]
        return [
            ("Continue this text: {premise} {verbalizer},", "{hypothesis}"),
            ("{premise} {verbalizer}:", "{hypothesis}"),
            (
                'Write a follow-up sentence for "{premise}" starting from the word "{verbalizer}".',
                "{hypothesis}",
            ),
            ('Complete the passage: "{premise} {verbalizer}, ..."', "{hypothesis}"),
            ("{premise}\nWhat sentence naturally follows, beginning with {verbalizer}?", "{hypothesis}"),
            (
                "Extend the following so the next sentence starts with "
                '"{verbalizer}":\n{premise}',
                "{hypothesis}",
            ),
            ("Finish the thought: {premise} {verbalizer},", "{hypothesis}"),
        ]


class CauseEffectMiner(BaseMiner):
    subcategories = {
        "Cause-effect": _mk(["Thus", "Therefore", "Accordingly", "Hence", "For this reason"]),
        "Effect-cause": re.compile(
            _SENT_END + r"([^.!?;\n,]{50,}[.!?])\s+(due to|on account of|owing to)\s+([^.!?;\n,]{50,}[.!?])",
            re.IGNORECASE,
        ),
    }

    def collect(self, m, subcategory):
        return {
            "relation": subcategory,
            "sentence1": m.group(1),
            "verbalizer": m.group(2),
            "sentence2": m.group(3),
        }

    def keywords(self, entry):
        if entry["relation"] == "Cause-effect":
            cause, effect = entry["sentence1"], entry["sentence2"]
        else:
            effect, cause = entry["sentence1"], entry["sentence2"]
        return {"cause": cause, "effect": effect, "verbalizer": entry["verbalizer"]}

    def templates(self, entry, seed):
        if entry["relation"] == "Cause-effect":
            return [
                ('What follows from "{cause}"?', "{effect}"),
                ("{cause}\nWhat is the likely effect?", "{effect}"),
                ('State a consequence of "{cause}".', "{effect}"),
                ("{cause}\nEffect:", "{effect}"),
                ('Given "{cause}", what happens as a result?', "{effect}"),
                ("Cause: {cause}\nWhat is the resulting outcome?", "{effect}"),
                ('If "{cause}", then what?', "{effect}"),
                ("{cause}\nTherefore:", "{effect}"),
                ('Describe an outcome that follows when {cause}', "{effect}"),
            ]
        return [
            ('What could explain "{effect}"?', "{cause}"),
            ("{effect}\nWhat is the likely cause?", "{cause}"),
            ("{effect}\nCause:", "{cause}"),
            ('Why might it be the case that "{effect}"?', "{cause}"),
            ("Effect: {effect}\nWhat brought this about?", "{cause}"),
            ('Give a plausible reason for: "{effect}"', "{cause}"),
            ("{effect}\nThis happened because:", "{cause}"),
            ('What underlying condition leads to "{effect}"?', "{cause}"),
        ]


class ParaphraseMiner(BaseMiner):
    subcategories = {
        "Paraphrase": _mk(["In other words", "That is", "Namely", "To put it differently", "i.e."]),
    }

    def collect(self, m, subcategory):
        return {"sentence1": m.group(1), "verbalizer": m.group(2), "sentence2": m.group(3)}

    def templates(self, entry, seed):
        np.random.seed(seed)
        mode = np.random.choice(["classify", "generate"], p=[0.5, 0.5])
        if mode == "classify":
            return [
                (
                    'Do these two sentences say the same thing?\n"{sentence1}"\n"{sentence2}"',
                    "Yes, the second restates the first.",
                ),
                (
                    "Sentence 1: {sentence1}\nSentence 2: {sentence2}\nAre they paraphrases?",
                    "Yes",
                ),
                (
                    'Is "{sentence2}" a rewording of "{sentence1}"?',
                    "Yes, they express the same meaning.",
                ),
                (
                    "Compare:\nA. {sentence1}\nB. {sentence2}\nDo A and B convey the same information?",
                    "Yes",
                ),
                (
                    'Would you say these statements are equivalent?\n- {sentence1}\n- {sentence2}',
                    "Yes, they are equivalent.",
                ),
                (
                    "Here are two sentences:\n{sentence1}\n{sentence2}\nSame meaning or different?",
                    "Same meaning",
                ),
            ]
        return [
            ('Restate this in other words: "{sentence1}"', "{sentence2}"),
            ("{sentence1}\nIn other words:", "{sentence2}"),
            ('Paraphrase: "{sentence1}"', "{sentence2}"),
            ('Say this differently: "{sentence1}"', "{sentence2}"),
            ("Rewrite the following without changing its meaning:\n{sentence1}", "{sentence2}"),
            ("{sentence1}\nThat is to say:", "{sentence2}"),
            ('How else could one phrase "{sentence1}"?', "{sentence2}"),
            ("Express the same idea in a new sentence: {sentence1}", "{sentence2}"),
        ]


class Word2TextMiner(BaseMiner):
    """Sentences containing ≥3 domain-specific keywords → framing tasks."""

    MIN_KEYWORDS = 3

    def __init__(self, keywords: Optional[set] = None):
        self.keyword_words = {k.lstrip(WORD_BOUNDARY).lower() for k in (keywords or set())}

    def mine(self, text: str, sents: Optional[List[str]] = None, **kw):
        hits = []
        if self.keyword_words:
            for sent in sents or segment(text):
                words = {w.strip(".,;:!?()\"'").lower() for w in sent.split()}
                found = sorted(words & self.keyword_words)
                if len(found) >= self.MIN_KEYWORDS:
                    hits.append({"keywords": found[:5], "sentence": sent})
        return {"Word2Text": hits}

    def collect(self, m, subcategory):  # pragma: no cover - custom mine()
        raise NotImplementedError

    def keywords(self, entry):
        return {
            "keywords": ", ".join(f'"{k}"' for k in entry["keywords"]),
            "sentence": entry["sentence"],
        }

    def templates(self, entry, seed):
        return [
            ("Write a sentence from the domain using the terms {keywords}.", "{sentence}"),
            ("Compose one sentence that includes all of: {keywords}.", "{sentence}"),
            ("Concepts: {keywords}\nUse them together in a sentence:", "{sentence}"),
            ("Produce a technical sentence that mentions {keywords}.", "{sentence}"),
            ("Here are some domain terms: {keywords}\nPut them into one sentence.", "{sentence}"),
            ("Build a sentence around the following vocabulary: {keywords}", "{sentence}"),
            ("Using every one of these words — {keywords} — write a sentence.", "{sentence}"),
            ("Show how {keywords} relate by using them in a single sentence.", "{sentence}"),
        ]


class SummarizeTask:
    """Summary / title wrapper (reference `summarize` type; title may be None).

    The titled bank covers BOTH directions of the reference's title family
    (`regex_based.py:806-840`): generate-a-title-from-the-article
    (``templates_with_title``) and write-the-article-from-its-title
    (``templates_article_from_title``, where the answer is the context).
    """

    templates_with_title = [
        ("{context}\n\nGive this article a short title.", "{title}"),
        ("What would be a fitting headline for the article above?\n{context}", "{title}"),
        ("{context}\n\nPropose a title for this text.", "{title}"),
        ("{context}\n\nWhat would you name this article?", "{title}"),
        ("Suggest a one-line heading for the following:\n{context}", "{title}"),
        ("{context}\n\nSummarize the article above in a few words.\nTitle:", "{title}"),
        ("{context}\n\nWhat is this document called?", "{title}"),
    ]
    templates_article_from_title = [
        ('Write an article about "{title}".', "{context}"),
        ('Draft a piece of text under the heading "{title}".', "{context}"),
        ('The title of a document is "{title}". Write the document.', "{context}"),
        ('Compose an article that fits the headline "{title}".', "{context}"),
        ('Given the title "{title}", produce the article body.', "{context}"),
        ('"{title}" — expand this title into a full passage.', "{context}"),
    ]
    templates_no_title = [
        ("{context}\n\nSummarize the article above in one or two sentences.", "{summary}"),
        ("{context}\n\nWhat are the key points of this text?", "{summary}"),
        ("{context}\n\nGive a brief summary of the passage.", "{summary}"),
        ("{context}\n\nCondense the above into a short statement.", "{summary}"),
        ("State the main idea of the following text:\n{context}", "{summary}"),
        ("{context}\n\nIn short, what does this text say?", "{summary}"),
        ("{context}\n\nTL;DR:", "{summary}"),
    ]


class TextCompletionTask:
    """Continue-the-text wrapper from segmented sentences."""

    templates = [
        ("{head}\n\nHow does the text continue?", "{tail}"),
        ("{head}\n\nComplete the passage:", "{tail}"),
        ("{head}\n\nWrite the next part of this text.", "{tail}"),
        ("Here is the start of a passage:\n{head}\n\nFinish it.", "{tail}"),
        ("{head}\n\nWhat comes next?", "{tail}"),
        ("Continue from where this leaves off:\n{head}", "{tail}"),
        ("{head}\n\nProvide the remainder of the article:", "{tail}"),
    ]


class ReadingComprehensionFormatter:
    """Composes the final chatml conversation for one chunk."""

    INTROS = [
        "\nPlease answer some questions about the text above.\n\n",
        "\nNow answer the following questions:\n\n",
        "\n\nUse the article above to answer these questions:\n\n",
        "\nAnswer the questions below based on the article:\n\n",
        "\n\nCheck your understanding with these questions:\n\n",
    ]

    def compose(
        self,
        context: str,
        demos: List[List[Dict[str, str]]],
        sents: List[str],
        title: Optional[str],
        seed: int,
    ) -> Tuple[List[Dict[str, str]], Dict[str, int]]:
        rng = random.Random(seed)
        counts: Dict[str, int] = {}

        qa_demos: List[Dict[str, str]] = []
        if demos:
            rng.shuffle(demos)
            intro = rng.choice(self.INTROS)
            qa_demos = [msg for demo in demos for msg in demo]
            qa_demos[0] = {**qa_demos[0], "content": intro + qa_demos[0]["content"]}

        can_summarize = True  # summary always derivable (title optional)
        can_complete = len(sents) >= 2

        np.random.seed(seed)
        if can_complete:
            mode = np.random.choice(
                ["summarize", "complete", "both", "neither"], p=[0.4, 0.1, 0.4, 0.1]
            )
        else:
            mode = np.random.choice(["summarize", "neither"], p=[0.5, 0.5])

        counts["summarize"] = int(mode in ("summarize", "both"))
        counts["text_completion"] = int(mode in ("complete", "both"))

        conversation: List[Dict[str, str]]
        if mode in ("complete", "both"):
            cut = max(1, len(sents) // 2)
            head, tail = " ".join(sents[:cut]), " ".join(sents[cut:])
            q_t, a_t = rng.choice(TextCompletionTask.templates)
            completion = chatml(q_t.format(head=head), a_t.format(tail=tail))
        else:
            completion = []

        if mode in ("summarize", "both"):
            if title:
                # Both directions of the title family: generate-title (the
                # context sits in the user turn, demos slot between question
                # and answer) and article-from-title (the context IS the
                # assistant answer, so demos asking about "the text above"
                # must come after it).
                bank = (
                    SummarizeTask.templates_with_title
                    + SummarizeTask.templates_article_from_title
                )
                idx = rng.randrange(len(bank))
                q_t, a_t = bank[idx]
                summary_pair = chatml(
                    q_t.format(context=context, title=title),
                    a_t.format(title=title, context=context),
                )
                if idx >= len(SummarizeTask.templates_with_title):
                    conversation = summary_pair + qa_demos + completion
                    return conversation, counts
            else:
                q_t, a_t = rng.choice(SummarizeTask.templates_no_title)
                summary = " ".join(sents[: max(1, min(2, len(sents)))])
                summary_pair = chatml(q_t.format(context=context), a_t.format(summary=summary))
            conversation = summary_pair[:1] + qa_demos + summary_pair[1:]
            conversation += completion
        elif mode == "complete":
            conversation = [{"role": "user", "content": context}] + qa_demos + completion
        else:
            conversation = [{"role": "user", "content": context}] + qa_demos
            if not qa_demos:
                # degenerate chunk: still emit a usable completion-style task
                q_t, a_t = rng.choice(SummarizeTask.templates_no_title)
                summary = " ".join(sents[:2]) if sents else context[:200]
                conversation = chatml(q_t.format(context=context), a_t.format(summary=summary))
        return conversation, counts


class RegexBasedReadingComprehension:
    """Public API twin of the reference class (`regex_based.py:1116-1180`)."""

    def __init__(self, general_vocab, domain_vocab, general_tokenizer=None):
        self.general_vocab = load_piece_vocab(general_vocab)
        self.domain_vocab = load_piece_vocab(domain_vocab)
        keywords = domain_keywords(self.general_vocab, self.domain_vocab)
        logger.info("selected %d domain keywords", len(keywords))
        self.miners = {
            "nli": NLIMiner(),
            "common_reason": CauseEffectMiner(),
            "paraphrase": ParaphraseMiner(),
            "word2text": Word2TextMiner(keywords),
        }
        self.formatter = ReadingComprehensionFormatter()
        # token-budget chunker: the general tokenizer if it can encode,
        # else a whitespace-word budget fallback
        self._encoder = general_tokenizer if general_tokenizer is not None else (
            self.general_vocab if hasattr(self.general_vocab, "encode") else None
        )

    def _chunks(self, text: str, budget: int) -> List[str]:
        if self._encoder is not None:
            ids = self._encoder.encode(text)
            return [
                self._encoder.decode(ids[i : i + budget]) for i in range(0, len(ids), budget)
            ] or [text]
        words = text.split()
        return [" ".join(words[i : i + budget]) for i in range(0, len(words), budget)] or [text]

    def generate(self, entry: Dict[str, Any]) -> Dict[str, Any]:
        """One raw text → RC conversations for EVERY chunk.

        ``entry["title"]`` (optional) routes the summarize wrapper to the
        title template bank — the reference carries the same machinery
        (`regex_based.py:778-806`) but its entry point always passes
        ``title=None`` (`:1132-1134`); here a CSV title column flows
        through (``title_column``), so title tasks actually appear in
        generated corpora.
        """
        seed = entry["text_id"]
        title = entry.get("title")
        conversations = []
        for chunk in self._chunks(entry["text"], MAX_SEQ_LEN - 200):
            sents = segment(chunk)
            demos: List[List[Dict[str, str]]] = []
            for name, miner in self.miners.items():
                mined = miner.mine(chunk, sents=list(sents))
                for subcategory, examples in mined.items():
                    if not examples:
                        continue
                    random.Random(seed).shuffle(examples)
                    for ex in examples[:MAX_PER_SUBCATEGORY]:
                        demos.append(miner.format_demo(ex, seed))
            conversation, _ = self.formatter.compose(chunk, demos, sents, title, seed)
            conversations.append(conversation)
        return {"read_compre": conversations, "file_name": entry["file_name"]}

    def dataset_generator(
        self,
        input_dir_or_file: str,
        column: Optional[str] = None,
        workers: int = 1,
        title_column: Optional[str] = None,
    ) -> Iterator[Tuple[int, str, List[Dict[str, str]]]]:
        raw = []
        for i, item in enumerate(
            input_generator(input_dir_or_file, column, title_column=title_column)
        ):
            name, content = item[0], item[1]
            title = item[2] if len(item) > 2 else None
            raw.append(
                {"text": content.strip(), "text_id": i, "file_name": name, "title": title}
            )
        logger.info("mining reading comprehension from %d texts...", len(raw))
        if workers > 1:  # spawned workers: forking a process that runs threads (torch's) is unsafe
            with ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn")) as pool:
                results = list(pool.map(self.generate, raw, chunksize=64))
        else:
            results = [self.generate(r) for r in raw]
        for result in results:
            for index, conversation in enumerate(result["read_compre"]):
                yield index, result["file_name"], conversation


def jsonl_path(output_dataset_name: str) -> str:
    """The JSON-lines file that stands for the ``datasets`` directory ``output_dataset_name``."""
    return output_dataset_name if output_dataset_name.endswith(".jsonl") else output_dataset_name + ".jsonl"


def generate_rc_dataset(
    input_dir_or_file: str,
    csv_column: Optional[str],
    general_vocab,
    domain_vocab,
    output_dataset_name: Optional[str] = None,
    workers: int = 1,
    title_column: Optional[str] = None,
) -> ColumnDataset:
    """End-to-end helper mirroring the reference ``main`` (`:1204-1262`): a
    ``messages`` column, written to ``jsonl_path(output_dataset_name)`` when
    that is given."""
    rc = RegexBasedReadingComprehension(general_vocab, domain_vocab)
    rows = [
        {"messages": conversation}
        for _, _, conversation in rc.dataset_generator(
            input_dir_or_file, csv_column, workers, title_column=title_column
        )
    ]
    if output_dataset_name:
        write_jsonl(rows, jsonl_path(output_dataset_name))
    return from_rows(rows)
