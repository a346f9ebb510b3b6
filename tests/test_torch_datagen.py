"""The port's data-generation modules against the JAX package's: ``data/segmentation.py``, ``data/spm.py``,
``data/rc_utils.py``, ``data/rc_regex.py``, ``data/rc_synthetic.py`` and ``data/backends.py``.

The same seeded inputs go through both packages. Host code must agree exactly (sentences, pieces, chunks, extracted
pairs, mined conversations, the template choices of numpy's legacy stream and ``random.Random``). The text generators
run the same tiny f32 weights (the JAX generator's, carried into ``TorchTextGenerator.model`` by ``interop``): their
completions must be equal, and their tokens equal up to the first step whose top-two JAX logits lie within
``NEAR_TIE`` (a near tie that the two packages' f32 sums may resolve either way; the test says where it stopped).
The last test imports every new module in a fresh interpreter with ``datasets``, ``sklearn``, ``pandas``,
``tokenizers`` and ``transformers`` blocked and runs regex RC, QA-gen to CSV and the pipeline's data half there.
"""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import spm_model_bytes  # the one writer of sentencepiece .model files, shared with the card's run
from dalm_tpu.data import backends as jbackends
from dalm_tpu.data import rc_regex as jregex
from dalm_tpu.data import rc_synthetic as jsynth
from dalm_tpu.data import rc_utils as jutils
from dalm_tpu.data import segmentation as jseg
from dalm_tpu.data import spm as jspm
from dalm_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from dalm_tpu_torch.data import backends as tbackends
from dalm_tpu_torch.data import rc_regex as tregex
from dalm_tpu_torch.data import rc_synthetic as tsynth
from dalm_tpu_torch.data import rc_utils as tutils
from dalm_tpu_torch.data import segmentation as tseg
from dalm_tpu_torch.data import spm as tspm
from dalm_tpu_torch.data.loading import load_dataset
from dalm_tpu_torch.data.tokenizer import ByteTokenizer
from dalm_tpu_torch.interop import load_params

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores

NEAR_TIE = 1e-5
ROOT = Path(__file__).resolve().parent.parent

# ---- shared inputs (tests/test_torch_qa_gen.py and tests/test_torch_rc_pipeline.py import these) ----------------

WB = "▁"
GENERAL_PIECES = [WB + w for w in ("the", "of", "and", "panel", "layer", "signal", "current", "voltage", "stack")]
KEYWORDS = ("photovoltaic", "heterojunction", "passivation", "recombination", "encapsulation", "interconnection",
            "electroluminescence", "thermoregulation")
DOMAIN_PIECES = GENERAL_PIECES + [WB + k for k in KEYWORDS] + ["ing", "▁cell", WB + "sharedshortish"]
WORDS = ("the assembly module array layer cell stack panel circuit converter signal sensor output input current "
         "voltage field measured across every band during testing remained stable under load").split()
VERBALIZERS = ("Therefore", "However", "Moreover", "In other words", "Hence", "Thus", "In addition", "Whereas")


def write_spm(path, pieces) -> str:
    Path(path).write_bytes(spm_model_bytes(pieces))
    return str(path)


def _clause(rng, keywords=0, lower=False) -> str:
    words = list(rng.choice(WORDS, size=int(rng.integers(10, 15))))
    for k in rng.choice(KEYWORDS, size=keywords, replace=False):
        words.insert(int(rng.integers(0, len(words) + 1)), str(k))
    text = " ".join(words)
    return (text if lower else text[0].upper() + text[1:]) + "."


def domain_text(rng, n_sentences: int) -> str:
    """Sentences for the miners: plain ones, connective-led ones (NLI, cause-effect, paraphrase), "due to" tails
    (effect-cause) and sentences of three domain keywords (word2text), at least 50 characters, no commas inside."""
    out = [_clause(rng)]
    for _ in range(n_sentences):
        kind = int(rng.integers(0, 5))
        if kind == 0:
            out.append(_clause(rng))
        elif kind == 1:
            out.append(f"{rng.choice(VERBALIZERS)}, {_clause(rng, lower=True)}")
        elif kind == 2:
            out.append(_clause(rng))
            out.append(f"due to {_clause(rng, lower=True)}")
        elif kind == 3:
            out.append(_clause(rng, keywords=3))
        else:
            out.append(_clause(rng, keywords=1))
    return " ".join(out)


def write_docs(root, rng, n_docs: int, n_sentences: int, csv_name=None):
    """``n_docs`` text files under ``root`` (and, with ``csv_name``, the same texts as a Title / Abstract CSV)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    texts = [domain_text(rng, n_sentences) for _ in range(n_docs)]
    for i, t in enumerate(texts):
        (root / f"doc_{i}.txt").write_text(t)
    if csv_name:
        with open(root.parent / csv_name, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Title", "Abstract"])
            w.writerows([f"Title number {i}", t] for i, t in enumerate(texts))
    return texts


def scripted_generate_fn(fail_at=None):
    """Completions in the extractor's formats, numbered by call, one per prompt; raises at call ``fail_at``."""
    calls = []

    def generate(prompts):
        calls.append(list(prompts))
        n = len(calls)
        if n == fail_at:
            raise RuntimeError(f"generation interrupted at call {n}")
        outs = []
        for j, p in enumerate(prompts):
            if (n + j) % 4 == 3:
                outs.append("no structure at all")  # a text the extractor misses
            else:
                outs.append(f"1. QUESTION: what is item {n}.{j} about?\nANSWER: it covers {len(p)} characters.\n"
                            f"[question type: factual] QUESTION: Which layer is {n}?\n[answer] ANSWER: layer {j}.")
        return outs

    generate.calls = calls
    return generate


# ---- segmentation, spm -----------------------------------------------------------------------------------------

CORPUS = ("Dr. Smith met Mr. J. Doe at 3.14 p.m. on the 5th. They discussed the U.S. plan! Was it good? "
          "Yes... e.g. the results were fine. Prof. Lee et al. disagreed; see Fig. 3 and Eq. 2.  The end.\n"
          "A new paragraph starts here.No space after that dot. Approx. 10 vs. 12 items, i.e. two more.")


def test_segmentation_equals_jax():
    assert tseg.segment(CORPUS) == jseg.segment(CORPUS) and len(jseg.segment(CORPUS)) > 5
    assert tseg.split_to_sentences(CORPUS) == jseg.split_to_sentences(CORPUS)
    assert tutils.split_to_sentences is tseg.split_to_sentences
    for text in ("", "   ", "no terminal punctuation", "One. Two! Three?"):
        assert tseg.segment(text) == jseg.segment(text)


def test_read_spm_vocab_and_domain_keywords_equal_jax(tmp_path):
    pieces = DOMAIN_PIECES + ["<unk>", "ü" + WB + "multibyte", WB + "x" * 300]  # a 300-byte piece: 2-byte lengths
    path = write_spm(tmp_path / "domain.model", pieces)
    t, j = tspm.read_spm_vocab(path), jspm.read_spm_vocab(path)
    assert t.pieces() == j.pieces() == pieces and len(t) == len(pieces)
    general = write_spm(tmp_path / "general.spm", GENERAL_PIECES)
    assert tspm.load_piece_vocab(general).pieces() == jspm.load_piece_vocab(general).pieces()
    tk = tspm.domain_keywords(tspm.load_piece_vocab(general), t)
    jk = jspm.domain_keywords(jspm.load_piece_vocab(general), j)
    assert tk == jk and tk >= {WB + k for k in KEYWORDS} and WB + "sharedshortish" in tk
    assert tspm.domain_keywords(t, t, min_len=3) == set()
    with pytest.raises(ValueError, match="cannot load piece vocab"):
        tspm.load_piece_vocab(str(tmp_path / "vocab.txt"))


def test_unigram_training_equals_jax(tmp_path):
    """Both packages call the ``tokenizers`` crate's Unigram trainer. It orders pieces of equal score differently
    from run to run (within one package too), so the piece sets are compared: what ``domain_keywords`` reads."""
    lines = [domain_text(np.random.default_rng(i), 4) for i in range(40)]
    t = tspm.UnigramPieceTokenizer.train(iterator=lines, vocab_size=300)
    j = jspm.UnigramPieceTokenizer.train(iterator=lines, vocab_size=300)
    assert sorted(t.pieces()) == sorted(j.pieces()) and len(t) > 16
    general = tspm.PieceVocab(GENERAL_PIECES)
    assert tspm.domain_keywords(general, t) == jspm.domain_keywords(general, j) != set()
    assert t.decode(t.encode(lines[0])) == lines[0]
    path = str(tmp_path / "domain.json")
    t.tokenizer.save(path)
    assert tspm.load_piece_vocab(path).pieces() == jspm.load_piece_vocab(path).pieces() == t.pieces()
    docs = tmp_path / "docs"
    write_docs(docs, np.random.default_rng(3), 4, 12)
    tf = tspm.create_domain_tokenizer_from_files(str(docs), None, vocab_size=200)
    jf = jspm.create_domain_tokenizer_from_files(str(docs), None, vocab_size=200)
    assert sorted(tf.pieces()) == sorted(jf.pieces())
    (tmp_path / "all.txt").write_text("\n".join(lines))
    assert (sorted(tspm.create_domain_tokenizer(str(tmp_path / "all.txt"), 250).pieces())
            == sorted(jspm.create_domain_tokenizer(str(tmp_path / "all.txt"), 250).pieces()))


# ---- rc_utils ----------------------------------------------------------------------------------------------------

def test_input_generator_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    texts = write_docs(tmp_path / "docs", rng, 3, 6, csv_name="docs.csv")
    with open(tmp_path / "docs" / "extra.csv", "w", newline="") as f:  # a CSV inside the directory
        w = csv.writer(f)
        w.writerow(["Abstract", "Title"])
        w.writerows([["first, with a comma", "t0"], ["second\nline", ""]])
    cases = [(str(tmp_path / "docs" / "doc_0.txt"), None, None), (str(tmp_path / "docs" / "doc_0.txt"), None, "x"),
             (str(tmp_path / "docs.csv"), "Abstract", None), (str(tmp_path / "docs.csv"), "Abstract", "Title"),
             (str(tmp_path / "docs"), None, None), (str(tmp_path / "docs"), "Abstract", None),
             (str(tmp_path / "docs"), "Abstract", "Title")]
    for path, column, title in cases:
        t = list(tutils.input_generator(path, column, title_column=title))
        assert t == list(jutils.input_generator(path, column, title_column=title)) and t, (path, column, title)
    assert [x[1] for x in tutils.input_generator(str(tmp_path / "docs.csv"), "Abstract")] == texts
    for bad in ((str(tmp_path / "docs" / "doc_0.txt"), "Abstract"), (str(tmp_path / "missing"), None)):
        with pytest.raises(ValueError):
            list(tutils.input_generator(*bad))
        with pytest.raises(ValueError):
            list(jutils.input_generator(*bad))


def test_text_chunker_equals_jax():
    rng = np.random.default_rng(2)
    text = domain_text(rng, 30) + " ünïcödé — 数据 " + domain_text(rng, 5)  # multi-byte characters cut mid-way
    for size in (1, 7, 64, 333, 10_000):
        t = list(tutils.text_chunker(text, ByteTokenizer(), size))
        assert t == list(jutils.text_chunker(text, JaxByteTokenizer(), size)) and t
    assert list(tutils.text_chunker("", ByteTokenizer(), 8)) == list(jutils.text_chunker("", JaxByteTokenizer(), 8))


# the five format families of the JAX package's extractor tests (inputs copied), and chat wrapping
EXTRACTOR_TEXTS = [
    "QUESTION: What powers a TPU matmul?\nANSWER: The MXU systolic array.\n"
    "QUESTION: Where do embeddings live?\nANSWER: In HBM across the mesh.\n",
    "1. QUESTION: What is sharding?\nANSWER: Splitting arrays across devices.\n"
    "2. QUESTION: What merges winners?\nANSWER: An all-gather over ICI.\n",
    "[question type: factual] QUESTION: What is a mesh?\n[answer] ANSWER: A named grid of devices.\n",
    "QUESTION: First without answer?\nSome stray narration line.\nQUESTION: Second with answer?\nANSWER: Yes indeed.\n",
    "\n\nQUESTION: Q here?\n\n\nANSWER: A here.\n\n",
    "QUESTION: Q1?\nANSWER: A1.\nQUESTION: Q2?\nANSWER: A2.\n",
    "**Task 1** QUESTION: empty answer next?\nANSWER:\nno structure at all",
    "no structure at all",
]


@pytest.mark.parametrize("i", range(len(EXTRACTOR_TEXTS)))
def test_extractor_equals_jax(i):
    text = EXTRACTOR_TEXTS[i]
    t = tutils._raw_question_and_answer_extractor(text)
    assert t == jutils._raw_question_and_answer_extractor(text)
    assert (tutils.question_and_answer_extractor(text, "Some context passage.")
            == jutils.question_and_answer_extractor(text, "Some context passage."))
    assert tsynth.convert_to_chat(text, "ctx") == jsynth.convert_to_chat(text, "ctx")
    for line in text.split("\n"):
        assert tutils.extract_answer(line) == jutils.extract_answer(line)
    if i < 6:
        assert t  # the five families and the chat case each give pairs


# ---- rc_regex ----------------------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def regex_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("regex")
    write_docs(root / "docs", np.random.default_rng(5), 6, 40, csv_name="docs.csv")
    (root / "docs" / "short.txt").write_text("Too short to mine.")  # a degenerate chunk
    general = write_spm(root / "general.model", GENERAL_PIECES)
    domain = write_spm(root / "domain.model", DOMAIN_PIECES)
    return root, general, domain


@pytest.mark.parametrize("source", ["dir", "csv", "csv-title"])
def test_regex_dataset_generator_equals_jax(regex_corpus, source):
    root, general, domain = regex_corpus
    path, column, title = {"dir": (root / "docs", None, None), "csv": (root / "docs.csv", "Abstract", None),
                           "csv-title": (root / "docs.csv", "Abstract", "Title")}[source]
    j = list(jregex.RegexBasedReadingComprehension(general, domain).dataset_generator(str(path), column, 1,
                                                                                      title_column=title))
    rc = tregex.RegexBasedReadingComprehension(general, domain)
    assert list(rc.dataset_generator(str(path), column, 1, title_column=title)) == j
    assert list(rc.dataset_generator(str(path), column, 2, title_column=title)) == j  # two worker processes
    text = " ".join(m["content"] for _, _, conv in j for m in conv)
    for needle in ("Therefore", "due to", "photovoltaic"):
        assert needle in text
    assert len({len(conv) for _, _, conv in j}) > 2  # demos and wrapper modes vary across texts
    if title:
        assert "Title number" in text


def test_generate_rc_dataset_writes_the_jax_rows(regex_corpus, tmp_path):
    root, general, domain = regex_corpus
    want = jregex.generate_rc_dataset(str(root / "docs.csv"), "Abstract", general, domain, title_column="Title")
    got = tregex.generate_rc_dataset(str(root / "docs.csv"), "Abstract", general, domain,
                                     output_dataset_name=str(tmp_path / "rc"), title_column="Title")
    assert got["messages"] == want["messages"] and got.column_names == ["messages"]
    assert load_dataset(str(tmp_path / "rc.jsonl"))["messages"] == want["messages"]
    assert tregex.jsonl_path("x.jsonl") == "x.jsonl" and tregex.jsonl_path("out/rc") == "out/rc.jsonl"


# ---- rc_synthetic ------------------------------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [True, False])
def test_generate_synthetic_dataset_equals_jax(tmp_path, chunk):
    write_docs(tmp_path / "docs", np.random.default_rng(9), 4, 8)
    kw = dict(model_name="unused", input_directory_or_file=str(tmp_path / "docs"), csv_column=None,
              processed_files=["doc_1.txt"], chunk=chunk, context_length=900)
    jfn, tfn = scripted_generate_fn(), scripted_generate_fn()
    j = list(jsynth.generate_synthetic_dataset(generate_fn=jfn, **kw))
    t = list(tsynth.generate_synthetic_dataset(generate_fn=tfn, **kw))
    assert t == j and tfn.calls == jfn.calls
    assert "doc_1.txt" not in {x[1] for x in t} and len({x[1] for x in t}) == 3
    assert (max(x[0] for x in t) > 2) == chunk  # the 64-byte floor of the budget: many chunks a file
    assert tsynth.gen_prompt("T") == jsynth.gen_prompt("T") and tsynth.TASK_SPEC_PROMPT == jsynth.TASK_SPEC_PROMPT


# ---- the text generator --------------------------------------------------------------------------------------------

GEN_KW = dict(max_input_tokens=160, max_new_tokens=8, batch_size=4)
PROMPTS = ["short", "a somewhat longer prompt about photovoltaic cells", "x" * 200, "mid length prompt here",
           "ünïcödé prompt", "the last prompt, alone in a padded batch"]


@pytest.fixture(scope="module")
def generators():
    """The JAX tiny generator (random init from PRNGKey(0)) and the port's, carrying its weights."""
    jgen = jbackends.JaxTextGenerator("tiny", system_message="You write questions.", **GEN_KW)
    tgen = tbackends.TorchTextGenerator("tiny", system_message="You write questions.", device="cpu", **GEN_KW)
    load_params(tgen.model, jgen.params)
    return jgen, tgen


def _jax_top2_gap(jgen, ids, mask, gen, step):
    """Per row, the gap between the top two JAX logits at generated position ``step`` (a full forward without a
    cache over the prompt and the tokens before it)."""
    import jax.numpy as jnp

    full = np.concatenate([ids, gen[:, :step]], axis=1).astype(np.int32)
    m = np.concatenate([mask, np.ones_like(gen[:, :step])], axis=1).astype(np.int32)
    pos = np.clip(np.cumsum(m, axis=1) - 1, 0, None).astype(np.int32)
    logits = np.asarray(jgen.model.apply({"params": jgen.params}, jnp.asarray(full), jnp.asarray(m),
                                         positions=jnp.asarray(pos)))[:, -1]
    top = np.sort(logits, axis=-1)
    return top[:, -1] - top[:, -2]


def assert_tokens_tie_aware(jgen, ids, mask, j_tok, t_tok):
    """Tokens equal up to the first step where some row differs; that step must be a near tie on the JAX side.
    Returns the number of steps compared."""
    diff = np.nonzero((j_tok != t_tok).any(axis=0))[0]
    if len(diff) == 0:
        return j_tok.shape[1]
    step = int(diff[0])
    gaps = _jax_top2_gap(jgen, ids, mask, j_tok, step)
    rows = np.nonzero(j_tok[:, step] != t_tok[:, step])[0]
    assert (gaps[rows] < NEAR_TIE).all(), f"tokens differ at step {step} without a near tie: gaps {gaps[rows]}"
    print(f"stopped at step {step}: a near tie (JAX top-two gap {gaps[rows].min():.2e})")
    return step


@pytest.mark.parametrize("chat", [True, False], ids=["chat", "plain"])
def test_torch_text_generator_equals_jax(generators, chat):
    jgen, tgen = generators
    jgen.chat = tgen.chat = chat
    seen = []
    raw = tgen._generate

    def capture(ids, mask):
        out = raw(ids, mask)
        seen.append((ids.numpy(), mask.numpy(), out.numpy()))
        return out

    tgen._generate = capture
    try:
        t_out = tgen(PROMPTS)
    finally:
        tgen._generate = raw
    j_out = jgen(PROMPTS)
    assert len(seen) == 2 and all(ids.shape == (4, 160) for ids, _, _ in seen)
    last_ids = seen[1][0]
    assert (last_ids[1:] == last_ids[1]).all() and (last_ids[0] != last_ids[1]).any()  # padded with the last prompt
    assert (seen[0][1][:, 0] == 0).any() and (seen[0][1][:, -1] == 1).all()  # left padding
    compared = [assert_tokens_tie_aware(jgen, ids, mask, np.asarray(jgen._generate(jgen.params, ids, mask)), tok)
                for ids, mask, tok in seen]
    if compared == [8, 8]:
        assert t_out == j_out
    assert len(t_out) == len(PROMPTS) and all(isinstance(s, str) for s in t_out)
    assert tgen._render("p") == jgen._render("p")


def test_torch_text_generator_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbackends.TorchTextGenerator("tiny")


# ---- a fresh interpreter without datasets, sklearn, pandas, tokenizers, transformers ------------------------------

BLOCKED = ("datasets", "sklearn", "pandas", "tokenizers", "transformers")
NEW_MODULES = ("data.segmentation", "data.spm", "data.rc_utils", "data.rc_regex", "data.backends", "data.rc_synthetic",
               "data.qa_gen", "data.docs_to_passage", "data.json_pre_process", "data.check_dataset", "pipelines",
               "pipelines.reading_comprehension", "cli")


def test_new_modules_run_without_the_hf_packages(regex_corpus, tmp_path):
    root, general, domain = regex_corpus
    small = tmp_path / "small"  # one text of one LLM chunk: the default generator writes 600 tokens a chunk
    small.mkdir()
    (small / "doc.txt").write_text(domain_text(np.random.default_rng(4), 8))
    code = f"""
import importlib, json, logging, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
for m in {NEW_MODULES!r}:
    importlib.import_module("dalm_tpu_torch." + m)
from dalm_tpu_torch.data.rc_regex import generate_rc_dataset
from dalm_tpu_torch.data.qa_gen import generate_qa_from_disk
from dalm_tpu_torch.data.spm import UnigramPieceTokenizer
from dalm_tpu_torch.pipelines import LLMKwargs, SynthKwargs, SynthMode, pipeline
from dalm_tpu_torch.pipelines import reading_comprehension as rcp
out = {{}}
out["regex_rows"] = len(generate_rc_dataset({str(root / 'docs')!r}, None, {general!r}, {domain!r}))
generate_qa_from_disk({str(root / 'docs.csv')!r}, "Abstract", "Title", 6, 4, {str(tmp_path / 'qa')!r}, True,
                      max_input_tokens=64, device="cpu")
try:
    UnigramPieceTokenizer.train(iterator=["a b c"])
except ImportError as e:
    out["spm_error"] = str(e)
seen = {{}}
rcp.train_generator = lambda **kw: seen.update(kw) or {{"final_loss": 0.0}}
pipeline("tiny", {str(tmp_path / 'rc')!r}, {str(small)!r}, {str(tmp_path / 'model')!r},
         llm_kwargs=LLMKwargs("tiny", 2048, {str(tmp_path / 'llm')!r}, True),
         synth_kwargs=SynthKwargs({general!r}, {domain!r}), comprehension_type=SynthMode.BOTH,
         generation_state_file={str(tmp_path / 'state.pkl')!r}, device="cpu")
out["dataset_name"] = seen["dataset_name"]
out["loaded"] = sorted(m for m, mod in sys.modules.items()
                      if mod is not None and m.split(".")[0] in {BLOCKED!r} + ("jax", "dalm_tpu"))
print(json.dumps(out))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["regex_rows"] == 7 and out["loaded"] == [] and "'tokenizers'" in out["spm_error"]
    assert sorted(os.listdir(tmp_path / "qa")) == ["question_answer_pairs_test.csv", "question_answer_pairs_train.csv"]
    assert out["dataset_name"] == str(tmp_path / "rc.jsonl") and (tmp_path / "rc.jsonl").is_file()
    assert not (tmp_path / "state.pkl").exists()
