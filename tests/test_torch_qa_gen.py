"""The port's QA-gen and passage preparation against the JAX package's: ``data/qa_gen.py``,
``data/docs_to_passage.py``, ``data/json_pre_process.py``, ``data/check_dataset.py``.

The same seeded CSVs go through both packages (the JAX side reads them with ``datasets``, the port with its own
``ColumnDataset``). Exact: the title split against scikit-learn for 0–60 titles, the rows of every split, the
batches each ``generate_fn`` call receives, and the bytes of every CSV / TSV written. The tiny generators (the JAX
one's weights carried into the port's by ``interop``) write the questions of one run; their outputs must be equal.
"""

import csv
import json

import datasets
import numpy as np
import pytest
import sklearn.model_selection
import torch

from dalm_tpu.data import check_dataset as jcheck
from dalm_tpu.data import docs_to_passage as jdocs
from dalm_tpu.data import json_pre_process as jjson
from dalm_tpu.data import qa_gen as jqa
from dalm_tpu.data.backends import JaxTextGenerator
from dalm_tpu_torch.data import check_dataset as tcheck
from dalm_tpu_torch.data import docs_to_passage as tdocs
from dalm_tpu_torch.data import json_pre_process as tjson
from dalm_tpu_torch.data import qa_gen as tqa
from dalm_tpu_torch.data.backends import TorchTextGenerator
from dalm_tpu_torch.data.loading import ColumnDataset, load_dataset, write_jsonl
from dalm_tpu_torch.interop import load_params
from test_torch_datagen import GEN_KW, assert_tokens_tie_aware, domain_text

torch.set_num_threads(1)  # one intra-op thread: the suite's pytest workers share the CPU's cores


def write_passages_csv(path, n, n_titles, seed, extra=True):
    """``n`` passages over ``n_titles`` titles; with ``extra``, a stale Question column, an id column and cells with
    commas, quotes and line breaks."""
    rng = np.random.default_rng(seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Title", "Abstract"] + (["Question", "doc_id"] if extra else []))
        for i in range(n):
            text = domain_text(rng, int(rng.integers(1, 4)))
            if extra and i % 5 == 0:
                text = f'{text} He said "yes, twice",\nthen left.'
            row = [f"Title {int(rng.integers(0, n_titles))}", text]
            w.writerow(row + ([f"stale {i}", f"d{i}"] if extra else []))
    return str(path)


def question_fn():
    """A scripted question writer: the questions it writes pass the filter or fail it by turns."""
    calls = []
    bad = ["", "-", "Too short", "<think> a model token leak here", "What is the answer to this passage here",
           "Here is the instruction you asked for today"]

    def generate(prompts):
        calls.append(list(prompts))
        out = []
        for j, p in enumerate(prompts):
            k = len(calls) * 7 + j
            out.append(bad[k % len(bad)] if k % 3 == 0 else f"How does passage {k} of {len(p)} characters\nwork today")
        return out

    generate.calls = calls
    return generate


def rows(ds):
    return [{k: ds[k][i] for k in ds.column_names} for i in range(len(ds))]


def test_title_split_equals_sklearn():
    for n in range(2, 61):
        titles = [f"t{i:03d}" for i in range(n)]
        want = sklearn.model_selection.train_test_split(titles, test_size=0.2, random_state=42)
        assert list(tqa.train_test_split(titles)) == [list(w) for w in want], n
        if n > 3:
            want = sklearn.model_selection.train_test_split(titles, test_size=2, random_state=7)
            assert list(tqa.train_test_split(titles, test_size=2, random_state=7)) == [list(w) for w in want], n


@pytest.mark.parametrize("n", [0, 1])
def test_title_split_raises_where_sklearn_raises(n):
    titles = [f"t{i}" for i in range(n)]
    with pytest.raises(ValueError, match="train set will be empty") as te:
        tqa.train_test_split(titles)
    with pytest.raises(ValueError, match="train set will be empty") as se:
        sklearn.model_selection.train_test_split(titles, test_size=0.2, random_state=42)
    assert str(te.value) == str(se.value)


def test_split_dataset_equals_jax():
    cols = {"Title": [f"t{i % 7}" for i in range(40)], "Abstract": [f"passage {i}" for i in range(40)]}
    j = jqa.split_dataset(datasets.Dataset.from_dict(cols), "Title")
    t = tqa.split_dataset(ColumnDataset(cols), "Title")
    assert list(t) == list(j) == ["train", "test"]
    for name in t:
        assert rows(t[name]) == rows(j[name])
    with pytest.raises(ValueError):
        tqa.split_dataset(ColumnDataset({"Title": ["one"] * 3, "Abstract": ["a", "b", "c"]}), "Title")


@pytest.mark.parametrize("question", ["What drives the retrieval quality in this system exactly", "", "-", "Too short",
                                      "<think> some model token leak here today", "A question about it here today",
                                      "The Answer to life the universe and everything", "an INSTRUCTION to follow now",
                                      None])
def test_filter_malformed_equals_jax(question):
    assert tqa.filter_malformed_questions({"Question": question}) is jqa.filter_malformed_questions({"Question": question})


@pytest.mark.parametrize("sample_size,batch_size", [(1000, 4), (9, 8), (23, 5)])
def test_generate_qa_from_dataset_equals_jax(tmp_path, sample_size, batch_size):
    path = write_passages_csv(tmp_path / "passages.csv", 30, 9, seed=sample_size)
    jfn, tfn = question_fn(), question_fn()
    j = jqa.generate_qa_from_dataset(datasets.Dataset.from_csv(path), "Abstract", "Title", sample_size, batch_size,
                                     generate_fn=jfn)
    t = tqa.generate_qa_from_dataset(load_dataset(path), "Abstract", "Title", sample_size, batch_size,
                                     generate_fn=tfn)
    assert tfn.calls == jfn.calls and max(len(c) for c in tfn.calls) <= batch_size
    assert list(t) == list(j)
    for name in t:
        assert t[name].column_names == j[name].column_names and rows(t[name]) == rows(j[name]) and len(t[name])
    assert tqa.build_prompt("P") == jqa.build_prompt("P")


def test_generate_qa_from_disk_writes_the_jax_bytes(tmp_path):
    path = write_passages_csv(tmp_path / "passages.csv", 26, 8, seed=3)
    jqa.generate_qa_from_disk(path, "Abstract", "Title", 20, 6, str(tmp_path / "jax"), True, generate_fn=question_fn())
    tqa.generate_qa_from_disk(path, "Abstract", "Title", 20, 6, str(tmp_path / "port"), True, generate_fn=question_fn())
    for split in ("train", "test"):
        name = f"question_answer_pairs_{split}.csv"
        want = (tmp_path / "jax" / name).read_bytes()
        assert (tmp_path / "port" / name).read_bytes() == want and want.count(b"\n") > 2


def test_qa_gen_raises_where_the_jax_package_needs_datasets(tmp_path):
    path = write_passages_csv(tmp_path / "passages.csv", 6, 3, seed=1)
    with pytest.raises(NotImplementedError, match="'datasets'"):
        tqa.generate_qa_from_disk(path, "Abstract", "Title", 6, 2, str(tmp_path / "out"), False,
                                  generate_fn=question_fn())
    assert not (tmp_path / "out").exists()
    with pytest.raises(NotImplementedError, match="saved dataset directory.*'datasets'"):
        tqa._load_dataset_from_path(str(tmp_path))
    with pytest.raises(NotImplementedError, match="hub dataset name.*'datasets'"):
        tqa._load_dataset_from_path("org/some_dataset")
    for bad in ("passages.txt", "rows.json"):
        with pytest.raises(ValueError, match="dataset-path must be") as te:
            tqa._load_dataset_from_path(bad)
        with pytest.raises(ValueError) as je:
            jqa._load_dataset_from_path(bad)
        assert str(te.value) == str(je.value)


@pytest.fixture(scope="module")
def generators():
    """The JAX tiny generator (random init from PRNGKey(0)) and the port's, carrying its weights."""
    jgen = JaxTextGenerator("tiny", **GEN_KW)
    tgen = TorchTextGenerator("tiny", device="cpu", **GEN_KW)
    load_params(tgen.model, jgen.params)
    return jgen, tgen


def test_generate_qa_with_the_tiny_generators_equals_jax(tmp_path, generators):
    """The whole path on a model: both generators' completions equal (tie-aware tokens), then both CSVs' bytes."""
    jgen, tgen = generators
    path = write_passages_csv(tmp_path / "passages.csv", 10, 4, seed=5, extra=False)
    seen, raw = [], tgen._generate

    def capture(ids, mask):
        out = raw(ids, mask)
        seen.append((ids.numpy(), mask.numpy(), out.numpy()))
        return out

    outputs = {"jax": [], "port": []}

    def recorded(gen, side):
        def generate(prompts):
            outputs[side].extend(gen(prompts))
            return outputs[side][-len(prompts):]
        return generate

    tgen._generate = capture
    try:
        tqa.generate_qa_from_disk(path, "Abstract", "Title", 10, 4, str(tmp_path / "port"), True,
                                  generate_fn=recorded(tgen, "port"))
    finally:
        tgen._generate = raw
    jqa.generate_qa_from_disk(path, "Abstract", "Title", 10, 4, str(tmp_path / "jax"), True,
                              generate_fn=recorded(jgen, "jax"))
    assert len(seen) == 3 and len(outputs["port"]) == 10  # train 2 batches + test 1, each of 4 rows
    compared = [assert_tokens_tie_aware(jgen, ids, mask, np.asarray(jgen._generate(jgen.params, ids, mask)), tok)
                for ids, mask, tok in seen]
    if compared == [GEN_KW["max_new_tokens"]] * 3:
        assert outputs["port"] == outputs["jax"]
        for split in ("train", "test"):
            name = f"question_answer_pairs_{split}.csv"
            assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


# ---- passage preparation -----------------------------------------------------------------------------------------

def _documents(seed, n=12):
    rng = np.random.default_rng(seed)
    texts = [domain_text(rng, int(rng.integers(0, 30))) for _ in range(n)]
    texts[3] = "too short"
    return {"doc_title": [None if i == 2 else f"Doc {i}" for i in range(n)], "body": texts,
            "other": list(range(n))}


@pytest.mark.parametrize("max_words", [5, 40, 100])
def test_docs_to_passages_equals_jax(max_words):
    cols = _documents(max_words)
    j = jdocs.docs_to_passages(datasets.Dataset.from_dict(cols), max_words, "doc_title", "body")
    t = tdocs.docs_to_passages(ColumnDataset(cols), max_words, "doc_title", "body")
    assert t.column_names == j.column_names == ["title", "text"] and rows(t) == rows(j) and len(t) > 12
    for bad in ("title", "missing"):
        with pytest.raises(AssertionError):
            tdocs.docs_to_passages(ColumnDataset(cols), max_words, bad, "body")
    capped = tdocs.docs_to_passages(ColumnDataset(cols), max_words, "doc_title", "body", max_docs=4)
    assert set(capped["title"]) <= set(t["title"]) and len({x for x in capped["title"]}) <= 4
    assert tdocs.split_text("a b c d e", 2) == jdocs.split_text("a b c d e", 2)


def test_main_to_csv_writes_the_jax_bytes(tmp_path):
    cols = _documents(11)
    cols = {"title": [t or "" for t in cols["doc_title"]], "text": cols["body"]}
    datasets.Dataset.from_dict(cols).save_to_disk(str(tmp_path / "saved"))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jdocs.main_to_csv(str(tmp_path / "saved"), output_dir=str(tmp_path / "jax"), max_words=30)
    write_jsonl([{"title": a, "text": b} for a, b in zip(cols["title"], cols["text"])], str(tmp_path / "docs.jsonl"))
    got = tdocs.main_to_csv(str(tmp_path / "docs.jsonl"), output_dir=str(tmp_path / "port"), max_words=30)
    assert open(got, "rb").read() == open(want, "rb").read()
    with pytest.raises(NotImplementedError, match="'datasets'"):
        tdocs.main_to_csv(str(tmp_path / "saved"), output_dir=str(tmp_path / "port"))


def test_json_dir_to_tsv_writes_the_jax_bytes(tmp_path):
    src = tmp_path / "patents"
    src.mkdir()
    rng = np.random.default_rng(6)
    for i in range(23):
        patent = {"bibliographic_information": {"title_of_invention": f"Invention\t{i}, \"quoted\""}}
        if i % 4:
            patent["abstract_information"] = {"paragraphs": [domain_text(rng, 2), f"line\n{i}"]}
        elif i % 8 == 0:
            patent["abstract_information"] = "a plain abstract"
        (src / f"p{i:02d}.json").write_text(json.dumps(patent))
    (src / "broken.json").write_text("{not json")
    n_j = jjson.json_dir_to_tsv(str(src), str(tmp_path / "jax.tsv"), batch_size=4)
    n_t = tjson.json_dir_to_tsv(str(src), str(tmp_path / "port.tsv"), batch_size=4)
    assert n_t == n_j == 20 and (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()


@pytest.mark.parametrize("limit", [None, 3])
def test_check_dataset_rows_equal_jax(tmp_path, capsys, limit):
    path = write_passages_csv(tmp_path / "passages.csv", 7, 3, seed=8, extra=False)
    jcheck.main(path, limit)
    j = capsys.readouterr().out.splitlines()
    tcheck.main(path, limit)
    t = capsys.readouterr().out.splitlines()
    assert t[0] == "ColumnDataset(columns=['Title', 'Abstract'], num_rows=7)" and j[0].startswith("Dataset(")
    j_rows = j[j.index("})") + 1:]  # the datasets repr spans four lines
    assert t[1:] == j_rows and len(t) == (5 if limit else 8)
