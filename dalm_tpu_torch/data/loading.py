"""Dataset loading without third-party packages: a small column store over
CSV / JSON / JSON-lines files (the reference reads the same files through
the ``datasets`` package, ``dalm_tpu/data/loading.py``).

``ColumnDataset`` keeps the few ``datasets.Dataset`` operations the data
layer runs, with the same results: ``shuffle(seed)`` (the permutation
``numpy.random.default_rng(seed).permutation(n)`` that ``Dataset.shuffle``
draws), ``select``, a row-wise ``filter`` that keeps the order, and
``to_csv`` (the bytes ``Dataset.to_csv`` writes: pandas' CSV without the
index, LF line ends, nothing at all for zero rows). CSV cells are read
as strings, where ``datasets`` infers numbers."""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, Sequence, Union

import numpy as np


class ColumnDataset:
    """Columns of equal length, ``{name: list}``. ``ds[name]`` is a column,
    ``len(ds)`` the row count."""

    def __init__(self, columns: Mapping[str, Sequence]):
        self.columns: Dict[str, List] = {k: list(v) for k, v in columns.items()}
        lengths = {len(v) for v in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns differ in length: {sorted(lengths)}")

    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def __getitem__(self, name: str) -> List:
        return self.columns[name]

    def map(self, fn: Callable[[Mapping[str, List]], Mapping[str, Sequence]]) -> "ColumnDataset":
        """``fn`` takes all columns at once and returns the new columns (the
        old ones are dropped)."""
        return ColumnDataset(fn(self.columns))

    def __repr__(self) -> str:
        return f"ColumnDataset(columns={self.column_names}, num_rows={len(self)})"

    def row(self, i: int) -> Dict[str, Any]:
        return {name: col[i] for name, col in self.columns.items()}

    def rows(self) -> Iterator[Dict[str, Any]]:
        return (self.row(i) for i in range(len(self)))

    def select(self, indices: Iterable[int]) -> "ColumnDataset":
        idx = list(indices)
        return ColumnDataset({name: [col[i] for i in idx] for name, col in self.columns.items()})

    def shuffle(self, seed: int) -> "ColumnDataset":
        return self.select(np.random.default_rng(seed).permutation(len(self)).tolist())

    def filter(self, keep: Callable[[Dict[str, Any]], bool]) -> "ColumnDataset":
        """The rows for which ``keep(row)`` is true, in their order."""
        return self.select(i for i in range(len(self)) if keep(self.row(i)))

    def to_csv(self, path: str) -> None:
        with open(path, "w", newline="", encoding="utf-8") as f:
            if len(self):
                w = csv.writer(f, lineterminator="\n")
                w.writerow(self.column_names)
                w.writerows(zip(*self.columns.values()))


def from_rows(rows: Sequence[Mapping]) -> ColumnDataset:
    """Rows of one schema (the first row's keys) as columns."""
    names = list(rows[0]) if rows else []
    return ColumnDataset({n: [r[n] for r in rows] for n in names})


def write_jsonl(rows: Iterable[Mapping], path: str) -> None:
    """One JSON object a line."""
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def load_dataset(dataset_or_path: Union[str, ColumnDataset, Mapping[str, Sequence]]) -> ColumnDataset:
    """A ``ColumnDataset``, a mapping of columns, or the path of a ``.csv``,
    ``.json`` (list of rows or mapping of columns) or ``.jsonl`` file."""
    if isinstance(dataset_or_path, ColumnDataset):
        return dataset_or_path
    if isinstance(dataset_or_path, Mapping):
        return ColumnDataset(dataset_or_path)
    path = str(dataset_or_path)
    if os.path.isdir(path):
        raise NotImplementedError(f"{path!r} is a directory: a dataset saved by save_to_disk needs the 'datasets' "
                                  "package, which the port does not use; give a .csv, .json or .jsonl file")
    if path.endswith(".jsonl"):
        with open(path) as f:
            return from_rows([json.loads(line) for line in f if line.strip()])
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        return ColumnDataset(data) if isinstance(data, Mapping) else from_rows(data)
    with open(path, newline="") as f:
        return from_rows(list(csv.DictReader(f)))
