"""Dataset loading without third-party packages: a small column store over
CSV / JSON / JSON-lines files (the reference reads the same files through
the ``datasets`` package, ``dalm_tpu/data/loading.py``)."""

from __future__ import annotations

import csv
import json
from typing import Callable, Dict, List, Mapping, Sequence, Union


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


def _from_rows(rows: Sequence[Mapping]) -> ColumnDataset:
    names = list(rows[0]) if rows else []
    return ColumnDataset({n: [r[n] for r in rows] for n in names})


def load_dataset(dataset_or_path: Union[str, ColumnDataset, Mapping[str, Sequence]]) -> ColumnDataset:
    """A ``ColumnDataset``, a mapping of columns, or the path of a ``.csv``,
    ``.json`` (list of rows or mapping of columns) or ``.jsonl`` file."""
    if isinstance(dataset_or_path, ColumnDataset):
        return dataset_or_path
    if isinstance(dataset_or_path, Mapping):
        return ColumnDataset(dataset_or_path)
    path = str(dataset_or_path)
    if path.endswith(".jsonl"):
        with open(path) as f:
            return _from_rows([json.loads(line) for line in f if line.strip()])
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        return ColumnDataset(data) if isinstance(data, Mapping) else _from_rows(data)
    with open(path, newline="") as f:
        return _from_rows(list(csv.DictReader(f)))
