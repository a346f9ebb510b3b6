"""Print a dataset's rows — debugging helper (counterpart of
``dalm_tpu/data/check_dataset.py``).

Usage: ``python -m dalm_tpu_torch.data.check_dataset <csv_json_or_jsonl> [limit]``

The row lines are the JAX package's; the first line is the port's
``ColumnDataset`` repr where the JAX package prints the ``datasets.Dataset`` one.
A ``datasets`` directory raises ``NotImplementedError`` (``data/loading.py``).
"""

from __future__ import annotations

import sys

from dalm_tpu_torch.data.loading import load_dataset


def main(path: str, limit: int | None = None) -> None:
    dataset = load_dataset(path)
    print(dataset)
    for idx, row in enumerate(dataset.rows()):
        if limit is not None and idx >= limit:
            print(f"... ({len(dataset) - limit} more rows)")
            break
        print(f"Row {idx}: {row}")


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit("usage: python -m dalm_tpu_torch.data.check_dataset <path> [limit]")
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else None)
