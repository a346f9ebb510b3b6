"""Patent-JSON → Title/Abstract TSV scraper (the port's own copy of
``dalm_tpu/data/json_pre_process.py``, the reference's corpus-prep script).

Walk a directory of patent JSON files, pull the abstract
(``abstract_information`` paragraphs) and title
(``bibliographic_information.title_of_invention``), and write a
tab-separated file with a ``Title\tAbstract`` header, skipping records
missing either field.
"""

from __future__ import annotations

import csv
import glob
import json
import logging
import os
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


def get_abstract(patent: Dict) -> Optional[str]:
    try:
        info = patent["abstract_information"]
        if isinstance(info, dict):
            paragraphs = info.get("paragraphs") or info.get("paragraph") or []
            if isinstance(paragraphs, list):
                return " ".join(str(p) for p in paragraphs) or None
            return str(paragraphs)
        return str(info)
    except Exception:
        return None


def get_title(patent: Dict) -> Optional[str]:
    try:
        return patent["bibliographic_information"]["title_of_invention"]
    except Exception:
        return None


def extract_batch(filenames: List[str]) -> Tuple[List[str], List[str], int]:
    """(abstracts, titles, skipped) for a batch of JSON files."""
    abstracts: List[str] = []
    titles: List[str] = []
    skipped = 0
    for filename in filenames:
        try:
            with open(filename) as f:
                patent = json.load(f)
        except Exception:
            skipped += 1
            continue
        abstract, title = get_abstract(patent), get_title(patent)
        if abstract is not None and title is not None:
            abstracts.append(abstract)
            titles.append(title)
        else:
            skipped += 1
    return abstracts, titles, skipped


def json_dir_to_tsv(json_dir: str, output_tsv: str, batch_size: int = 10) -> int:
    """Walk ``json_dir/*.json`` → TSV; returns rows written."""
    files = sorted(glob.glob(os.path.join(json_dir, "*.json")))
    written = 0
    total_skipped = 0
    with open(output_tsv, "w", newline="", encoding="utf-8") as out:
        writer = csv.writer(out, delimiter="\t", quotechar='"', quoting=csv.QUOTE_MINIMAL)
        writer.writerow(["Title", "Abstract"])
        for i in range(0, len(files), batch_size):
            abstracts, titles, skipped = extract_batch(files[i : i + batch_size])
            total_skipped += skipped
            for title, abstract in zip(titles, abstracts):
                writer.writerow([title, abstract])
                written += 1
    logger.info("wrote %d rows, skipped %d files", written, total_skipped)
    return written
