"""Checkpoint / resume with the reference's layout (counterpart of
``dalm_tpu/train/checkpoints.py``, on ``torch.save``): periodic directories
``step_{k}`` and ``epoch_{e}`` under the output directory, each holding one
``state.pt``; resume parses the directory name."""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"


def save_state(root: str, tag: str, state_tree: Any) -> str:
    """Save under ``{root}/{tag}`` (tag = ``step_{k}`` or ``epoch_{e}``), atomically."""
    path = os.path.abspath(os.path.join(root, tag))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(_to_cpu(state_tree), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def load_state(path: str) -> Any:
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu", weights_only=True)


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree


def parse_checkpoint_tag(path: str) -> tuple:
    """``.../step_40`` -> ("step", 40); ``.../epoch_2`` -> ("epoch", 2)."""
    base = os.path.basename(os.path.normpath(path))
    m = re.fullmatch(r"(step|epoch)_(\d+)", base)
    if not m:
        raise ValueError(f"checkpoint dir {base!r} not of form step_<k>/epoch_<e>")
    return m.group(1), int(m.group(2))


def _tagged(root: str) -> list:
    """(kind, number, path) of every checkpoint directory under ``root``."""
    found = []
    if os.path.isdir(root):
        for d in os.listdir(root):
            full = os.path.join(root, d)
            if os.path.isdir(full):
                try:
                    kind, num = parse_checkpoint_tag(full)
                except ValueError:
                    continue
                found.append((kind, num, full))
    return found


def prune_checkpoints(root: str, keep_last: int = 3, kind: str = "step") -> int:
    """Remove all but the newest ``keep_last`` ``{kind}_*`` directories; returns how many went."""
    found = sorted((num, path) for k, num, path in _tagged(root) if k == kind)
    doomed = found[:-keep_last] if keep_last > 0 else found
    for _, path in doomed:
        shutil.rmtree(path, ignore_errors=True)
    return len(doomed)


def latest_checkpoint(root: str) -> Optional[str]:
    """The most recently written checkpoint directory under ``root``."""
    candidates = [(os.path.getmtime(path), kind, num, path) for kind, num, path in _tagged(root)]
    return max(candidates)[3] if candidates else None
