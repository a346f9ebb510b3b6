"""Nested dicts of tensors <-> flat ``{"a.b.c": leaf}`` dicts (the shape of a
flax parameter tree and of a ``state_dict``)."""

from __future__ import annotations

from typing import Mapping


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """Nested dict -> {"a.b.c": leaf}."""
    out = {}
    for name, v in tree.items():
        key = f"{prefix}{name}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


def unflatten(flat: Mapping) -> dict:
    """{"a.b.c": leaf} -> nested dict."""
    tree: dict = {}
    for key, v in flat.items():
        set_path(tree, tuple(key.split(".")), v)
    return tree


def set_path(tree: dict, path: tuple, value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value
