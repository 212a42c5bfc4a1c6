"""Nested dicts of tensors (counterpart of ``repro/nn/pytree.py``).

Only what the training slice uses: a flat ``{path: leaf}`` view of a
param tree and back (checkpoint paths), and zeros shaped like a tree
(Adam's moments).
"""
from __future__ import annotations

import torch


def flatten_dict(d: dict, sep: str = "/", prefix: str = "") -> dict:
    """Nested dict -> flat ``{path: leaf}``, in the dict's own order."""
    out = {}
    for k, v in d.items():
        path = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_dict(v, sep=sep, prefix=path))
        else:
            out[path] = v
    return out


def unflatten_dict(flat: dict, sep: str = "/") -> dict:
    """Flat ``{path: leaf}`` -> nested dict."""
    out: dict = {}
    for path, v in flat.items():
        *heads, leaf = path.split(sep)
        node = out
        for k in heads:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def tree_zeros_like(tree: dict) -> dict:
    """Zeros of each leaf's shape, dtype and device, in the same tree."""
    return {k: tree_zeros_like(v) if isinstance(v, dict)
            else torch.zeros_like(v) for k, v in tree.items()}
