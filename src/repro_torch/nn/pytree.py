"""Nested dicts of tensors (counterpart of ``repro/nn/pytree.py``).

A flat ``{path: leaf}`` view of a param tree and back (checkpoint paths),
zeros shaped like a tree (the optimizers' moments), and the reference's
size, bytes, cast, path-map and global-norm helpers. A leaf is a tensor;
``tree_map_with_path`` also walks lists and tuples, as the reference's.
``tree_tensors``/``tree_refill`` walk the carries of the rollout driver
(NamedTuples, tuples and dicts, with host ints and None beside the
tensors).
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


def _leaves(tree) -> list:
    return list(flatten_dict(tree).values()) if isinstance(tree, dict) \
        else [tree]


def tree_size(tree) -> int:
    """Total number of scalar parameters."""
    return sum(x.numel() for x in _leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


def tree_map_with_path(fn, tree):
    """Map ``fn(path_str, leaf) -> leaf`` over a nested dict (lists and
    tuples indexed by position), paths joined with "/"."""

    def rec(prefix, node):
        if isinstance(node, dict):
            return {k: rec(f"{prefix}/{k}" if prefix else k, v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(f"{prefix}/{i}", v)
                              for i, v in enumerate(node))
        return fn(prefix, node)

    return rec("", tree)


def tree_cast(tree, dtype):
    """Floating leaves cast to ``dtype``; the others kept."""
    return tree_map_with_path(
        lambda _, x: x.to(dtype) if x.is_floating_point() else x, tree)


def tree_global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def tree_tensors(tree) -> list:
    """The tensors of a tree of NamedTuples, tuples and dicts, in a fixed
    order; host ints and None are skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_tensors(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in tree_tensors(v)]
    return []


def tree_refill(tree, leaves):
    """``tree`` with its tensors replaced, in ``tree_tensors`` order, by
    the items of the iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        return {k: tree_refill(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [tree_refill(v, leaves) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree
