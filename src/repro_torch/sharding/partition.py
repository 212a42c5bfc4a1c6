"""Partition rules: parameter and cache specs per architecture, and their
DTensor placements.

Counterpart of ``repro/sharding/partition.py``, whose scheme this keeps:

  * tensor parallel on the ``model`` axis: attention heads, FFN columns,
    MoE experts, vocab;
  * data parallel on ``(pod, data)`` for batch dims;
  * ``cfg.fsdp`` also splits the non-model weight dim (and so the Adam
    state) over ``data``.

Every rule is checked against the mesh: a dim that does not divide its
axis falls back to no split (Whisper's odd 51865 vocab; 8 KV heads on a
16-way ``model`` axis, whose caches split ``head_dim`` instead). A spec is
a ``PSpec``, one entry per tensor dim: None, an axis name, or a tuple of
names (split over their product), as the reference's ``PartitionSpec``.
The rules read a mesh's axis names and sizes only, so they take a
``DeviceMesh`` or a shape-only ``launch.mesh.ShapeMesh`` alike.

``to_placements`` turns a spec into DTensor placements on a
``DeviceMesh`` (``Shard(d)`` / ``Replicate()`` per mesh dim),
``distribute_tree`` places a tree of tensors under its specs (the
reference's ``make_named_sharding`` + ``device_put``), ``batch_pspecs``
gives a step's batch (and decode tokens and positions) their batch split
(the caches' specs are ``cache_pspecs``), ``shard_shapes`` gives each
device's local shapes on the meta device (the reference's
``shard_tree_specs``), and ``fake_tree`` places a tree of meta tensors as
DTensors whose local shards are fake tensors of those shapes (the dry
run's route: no full tensor is ever made, so a 236B config costs what a
0.5B one does).
"""
from __future__ import annotations

import math
import re
from typing import Optional

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.nn.pytree import (flatten_dict, tree_refill, tree_tensors,
                                   unflatten_dict)


class PSpec(tuple):
    """A partition spec: per tensor dim, the mesh axis (or axes) it is
    split over, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "PSpec" + tuple.__repr__(self)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or ``ShapeMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(sizes: dict, name) -> int:
    if isinstance(name, tuple):
        return math.prod(sizes[n] for n in name)
    return sizes[name]


def _fits(dim: Optional[int], sizes: dict, axis) -> bool:
    if axis is None or dim is None:
        return True
    return dim % _axis_size(sizes, axis) == 0


def _spec(shape, sizes, *axes) -> PSpec:
    """A spec of ``axes``, each dropped where it does not divide."""
    return PSpec(*(ax if (ax is not None and _fits(dim, sizes, ax)) else None
                   for dim, ax in zip(shape, axes)))


# Suffix-pattern rules: (regex on the flattened path, (axis per dim)).
# 'M' = model axis, 'F' = fsdp axis (data, only when cfg.fsdp), '-' = none.
_RULES = [
    (r"embed/table$",            ("M", "F")),
    (r"lm_head/w$",              ("F", "M")),
    (r"(wq|wk|wv|wg|cm_k|cm_r)/w$", ("F", "M")),
    (r"(wq|wk|wv|wg)/b$",        ("M",)),
    (r"(wo|cm_v|w_o|out_proj)/w$", ("M", "F")),
    (r"(w1|w3|fc1)/w$",          ("F", "M")),
    (r"(w2|fc2)/w$",             ("M", "F")),
    (r"router/w$",               ("-", "-")),
    # MoE expert tensors [E, d, m] / [E, m, d]
    (r"ffn/w1$",                 ("M", "F", "-")),
    (r"ffn/w3$",                 ("M", "F", "-")),
    (r"ffn/w2$",                 ("M", "F", "-")),
    # MLA
    (r"w_dkv/w$",                ("F", "-")),
    (r"w_kpe/w$",                ("-", "-")),
    (r"w_uk$",                   ("F", "M", "-")),
    (r"w_uv$",                   ("F", "M", "-")),
    # Mamba2
    (r"in_proj/w$",              ("F", "M")),
    (r"conv_w$",                 ("-", "M")),
    (r"conv_b$",                 ("M",)),
    # RWKV6
    (r"lora_a$",                 ("F", "-")),
    (r"lora_b$",                 ("-", "M")),
]


def _rule_for(path: str, shape, cfg: ArchConfig, sizes: dict) -> PSpec:
    # layer-stacked params have a leading L axis: the rule shifts right by
    # one (the stack is told by the path's prefix, not the shape)
    stacked = bool(re.search(r"(^|/)(blocks|encoder|exit_norms)/", path))
    for pat, axes in _RULES:
        if re.search(pat, path):
            names = [{"M": "model", "F": "data" if cfg.fsdp else None}
                     .get(a) for a in axes]
            if stacked:
                names = [None] + names
            # rule axes beyond the rank are ignored
            names = names[: len(shape)]
            names += [None] * (len(shape) - len(names))
            return _spec(shape, sizes, *names)
    return PSpec(*([None] * len(shape)))   # norms, scalars, small tensors


def param_pspecs(cfg: ArchConfig, params_shape: dict, mesh) -> dict:
    """A param tree (tensors, meta ones too) -> the same tree of specs."""
    sizes = axis_sizes(mesh)
    flat = flatten_dict(params_shape)
    return unflatten_dict({p: _rule_for(p, tuple(v.shape), cfg, sizes)
                           for p, v in flat.items()})


def batch_pspec(mesh):
    """Leading-batch split over every data-like axis present."""
    axes = tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _batch_axes(mesh, dim: int):
    """Best data-parallel split of a batch dim of the given size."""
    sizes = axis_sizes(mesh)
    for c in (("pod", "data"), ("data",), ("pod",)):
        names = tuple(n for n in c if n in sizes)
        if names and dim % _axis_size(sizes, names) == 0:
            return names if len(names) > 1 else names[0]
    return None


def batch_pspecs(tree, mesh):
    """A spec for every leaf of a tree of batch-leading tensors (a step's
    batch; decode's tokens and positions): the leading dim over the best
    data-parallel split that divides it (``_batch_axes``), the rest
    whole."""
    return tree_refill(tree, iter([
        PSpec(_batch_axes(mesh, x.shape[0]), *([None] * (x.dim() - 1)))
        for x in tree_tensors(tree)]))


def cache_pspecs(cfg: ArchConfig, cache_shape: dict, mesh,
                 seq_len: int) -> dict:
    """Specs of the decode caches, by shape (``seq_len`` is the cache
    length, which tells KV buffers [L, B, S, ...] from recurrent states
    [L, B, H, ...]).

    GQA cache [L, B, S, KVH, hd]: batch over (pod, data) where it divides;
    KV heads over ``model`` where they divide, else (``seqshard_cache``)
    the sequence, else head_dim over ``model``, else the sequence over
    ``data`` (long context, batch 1).
    """
    from repro_torch.sharding.runtime import enabled

    sizes = axis_sizes(mesh)
    kv_len = min(seq_len, cfg.window) if cfg.window else seq_len

    def model_fits(dim: int) -> bool:
        return _fits(dim, sizes, "model") and dim >= sizes["model"]

    def is_seq(dim: int) -> bool:
        return dim in (seq_len, kv_len, cfg.n_audio_frames)

    def spec_for(v, layer_stacked: bool) -> PSpec:
        shape = tuple(v.shape)
        if not layer_stacked:                    # enc_out [B, frames, d]
            return _spec(shape, sizes, _batch_axes(mesh, shape[0]), None,
                         "model")
        baxes = _batch_axes(mesh, shape[1])
        rest = shape[2:]
        if len(rest) == 3 and is_seq(rest[0]):   # GQA [S, KVH, hd]
            s, kvh, hd = rest
            if model_fits(kvh):
                return PSpec(None, baxes, None, "model", None)
            # KV heads do not divide the model axis: split the sequence on
            # it (flash-decode style) rather than head_dim
            if enabled("seqshard_cache") and model_fits(s):
                return PSpec(None, baxes, "model", None, None)
            if model_fits(hd):
                if baxes is None and _fits(s, sizes, "data"):
                    return PSpec(None, None, "data", None, "model")
                return PSpec(None, baxes, None, None, "model")
            if baxes is None and _fits(s, sizes, "data"):
                return PSpec(None, None, "data", None, None)
            return PSpec(None, baxes, None, None, None)
        if len(rest) == 2 and is_seq(rest[0]):   # MLA [S, r] / [S, rope]
            s, r = rest
            if model_fits(r):
                if baxes is None and _fits(s, sizes, "data"):
                    return PSpec(None, None, "data", "model")
                return PSpec(None, baxes, None, "model")
            if baxes is None and _fits(s, sizes, "data"):
                return PSpec(None, None, "data", None)
            return PSpec(None, baxes, None, None)
        if len(rest) == 3:                       # ssm state [H, dk, dv]
            return PSpec(None, baxes, "model" if model_fits(rest[0])
                         else None, None, None)
        if len(rest) == 2:                       # conv state [K-1, C]
            return PSpec(None, baxes, None, "model"
                         if _fits(rest[1], sizes, "model") else None)
        if len(rest) == 1:                       # shift state [d]
            return _spec(shape, sizes, None, baxes, "model")
        return PSpec(*([None] * len(shape)))

    return {k: tree_refill(sub, iter([spec_for(v, k != "enc_out")
                                      for v in tree_tensors(sub)]))
            for k, sub in cache_shape.items()}


# ------------------------------------------------------------ placements
def _pairs(tree, specs):
    """(tensor, spec) of every leaf of ``tree`` and its spec tree, in
    ``tree_tensors`` order."""
    if isinstance(tree, torch.Tensor):
        if not isinstance(specs, PSpec):
            raise ValueError(f"no spec for a tensor of shape "
                             f"{tuple(tree.shape)}: {specs!r}")
        return [(tree, specs)]
    if isinstance(tree, dict):
        return [p for k in tree for p in _pairs(tree[k], specs[k])]
    if isinstance(tree, (tuple, list)):
        return [p for x, s in zip(tree, specs) for p in _pairs(x, s)]
    return []


def to_placements(spec: PSpec, device_mesh) -> list:
    """DTensor placements of ``spec`` on ``device_mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` that names it, else
    ``Replicate()``. A dim split over several axes (("pod", "data")) names
    them in mesh order, as the reference lays them out major to minor."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(device_mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec!r} names axis {a!r}, not in "
                                 f"the mesh's {tuple(names)}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r}: axes {axes} out of the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def distribute_tree(tree, specs, device_mesh):
    """``tree`` (the same full tensors on every rank) as DTensors placed
    under ``specs`` on ``device_mesh``, the same structure."""
    from torch.distributed.tensor import distribute_tensor

    return tree_refill(tree, iter([
        distribute_tensor(x, device_mesh, to_placements(s, device_mesh))
        for x, s in _pairs(tree, specs)]))


def local_shape(shape, spec: PSpec, mesh) -> tuple:
    """One device's shape of a tensor of ``shape`` under ``spec``."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        k = 1 if entry is None else _axis_size(sizes, entry)
        if dim % k:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"{entry!r} ({k} devices)")
        out.append(dim // k)
    return tuple(out)


def shard_shapes(tree, specs, mesh):
    """Each device's shard of every tensor of ``tree`` under ``specs``: a
    tensor of the local shape and the same dtype on the meta device."""
    return tree_refill(tree, iter([
        torch.empty(local_shape(x.shape, s, mesh), dtype=x.dtype,
                    device="meta") for x, s in _pairs(tree, specs)]))


def fake_tree(tree, specs, device_mesh, fake_mode):
    """``tree`` (tensors whose shapes and dtypes count, on any device: the
    meta device's do) as DTensors on ``device_mesh`` under ``specs``, each
    local shard a tensor of ``fake_mode`` (a ``FakeTensorMode``) of this
    device's shape on the mesh's device type. Nothing is allocated."""
    from torch.distributed.tensor import DTensor

    def place(x, spec):
        shape = local_shape(x.shape, spec, device_mesh)
        with fake_mode:
            local = torch.empty(shape, dtype=x.dtype,
                                device=device_mesh.device_type)
        return DTensor.from_local(local, device_mesh,
                                  to_placements(spec, device_mesh),
                                  run_check=False, shape=x.shape,
                                  stride=torch.empty(
                                      x.shape, device="meta").stride())

    return tree_refill(tree, iter([place(x, s)
                                   for x, s in _pairs(tree, specs)]))
