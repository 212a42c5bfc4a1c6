"""Shape-only input specs for every (arch × input shape), on one card or
per device of a mesh.

Counterpart of ``repro/launch/specs.py``. Everything here lives on
PyTorch's ``meta`` device, tensors with a shape and a dtype and no memory
(the reference's ``jax.eval_shape``), so the 236B configs are as cheap to
spec as the 0.5B ones. Each function returns the reference's tree (the same
paths, shapes and dtypes), built from ``param_shapes``/``param_dtypes``,
``init_cache(device="meta")`` and the optimizer's own ``init``. Without a
mesh the tree is whole (one card); with one (a ``DeviceMesh``, or the
shape-only ``launch.mesh.make_production_mesh``) every tensor is one
device's shard under the reference's partition rules
(``sharding/partition.py``: ``params_specs``, ``train_state_specs`` and
``cache_specs`` give the specs themselves), the per-device shapes of the
reference's ``NamedSharding`` structs. ``params_struct`` returns the tree
alone and ``train_state_struct`` the state and the optimizer. The dry run
(``launch/dryrun.py``) reads its static bytes from them.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.models.lm import model_for
from repro_torch.optim import adamw
from repro_torch.sharding.partition import (PSpec, _batch_axes, cache_pspecs,
                                            param_pspecs, shard_shapes)
from repro_torch.sharding.runtime import enabled
from repro_torch.train.steps import make_train_state

LONG_CONTEXT_WINDOW = 8192
META = torch.device("meta")


def arch_for_shape(cfg: ArchConfig, shape: ShapeSpec) -> ArchConfig:
    """Shape-dependent config tweaks, the reference's rule: ``long_500k``
    on a quadratic-attention family switches to sliding-window decode
    attention (``LONG_CONTEXT_WINDOW`` rows); the SSM archs run natively
    and Zamba2 (``hybrid``) keeps its full shared-attention cache."""
    if (shape.name == "long_500k" and cfg.attn_kind != "none"
            and cfg.family != "hybrid"):
        return dataclasses.replace(cfg, window=LONG_CONTEXT_WINDOW)
    return cfg


def leaves(tree, prefix: str = ""):
    """(path, tensor) of every leaf of a tree of dicts, NamedTuples,
    tuples and lists: keys, field names and indices joined by "/"."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from leaves(v, f"{prefix}/{k}" if prefix else str(k))


def tree_nbytes(tree) -> int:
    """Bytes of every leaf of ``tree`` (``leaves``), as allocated."""
    return sum(t.numel() * t.element_size() for _, t in leaves(tree))


def _meta_tree(shapes, dtypes):
    if isinstance(shapes, dict):
        return {k: _meta_tree(v, dtypes[k]) for k, v in shapes.items()}
    return torch.empty(shapes, dtype=dtypes, device=META)


def _global_params(cfg: ArchConfig) -> dict:
    model = model_for(cfg)
    return _meta_tree(model.param_shapes(cfg), model.param_dtypes(cfg))


def params_specs(cfg: ArchConfig, mesh) -> dict:
    """The inference param specs on ``mesh``: the partition rules, with
    ``no_fsdp_infer`` (``REPRO_OPT``) without the FSDP ``data`` split."""
    if enabled("no_fsdp_infer") and cfg.fsdp:
        cfg = dataclasses.replace(cfg, fsdp=False)
    return param_pspecs(cfg, _global_params(cfg), mesh)


def params_struct(cfg: ArchConfig, mesh=None) -> dict:
    """The param tree of ``model_for(cfg)`` on the meta device: whole, or
    one device's shards on ``mesh``."""
    params = _global_params(cfg)
    if mesh is None:
        return params
    return shard_shapes(params, params_specs(cfg, mesh), mesh)


def train_state_specs(cfg: ArchConfig, state, mesh):
    """Specs of a ``TrainState``: the params' rules for the params and both
    moments, the optimizer's and the state's step whole."""
    pspecs = param_pspecs(cfg, state.params, mesh)
    opt = {k: (PSpec() if k == "step" else param_pspecs(cfg, v, mesh))
           for k, v in state.opt_state.items()}
    return type(state)(pspecs, opt, PSpec())


def train_state_struct(cfg: ArchConfig, optimizer=None, mesh=None):
    """(TrainState, optimizer) on the meta device: the params, the
    optimizer's state (``adamw(3e-4)`` by default: step, mu, nu) and the
    step, as ``train.steps.make_train_state`` builds them; on ``mesh`` one
    device's shards."""
    state, opt = make_train_state(cfg, None, optimizer or adamw(3e-4),
                                  params=_global_params(cfg))
    if mesh is not None:
        state = shard_shapes(state, train_state_specs(cfg, state, mesh),
                             mesh)
    return state, opt


def _batched(mesh, shape, dtype):
    """A batch-leading tensor: whole, or split over the mesh's data axes
    where they divide."""
    if mesh is not None:
        spec = PSpec(_batch_axes(mesh, shape[0]), *([None] * (len(shape) - 1)))
        return shard_shapes(torch.empty(shape, dtype=dtype, device=META),
                            spec, mesh)
    return torch.empty(shape, dtype=dtype, device=META)


def batch_struct(cfg: ArchConfig, shape: ShapeSpec, mesh=None) -> dict:
    """The step's batch: int32 tokens (and labels, but for ``prefill``)
    [global_batch, seq_len], and Whisper's audio frames; on ``mesh`` one
    device's shards."""
    gb, s = shape.global_batch, shape.seq_len
    batch = {
        "tokens": _batched(mesh, (gb, s), torch.int32),
        "labels": _batched(mesh, (gb, s), torch.int32),
    }
    if cfg.enc_layers:
        batch["audio"] = _batched(mesh, (gb, cfg.n_audio_frames, cfg.d_model),
                                  cfg.torch_dtype)
    if shape.mode == "prefill":
        del batch["labels"]
    return batch


def cache_specs(cfg: ArchConfig, shape: ShapeSpec, mesh) -> dict:
    """Specs of ``decode_struct``'s cache on ``mesh``."""
    b, s = shape.global_batch, shape.seq_len
    cache = model_for(cfg).init_cache(cfg, b, s, device=META)
    return cache_pspecs(cfg, cache, mesh, s)


def decode_struct(cfg: ArchConfig, shape: ShapeSpec, mesh=None):
    """(cache, tokens, pos) of one decode step: ``init_cache`` over
    ``seq_len`` rows (under a window the ring) and int32 tokens and
    positions [global_batch]; on ``mesh`` one device's shards."""
    b, s = shape.global_batch, shape.seq_len
    cache = model_for(cfg).init_cache(cfg, b, s, device=META)
    if mesh is not None:
        cache = shard_shapes(cache, cache_pspecs(cfg, cache, mesh, s), mesh)
    tokens = _batched(mesh, (b,), torch.int32)
    pos = _batched(mesh, (b,), torch.int32)
    return cache, tokens, pos


def describe(cfg: ArchConfig) -> dict:
    """Parameter count + activated params (MoE)."""
    total = sum(math.prod(t.shape) for _, t in leaves(_global_params(cfg)))
    active = total
    if cfg.is_moe:
        per_expert = 3 * cfg.d_model * cfg.moe_d_ff
        inactive = cfg.n_layers * (cfg.n_experts - cfg.top_k) * per_expert
        active = total - inactive
    return {"params": int(total), "active_params": int(active)}
