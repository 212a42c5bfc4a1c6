"""Shape-only input specs for every (arch × input shape), on one card.

Counterpart of ``repro/launch/specs.py``. Everything here lives on
PyTorch's ``meta`` device, tensors with a shape and a dtype and no memory
(the reference's ``jax.eval_shape``), so the 236B configs are as cheap to
spec as the 0.5B ones. Each function returns the reference's tree (the same
paths, shapes and dtypes), built from ``param_shapes``/``param_dtypes``,
``init_cache(device="meta")`` and the optimizer's own ``init``. One card
has no mesh: there is no mesh argument and no shardings, so
``params_struct`` returns the tree alone (the reference's also returns its
partition specs) and ``train_state_struct`` the state and the optimizer.
The dry run (``launch/dryrun.py``) reads its static bytes from them.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.models.lm import model_for
from repro_torch.optim import adamw
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


def params_struct(cfg: ArchConfig) -> dict:
    """The param tree of ``model_for(cfg)`` on the meta device."""
    model = model_for(cfg)
    return _meta_tree(model.param_shapes(cfg), model.param_dtypes(cfg))


def train_state_struct(cfg: ArchConfig, optimizer=None):
    """(TrainState, optimizer) on the meta device: the params, the
    optimizer's state (``adamw(3e-4)`` by default: step, mu, nu) and the
    step, as ``train.steps.make_train_state`` builds them."""
    return make_train_state(cfg, None, optimizer or adamw(3e-4),
                            params=params_struct(cfg))


def batch_struct(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """The step's batch: int32 tokens (and labels, but for ``prefill``)
    [global_batch, seq_len], and Whisper's audio frames."""
    gb, s = shape.global_batch, shape.seq_len
    batch = {
        "tokens": torch.empty((gb, s), dtype=torch.int32, device=META),
        "labels": torch.empty((gb, s), dtype=torch.int32, device=META),
    }
    if cfg.enc_layers:
        batch["audio"] = torch.empty((gb, cfg.n_audio_frames, cfg.d_model),
                                     dtype=cfg.torch_dtype, device=META)
    if shape.mode == "prefill":
        del batch["labels"]
    return batch


def decode_struct(cfg: ArchConfig, shape: ShapeSpec):
    """(cache, tokens, pos) of one decode step: ``init_cache`` over
    ``seq_len`` rows (under a window the ring) and int32 tokens and
    positions [global_batch]."""
    b, s = shape.global_batch, shape.seq_len
    cache = model_for(cfg).init_cache(cfg, b, s, device=META)
    tokens = torch.empty((b,), dtype=torch.int32, device=META)
    pos = torch.empty((b,), dtype=torch.int32, device=META)
    return cache, tokens, pos


def describe(cfg: ArchConfig) -> dict:
    """Parameter count + activated params (MoE)."""
    total = sum(math.prod(t.shape) for _, t in leaves(params_struct(cfg)))
    active = total
    if cfg.is_moe:
        per_expert = 3 * cfg.d_model * cfg.moe_d_ff
        inactive = cfg.n_layers * (cfg.n_experts - cfg.top_k) * per_expert
        active = total - inactive
    return {"params": int(total), "active_params": int(active)}
