"""Adam, AdamW and SGD with an optax-like (init, update) interface, over
dict params, and gradient clipping.

Counterpart of ``repro/optim/optimizers.py`` (``Optimizer``,
``apply_updates``, ``adam``, ``adamw``, ``sgd``,
``clip_by_global_norm``, ``chain_clip``); the paper trains GRLE's GCN
with Adam at lr = 1e-3 (§VI-A), the LM training path uses AdamW. The
arithmetic is the reference's, not ``torch.optim.Adam``'s: the update is
``-lr * (mu / bc1) / (sqrt(nu / bc2) + eps)``, eps added after the
square root of the bias-corrected second moment, with ``bc = 1 - b **
step`` in float32. The state is ``{"step": int32, "mu": tree, "nu":
tree}`` and every function is pure: it returns new tensors. The leaves
go through ``torch._foreach_*`` ops, one multi-tensor launch per
operation on the card.

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``lr`` is a float or a schedule ``step -> lr`` (``optim/schedules.py``),
called with the 0-d int32 step after the increment. The moments keep
each param's dtype (bf16 for a bf16 model), as the reference's
``tree_zeros_like`` does; their Python constants (b1, 1 - b1, ...) are
rounded to the moment's dtype, as the reference's weakly typed scalars
are; Adam's and AdamW's updates are computed in float32 and
``apply_updates`` adds them in float32 before casting to the param's
dtype, as the reference's type promotion does (its bias corrections are
float32 arrays).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.nn.pytree import (flatten_dict, tree_global_norm,
                                   tree_zeros_like, unflatten_dict)


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _leaves(tree: dict):
    flat = flatten_dict(tree)
    return list(flat), list(flat.values())


def _tree(paths, leaves) -> dict:
    return unflatten_dict(dict(zip(paths, leaves)))


def _f32(xs: list) -> list:
    """The leaves in float32 (the float32 ones themselves, not copies)."""
    return [x.float() for x in xs]


def _scaled(xs: list, c: float) -> list:
    """Each leaf times ``c`` rounded to the leaf's dtype first, as the
    reference's weakly typed Python scalars are (a bf16 moment times 0.9
    multiplies by bf16's 0.9); float32 leaves are unaffected."""
    rounded = {x.dtype: torch.tensor(c, dtype=x.dtype).item() for x in xs}
    return torch._foreach_mul(xs, [rounded[x.dtype] for x in xs])


def apply_updates(params: dict, updates: dict) -> dict:
    """``params + updates`` leaf by leaf (in the wider of the two dtypes),
    cast to each param's dtype."""
    paths, p = _leaves(params)
    u = [flatten_dict(updates)[k] for k in paths]
    new = torch._foreach_add(p, u)
    return _tree(paths, [n.to(x.dtype) for n, x in zip(new, p)])


def scale_updates(updates: dict, scale) -> dict:
    """Every update times ``scale`` (the ``lr=`` rescale of
    ``AgentDef.train_step``: Adam's update is linear in lr)."""
    paths, u = _leaves(updates)
    return _tree(paths, torch._foreach_mul(u, scale))


def _sched(lr):
    return lr if callable(lr) else (lambda step: lr)


def _zero_step(params: dict) -> torch.Tensor:
    device = next(iter(flatten_dict(params).values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Optimizer:
    lr_fn = _sched(lr)

    def init(params: dict) -> dict:
        return {"step": _zero_step(params), "mu": tree_zeros_like(params),
                "nu": tree_zeros_like(params)}

    def update(grads: dict, state: dict, params=None):
        del params
        step = state["step"] + 1
        paths, g = _leaves(grads)
        m = [flatten_dict(state["mu"])[k] for k in paths]
        v = [flatten_dict(state["nu"])[k] for k in paths]
        mu = torch._foreach_add(_scaled(m, b1), _scaled(g, 1 - b1))
        nu = torch._foreach_add(_scaled(v, b2),
                                _scaled(torch._foreach_mul(g, g), 1 - b2))
        sf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, sf)
        bc2 = 1.0 - torch.pow(b2, sf)
        lr_t = lr_fn(step)
        num = torch._foreach_mul(torch._foreach_div(_f32(mu), bc1), -lr_t)
        den = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(_f32(nu), bc2)), eps)
        updates = torch._foreach_div(num, den)
        return _tree(paths, updates), {"step": step, "mu": _tree(paths, mu),
                                       "nu": _tree(paths, nu)}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """Adam plus decoupled weight decay: ``adam``'s update minus ``lr_t *
    weight_decay * param``, at the same step's ``lr_t``."""
    lr_fn = _sched(lr)
    base = adam(lr, b1, b2, eps)

    def update(grads: dict, state: dict, params: dict):
        lr_t = lr_fn(state["step"] + 1)
        updates, state = base.update(grads, state)
        paths, u = _leaves(updates)
        p = [flatten_dict(params)[k] for k in paths]
        decay = torch._foreach_mul(_f32(p), lr_t * weight_decay)
        return _tree(paths, torch._foreach_sub(u, decay)), state

    return Optimizer(base.init, update)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    """``-lr_t * g``, or with ``momentum`` ``-lr_t * vel``, ``vel = momentum
    * vel + g`` (state ``{"step", "vel"}``)."""
    lr_fn = _sched(lr)

    def init(params: dict) -> dict:
        st = {"step": _zero_step(params)}
        if momentum:
            st["vel"] = tree_zeros_like(params)
        return st

    def update(grads: dict, state: dict, params=None):
        del params
        step = state["step"] + 1
        lr_t = lr_fn(step)
        paths, g = _leaves(grads)
        if momentum:
            v = [flatten_dict(state["vel"])[k] for k in paths]
            vel = torch._foreach_add(_scaled(v, momentum), g)
            updates = torch._foreach_mul(vel, -lr_t)
            return _tree(paths, updates), {"step": step,
                                           "vel": _tree(paths, vel)}
        return _tree(paths, torch._foreach_mul(g, -lr_t)), {"step": step}

    return Optimizer(init, update)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled by ``min(1, max_norm / (norm + 1e-9))``, norm), the
    norm over every leaf (``tree_global_norm``)."""
    norm = tree_global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    paths, g = _leaves(grads)
    return _tree(paths, torch._foreach_mul(g, scale)), norm


def chain_clip(opt: Optimizer, max_norm: float) -> Optimizer:
    """``opt`` on gradients clipped to global norm ``max_norm``."""

    def update(grads: dict, state: dict, params=None):
        grads, _ = clip_by_global_norm(grads, max_norm)
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update)
