"""Adam with an optax-like (init, update) interface, over dict params.

Counterpart of ``repro/optim/optimizers.py`` (``Optimizer``,
``apply_updates``, ``adam``); the paper trains GRLE's GCN with Adam at
lr = 1e-3 (§VI-A). The arithmetic is the reference's, not
``torch.optim.Adam``'s: the update is ``-lr * (mu / bc1) / (sqrt(nu /
bc2) + eps)``, eps added after the square root of the bias-corrected
second moment, with ``bc = 1 - b ** step`` in float32. The state is
``{"step": int32, "mu": tree, "nu": tree}`` and every function is pure:
it returns new tensors. The leaves go through ``torch._foreach_*`` ops,
one multi-tensor launch per operation on the card.

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``adamw``, ``sgd`` and gradient clipping are not ported yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.nn.pytree import (flatten_dict, tree_zeros_like,
                                   unflatten_dict)


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _leaves(tree: dict):
    flat = flatten_dict(tree)
    return list(flat), list(flat.values())


def _tree(paths, leaves) -> dict:
    return unflatten_dict(dict(zip(paths, leaves)))


def apply_updates(params: dict, updates: dict) -> dict:
    """``params + updates`` leaf by leaf, in each param's dtype."""
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


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Optimizer:
    lr_fn = _sched(lr)

    def init(params: dict) -> dict:
        device = next(iter(flatten_dict(params).values())).device
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_zeros_like(params),
                "nu": tree_zeros_like(params)}

    def update(grads: dict, state: dict, params=None):
        del params
        step = state["step"] + 1
        paths, g = _leaves(grads)
        m = [flatten_dict(state["mu"])[k] for k in paths]
        v = [flatten_dict(state["nu"])[k] for k in paths]
        mu = torch._foreach_add(torch._foreach_mul(m, b1),
                                torch._foreach_mul(g, 1 - b1))
        nu = torch._foreach_add(torch._foreach_mul(v, b2),
                                torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - b2))
        sf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, sf)
        bc2 = 1.0 - torch.pow(b2, sf)
        lr_t = lr_fn(step)
        num = torch._foreach_mul(torch._foreach_div(mu, bc1), -lr_t)
        den = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
        updates = torch._foreach_div(num, den)
        return _tree(paths, updates), {"step": step, "mu": _tree(paths, mu),
                                       "nu": _tree(paths, nu)}

    return Optimizer(init, update)
