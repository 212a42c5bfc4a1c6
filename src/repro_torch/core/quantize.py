"""Order-preserving quantization (paper §V-D, adapted from DROO).

Counterpart of ``repro/core/quantize.py``, with leading batch axes
written out:

  candidate 0      = per-device argmax of x̂,
  candidate s ≥ 1  = candidate 0 with the (device, option) pair of the s-th
                     smallest score margin flipped to that option.

``binary_order_preserving`` is the original DROO scheme on a per-device
offload relaxation (public API; the policy quantizes with
``one_hot_candidates`` for every method, as the reference does).
"""
from __future__ import annotations

import math

import torch


def one_hot_candidates(scores: torch.Tensor, n_candidates: int) -> torch.Tensor:
    """scores [..., M, O] -> candidate decisions [..., S, M] (int32 in
    [0, O)), S = ``n_candidates`` <= ``max_candidates(M, O)``."""
    m, o = scores.shape[-2:]
    best = torch.argmax(scores, dim=-1)                        # [..., M], first max
    best_score = torch.take_along_dim(scores, best[..., None], -1)
    margin = best_score - scores                               # [..., M, O] >= 0
    # the argmax itself must never be "flipped to": give it +inf margin
    margin = margin.scatter(-1, best[..., None], math.inf)
    flat = margin.flatten(-2)
    order = torch.argsort(flat, dim=-1, stable=True)           # ascending gap
    dev_of = order // o                                        # [..., M*O]
    opt_of = order % o
    # masked/disallowed options carry ~1e9 margins (the actor scores them
    # -1e9): flipping onto them must be a no-op, not an illegal decision
    valid_flip = flat.gather(-1, order) < 1e8
    opt_of = torch.where(valid_flip, opt_of, best.gather(-1, dev_of))

    s = n_candidates
    base = best[..., None, :].expand(best.shape[:-1] + (s, m))  # [..., S, M]
    k = torch.clamp_min(torch.arange(s, device=scores.device) - 1, 0)
    # candidate 0 keeps the argmax; candidate k flips pair k-1
    flip_dev = dev_of[..., k]
    flip_opt = opt_of[..., k]
    flipped = base.scatter(-1, flip_dev[..., None], flip_opt[..., None])
    flipped[..., 0, :] = best
    return flipped.to(torch.int32)


def binary_order_preserving(x_hat: torch.Tensor,
                            n_candidates: int) -> torch.Tensor:
    """Original DROO order-preserving quantization.

    x_hat [..., M] in (0,1) -> binary candidates [..., S, M] (int32):
    candidate 0 thresholds at 0.5; candidate s flips the device of the
    s-th smallest |x̂−0.5| (ties in index order).
    """
    m = x_hat.shape[-1]
    base = (x_hat > 0.5).to(torch.int32)                       # [..., M]
    order = torch.argsort(torch.abs(x_hat - 0.5), dim=-1, stable=True)
    s = n_candidates
    k = torch.clamp(torch.arange(s, device=x_hat.device) - 1, 0, m - 1)
    flips = order[..., k][..., None]                           # [..., S, 1]
    cands = base[..., None, :].expand(base.shape[:-1] + (s, m))
    flipped = cands.scatter(-1, flips, 1 - cands.gather(-1, flips))
    flipped[..., 0, :] = base
    return flipped


def max_candidates(n_devices: int, n_options: int) -> int:
    return n_devices * (n_options - 1) + 1
