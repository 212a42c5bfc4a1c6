"""Prefill and serve steps of the decoder LMs.

Counterpart of ``repro/train/steps.py::make_prefill_step`` /
``::make_serve_step``. PyTorch runs eagerly, so a step is a plain
function (no ``jit``); it runs under ``torch.no_grad()``. The training
step waits for the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import model_for


def make_serve_step(cfg: ArchConfig, *, exit_layer: Optional[int] = None):
    """``serve_step(params, cache, tokens [B], pos [B]) -> (logits [B, V],
    cache)``, through the first ``exit_layer`` layers (all by default).
    The cache is updated in place and returned."""
    model = model_for(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        return model.serve_step(params, cfg, tokens, cache, pos,
                                exit_layer=exit_layer)

    return serve_step


def make_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, {"tokens": [B, S]}) -> (logits [B, V] at the
    last position, cache)``; the cache is the layers' K/V (GQA) or
    ``RWKVState`` (RWKV-6), as ``serve_step`` takes it."""
    model = model_for(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        h, cache = model.prefill(params, cfg, batch["tokens"])
        logits = model.logits(params, h[:, -1:])
        return logits[:, 0], cache

    return prefill_step
