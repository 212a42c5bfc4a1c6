"""Prefill and serve steps of the LMs.

Counterpart of ``repro/train/steps.py::make_prefill_step`` /
``::make_serve_step``. PyTorch runs eagerly, so a step is a plain
function (no ``jit``); it runs under ``torch.no_grad()``. The LM training
step is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import DecoderLM, EncDecLM, model_for


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
    last position, cache)``; the cache is each layer's K/V (GQA), latents
    (MLA) or recurrent state (RWKV-6, Mamba-2), and the shared block's
    K/V, as ``serve_step`` takes it. For the encoder-decoder,
    ``{"audio": [B, frames, d], "tokens": [B, S]}`` -> logits [B, V] only,
    as the reference returns: the encoder, then the decoder's dense pass."""
    model = model_for(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        if model is EncDecLM:
            enc_out = EncDecLM.encode(params, cfg, batch["audio"])
            hiddens, _ = EncDecLM._decode_dense(params["decoder"], cfg,
                                                batch["tokens"], enc_out)
            h = hiddens[cfg.n_layers]
            return DecoderLM.logits(params["decoder"], h[:, -1:])[:, 0]
        h, cache, _ = DecoderLM.prefill(params, cfg, batch["tokens"])
        return DecoderLM.logits(params, h[:, -1:])[:, 0], cache

    return prefill_step
