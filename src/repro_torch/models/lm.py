"""Decoder LM assembly with early exits.

Counterpart of ``repro/models/lm.py::DecoderLM`` for the dense GQA
families and RWKV-6. Layers are stacked on a leading axis
(``params["blocks"]`` as ``DecoderLM.init`` builds it in the reference),
so a JAX param tree maps over 1:1; a Python loop over the layers takes
the place of ``lax.scan``. A layer's cache is its block's NamedTuple (a
``GQACache`` or an ``RWKVState``), stacked field by field.
``serve_step(..., exit_layer=e)`` runs the first ``e`` layers and reads
logits through exit ``e``'s norm and the shared LM head — the paper's
early-exit dial that GRLE's scheduler turns. The encoder-decoder
(``EncDecLM``) and Zamba2's shared block are not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.blocks import BLOCK_BY_KIND, block_kind
from repro_torch.models.config import ArchConfig
from repro_torch.nn import Embedding, Linear, RMSNorm
from repro_torch.nn.initializers import (normal_init, ones_init,
                                         xavier_uniform, zeros_init)


# ------------------------------------------------------------- layer schedule
def build_plan(cfg: ArchConfig, up_to_exit: Optional[int] = None):
    """Ordered events: ('layers', a, b) | ('shared', idx) | ('exit', layer)."""
    n = cfg.n_layers
    every = cfg.shared_attn_every
    shared_marks = set(range(every, n + 1, every)) if every else set()
    exit_marks = set(cfg.exit_layers)
    events = []
    last = 0
    shared_idx = 0
    for m in sorted(shared_marks | exit_marks):
        if m > last:
            events.append(("layers", last, m))
            last = m
        if m in shared_marks:
            events.append(("shared", shared_idx))
            shared_idx += 1
        if m in exit_marks:
            events.append(("exit", m))
            if up_to_exit is not None and m == up_to_exit:
                return events
    if last < n:
        events.append(("layers", last, n))
    return events


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked param or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_layer(v, i) for v in tree))
    return tree[i]


# leaves drawn N(0, 0.02), as the reference's normal_init does
_NORMAL_LEAVES = frozenset({"table", "mix", "lora_a", "lora_b", "bonus_u",
                            "cm_mix"})


def _init_leaf(generator, name: str, shape, *, device, dtype):
    if name in _NORMAL_LEAVES:
        return normal_init(generator, shape, device=device, dtype=dtype)
    if name == "scale":
        return ones_init(generator, shape, device=device, dtype=dtype)
    if name in ("b", "w0"):
        return zeros_init(generator, shape, device=device, dtype=dtype)
    if name != "w":
        raise ValueError(f"no initializer for param leaf {name!r}")
    # "w": Xavier-uniform per [in, out] matrix, also inside a layer stack
    mats = [xavier_uniform(generator, shape[-2:], device=device, dtype=dtype)
            for _ in range(math.prod(shape[:-2]))]
    return torch.stack(mats).reshape(shape)


def _stack(items):
    """Stack a list of per-layer cache NamedTuples field by field."""
    return type(items[0])(*(torch.stack(f) for f in zip(*items)))


# ---------------------------------------------------------------- decoder LM
class DecoderLM:
    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        """The param tree's names and shapes, in the reference's layout:
        ``blocks`` leaves carry a leading ``n_layers`` axis and
        ``exit_norms`` one of ``max(len(exit_layers), 1)``."""
        block = BLOCK_BY_KIND[block_kind(cfg)]
        n_exits = max(len(cfg.exit_layers), 1)

        def stack(tree, n):
            if isinstance(tree, dict):
                return {k: stack(v, n) for k, v in tree.items()}
            return (n, *tree)

        return {
            "embed": {"table": (cfg.vocab, cfg.d_model)},
            "blocks": stack(block.param_shapes(cfg), cfg.n_layers),
            "final_norm": {"scale": (cfg.d_model,)},
            "lm_head": {"w": (cfg.d_model, cfg.vocab)},
            "exit_norms": {"scale": (n_exits, cfg.d_model)},
        }

    @staticmethod
    def param_dtypes(cfg: ArchConfig) -> dict:
        """The param tree's leaf dtypes: ``cfg.torch_dtype``, except the
        block's ``FLOAT32_LEAVES`` (RWKV-6's ``w0`` and ``bonus_u``),
        which are float32 in any model, as in the reference."""
        f32 = BLOCK_BY_KIND[block_kind(cfg)].FLOAT32_LEAVES

        def walk(tree, name=""):
            if isinstance(tree, dict):
                return {k: walk(v, k) for k, v in tree.items()}
            return torch.float32 if name in f32 else cfg.torch_dtype

        return walk(DecoderLM.param_shapes(cfg))

    @staticmethod
    def init(generator: torch.Generator, cfg: ArchConfig, *, device=None):
        """Random params from ``generator`` in ``param_dtypes(cfg)`` (the
        reference's distributions: Xavier-uniform weights, zero biases and
        ``w0``, N(0, 0.02) embedding and RWKV mixes, LoRAs and bonus, unit
        norm scales), on the card unless ``device="cpu"``."""
        device = resolve_device(device)

        def build(tree, dtypes, name=""):
            if isinstance(tree, dict):
                return {k: build(v, dtypes[k], k) for k, v in tree.items()}
            return _init_leaf(generator, name, tree, device=device,
                              dtype=dtypes)

        return build(DecoderLM.param_shapes(cfg), DecoderLM.param_dtypes(cfg))

    @staticmethod
    def _exit_head(params, cfg: ArchConfig, x, exit_pos: int):
        idx = cfg.exit_layers.index(exit_pos)
        norm = {"scale": params["exit_norms"]["scale"][idx]}
        return RMSNorm.apply(norm, x, eps=cfg.norm_eps)

    @staticmethod
    def logits(params, hidden):
        return Linear.apply(params["lm_head"], hidden)

    # ----------------------------------------------------------------- cache
    @staticmethod
    def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *, device=None,
                   dtype=None):
        """Zeroed per-layer caches, stacked: ``{"layers": cache}`` with each
        field of the block's cache NamedTuple on a leading ``n_layers``
        axis — ``GQACache`` k, v [n_layers, B, seq_len, KVH, hd], or
        ``RWKVState`` wkv [n_layers, B, H, dk, dv] and shifts
        [n_layers, B, d] (no ``seq_len`` axis)."""
        device = resolve_device(device)
        block = BLOCK_BY_KIND[block_kind(cfg)]
        one = block.init_cache(cfg, batch, seq_len, device=device,
                               dtype=dtype)
        return {"layers": type(one)(
            *(a.unsqueeze(0).repeat(cfg.n_layers, *([1] * a.dim()))
              for a in one))}

    # --------------------------------------------------------------- prefill
    @staticmethod
    def prefill(params, cfg: ArchConfig, tokens):
        """tokens [B, S] -> (final-normed hidden [B,S,D], cache): the
        layers' caches stacked as ``init_cache`` lays them out — the K/V of
        each layer's ln1 output over the S tokens (see
        ``models/blocks.py``), or each layer's ``RWKVState`` after them."""
        block = BLOCK_BY_KIND[block_kind(cfg)]
        x = Embedding.apply(params["embed"], tokens)
        caches = []
        for ev in build_plan(cfg):
            if ev[0] == "shared":
                raise NotImplementedError("shared attention blocks are not "
                                          "ported yet")
            if ev[0] != "layers":
                continue
            for i in range(ev[1], ev[2]):
                x, c = block.apply_dense(_layer(params["blocks"], i), cfg, x,
                                         want_cache=True)
                caches.append(c)
        h = RMSNorm.apply(params["final_norm"], x, eps=cfg.norm_eps)
        return h, {"layers": _stack(caches)}

    # ---------------------------------------------------------------- decode
    @staticmethod
    def serve_step(params, cfg: ArchConfig, tokens, cache, pos, *,
                   exit_layer: Optional[int] = None):
        """One decode step. tokens [B], pos [B] -> (logits [B, V], cache).

        ``exit_layer`` runs the first ``exit_layer`` layers only (the
        early-exit serving path); the deeper layers' caches are left
        untouched. The layers that run update ``cache`` in place (a block
        that returns new state tensors has them copied into its layer's
        slice), and the returned cache is the same tensors.
        """
        exit_layer = exit_layer or cfg.n_layers
        block = BLOCK_BY_KIND[block_kind(cfg)]
        x = Embedding.apply(params["embed"], tokens[:, None])
        for ev in build_plan(cfg, up_to_exit=exit_layer):
            if ev[0] == "shared":
                raise NotImplementedError("shared attention blocks are not "
                                          "ported yet")
            if ev[0] == "exit":
                if ev[1] == exit_layer:     # requested exit reached
                    break
                continue                    # intermediate exits pass through
            for i in range(ev[1], ev[2]):
                layer_cache = _layer(cache["layers"], i)
                x, new = block.apply_decode(_layer(params["blocks"], i), cfg,
                                            x, layer_cache, pos)
                for old, upd in zip(layer_cache, new):
                    if upd is not old:
                        old.copy_(upd)
        if exit_layer == cfg.n_layers:
            h = RMSNorm.apply(params["final_norm"], x, eps=cfg.norm_eps)
        else:
            h = DecoderLM._exit_head(params, cfg, x, exit_layer)
        return DecoderLM.logits(params, h)[:, 0], cache


def model_for(cfg: ArchConfig):
    """The model class of ``cfg``; raises ``NotImplementedError`` for the
    families the port does not run yet."""
    if cfg.enc_layers:
        raise NotImplementedError(
            f"{cfg.arch_id}: EncDecLM (encoder-decoder) is not ported to "
            f"repro_torch yet")
    if cfg.shared_attn_every:
        raise NotImplementedError(
            f"{cfg.arch_id}: shared attention blocks (shared_attn_every="
            f"{cfg.shared_attn_every}) are not ported to repro_torch yet")
    block_kind(cfg)
    return DecoderLM
