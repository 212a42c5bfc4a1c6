"""Grouped-query attention with RoPE, through the hand-written kernels.

Counterpart of ``repro/models/attention.py::GQAAttention`` / ``GQACache``.
The reference computes both paths with the jnp ``sdpa``; here prefill
calls ``ops.flash_attention`` (positions ``arange(S)``, as in every caller
of the reference) and decode calls ``ops.decode_attention`` — the same
function, on the hand-written kernels on the card. MLA, cross-attention
and ``sdpa`` with arbitrary positions are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.rope import apply_rope
from repro_torch.nn import Linear


class GQACache(NamedTuple):
    k: torch.Tensor      # [..., B, S_cache, KVH, hd]
    v: torch.Tensor


class GQAAttention:
    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        hd, h, kvh, d = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model

        def lin(i, o, bias):
            return {"w": (i, o), **({"b": (o,)} if bias else {})}

        return {"wq": lin(d, h * hd, cfg.qkv_bias),
                "wk": lin(d, kvh * hd, cfg.qkv_bias),
                "wv": lin(d, kvh * hd, cfg.qkv_bias),
                "wo": lin(h * hd, d, False)}

    @staticmethod
    def _qkv(params, cfg: ArchConfig, x, positions):
        b, s, _ = x.shape
        q = Linear.apply(params["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
        k = Linear.apply(params["wk"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = Linear.apply(params["wv"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    @staticmethod
    def apply_dense(params, cfg: ArchConfig, x, *, want_cache: bool = False):
        """Full-sequence causal attention (prefill) over positions
        ``arange(S)``: x [B,S,d] -> y [B,S,d], and with ``want_cache`` the
        K/V of these tokens as a ``GQACache`` (the last ``window`` rows
        under a window, as the reference's ``prefill_cache``)."""
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        q, k, v = GQAAttention._qkv(params, cfg, x, positions)
        out = ops.flash_attention(q, k, v, causal=True, window=cfg.window)
        y = Linear.apply(params["wo"], out.reshape(b, s, -1))
        if not want_cache:
            return y
        if cfg.window and s > cfg.window:
            k, v = k[:, -cfg.window:], v[:, -cfg.window:]
        return y, GQACache(k, v)

    @staticmethod
    def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *, device,
                   dtype=None):
        dtype = dtype or cfg.torch_dtype
        length = min(seq_len, cfg.window) if cfg.window else seq_len
        shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
        return GQACache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))

    @staticmethod
    def apply_decode(params, cfg: ArchConfig, x, cache: GQACache, pos):
        """One new token vs. the cache. x [B,1,d], pos [B] absolute
        position -> (y [B,1,d], cache).

        The new K/V are written into ``cache`` at ``pos % length`` **in
        place** (the reference returns an updated copy); the returned cache
        is the same tensors. Attention covers the first
        ``min(pos + 1, length)`` rows, the reference's mask for a cache
        without a window, also after ``pos`` wraps.
        """
        if cfg.window:
            raise NotImplementedError(
                "GQAAttention.apply_decode: the sliding-window ring buffer "
                "is not ported yet (no ported config sets a window)")
        b = x.shape[0]
        q, k_new, v_new = GQAAttention._qkv(params, cfg, x, pos[:, None])
        length = cache.k.shape[1]
        rows = torch.arange(b, device=x.device)
        slot = pos % length
        cache.k[rows, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[rows, slot] = v_new[:, 0].to(cache.v.dtype)
        lengths = torch.clamp(pos + 1, max=length).to(torch.int32)
        out = ops.decode_attention(q[:, 0], cache.k, cache.v, lengths)
        y = Linear.apply(params["wo"], out.reshape(b, 1, -1))
        return y, cache
