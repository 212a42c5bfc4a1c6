"""Residual blocks of every family.

Counterpart of ``repro/models/blocks.py``: the pre-norm attention block
``AttnBlock`` (GQA or MLA, dense or MoE FFN), ``RWKVBlockWrap`` (RWKV-6),
``MambaBlockWrap`` (Mamba-2), Whisper's decoder block ``EncDecBlock`` and
``EncoderBlock``, ``BlockAux`` and ``block_kind``. Layer parameters are
stacked on a leading axis by ``models/lm.py``; a block sees one layer's
slice. ``apply_dense`` and ``apply_decode`` return ``(x, cache, aux)`` as
the reference's do; ``aux`` is the MoE's load-balance loss and dropped
fraction (``ZERO_AUX``, Python zeros, for the other FFNs, so that they add
no device work). Each block names the leaves it keeps in float32 whatever
``cfg.dtype`` (``FLOAT32_LEAVES``: a leaf name, or a path's tail such as
``router/w``).

One deliberate difference: the reference's ``AttnBlock.apply_dense(...,
want_cache=True)`` builds the prefill cache from the ln2 output (``h`` is
reassigned before ``prefill_cache`` reads it, ``repro/models/blocks.py``
lines 75-80), for GQA's K/V and MLA's latents alike, while its name,
``prefill_cache(params, cfg, h_ln1, ...)``, the shared-block branch of its
``DecoderLM.prefill`` and its own decode path use the ln1 output. The
port's cache is built from the ln1 output, so it equals the cache that
``serve_step`` writes over the same tokens.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from repro_torch.kernels import ops
from repro_torch.models.attention import (CrossAttention, GQAAttention,
                                          MLAAttention)
from repro_torch.models.config import ArchConfig
from repro_torch.models.ffn import DenseFFN, MoEFFN
from repro_torch.models.ssm import (Mamba2Block, MambaState, RWKV6Block,
                                    RWKVState)
from repro_torch.nn import Linear, RMSNorm


class BlockAux(NamedTuple):
    moe_aux: Union[torch.Tensor, float]
    moe_dropped: Union[torch.Tensor, float]


ZERO_AUX = BlockAux(0.0, 0.0)


def add_aux(a: BlockAux, b: BlockAux) -> BlockAux:
    return BlockAux(a.moe_aux + b.moe_aux, a.moe_dropped + b.moe_dropped)


def _norm(d_model: int) -> dict:
    return {"scale": (d_model,)}


def _ffn_shapes(cfg: ArchConfig) -> dict:
    if cfg.is_moe:
        return MoEFFN.param_shapes(cfg)
    return DenseFFN.param_shapes(cfg.d_model, cfg.d_ff)


def _ffn_apply(params, cfg: ArchConfig, x):
    if cfg.is_moe:
        y, metrics = MoEFFN.apply(params, cfg, x)
        return y, BlockAux(metrics.aux_loss, metrics.dropped_frac)
    return DenseFFN.apply(params, x), ZERO_AUX


def _attn_cls(cfg: ArchConfig):
    return MLAAttention if cfg.attn_kind == "mla" else GQAAttention


# ------------------------------------------------------------ attention block
class AttnBlock:
    """Pre-norm attention (GQA or MLA) + FFN (dense or MoE). Covers the
    dense, MoE and VLM families and Zamba2's shared block."""

    FLOAT32_LEAVES = MoEFFN.FLOAT32_LEAVES

    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        return {"ln1": _norm(cfg.d_model),
                "attn": _attn_cls(cfg).param_shapes(cfg),
                "ln2": _norm(cfg.d_model),
                "ffn": _ffn_shapes(cfg)}

    @staticmethod
    def apply_dense(params, cfg: ArchConfig, x, *, want_cache: bool = False):
        """x [B,S,d] -> (x, cache or None, aux) over positions
        ``arange(S)``; the cache is that of the ln1 output."""
        h = RMSNorm.apply(params["ln1"], x, eps=cfg.norm_eps)
        y = _attn_cls(cfg).apply_dense(params["attn"], cfg, h,
                                       want_cache=want_cache)
        cache = None
        if want_cache:
            y, cache = y
        x = x + y
        h = RMSNorm.apply(params["ln2"], x, eps=cfg.norm_eps)
        y, aux = _ffn_apply(params["ffn"], cfg, h)
        return x + y, cache, aux

    @staticmethod
    def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *, device,
                   dtype=None):
        return _attn_cls(cfg).init_cache(cfg, batch, seq_len, device=device,
                                         dtype=dtype)

    @staticmethod
    def apply_decode(params, cfg: ArchConfig, x, cache, pos):
        """x [B,1,d], pos [B] -> (x, cache, aux); the cache is updated in
        place."""
        h = RMSNorm.apply(params["ln1"], x, eps=cfg.norm_eps)
        y, cache = _attn_cls(cfg).apply_decode(params["attn"], cfg, h, cache,
                                               pos)
        x = x + y
        h = RMSNorm.apply(params["ln2"], x, eps=cfg.norm_eps)
        y, aux = _ffn_apply(params["ffn"], cfg, h)
        return x + y, cache, aux


# ----------------------------------------------------------------- RWKV block
class RWKVBlockWrap:
    """Pre-norm RWKV-6 time-mix + channel-mix. Its per-layer state is an
    ``RWKVState``: the wkv state, the last ln1 token (time-mix shift) and
    the last ln2 token (channel-mix shift)."""

    FLOAT32_LEAVES = RWKV6Block.FLOAT32_LEAVES

    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        return {"ln1": _norm(cfg.d_model),
                "core": RWKV6Block.param_shapes(cfg),
                "ln2": _norm(cfg.d_model)}

    @staticmethod
    def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *, device,
                   dtype=None) -> RWKVState:
        del seq_len
        return RWKV6Block.init_state(cfg, batch, device=device, dtype=dtype)

    @staticmethod
    def apply_dense(params, cfg: ArchConfig, x, *, want_cache: bool = False):
        """x [B,S,d] -> (x, RWKVState after the S tokens or None, aux)."""
        h = RMSNorm.apply(params["ln1"], x, eps=cfg.norm_eps)
        y, wkv, last_tm = RWKV6Block.apply_dense(params["core"], cfg, h)
        x = x + y
        h2 = RMSNorm.apply(params["ln2"], x, eps=cfg.norm_eps)
        x = x + RWKV6Block.channel_mix(params["core"], h2)
        cache = RWKVState(wkv, last_tm, h2[:, -1]) if want_cache else None
        return x, cache, ZERO_AUX

    @staticmethod
    def apply_decode(params, cfg: ArchConfig, x, state: RWKVState, pos):
        """x [B,1,d] -> (x, new RWKVState, aux); ``pos`` is not needed."""
        del pos
        h = RMSNorm.apply(params["ln1"], x, eps=cfg.norm_eps)
        y, state = RWKV6Block.apply_decode(params["core"], cfg, h, state)
        x = x + y
        h2 = RMSNorm.apply(params["ln2"], x, eps=cfg.norm_eps)
        y = RWKV6Block.channel_mix(params["core"], h2,
                                   x_prev_last=state.shift_cm)
        return x + y, RWKVState(state.wkv, state.shift_tm, h2[:, 0]), ZERO_AUX


# ---------------------------------------------------------------- Mamba block
class MambaBlockWrap:
    """Pre-norm Mamba-2 mixer; its per-layer state is a ``MambaState``."""

    FLOAT32_LEAVES = Mamba2Block.FLOAT32_LEAVES

    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        return {"ln": _norm(cfg.d_model),
                "core": Mamba2Block.param_shapes(cfg)}

    @staticmethod
    def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *, device,
                   dtype=None) -> MambaState:
        del seq_len
        return Mamba2Block.init_state(cfg, batch, device=device, dtype=dtype)

    @staticmethod
    def apply_dense(params, cfg: ArchConfig, x, *, want_cache: bool = False):
        """x [B,S,d] -> (x, MambaState after the S tokens or None, aux)."""
        h = RMSNorm.apply(params["ln"], x, eps=cfg.norm_eps)
        y, state = Mamba2Block.apply_dense(params["core"], cfg, h)
        return x + y, (state if want_cache else None), ZERO_AUX

    @staticmethod
    def apply_decode(params, cfg: ArchConfig, x, state: MambaState, pos):
        """x [B,1,d] -> (x, new MambaState, aux); ``pos`` is not needed."""
        del pos
        h = RMSNorm.apply(params["ln"], x, eps=cfg.norm_eps)
        y, state = Mamba2Block.apply_decode(params["core"], cfg, h, state)
        return x + y, state, ZERO_AUX


# -------------------------------------------------------- Whisper decoder blk
class EncDecBlock:
    """Decoder block with causal self-attention (GQA through the kernels),
    cross-attention to the encoder output, and FFN."""

    FLOAT32_LEAVES = MoEFFN.FLOAT32_LEAVES

    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        return {"ln1": _norm(cfg.d_model),
                "self": GQAAttention.param_shapes(cfg),
                "ln_x": _norm(cfg.d_model),
                "cross": CrossAttention.param_shapes(cfg),
                "ln2": _norm(cfg.d_model),
                "ffn": _ffn_shapes(cfg)}

    @staticmethod
    def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *, device,
                   dtype=None):
        return GQAAttention.init_cache(cfg, batch, seq_len, device=device,
                                       dtype=dtype)

    @staticmethod
    def apply_dense(params, cfg: ArchConfig, x, enc_out, *,
                    want_cache: bool = False):
        """x [B,S,d] over positions ``arange(S)``, enc_out [B,Se,d] ->
        (x, the self-attention's ln1 K/V or None, aux)."""
        h = RMSNorm.apply(params["ln1"], x, eps=cfg.norm_eps)
        y = GQAAttention.apply_dense(params["self"], cfg, h,
                                     want_cache=want_cache)
        cache = None
        if want_cache:
            y, cache = y
        x = x + y
        hx = RMSNorm.apply(params["ln_x"], x, eps=cfg.norm_eps)
        x = x + CrossAttention.apply(params["cross"], cfg, hx, enc_out)
        h2 = RMSNorm.apply(params["ln2"], x, eps=cfg.norm_eps)
        y, aux = _ffn_apply(params["ffn"], cfg, h2)
        return x + y, cache, aux

    @staticmethod
    def apply_decode(params, cfg: ArchConfig, x, cache, pos, enc_out):
        """x [B,1,d], pos [B], enc_out [B,Se,d] -> (x, cache, aux); the
        self-attention cache is updated in place."""
        h = RMSNorm.apply(params["ln1"], x, eps=cfg.norm_eps)
        y, cache = GQAAttention.apply_decode(params["self"], cfg, h, cache,
                                             pos)
        x = x + y
        hx = RMSNorm.apply(params["ln_x"], x, eps=cfg.norm_eps)
        x = x + CrossAttention.apply(params["cross"], cfg, hx, enc_out)
        h2 = RMSNorm.apply(params["ln2"], x, eps=cfg.norm_eps)
        y, aux = _ffn_apply(params["ffn"], cfg, h2)
        return x + y, cache, aux


# ------------------------------------------------------------- encoder block
class EncoderBlock:
    """Pre-norm bidirectional attention + dense FFN (Whisper's encoder)."""

    FLOAT32_LEAVES = frozenset()

    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        return {"ln1": _norm(cfg.d_model),
                "attn": GQAAttention.param_shapes(cfg),
                "ln2": _norm(cfg.d_model),
                "ffn": DenseFFN.param_shapes(cfg.d_model, cfg.d_ff)}

    @staticmethod
    def apply(params, cfg: ArchConfig, x):
        """x [B,S,d] -> [B,S,d]: RoPE'd q/k over positions ``arange(S)``
        and ``ops.flash_attention`` without the causal mask."""
        b, s, _ = x.shape
        h = RMSNorm.apply(params["ln1"], x, eps=cfg.norm_eps)
        pos = torch.arange(s, device=x.device).expand(b, s)
        q, k, v = GQAAttention._qkv(params["attn"], cfg, h, pos)
        out = ops.flash_attention(q, k, v, causal=False)
        x = x + Linear.apply(params["attn"]["wo"], out.reshape(b, s, -1))
        h = RMSNorm.apply(params["ln2"], x, eps=cfg.norm_eps)
        return x + DenseFFN.apply(params["ffn"], h)


BLOCK_BY_KIND = {
    "attn": AttnBlock,
    "rwkv6": RWKVBlockWrap,
    "mamba2": MambaBlockWrap,
    "encdec": EncDecBlock,
}


def block_kind(cfg: ArchConfig) -> str:
    """The block family of ``cfg``, as the reference picks it."""
    if cfg.enc_layers:
        return "encdec"
    if cfg.ssm_kind == "rwkv6":
        return "rwkv6"
    if cfg.ssm_kind == "mamba2":
        return "mamba2"
    return "attn"
