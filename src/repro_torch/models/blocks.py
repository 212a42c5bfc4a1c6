"""Residual blocks of the ported families.

Counterpart of ``repro/models/blocks.py``: the pre-norm attention + SwiGLU
block ``AttnBlock`` (dense GQA families) and ``RWKVBlockWrap`` (RWKV-6).
Layer parameters are stacked on a leading axis by ``models/lm.py``; a
block sees one layer's slice. Each block names the leaves it keeps in
float32 whatever ``cfg.dtype`` (``FLOAT32_LEAVES``). ``block_kind``
raises for the families not ported yet.

One deliberate difference: the reference's ``AttnBlock.apply_dense(...,
want_cache=True)`` builds the prefill cache from the ln2 output (``h`` is
reassigned before ``prefill_cache`` reads it, ``repro/models/blocks.py``
lines 75-80), while its name, ``prefill_cache(params, cfg, h_ln1, ...)``,
and the reference's own decode path use the ln1 output. The port's cache
is the K/V of the ln1 output, so it equals the cache that ``serve_step``
writes over the same tokens.
"""
from __future__ import annotations

from repro_torch.models.attention import GQAAttention
from repro_torch.models.config import ArchConfig
from repro_torch.models.ffn import DenseFFN
from repro_torch.models.ssm import RWKV6Block, RWKVState
from repro_torch.nn import RMSNorm


class AttnBlock:
    """Pre-norm GQA attention + dense SwiGLU FFN."""

    FLOAT32_LEAVES = frozenset()

    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        return {"ln1": {"scale": (cfg.d_model,)},
                "attn": GQAAttention.param_shapes(cfg),
                "ln2": {"scale": (cfg.d_model,)},
                "ffn": DenseFFN.param_shapes(cfg.d_model, cfg.d_ff)}

    @staticmethod
    def apply_dense(params, cfg: ArchConfig, x, *, want_cache: bool = False):
        """x [B,S,d] -> (x, cache or None) over positions ``arange(S)``."""
        h = RMSNorm.apply(params["ln1"], x, eps=cfg.norm_eps)
        y = GQAAttention.apply_dense(params["attn"], cfg, h,
                                     want_cache=want_cache)
        cache = None
        if want_cache:
            y, cache = y
        x = x + y
        h = RMSNorm.apply(params["ln2"], x, eps=cfg.norm_eps)
        return x + DenseFFN.apply(params["ffn"], h), cache

    @staticmethod
    def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *, device,
                   dtype=None):
        return GQAAttention.init_cache(cfg, batch, seq_len, device=device,
                                       dtype=dtype)

    @staticmethod
    def apply_decode(params, cfg: ArchConfig, x, cache, pos):
        """x [B,1,d], pos [B] -> (x, cache); the cache is updated in place."""
        h = RMSNorm.apply(params["ln1"], x, eps=cfg.norm_eps)
        y, cache = GQAAttention.apply_decode(params["attn"], cfg, h, cache, pos)
        x = x + y
        h = RMSNorm.apply(params["ln2"], x, eps=cfg.norm_eps)
        return x + DenseFFN.apply(params["ffn"], h), cache


class RWKVBlockWrap:
    """Pre-norm RWKV-6 time-mix + channel-mix. Its per-layer state is an
    ``RWKVState``: the wkv state, the last ln1 token (time-mix shift) and
    the last ln2 token (channel-mix shift)."""

    FLOAT32_LEAVES = RWKV6Block.FLOAT32_LEAVES

    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        return {"ln1": {"scale": (cfg.d_model,)},
                "core": RWKV6Block.param_shapes(cfg),
                "ln2": {"scale": (cfg.d_model,)}}

    @staticmethod
    def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *, device,
                   dtype=None) -> RWKVState:
        del seq_len
        return RWKV6Block.init_state(cfg, batch, device=device, dtype=dtype)

    @staticmethod
    def apply_dense(params, cfg: ArchConfig, x, *, want_cache: bool = False):
        """x [B,S,d] -> (x, RWKVState after the S tokens, or None)."""
        h = RMSNorm.apply(params["ln1"], x, eps=cfg.norm_eps)
        y, wkv, last_tm = RWKV6Block.apply_dense(params["core"], cfg, h)
        x = x + y
        h2 = RMSNorm.apply(params["ln2"], x, eps=cfg.norm_eps)
        x = x + RWKV6Block.channel_mix(params["core"], h2)
        cache = RWKVState(wkv, last_tm, h2[:, -1]) if want_cache else None
        return x, cache

    @staticmethod
    def apply_decode(params, cfg: ArchConfig, x, state: RWKVState, pos):
        """x [B,1,d] -> (x, new RWKVState); ``pos`` is not needed."""
        del pos
        h = RMSNorm.apply(params["ln1"], x, eps=cfg.norm_eps)
        y, state = RWKV6Block.apply_decode(params["core"], cfg, h, state)
        x = x + y
        h2 = RMSNorm.apply(params["ln2"], x, eps=cfg.norm_eps)
        y = RWKV6Block.channel_mix(params["core"], h2,
                                   x_prev_last=state.shift_cm)
        return x + y, RWKVState(state.wkv, state.shift_tm, h2[:, 0])


BLOCK_BY_KIND = {"attn": AttnBlock, "rwkv6": RWKVBlockWrap}


def block_kind(cfg: ArchConfig) -> str:
    """The block family of ``cfg``; raises ``NotImplementedError`` for the
    families the port does not run yet."""
    if cfg.enc_layers:
        missing = "the encoder-decoder block (encdec, whisper)"
    elif cfg.ssm_kind == "rwkv6":
        return "rwkv6"
    elif cfg.ssm_kind == "mamba2":
        missing = "the Mamba-2 block (mamba2)"
    elif cfg.attn_kind == "mla":
        missing = "multi-head latent attention (mla)"
    elif cfg.is_moe:
        missing = "the mixture-of-experts FFN (moe)"
    elif cfg.attn_kind != "gqa":
        missing = f"attention kind {cfg.attn_kind!r}"
    else:
        return "attn"
    raise NotImplementedError(
        f"{cfg.arch_id} ({cfg.family}): {missing} is not ported to "
        f"repro_torch yet; the port runs dense GQA decoders and RWKV-6")
