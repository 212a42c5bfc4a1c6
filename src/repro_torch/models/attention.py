"""Attention variants: GQA with RoPE, MLA and cross-attention.

Counterpart of ``repro/models/attention.py``. The reference computes every
path with its jnp ``sdpa``; here GQA's prefill calls
``ops.flash_attention`` (positions ``arange(S)``, as in every caller of
the reference) and GQA's decode ``ops.decode_attention`` — the same
function, on the hand-written kernels on the card. ``sdpa`` itself is
ported as the reference has it (query-chunked, float32 matmul and
softmax, arbitrary positions, q/k wider than v) in plain PyTorch: no
Pallas kernel computes it in the reference. It carries MLA's dense pass
(q/k 192 wide, v 128: no kernel takes that) and the dense pass of
``CrossAttention``; MLA's absorbed decode over the latent cache is plain
PyTorch as in the reference (``decode_attention`` takes a group of at
most 8 query heads, MLA has 128 over one latent). ``CrossAttention``'s
one-token decode is ``ops.decode_attention`` over all ``Se`` encoder rows.

Under a sliding window (``cfg.window``; ``launch/specs.py::arch_for_shape``
sets 8192 on ``long_500k``) GQA's cache is a ring of ``min(seq_len,
window)`` rows holding position p at slot ``p % length``, and its prefill
cache a ``window``-row ring in the same order. A decode step attends the
first ``min(pos + 1, length)`` rows through ``ops.decode_attention``, as
without a window: every written row lies inside the window and softmax
does not care about row order. This is the reference's dense path
(``apply_dense``), which its own ring decode is not at three points
(ROADMAP §3 item 8): an empty ring attends its zero rows, and a prefill
cache of S rows is kept in position order (S > window) or as an S-row
ring (S < window). MLA's decode masks rows outside the window, which the
reference's does not (item 9); its latent cache keeps every position.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.rope import apply_rope
from repro_torch.nn import Linear

_NEG = -1e30
_Q_CHUNK = 1024


def sdpa(q, k, v, q_pos, k_pos, *, scale: float, causal: bool = True,
         window: Optional[int] = None, chunk: int = _Q_CHUNK):
    """Grouped-query attention with query chunking, plain PyTorch.

    q [B,Sq,H,Dk], k [B,Sk,KVH,Dk], v [B,Sk,KVH,Dv], H % KVH == 0; q_pos
    [B,Sq], k_pos [B,Sk] absolute positions (key j kept where k_pos <=
    q_pos under ``causal`` and q_pos - k_pos < ``window``). Logits and
    softmax in float32 over chunks of ``chunk`` queries (the largest
    divisor of Sq at most ``chunk``, as the reference picks it for
    Whisper's 1500 frames) -> [B,Sq,H,Dv] in q's dtype."""
    b, sq, h, dk = q.shape
    kvh = k.shape[2]
    dv = v.shape[-1]
    qg = q.reshape(b, sq, kvh, h // kvh, dk)
    kf, vf = k.float(), v.float()

    def attend(q_blk, qp_blk):
        logits = torch.einsum("bqkgd,bskd->bkgqs", q_blk.float(), kf) * scale
        ok = torch.ones((b, qp_blk.shape[1], kf.shape[1]), dtype=torch.bool,
                        device=q.device)
        if causal:
            ok &= k_pos[:, None, :] <= qp_blk[:, :, None]
        if window is not None:
            ok &= (qp_blk[:, :, None] - k_pos[:, None, :]) < window
        logits = logits + torch.where(ok, 0.0, _NEG)[:, None, None, :, :]
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bkgqs,bskd->bqkgd", probs, vf)

    if sq % chunk:
        chunk = next(c for c in range(min(chunk, sq), 0, -1) if sq % c == 0)
    out = torch.cat([attend(qg[:, i:i + chunk], q_pos[:, i:i + chunk])
                     for i in range(0, sq, chunk)], dim=1)
    return out.reshape(b, sq, h, dv).to(q.dtype)


def _lin(i, o, bias=False):
    return {"w": (i, o), **({"b": (o,)} if bias else {})}


class GQACache(NamedTuple):
    k: torch.Tensor      # [..., B, S_cache, KVH, hd]
    v: torch.Tensor


def ring_rows(rows, window: int):
    """rows [B, S, ...] of positions 0..S-1 -> the ``window``-row ring that
    holds position p at slot ``p % window``: the last ``window`` rows
    rolled by ``S % window``, or, for S < window, rows S.. zero (not yet
    written, and not attended before they are)."""
    s = rows.shape[1]
    if s >= window:
        return torch.roll(rows[:, s - window:], s % window, dims=1)
    ring = rows.new_zeros((rows.shape[0], window, *rows.shape[2:]))
    ring[:, :s] = rows
    return ring


class GQAAttention:
    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        hd, h, kvh, d = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
        return {"wq": _lin(d, h * hd, cfg.qkv_bias),
                "wk": _lin(d, kvh * hd, cfg.qkv_bias),
                "wv": _lin(d, kvh * hd, cfg.qkv_bias),
                "wo": _lin(h * hd, d)}

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
        K/V of these tokens as a ``GQACache``: S rows in position order,
        or under a window the ``window``-row ring (``ring_rows``) that
        ``apply_decode`` continues."""
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        q, k, v = GQAAttention._qkv(params, cfg, x, positions)
        out = ops.flash_attention(q, k, v, causal=True, window=cfg.window)
        y = Linear.apply(params["wo"], out.reshape(b, s, -1))
        if not want_cache:
            return y
        if cfg.window:
            k, v = ring_rows(k, cfg.window), ring_rows(v, cfg.window)
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
        without a window, also after ``pos`` wraps. Under a window the
        cache is the ring of at most ``window`` rows (a longer one would
        attend rows outside the window, and raises), and the same rows are
        the window's: the reference's dense attention.
        """
        length = cache.k.shape[1]
        if cfg.window and length > cfg.window:
            raise ValueError(
                f"GQAAttention.apply_decode: a cache of {length} rows under "
                f"a window of {cfg.window}; the window's cache is a ring of "
                f"at most {cfg.window} rows (init_cache, apply_dense)")
        b = x.shape[0]
        q, k_new, v_new = GQAAttention._qkv(params, cfg, x, pos[:, None])
        rows = torch.arange(b, device=x.device)
        slot = pos % length
        cache.k[rows, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[rows, slot] = v_new[:, 0].to(cache.v.dtype)
        lengths = torch.clamp(pos + 1, max=length).to(torch.int32)
        out = ops.decode_attention(q[:, 0], cache.k, cache.v, lengths)
        y = Linear.apply(params["wo"], out.reshape(b, 1, -1))
        return y, cache


# ----------------------------------------------------------------------- MLA
class MLACache(NamedTuple):
    c_kv: torch.Tensor    # [..., B, S, kv_lora_rank]
    k_pe: torch.Tensor    # [..., B, S, rope_head_dim]


class MLAAttention:
    """Multi-head Latent Attention (DeepSeek-V2) with decode-time weight
    absorption: the cache holds only the rank-r latent and the shared
    RoPE key."""

    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        d, h = cfg.d_model, cfg.n_heads
        r, dn, dr, dv = (cfg.kv_lora_rank, cfg.nope_head_dim,
                         cfg.rope_head_dim, cfg.v_head_dim)
        return {"wq": _lin(d, h * (dn + dr)), "w_dkv": _lin(d, r),
                "w_kpe": _lin(d, dr), "w_uk": (r, h, dn), "w_uv": (r, h, dv),
                "wo": _lin(h * dv, d)}

    @staticmethod
    def _scale(cfg: ArchConfig) -> float:
        return 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)

    @staticmethod
    def _latents(params, cfg: ArchConfig, x, positions):
        c_kv = Linear.apply(params["w_dkv"], x)                 # [B,S,r]
        k_pe = Linear.apply(params["w_kpe"], x)[:, :, None, :]  # [B,S,1,dr]
        return c_kv, apply_rope(k_pe, positions, cfg.rope_theta)[:, :, 0, :]

    @staticmethod
    def _queries(params, cfg: ArchConfig, x, positions):
        b, s, _ = x.shape
        dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
        q = Linear.apply(params["wq"], x).reshape(b, s, cfg.n_heads, dn + dr)
        return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)

    @staticmethod
    def apply_dense(params, cfg: ArchConfig, x, *, want_cache: bool = False):
        """Prefill over positions ``arange(S)``: per-head K/V materialized
        from the latent, attention with (nope ‖ rope) keys through
        ``sdpa`` -> y [B,S,d], and with ``want_cache`` the latents of these
        tokens as an ``MLACache``."""
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        q_nope, q_pe = MLAAttention._queries(params, cfg, x, positions)
        c_kv, k_pe = MLAAttention._latents(params, cfg, x, positions)
        k_nope = torch.einsum("bsr,rhd->bshd", c_kv, params["w_uk"])
        v = torch.einsum("bsr,rhd->bshd", c_kv, params["w_uv"])
        q = torch.cat([q_nope, q_pe], dim=-1)
        k_pe_b = k_pe[:, :, None, :].expand(b, s, cfg.n_heads,
                                            cfg.rope_head_dim)
        k = torch.cat([k_nope, k_pe_b], dim=-1)
        out = sdpa(q, k, v, positions, positions,
                   scale=MLAAttention._scale(cfg), causal=True,
                   window=cfg.window)
        y = Linear.apply(params["wo"], out.reshape(b, s, -1))
        return (y, MLACache(c_kv, k_pe)) if want_cache else y

    @staticmethod
    def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *, device,
                   dtype=None):
        dtype = dtype or cfg.torch_dtype
        return MLACache(
            torch.zeros((batch, seq_len, cfg.kv_lora_rank), dtype=dtype,
                        device=device),
            torch.zeros((batch, seq_len, cfg.rope_head_dim), dtype=dtype,
                        device=device))

    @staticmethod
    def apply_decode(params, cfg: ArchConfig, x, cache: MLACache, pos):
        """Absorbed decode, scored in latent space: x [B,1,d], pos [B] ->
        (y [B,1,d], cache). The new latents are written into ``cache`` in
        place at ``min(pos, S - 1)`` (where the reference's
        ``dynamic_update_slice`` clamps), and rows ``<= pos`` are
        attended, under a window only those with ``pos - row < window``,
        as ``apply_dense`` masks (the reference's decode ignores the
        window: ROADMAP §3 item 9)."""
        b = x.shape[0]
        q_nope, q_pe = MLAAttention._queries(params, cfg, x, pos[:, None])
        c_new, kpe_new = MLAAttention._latents(params, cfg, x, pos[:, None])
        s_len = cache.c_kv.shape[1]
        rows = torch.arange(b, device=x.device)
        slot = pos.clamp(max=s_len - 1)
        cache.c_kv[rows, slot] = c_new[:, 0].to(cache.c_kv.dtype)
        cache.k_pe[rows, slot] = kpe_new[:, 0].to(cache.k_pe.dtype)
        # absorb W_uk into the query: q_c [B,1,H,r]
        q_c = torch.einsum("bqhd,rhd->bqhr", q_nope, params["w_uk"])
        c_f = cache.c_kv.float()
        logits = (torch.einsum("bqhr,bsr->bhqs", q_c.float(), c_f)
                  + torch.einsum("bqhd,bsd->bhqs", q_pe.float(),
                                 cache.k_pe.float())) * MLAAttention._scale(cfg)
        rows_at = torch.arange(s_len, device=x.device)[None, :]
        valid = rows_at <= pos[:, None]
        if cfg.window:
            valid &= pos[:, None] - rows_at < cfg.window
        logits = torch.where(valid[:, None, None, :], logits, _NEG)
        probs = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bhqs,bsr->bqhr", probs, c_f)
        out = torch.einsum("bqhr,rhd->bqhd", ctx,
                           params["w_uv"].float()).to(x.dtype)
        return Linear.apply(params["wo"], out.reshape(b, 1, -1)), cache


# -------------------------------------------------- cross-attention (Whisper)
class CrossAttention:
    """Queries from the decoder, keys and values from the encoder output:
    no causal mask, no rope. K/V are recomputed from ``enc_out`` at every
    call, as in the reference (no cross-K/V cache)."""

    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        return GQAAttention.param_shapes(cfg)

    @staticmethod
    def apply(params, cfg: ArchConfig, x, enc_out):
        """x [B,Sq,d] attends to enc_out [B,Se,d] -> [B,Sq,d]. One query
        (decode) runs ``ops.decode_attention`` over all Se rows; more run
        ``sdpa`` without a mask (``flash_attention`` takes Sq == Sk only)."""
        b, sq, _ = x.shape
        se = enc_out.shape[1]
        hd = cfg.head_dim
        q = Linear.apply(params["wq"], x).reshape(b, sq, cfg.n_heads, hd)
        k = Linear.apply(params["wk"], enc_out).reshape(b, se, cfg.n_kv_heads,
                                                         hd)
        v = Linear.apply(params["wv"], enc_out).reshape(b, se, cfg.n_kv_heads,
                                                         hd)
        if sq == 1:
            lengths = torch.full((b,), se, dtype=torch.int32, device=x.device)
            out = ops.decode_attention(q[:, 0], k, v, lengths)[:, None]
        else:
            q_pos = torch.arange(sq, device=x.device).expand(b, sq)
            k_pos = torch.arange(se, device=x.device).expand(b, se)
            out = sdpa(q, k, v, q_pos, k_pos, scale=1.0 / math.sqrt(hd),
                       causal=False)
        return Linear.apply(params["wo"], out.reshape(b, sq, -1))
