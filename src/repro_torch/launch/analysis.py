"""The analytic FLOPs / HBM-bytes model of every architecture × input
shape (counterpart of ``repro/launch/analysis.py``).

``flops_bytes_model`` gives the global FLOPs and HBM bytes of one step of
the shape's mode, ``_param_count`` the parameter counts it rests on and
``_cache_bytes`` the decode cache's bytes; pure arithmetic over
``ArchConfig`` and ``ShapeSpec``, the same operations in the same order as
the reference's, so the numbers are equal. The reference's HLO walkers
(``parse_computations``, ``collective_bytes_nested``) are not ported: one
card runs no collectives and there is no HLO to read.
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig, ShapeSpec


# --------------------------------------------------------------------------
# Analytic FLOPs / HBM-bytes model (global; divide by chips for per-device).
# --------------------------------------------------------------------------
def _param_count(cfg: ArchConfig) -> dict:
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    out = {"embed": V * d, "head": d * V}
    per_layer = 0.0
    if cfg.attn_kind == "gqa":
        hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        per_layer += d * h * hd + 2 * d * kvh * hd + h * hd * d
    elif cfg.attn_kind == "mla":
        r, dn, dr, dv = (cfg.kv_lora_rank, cfg.nope_head_dim,
                         cfg.rope_head_dim, cfg.v_head_dim)
        h = cfg.n_heads
        per_layer += d * h * (dn + dr) + d * r + d * dr \
            + r * h * (dn + dv) + h * dv * d
    if cfg.ssm_kind == "rwkv6":
        per_layer += 5 * d * d + 2 * d * f + d * d   # time-mix + channel-mix
    elif cfg.ssm_kind == "mamba2":
        di = cfg.ssm_expand * d
        per_layer += d * (2 * di + 2 * cfg.d_state + di // cfg.ssm_head_dim) \
            + di * d
    if cfg.is_moe:
        per_layer += d * cfg.n_experts \
            + cfg.n_experts * 3 * d * cfg.moe_d_ff \
            + cfg.n_shared_experts * 3 * d * cfg.moe_d_ff
        active_per_layer = per_layer - (cfg.n_experts - cfg.top_k) \
            * 3 * d * cfg.moe_d_ff
    elif cfg.ssm_kind == "none" or cfg.shared_attn_every:
        per_layer += 3 * d * f
        active_per_layer = per_layer
    else:
        active_per_layer = per_layer
    if cfg.ssm_kind != "none" and not cfg.is_moe and not cfg.shared_attn_every:
        active_per_layer = per_layer
    shared = 0.0
    if cfg.shared_attn_every:
        hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        shared = d * h * hd + 2 * d * kvh * hd + h * hd * d + 3 * d * f
    enc = 0.0
    if cfg.enc_layers:
        hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        enc = cfg.enc_layers * (d * h * hd + 2 * d * kvh * hd + h * hd * d
                                + 3 * d * f)
    out.update(per_layer=per_layer, active_per_layer=active_per_layer,
               shared=shared, enc=enc)
    out["total"] = (out["embed"] + out["head"] + L * per_layer + shared + enc)
    out["active"] = (out["embed"] + out["head"] + L * active_per_layer
                     + shared + enc)
    return out


def flops_bytes_model(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Global FLOPs and HBM bytes for one step of the given mode."""
    p = _param_count(cfg)
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    L = cfg.n_layers
    bpe = 2.0                                   # bf16

    if shape.mode in ("train", "prefill"):
        T = B * S
        flops = 2.0 * T * p["active"]           # matmul fwd
        # attention math (causal avg S/2), windowed if set
        if cfg.attn_kind in ("gqa", "mla"):
            hd = (cfg.nope_head_dim + cfg.rope_head_dim
                  if cfg.attn_kind == "mla" else cfg.head_dim)
            dv = cfg.v_head_dim if cfg.attn_kind == "mla" else cfg.head_dim
            span = min(S / 2, cfg.window or S)
            n_attn = L if not cfg.shared_attn_every else (
                L // cfg.shared_attn_every)
            flops += 2.0 * T * span * cfg.n_heads * (hd + dv) * n_attn
        if cfg.enc_layers:
            F = cfg.n_audio_frames
            flops += 2.0 * B * F * F * cfg.n_heads * cfg.head_dim \
                * 2 * cfg.enc_layers                        # enc self-attn
            flops += 2.0 * T * F * cfg.n_heads * cfg.head_dim * 2 * L  # cross
        if cfg.ssm_kind != "none":
            dk = cfg.d_state if cfg.ssm_kind == "mamba2" else cfg.ssm_head_dim
            dvs = cfg.ssm_head_dim
            heads = ((cfg.ssm_expand * d) // cfg.ssm_head_dim
                     if cfg.ssm_kind == "mamba2" else d // cfg.ssm_head_dim)
            C = cfg.ssm_chunk
            # intra-chunk [C,C] matmuls + state update/read
            flops += L * (B * S) * heads * (2 * C * (dk + dvs)
                                            + 4 * dk * dvs)
        # extra exits: head matmul per exit
        flops += 2.0 * T * d * cfg.vocab * max(len(cfg.exit_layers) - 1, 0)
        act_bytes = L * T * d * bpe
        if shape.mode == "train":
            flops *= 4.0                        # fwd + bwd(2x) + remat refwd
            bytes_ = (3 * p["total"] * bpe      # weights fwd+refwd+bwd reads
                      + p["total"] * bpe        # grads write
                      + 3 * p["total"] * 8.0    # adam m,v f32 read+write
                      + 6 * act_bytes)          # save + reload + grads
        else:
            bytes_ = p["total"] * bpe + 4 * act_bytes \
                + (2 * p["per_layer"] and 0.0)
            # prefill also writes the KV cache:
            bytes_ += _cache_bytes(cfg, B, S)
        return {"flops": flops, "bytes": bytes_, "model_flops":
                (6.0 if shape.mode == "train" else 2.0) * p["active"] * T}

    # decode: one token per sequence
    T = B
    flops = 2.0 * T * p["active"]
    cache_b = _cache_bytes(cfg, B, S)
    if cfg.attn_kind in ("gqa", "mla"):
        span = min(S, cfg.window or S)
        hd = (cfg.kv_lora_rank + cfg.rope_head_dim
              if cfg.attn_kind == "mla" else cfg.head_dim)
        n_attn = L if not cfg.shared_attn_every else (
            L // cfg.shared_attn_every)
        flops += 2.0 * T * span * cfg.n_heads * hd * 2 * n_attn
    if cfg.ssm_kind != "none":
        dk = cfg.d_state if cfg.ssm_kind == "mamba2" else cfg.ssm_head_dim
        heads = ((cfg.ssm_expand * d) // cfg.ssm_head_dim
                 if cfg.ssm_kind == "mamba2" else d // cfg.ssm_head_dim)
        flops += L * T * heads * 4 * dk * cfg.ssm_head_dim
    bytes_ = p["active"] * bpe + cache_b   # weights + full cache read
    return {"flops": flops, "bytes": bytes_,
            "model_flops": 2.0 * p["active"] * T}


def _cache_bytes(cfg: ArchConfig, B: int, S: int) -> float:
    bpe = 2.0
    span = min(S, cfg.window or S)
    if cfg.enc_layers:
        kv = cfg.n_layers * B * span * 2 * cfg.n_kv_heads * cfg.head_dim
        kv += B * cfg.n_audio_frames * cfg.d_model
        return kv * bpe
    if cfg.attn_kind == "mla":
        return cfg.n_layers * B * S * (cfg.kv_lora_rank
                                       + cfg.rope_head_dim) * bpe
    total = 0.0
    if cfg.attn_kind == "gqa" and not cfg.shared_attn_every:
        total += cfg.n_layers * B * span * 2 * cfg.n_kv_heads * cfg.head_dim
    if cfg.shared_attn_every:
        n_sh = len(range(cfg.shared_attn_every, cfg.n_layers + 1,
                         cfg.shared_attn_every))
        total += n_sh * B * S * 2 * cfg.n_kv_heads * cfg.head_dim
    if cfg.ssm_kind == "rwkv6":
        h = cfg.d_model // cfg.ssm_head_dim
        total += cfg.n_layers * B * h * cfg.ssm_head_dim ** 2 * 2  # f32
    elif cfg.ssm_kind == "mamba2":
        di = cfg.ssm_expand * cfg.d_model
        h = di // cfg.ssm_head_dim
        total += cfg.n_layers * B * h * cfg.d_state * cfg.ssm_head_dim * 2
    return total * bpe
