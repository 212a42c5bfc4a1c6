"""RWKV-6 (Finch) and Mamba-2 (SSD): the gated linear recurrence and its
blocks.

Counterpart of ``repro/models/ssm.py``: ``chunked_linear_attn``,
``linear_attn_step``, ``naive_linear_attn``, ``RWKVState``,
``RWKV6Block``, ``MambaState`` and ``Mamba2Block``. The primitive is a linear recurrence over rank-1 state
updates,

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t          (state [dk, dv] per head)
    y_t = q_t · S_(t or t-1)  (+ RWKV's bonus-u current-token term)

``chunked_linear_attn`` (prefill) runs it through ``ops.ssm_scan``, the
hand-written chunked kernel on the card; ``linear_attn_step`` (decode) is
plain PyTorch, as it is plain jnp in the reference. RWKV-6 reads the
state before the update with a bonus term; Mamba-2 reads it after
(``bonus_u=None``). Mamba-2's depthwise causal conv (K = 4, its last
K - 1 inputs carried as state) is plain PyTorch, as it is jnp there.

The block keeps the reference's quirks as they are: the decay's LoRA
reuses ``lora_b[:, :d]``, the decay adds ``xw * 0.0``, ``ln_x`` uses
``RMSNorm.apply``'s default eps (1e-6, not ``cfg.norm_eps``), and the
ddlerp of ``_mix_inputs`` runs in the params' dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.config import ArchConfig
from repro_torch.nn import Linear, RMSNorm


def chunked_linear_attn(q, k, v, log_w, *, chunk: int, bonus_u=None,
                        initial_state=None):
    """q, k [B,T,H,dk], v [B,T,H,dv], log_w [B,T,H,dk] (<= 0).

    bonus_u: None -> Mamba-style (y_t reads S_t); [H, dk] -> RWKV-style
    (y_t = q_t·S_{t-1} + q_t·(u ⊙ k_t) v_t).
    Returns (y [B,T,H,dv] in q's dtype, final_state [B,H,dk,dv] float32).
    """
    u = None if bonus_u is None else bonus_u.float()
    return ops.ssm_scan(q, k, v, log_w.float(), u, chunk=chunk,
                        initial_state=initial_state)


def linear_attn_step(q, k, v, log_w, state, *, bonus_u=None):
    """Single decode step. q, k [B,H,dk], v [B,H,dv], state [B,H,dk,dv]
    float32 -> (y [B,H,dv] in q's dtype, new state)."""
    y, state = ref.ssm_step_ref(q, k, v, torch.exp(log_w.float()), state,
                                bonus_u=bonus_u)
    return y.to(q.dtype), state


def naive_linear_attn(q, k, v, log_w, *, bonus_u=None, initial_state=None):
    """Sequential oracle: ``linear_attn_step``'s arithmetic over T, as
    ``ref.ssm_scan_ref`` runs it."""
    return ref.ssm_scan_ref(q, k, v, log_w, bonus_u=bonus_u,
                            initial_state=initial_state)


# ---------------------------------------------------------------------- RWKV6
class RWKVState(NamedTuple):
    wkv: torch.Tensor       # [B, H, dk, dv] float32
    shift_tm: torch.Tensor  # [B, d_model] previous token (time-mix shift)
    shift_cm: torch.Tensor  # [B, d_model] previous token (channel-mix shift)


class RWKV6Block:
    """Finch time-mix (data-dependent decay via low-rank ddlerp) +
    squared-relu channel-mix. arXiv:2404.05892, simplified LoRA ranks."""

    LORA_RANK = 32
    # leaves kept in float32 whatever cfg.dtype, as the reference's init does
    FLOAT32_LEAVES = frozenset({"w0", "bonus_u"})

    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        d, hd, r = cfg.d_model, cfg.ssm_head_dim, RWKV6Block.LORA_RANK

        def lin(i, o):
            return {"w": (i, o)}

        return {
            "mix": (5, d),                       # r, k, v, w, g
            "lora_a": (d, r),
            "lora_b": (r, 5 * d),
            "w0": (d,),
            "wr": lin(d, d), "wk": lin(d, d), "wv": lin(d, d),
            "wg": lin(d, d), "wo": lin(d, d),
            "bonus_u": (d // hd, hd),
            "ln_x": {"scale": (d,)},
            # channel mix
            "cm_mix": (2, d),
            "cm_k": lin(d, cfg.d_ff),
            "cm_v": lin(cfg.d_ff, d),
            "cm_r": lin(d, d),
        }

    @staticmethod
    def _mix_inputs(params, x, x_prev):
        """Data-dependent lerp between x_t and x_{t-1} for the 5 streams."""
        delta = x_prev - x
        lora = torch.tanh((x + 0.5 * delta) @ params["lora_a"]) \
            @ params["lora_b"]
        lora = lora.reshape(*x.shape[:-1], 5, x.shape[-1])
        mix = torch.sigmoid(params["mix"] + lora)                # [..., 5, d]
        return x[..., None, :] + delta[..., None, :] * mix

    @staticmethod
    def _tm_project(params, cfg: ArchConfig, streams):
        d, hd = cfg.d_model, cfg.ssm_head_dim
        xr, xk, xv, xw, xg = (streams[..., i, :] for i in range(5))
        sh = (*xr.shape[:-1], d // hd, hd)
        r = Linear.apply(params["wr"], xr).reshape(sh)
        k = Linear.apply(params["wk"], xk).reshape(sh)
        v = Linear.apply(params["wv"], xv).reshape(sh)
        g = F.silu(Linear.apply(params["wg"], xg))
        # data-dependent decay: w = exp(-exp(w0 + lora_w)) in (0, 1)
        logw = -torch.exp(params["w0"].float() + xw.float() * 0.0
                          + (torch.tanh(xw @ params["lora_a"])
                             @ params["lora_b"][:, :d]).float())
        return r, k, v, g, logw.reshape(sh)

    @staticmethod
    def init_state(cfg: ArchConfig, batch: int, *, device,
                   dtype=None) -> RWKVState:
        dtype = dtype or cfg.torch_dtype
        d, hd = cfg.d_model, cfg.ssm_head_dim
        h = d // hd
        return RWKVState(
            torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
            torch.zeros((batch, d), dtype=dtype, device=device),
            torch.zeros((batch, d), dtype=dtype, device=device))

    @staticmethod
    def time_mix(params, cfg: ArchConfig, x, state: RWKVState | None):
        """x [B,T,d] (prefill; state optional) -> (y [B,T,d], wkv
        [B,H,dk,dv], last token x[:, -1])."""
        b, t, d = x.shape
        prev = (torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
                if state is None else state.shift_tm[:, None, :])
        x_prev = torch.cat([prev, x[:, :-1]], dim=1)
        streams = RWKV6Block._mix_inputs(params, x, x_prev)
        r, k, v, g, logw = RWKV6Block._tm_project(params, cfg, streams)
        s0 = None if state is None else state.wkv
        y, s = chunked_linear_attn(r, k, v, logw, chunk=cfg.ssm_chunk,
                                   bonus_u=params["bonus_u"], initial_state=s0)
        y = RMSNorm.apply(params["ln_x"], y.reshape(b, t, d)) * g
        return Linear.apply(params["wo"], y), s, x[:, -1]

    @staticmethod
    def channel_mix(params, x, x_prev_last=None):
        b, t, d = x.shape
        prev = (torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
                if x_prev_last is None else x_prev_last[:, None, :])
        x_prev = torch.cat([prev, x[:, :-1]], dim=1)
        delta = x_prev - x
        mk = torch.sigmoid(params["cm_mix"][0])
        mr = torch.sigmoid(params["cm_mix"][1])
        xk = x + delta * mk
        xr = x + delta * mr
        k = torch.square(torch.relu(Linear.apply(params["cm_k"], xk)))
        return torch.sigmoid(Linear.apply(params["cm_r"], xr)) \
            * Linear.apply(params["cm_v"], k)

    @staticmethod
    def apply_dense(params, cfg: ArchConfig, x, state: RWKVState | None = None):
        """The time-mix half of the block (pre-norms and channel-mix are
        the caller's) -> (y, wkv, last token)."""
        return RWKV6Block.time_mix(params, cfg, x, state)

    @staticmethod
    def apply_decode(params, cfg: ArchConfig, x, state: RWKVState):
        """x [B,1,d] one token -> (y [B,1,d], RWKVState with the new wkv
        and shift_tm; shift_cm passed through)."""
        b, _, d = x.shape
        streams = RWKV6Block._mix_inputs(params, x[:, 0], state.shift_tm)
        r, k, v, g, logw = RWKV6Block._tm_project(params, cfg,
                                                  streams[:, None])
        y, wkv = linear_attn_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0],
                                  state.wkv, bonus_u=params["bonus_u"])
        y = RMSNorm.apply(params["ln_x"], y.reshape(b, 1, d)) * g
        y = Linear.apply(params["wo"], y)
        return y, RWKVState(wkv, x[:, 0], state.shift_cm)


# --------------------------------------------------------------------- Mamba2
class MambaState(NamedTuple):
    ssd: torch.Tensor     # [B, H, d_state, head_dim] float32
    conv: torch.Tensor    # [B, conv_k - 1, d_conv_in] the last conv inputs


class Mamba2Block:
    """Mamba2 / SSD block (arXiv:2405.21060 form used by Zamba2): one input
    projection to (z, x, B, C, dt), a causal depthwise conv over (x, B, C),
    the SSD recurrence with decay exp(dt a) per head (keys B and queries C
    shared by the heads, values dt x), a gated RMSNorm and the output
    projection."""

    CONV_K = 4
    # leaves kept in float32 whatever cfg.dtype, as the reference's init does
    FLOAT32_LEAVES = frozenset({"a_log", "dt_bias"})

    @staticmethod
    def dims(cfg: ArchConfig):
        d_inner = cfg.ssm_expand * cfg.d_model
        h = d_inner // cfg.ssm_head_dim
        d_conv_in = d_inner + 2 * cfg.d_state   # x, B, C share the conv
        return d_inner, h, d_conv_in

    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        d = cfg.d_model
        d_inner, h, d_conv_in = Mamba2Block.dims(cfg)
        return {
            "in_proj": {"w": (d, 2 * d_inner + 2 * cfg.d_state + h)},
            "conv_w": (Mamba2Block.CONV_K, d_conv_in),
            "conv_b": (d_conv_in,),
            "a_log": (h,),
            "dt_bias": (h,),
            "norm": {"scale": (d_inner,)},
            "out_proj": {"w": (d_inner, d)},
        }

    @staticmethod
    def _split(cfg: ArchConfig, zxbcdt):
        d_inner, h, _ = Mamba2Block.dims(cfg)
        n = cfg.d_state
        z, x, bmat, cmat, dt = torch.split(
            zxbcdt, [d_inner, d_inner, n, n, h], dim=-1)
        return z, x, bmat, cmat, dt

    @staticmethod
    def _conv(params, xbc, conv_state=None):
        """Causal depthwise conv over time: xbc [B,T,C] -> (silu(conv + b)
        [B,T,C], the last K - 1 inputs [B,K-1,C] as the next state)."""
        k = Mamba2Block.CONV_K
        pad = (xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[-1]))
               if conv_state is None else conv_state)
        xp = torch.cat([pad, xbc], dim=1)
        w, t = params["conv_w"], xbc.shape[1]
        out = xp[:, 0:t] * w[0]
        for i in range(1, k):
            out = out + xp[:, i:i + t] * w[i]
        return F.silu(out + params["conv_b"]), xp[:, -(k - 1):]

    @staticmethod
    def init_state(cfg: ArchConfig, batch: int, *, device,
                   dtype=None) -> MambaState:
        dtype = dtype or cfg.torch_dtype
        _, h, d_conv_in = Mamba2Block.dims(cfg)
        return MambaState(
            torch.zeros((batch, h, cfg.d_state, cfg.ssm_head_dim),
                        dtype=torch.float32, device=device),
            torch.zeros((batch, Mamba2Block.CONV_K - 1, d_conv_in),
                        dtype=dtype, device=device))

    @staticmethod
    def _ssd_inputs(params, cfg: ArchConfig, x, bmat, cmat, dt):
        """(q, k, v, log_w) of the recurrence: q = C and k = B broadcast
        over the heads (views), v = dt x, log_w = dt a broadcast over
        d_state (float32, contiguous: the scan kernel reads its last axis
        as 16-byte rows)."""
        b, t, _ = x.shape
        _, h, _ = Mamba2Block.dims(cfg)
        n = cfg.d_state
        dt = F.softplus(dt.float() + params["dt_bias"])           # [B,T,H]
        a = -torch.exp(params["a_log"])                           # [H] < 0
        log_w = (dt * a)[..., None].expand(b, t, h, n).contiguous()
        xh = x.reshape(b, t, h, cfg.ssm_head_dim)
        v = xh * dt[..., None].to(xh.dtype)                       # dt x
        k = bmat[:, :, None, :].expand(b, t, h, n)
        q = cmat[:, :, None, :].expand(b, t, h, n)
        return q, k, v, log_w

    @staticmethod
    def _mixer_inputs(params, cfg: ArchConfig, xin, conv_state):
        d_inner = Mamba2Block.dims(cfg)[0]
        z, x, bmat, cmat, dt = Mamba2Block._split(
            cfg, Linear.apply(params["in_proj"], xin))
        xbc, conv = Mamba2Block._conv(params, torch.cat([x, bmat, cmat], -1),
                                      conv_state)
        x, bmat, cmat = torch.split(
            xbc, [d_inner, cfg.d_state, cfg.d_state], dim=-1)
        return z, conv, Mamba2Block._ssd_inputs(params, cfg, x, bmat, cmat,
                                                dt)

    @staticmethod
    def _out(params, y, z):
        y = RMSNorm.apply(params["norm"], y * F.silu(z))
        return Linear.apply(params["out_proj"], y)

    @staticmethod
    def apply_dense(params, cfg: ArchConfig, xin,
                    state: MambaState | None = None):
        """xin [B,T,d] (prefill; state optional) -> (y [B,T,d],
        MambaState after the T tokens). The recurrence runs through
        ``chunked_linear_attn`` (``ops.ssm_scan``, Mamba semantics)."""
        b, t, _ = xin.shape
        z, conv, (q, k, v, log_w) = Mamba2Block._mixer_inputs(
            params, cfg, xin, None if state is None else state.conv)
        y, ssd = chunked_linear_attn(
            q, k, v, log_w, chunk=cfg.ssm_chunk,
            initial_state=None if state is None else state.ssd)
        y = y.reshape(b, t, Mamba2Block.dims(cfg)[0])
        return Mamba2Block._out(params, y, z), MambaState(ssd, conv)

    @staticmethod
    def apply_decode(params, cfg: ArchConfig, xin, state: MambaState):
        """xin [B,1,d] one token -> (y [B,1,d], new MambaState); the
        recurrence is ``linear_attn_step`` (plain)."""
        b = xin.shape[0]
        z, conv, (q, k, v, log_w) = Mamba2Block._mixer_inputs(
            params, cfg, xin, state.conv)
        y, ssd = linear_attn_step(q[:, 0], k[:, 0], v[:, 0], log_w[:, 0],
                                  state.ssd)
        y = y.reshape(b, 1, Mamba2Block.dims(cfg)[0])
        return Mamba2Block._out(params, y, z), MambaState(ssd, conv)
