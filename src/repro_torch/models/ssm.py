"""RWKV-6 (Finch): the gated linear recurrence and its block.

Counterpart of ``repro/models/ssm.py``: ``chunked_linear_attn``,
``linear_attn_step``, ``naive_linear_attn``, ``RWKVState`` and
``RWKV6Block``. The primitive is a linear recurrence over rank-1 state
updates,

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t          (state [dk, dv] per head)
    y_t = q_t · S_(t or t-1)  (+ RWKV's bonus-u current-token term)

``chunked_linear_attn`` (prefill) runs it through ``ops.ssm_scan``, the
hand-written chunked kernel on the card; ``linear_attn_step`` (decode) is
plain PyTorch, as it is plain jnp in the reference. Mamba-2 is not ported
yet.

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
