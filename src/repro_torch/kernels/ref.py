"""Plain PyTorch versions of the hand-written kernels.

Counterparts of ``repro/kernels/ref.py::gcn_agg_ref``, ``::edge_score_ref``,
``::flash_attention_ref``, ``::decode_attention_ref`` and ``::ssm_scan_ref``. They are what a
CPU tensor runs, and what ``chip_smoke.py`` holds the CUDA kernels against
on the card.
"""
from __future__ import annotations

import math

import torch

_NEG = -1e30


def gcn_agg_ref(adj, self_feat, nbr_feat, w_self, w_nbr, bias):
    """Degree-normalized neighbor aggregation + fused linear + relu (Eq 12).

    adj [B, M, O], self_feat [B, M, Fs], nbr_feat [B, O, Fn],
    w_self [Fs, H], w_nbr [Fn, H], bias [H] -> [B, M, H].
    """
    deg = adj.sum(-1, keepdim=True)
    agg = (adj @ nbr_feat) / (deg + 1e-6)
    pre = self_feat @ w_self + agg @ w_nbr + bias
    return torch.relu(pre)


def edge_score_ref(h_src, h_dst, edge_feat, w_src, b_src, w_dst, w_feat,
                   w_out, b_out):
    """Fused edge scorer (Eq 13-14).

    h_src [B, M, H], h_dst [B, O, H], edge_feat [B, M, O];
    w_src/w_dst [H, E], b_src/w_feat/w_out [E], b_out [1] -> [B, M, O].
    """
    src = h_src @ w_src + b_src                       # [B, M, E]
    dst = h_dst @ w_dst                               # [B, O, E]
    x = src[..., :, None, :] + dst[..., None, :, :] \
        + edge_feat[..., None] * w_feat
    return torch.sum(torch.relu(x) * w_out, dim=-1) + b_out[0]


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q [B,S,H,d], k/v [B,S,KVH,d] -> [B,S,H,d]: plain softmax attention
    in float32 with kv head h // (H / KVH), scale 1/sqrt(d), keys j kept
    where j <= i (causal) and i - j < window; cast to q's dtype."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qf = q.float().reshape(b, s, kvh, h // kvh, d)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    pos = torch.arange(s, device=q.device)
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window is not None:
        ok &= pos[:, None] - pos[None, :] < window
    logits = torch.where(ok, logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def decode_attention_ref(q, k, v, lengths):
    """q [B,H,d] one token; k/v [B,S,KVH,d]; lengths [B] = number of valid
    cache rows -> [B,H,d], in float32, cast to q's dtype."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, kvh, h // kvh, d)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) * scale
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    logits = torch.where(valid[:, None, None, :], logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def ssm_step_ref(q, k, v, decay, state, *, bonus_u=None):
    """One step of the gated linear recurrence: q, k [B,H,dk], v [B,H,dv],
    decay = exp(log_w) [B,H,dk], state [B,H,dk,dv] float32 -> (y [B,H,dv],
    new state), both float32. ``S = diag(decay) S + k^T v``; ``bonus_u``
    None reads ``y = q S`` after the update (Mamba/SSD), ``bonus_u``
    [H, dk] reads ``y = q S + (q * u * k) . v`` before it (RWKV-6)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    upd = kf[..., :, None] * vf[..., None, :]
    if bonus_u is None:
        state = state * decay[..., None] + upd
        return torch.einsum("bhd,bhde->bhe", qf, state), state
    y = torch.einsum("bhd,bhde->bhe", qf, state) + torch.sum(
        qf * bonus_u.float() * kf, dim=-1, keepdim=True) * vf
    return y, state * decay[..., None] + upd


def ssm_scan_ref(q, k, v, log_w, *, bonus_u=None, initial_state=None):
    """The gated linear recurrence, ``ssm_step_ref`` one step at a time,
    batched over B and H: q, k, log_w [B,T,H,dk], v [B,T,H,dv] ->
    (y [B,T,H,dv] in q's dtype, final state [B,H,dk,dv] float32), from
    ``initial_state`` (zeros if None). Float32 throughout. Deliberately
    not the chunked algorithm of the kernel, so that it checks the kernel
    independently."""
    b, t, h, dk = q.shape
    s = (torch.zeros((b, h, dk, v.shape[-1]), dtype=torch.float32,
                     device=q.device)
         if initial_state is None else initial_state.float())
    qf, kf, vf = q.float(), k.float(), v.float()
    w = torch.exp(log_w.float())
    u = None if bonus_u is None else bonus_u.float()
    ys = []
    for i in range(t):
        y, s = ssm_step_ref(qf[:, i], kf[:, i], vf[:, i], w[:, i], s,
                            bonus_u=u)
        ys.append(y)
    return torch.stack(ys, dim=1).to(q.dtype), s
