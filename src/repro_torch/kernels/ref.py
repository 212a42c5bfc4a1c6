"""Plain PyTorch versions of the actor-path kernels.

Counterparts of ``repro/kernels/ref.py::gcn_agg_ref`` and
``::edge_score_ref``. They are what a CPU tensor runs, and what
``chip_smoke.py`` holds the CUDA kernels against on the card.
"""
from __future__ import annotations

import torch


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
