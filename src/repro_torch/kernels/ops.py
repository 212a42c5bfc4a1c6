"""Dispatch for the actor-path kernels, forward only.

Counterpart of ``repro/kernels/ops.py::gcn_agg`` / ``::edge_score``. The
tensor's device picks the backend: CUDA tensors go to the hand-written
kernels, CPU tensors to their plain versions. There is no switch and no
fallback. The hand-written backwards (``repro/kernels/ops.py:85-105,
141-171``) come with the training slice as ``torch.autograd.Function``s;
until then an input that requires grad raises, so a missing gradient
cannot go unnoticed.
"""
from __future__ import annotations

from repro_torch.kernels import edge_score as _edge
from repro_torch.kernels import gcn_agg as _gcn


def _forward_only(op: str, *tensors) -> None:
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"ops.{op} is forward-only until the training slice adds its "
            f"backward; call it under torch.no_grad() or on tensors that do "
            f"not require grad")


def gcn_agg(adj, self_feat, nbr_feat, w_self, w_nbr, bias):
    """Eq-12 message passing: relu(self @ w_self + agg @ w_nbr + bias).

    adj [B, M, O], self_feat [B, M, Fs], nbr_feat [B, O, Fn] -> [B, M, H].
    """
    args = (adj, self_feat, nbr_feat, w_self, w_nbr, bias)
    _forward_only("gcn_agg", *args)
    return _gcn.gcn_agg(*args)


def edge_score(h_src, h_dst, edge_feat, w_src, b_src, w_dst, w_feat, w_out,
               b_out):
    """Eq-13/14 fused edge scorer: per-edge MLP logits [B, M, O]."""
    args = (h_src, h_dst, edge_feat, w_src, b_src, w_dst, w_feat, w_out,
            b_out)
    _forward_only("edge_score", *args)
    return _edge.edge_score(*args)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {"gcn_agg": _gcn.launches, "edge_score": _edge.launches}


def reset_launch_counts() -> None:
    _gcn.launches = 0
    _edge.launches = 0
