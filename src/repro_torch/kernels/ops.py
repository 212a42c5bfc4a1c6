"""Dispatch for the hand-written kernels, forward only.

Counterpart of ``repro/kernels/ops.py::gcn_agg`` / ``::edge_score`` /
``::flash_attention`` / ``::decode_attention``, and of the chunked
recurrence of ``repro/models/ssm.py::chunked_linear_attn``
(``ssm_scan``). The tensor's device picks
the backend: CUDA tensors go to the hand-written kernels, CPU tensors to
their plain versions. There is no switch and no fallback. The
hand-written backwards of the actor kernels (``repro/kernels/ops.py:85-105,
141-171``) come with the training slice as ``torch.autograd.Function``s;
the TPU attention and scan kernels have no backward. Until then an input that
requires grad raises, so a missing gradient cannot go unnoticed.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import edge_score as _edge
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gcn_agg as _gcn
from repro_torch.kernels import ssm_scan as _ssm

_MODULES = {"gcn_agg": _gcn, "edge_score": _edge,
            "flash_attention": _flash, "decode_attention": _decode,
            "ssm_scan": _ssm}


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


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Causal GQA softmax attention: q [B,S,H,d], k/v [B,S,KVH,d] ->
    [B,S,H,d], keys j <= i with i - j < ``window``."""
    _forward_only("flash_attention", q, k, v)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, lengths):
    """One query token per sequence against a KV cache: q [B,H,d],
    k/v [B,S,KVH,d], keys j < lengths[b] -> [B,H,d]."""
    _forward_only("decode_attention", q, k, v)
    return _decode.decode_attention(q, k, v, lengths)


def ssm_scan(q, k, v, log_w, bonus_u=None, *, chunk: int,
             initial_state=None):
    """The gated linear recurrence in chunks of ``chunk`` rows: q, k,
    log_w [B,T,H,dk], v [B,T,H,dv] -> (y [B,T,H,dv], final state
    [B,H,dk,dv] float32); ``bonus_u`` [H,dk] selects RWKV semantics, None
    Mamba/SSD; ``initial_state`` None starts from zeros."""
    extra = [x for x in (bonus_u, initial_state) if x is not None]
    _forward_only("ssm_scan", q, k, v, log_w, *extra)
    return _ssm.ssm_scan(q, k, v, log_w, bonus_u, chunk=chunk,
                         initial_state=initial_state)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
