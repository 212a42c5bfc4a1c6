"""Dispatch for the hand-written kernels.

Counterpart of ``repro/kernels/ops.py::gcn_agg`` / ``::edge_score`` /
``::flash_attention`` / ``::decode_attention``, and of the chunked
recurrence of ``repro/models/ssm.py::chunked_linear_attn``
(``ssm_scan``). The tensor's device picks
the backend: CUDA tensors go to the hand-written kernels, CPU tensors to
their plain versions. There is no switch and no fallback.

``gcn_agg`` and ``edge_score`` are differentiable, because the Eq-16 loss
differentiates through them: with grad enabled and an input that requires
grad they run as ``torch.autograd.Function``s whose forward is the kernel
(or its plain version) and whose backward is the reference's hand-written
rule in plain PyTorch (``ref.gcn_agg_bwd``, ``ref.edge_score_bwd``; the
JAX package's VJPs are jnp too, ``repro/kernels/ops.py:85-105,
141-171``). Otherwise they call the kernel directly and build no graph.
``flash_attention`` is differentiable too, because the LM training step
differentiates through it: on the card, with grad enabled and an input
that requires grad, it runs as ``_FlashAttention``, whose forward is the
kernel (the same launch, bit for bit) and whose backward recomputes the
plain version ``ref.flash_attention_ref`` in float32 and returns its VJP
in the inputs' dtype. The JAX package has no backward kernel for
attention either (its training differentiates jnp ``sdpa``; its Pallas
flash has no VJP). On the CPU autograd runs straight through the plain
version. ``ssm_scan`` is differentiable on both devices, because the
RWKV-6 and Mamba-2 blocks train through it: with grad enabled and an
input that requires grad it runs as ``_SsmScan``, whose forward is the
kernel on the card (the same launch, bit for bit) and the sequential
plain version on the CPU, and whose backward is the float32 VJP of the
plain chunked form ``ref.ssm_scan_chunked_ref`` (the reference's
``chunked_linear_attn``, which its training differentiates; it has no
backward kernel), so that the CPU tests run the backward the card runs.
``decode_attention`` has no backward: an input of its that requires grad
raises, so a missing gradient cannot go unnoticed.

While a cost counter (``obs.cost``) is active, each call is counted as one
operation whose FLOPs come from its formula in ``kernels/cost.py``, and
the PyTorch operations inside it (its plain version's, on the CPU) are not
counted, so that a program costs the same on the CPU and on the card.
"""
from __future__ import annotations

import functools
import inspect

import torch

from repro_torch.kernels import cost as _cost
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import edge_score as _edge
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gcn_agg as _gcn
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssm_scan as _ssm

_MODULES = {"gcn_agg": _gcn, "edge_score": _edge,
            "flash_attention": _flash, "decode_attention": _decode,
            "ssm_scan": _ssm}


# the active cost counters, innermost last; each has ``kernel(flops, fn,
# args, kwargs)``, which counts one call and runs it uncounted
_COST_COUNTERS: list = []

# name -> the call's FLOPs from the op's bound arguments
_FLOPS = {
    "gcn_agg": lambda a: _cost.gcn_agg_cost(*a.values())[1],
    "edge_score": lambda a: _cost.edge_score_cost(*a.values())[1],
    "flash_attention": lambda a: _cost.flash_cost(a["q"], a["k"],
                                                  a["window"],
                                                  a["causal"])[1],
    "decode_attention": lambda a: _cost.decode_cost(a["q"], a["k"],
                                                    a["lengths"])[1],
    "ssm_scan": lambda a: _cost.ssm_cost(a["q"], a["v"], a["log_w"],
                                         a["bonus_u"],
                                         a["initial_state"])[1],
}


def _counted(fn):
    """``fn`` (a public op of this module), counted as one operation by the
    innermost active cost counter, if any."""
    name, sig = fn.__name__, inspect.signature(fn)

    @functools.wraps(fn)
    def op(*args, **kwargs):
        if not _COST_COUNTERS:
            return fn(*args, **kwargs)
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        return _COST_COUNTERS[-1].kernel(_FLOPS[name](bound.arguments), fn,
                                         args, kwargs)

    return op


def _forward_only(op: str, *tensors) -> None:
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"ops.{op} is forward-only: the TPU kernel it ports has no "
            f"backward; call it under torch.no_grad() or on tensors that do "
            f"not require grad")


def _wants_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _GcnAgg(torch.autograd.Function):
    """Forward: the kernel on CUDA, ``ref.gcn_agg_ref`` on the CPU. Saves
    the inputs as given (the option side's transposed ``adj`` view stays a
    view) and the output, whose sign is the relu mask."""

    @staticmethod
    def forward(ctx, adj, hs, hn, ws, wn, bias):
        out = _gcn.gcn_agg(adj, hs, hn, ws, wn, bias)
        ctx.save_for_backward(adj, hs, hn, ws, wn, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        return _ref.gcn_agg_bwd(dout, *ctx.saved_tensors,
                                needs=ctx.needs_input_grad)


class _EdgeScore(torch.autograd.Function):
    """Forward: the kernel on CUDA, ``ref.edge_score_ref`` on the CPU. The
    backward recomputes the [B, M, O, E] hidden from the saved inputs."""

    @staticmethod
    def forward(ctx, hs, hd, ef, ws, bs, wd, wf, wo, bo):
        ctx.save_for_backward(hs, hd, ef, ws, bs, wd, wf, wo)
        return _edge.edge_score(hs, hd, ef, ws, bs, wd, wf, wo, bo)

    @staticmethod
    def backward(ctx, dl):
        return _ref.edge_score_bwd(dl, *ctx.saved_tensors,
                                   needs=ctx.needs_input_grad)


class _FlashAttention(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: autograd of
    ``ref.flash_attention_ref`` over float32 copies of the saved inputs,
    cast back to their dtypes (the plain version's probabilities are
    recomputed, [B, KVH, g, S, S] float32 per call)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _flash.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qf, kf, vf = (t.detach().float().requires_grad_()
                          for t in (q, k, v))
            out = _ref.flash_attention_ref(qf, kf, vf, causal=ctx.causal,
                                           window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, (qf, kf, vf),
                                             dout.float())
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


class _SsmScan(torch.autograd.Function):
    """Forward: the kernel on CUDA, ``ref.ssm_scan_ref`` on the CPU (the
    same call as without grad). Backward, on both devices:
    ``ref.ssm_scan_bwd``, the float32 VJP of the plain chunked form, from
    the saved inputs; a cotangent autograd leaves out (an output the loss
    does not use) is zero."""

    @staticmethod
    def forward(ctx, q, k, v, log_w, bonus_u, initial_state, chunk):
        ctx.save_for_backward(q, k, v, log_w, bonus_u, initial_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _ssm.ssm_scan(q, k, v, log_w, bonus_u, chunk=chunk,
                             initial_state=initial_state)

    @staticmethod
    def backward(ctx, dy, dstate):
        return (*_ref.ssm_scan_bwd(dy, dstate, *ctx.saved_tensors,
                                   chunk=ctx.chunk,
                                   needs=ctx.needs_input_grad[:6]), None)


@_counted
def gcn_agg(adj, self_feat, nbr_feat, w_self, w_nbr, bias):
    """Eq-12 message passing: relu(self @ w_self + agg @ w_nbr + bias).

    adj [B, M, O], self_feat [B, M, Fs], nbr_feat [B, O, Fn] -> [B, M, H].
    Differentiable in every input.
    """
    args = (adj, self_feat, nbr_feat, w_self, w_nbr, bias)
    if _wants_grad(args):
        return _GcnAgg.apply(*args)
    return _gcn.gcn_agg(*args)


@_counted
def edge_score(h_src, h_dst, edge_feat, w_src, b_src, w_dst, w_feat, w_out,
               b_out):
    """Eq-13/14 fused edge scorer: per-edge MLP logits [B, M, O].
    Differentiable in every input."""
    args = (h_src, h_dst, edge_feat, w_src, b_src, w_dst, w_feat, w_out,
            b_out)
    if _wants_grad(args):
        return _EdgeScore.apply(*args)
    return _edge.edge_score(*args)


@_counted
def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """GQA softmax attention: q [B,S,H,d], k/v [B,S,KVH,d] -> [B,S,H,d],
    keys j <= i (``causal``; all keys without it) with i - j <
    ``window``. Differentiable in q, k and v."""
    if _wants_grad((q, k, v)) and q.device.type == "cuda":
        return _FlashAttention.apply(q, k, v, causal, window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


@_counted
def decode_attention(q, k, v, lengths):
    """One query token per sequence against a KV cache: q [B,H,d],
    k/v [B,S,KVH,d], keys j < lengths[b] -> [B,H,d]."""
    _forward_only("decode_attention", q, k, v)
    return _decode.decode_attention(q, k, v, lengths)


@_counted
def ssm_scan(q, k, v, log_w, bonus_u=None, *, chunk: int,
             initial_state=None):
    """The gated linear recurrence in chunks of ``chunk`` rows: q, k,
    log_w [B,T,H,dk], v [B,T,H,dv] -> (y [B,T,H,dv], final state
    [B,H,dk,dv] float32); ``bonus_u`` [H,dk] selects RWKV semantics, None
    Mamba/SSD; ``initial_state`` None starts from zeros. Differentiable in
    every input, with cotangents on y and on the final state."""
    args = (q, k, v, log_w, bonus_u, initial_state)
    if _wants_grad([x for x in args if x is not None]):
        return _SsmScan.apply(*args, chunk)
    return _ssm.ssm_scan(q, k, v, log_w, bonus_u, chunk=chunk,
                         initial_state=initial_state)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
