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

The three LM kernels take DTensors too (the partitioned steps,
``sharding/partition.py``): ``flash_attention``, ``decode_attention``
and ``ssm_scan`` given a DTensor run through ``local_map``, one call per
device on its local shards. The batch stays split over the data axes
where the query has it split, and the heads go over ``model`` where their
count divides it; K/V heads that do not divide it (GQA's 8 on a 16-wide
axis) are gathered whole and each device slices the ones its query heads
read, and a cache split over its sequence or head_dim is gathered first:
those collectives are the DTensor redistributions ``local_map`` makes,
counted as any other. The per-device call is the kernel on the card and
the plain version on the CPU, as for a plain tensor, and is counted on
its local shapes. On fake tensors (``FakeTensorMode``, the dry run) a
call computes nothing: it allocates its outputs (and, in a backward, the
inputs' gradients) and is costed by its formula (``_ShapeOnly``). The
gcn_agg and edge_score kernels take no DTensor; a DTensor that reaches a
CUDA kernel by any other route raises (``_build.device_of``).
"""
from __future__ import annotations

import functools
import inspect

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import cost as _cost
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import edge_score as _edge
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gcn_agg as _gcn
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.sharding.runtime import heads_parallel

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
        if name in _SHARDED and any(isinstance(x, DTensor) for x in
                                    (*args, *kwargs.values())):
            return _SHARDED[name](op, *args, **kwargs)
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


class _ShapeOnly(torch.autograd.Function):
    """A kernel's call on fake tensors: the outputs ``outs`` ((shape,
    dtype) each) allocated on the inputs' device, nothing computed. Its
    backward allocates the gradients of the inputs that need one and is
    counted by the innermost cost counter as one operation of
    ``bwd_flops``."""

    @staticmethod
    def forward(ctx, bwd_flops, outs, *inputs):
        ctx.bwd_flops = bwd_flops
        ctx.metas = [None if x is None else (x.shape, x.dtype)
                     for x in inputs]
        device = next(x.device for x in inputs if x is not None)
        res = tuple(torch.empty(s, dtype=d, device=device) for s, d in outs)
        return res if len(res) > 1 else res[0]

    @staticmethod
    def backward(ctx, *cotangents):
        device = next(g.device for g in cotangents if g is not None)

        def grads(*_):
            return tuple(
                torch.empty(m[0], dtype=m[1], device=device)
                if m is not None and need else None
                for m, need in zip(ctx.metas, ctx.needs_input_grad[2:]))

        live = [g for g in cotangents if g is not None]
        out = (_COST_COUNTERS[-1].kernel(ctx.bwd_flops, grads, live, {})
               if _COST_COUNTERS else grads())
        return (None, None, *out)


def _is_fake(*tensors) -> bool:
    return any(isinstance(t, FakeTensor) for t in tensors)


# ------------------------------------------------------------ on DTensors
def _model_dim(mesh):
    names = tuple(mesh.mesh_dim_names or ())
    return names.index("model") if "model" in names else None


def _placements(mesh, like, batch_dim, head_dim, split_heads: bool):
    """Per mesh dim: ``Shard(head_dim)`` on ``model`` if ``split_heads``;
    on another axis ``Shard(batch_dim)`` where ``like`` (the query) has
    its batch split there; else ``Replicate()``."""
    m = _model_dim(mesh)
    out = []
    for i, p in enumerate(like.placements):
        if i == m:
            out.append(Shard(head_dim) if split_heads else Replicate())
        elif isinstance(p, Shard) and p.dim == batch_dim and \
                batch_dim is not None:
            out.append(Shard(batch_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def _head_split(mesh, h: int, kvh: int):
    """(query heads split over ``model``, K/V heads split with them, each
    device slices its K/V heads from the whole set)."""
    m = _model_dim(mesh)
    if m is None or h % mesh.size(m):
        return False, False, False
    if kvh % mesh.size(m) == 0:
        return True, True, False
    hl, g = h // mesh.size(m), h // kvh
    if hl % g == 0 or g % hl == 0:
        return True, False, True
    return False, False, False


def _kv_slice(mesh, k, v, h_local: int, group: int):
    """This device's K/V heads of the whole set: those its ``h_local``
    query heads (a block of ``model``) read."""
    lo = mesh.get_local_rank("model") * h_local // group
    n = max(1, h_local // group)
    return k[:, :, lo:lo + n], v[:, :, lo:lo + n]


def _grad_placements(mesh, pl, partial_on_model: bool):
    """A sliced input's gradient: partial sums over ``model``."""
    if not partial_on_model:
        return pl
    m = _model_dim(mesh)
    return tuple(Partial() if i == m else p for i, p in enumerate(pl))


def _on_mesh(*xs):
    """The mesh of the first DTensor among ``xs``, and ``xs`` with every
    plain tensor as a replicated DTensor on it (a constant the caller
    built)."""
    mesh = next(x.device_mesh for x in xs if isinstance(x, DTensor))
    return mesh, [x if x is None or isinstance(x, DTensor)
                  else DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                          run_check=False)
                  for x in xs]


def _flash_sharded(op, q, k, v, *, causal: bool = True, window=None):
    mesh, (q, k, v) = _on_mesh(q, k, v)
    h, kvh = q.shape[2], k.shape[2]
    split, kv_split, kv_slice = _head_split(mesh, h, kvh)
    q_pl = _placements(mesh, q, 0, 2, split)
    kv_pl = _placements(mesh, q, 0, 2, kv_split)

    def local(q, k, v):
        if kv_slice:
            k, v = _kv_slice(mesh, k, v, q.shape[2], h // kvh)
        return op(q, k, v, causal=causal, window=window)

    kv_grad = _grad_placements(mesh, kv_pl, kv_slice)
    return local_map(local, out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _decode_sharded(op, q, k, v, lengths):
    mesh, (q, k, v, lengths) = _on_mesh(q, k, v, lengths)
    h, kvh = q.shape[1], k.shape[2]
    split, kv_split, kv_slice = _head_split(mesh, h, kvh)
    q_pl = _placements(mesh, q, 0, 1, split)
    kv_pl = _placements(mesh, q, 0, 2, kv_split)
    len_pl = _placements(mesh, q, 0, None, False)

    def local(q, k, v, lengths):
        if kv_slice:
            k, v = _kv_slice(mesh, k, v, q.shape[1], h // kvh)
        return op(q, k, v, lengths)

    return local_map(local, out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl, len_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, lengths)


def _ssm_sharded(op, q, k, v, log_w, bonus_u=None, *, chunk: int,
                 initial_state=None):
    return heads_parallel(
        lambda q, k, v, log_w, u, s0: op(q, k, v, log_w, u, chunk=chunk,
                                         initial_state=s0),
        (q, k, v, log_w, bonus_u, initial_state), (2, 2, 2, 2, 0, 1),
        (2, 1), (True,) * 4 + (False, True))


# name -> the op's call on DTensors, given the op to run on each device
_SHARDED = {"flash_attention": _flash_sharded,
            "decode_attention": _decode_sharded,
            "ssm_scan": _ssm_sharded}


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
    if _is_fake(q, k, v):
        _flash.check_shapes(q, k, v, window)
        return _ShapeOnly.apply(
            _cost.flash_bwd_flops(q, k, window, causal),
            ((q.shape, q.dtype),), q, k, v)
    if _wants_grad((q, k, v)) and q.device.type == "cuda":
        return _FlashAttention.apply(q, k, v, causal, window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


@_counted
def decode_attention(q, k, v, lengths):
    """One query token per sequence against a KV cache: q [B,H,d],
    k/v [B,S,KVH,d], keys j < lengths[b] -> [B,H,d]."""
    _forward_only("decode_attention", q, k, v)
    if _is_fake(q, k, v, lengths):
        _decode.check_shapes(q, k, v, lengths)
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
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
    if _is_fake(q, k, v, log_w):
        _ssm.check_shapes(*args, chunk)
        b, t, h, dk = q.shape
        return _ShapeOnly.apply(
            _cost.ssm_bwd_flops(q, v, log_w, bonus_u, initial_state),
            (((b, t, h, v.shape[-1]), q.dtype),
             ((b, h, dk, v.shape[-1]), torch.float32)), *args)
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
