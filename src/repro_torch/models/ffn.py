"""Feed-forward layers: the gated dense MLP and the fine-grained MoE.

Counterpart of ``repro/models/ffn.py``: the SwiGLU ``DenseFFN`` and the
shared + routed-top-k ``MoEFFN`` (DeepSeekMoE, arXiv:2401.06066) with its
``MoEMetrics``. The MoE keeps the reference's routing exactly: a float32
router, softmax, top-k with renormalized gates, choices flattened k-major
so that primary choices win capacity ties, slots ranked by a cumsum per
group, per-group capacity ``min(ceil(t k / e * capacity_factor), t)`` with
the slots beyond it dropped, the [g, e, cap] gather, SwiGLU experts and a
gated scatter-add. A decode step (S == 1) makes all B tokens one group, so
at B = 8, k = 6, e = 64 the capacity is 1 and most routed slots drop, as in
the reference. Top-k breaks ties between equal probabilities by the lower
expert index, as ``jax.lax.top_k`` does. The experts are plain PyTorch
matmuls: the reference computes them in jnp, no Pallas kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.nn import Linear


class DenseFFN:
    """SwiGLU MLP (llama-family)."""

    @staticmethod
    def param_shapes(d_model: int, d_ff: int) -> dict:
        return {"w1": {"w": (d_model, d_ff)}, "w3": {"w": (d_model, d_ff)},
                "w2": {"w": (d_ff, d_model)}}

    @staticmethod
    def apply(params, x):
        h = F.silu(Linear.apply(params["w1"], x)) * Linear.apply(params["w3"], x)
        return Linear.apply(params["w2"], h)


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor       # load-balance loss (scalar)
    dropped_frac: torch.Tensor   # fraction of token-slots beyond capacity


def top_k(probs, k: int):
    """(values, indices) of the ``k`` largest along the last axis, in
    descending order, equal values by the lower index first (the order of
    ``jax.lax.top_k``, which ``torch.topk`` does not promise)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoEFFN:
    """Shared + routed-top-k mixture of experts."""

    # the router runs in float32 whatever cfg.dtype, as in the reference
    FLOAT32_LEAVES = frozenset({"router/w"})

    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        d, m, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        shapes = {"router": {"w": (d, e)}, "w1": (e, d, m), "w3": (e, d, m),
                  "w2": (e, m, d)}
        if cfg.n_shared_experts:
            shapes["shared"] = DenseFFN.param_shapes(
                d, cfg.n_shared_experts * m)
        return shapes

    @staticmethod
    def capacity(cfg: ArchConfig, tokens: int) -> int:
        """Slots per expert in a group of ``tokens`` tokens."""
        cap = max(1, int(math.ceil(tokens * cfg.top_k / cfg.n_experts
                                   * cfg.capacity_factor)))
        return min(cap, tokens)

    @staticmethod
    def apply(params, cfg: ArchConfig, x):
        """x [B, S, d] -> (y, MoEMetrics). Groups are the batch rows; a
        decode step (S == 1) regroups all B tokens into one group."""
        b, s, d = x.shape
        regroup = s == 1
        if regroup:
            x = x.reshape(1, b, d)
        y, metrics = MoEFFN._routed(params, cfg, x)
        if "shared" in params:
            y = y + DenseFFN.apply(params["shared"], x)
        if regroup:
            y = y.reshape(b, s, d)
        return y, metrics

    @staticmethod
    def route(params, cfg: ArchConfig, x):
        """The routing of x [g, t, d]: (probs [g,t,e] float32, expert_idx
        [g,t,k], flat_e [g,kt] the choices k-major, flat_gate [g,kt] their
        renormalized gates, slot [g,kt] each choice's rank within its
        expert, keep [g,kt] slot < capacity)."""
        probs = MoEFFN._probs(params, x)
        return (probs, *MoEFFN._choices(cfg, probs))

    @staticmethod
    def _probs(params, x):
        logits = Linear.apply(params["router"], x.float())         # [g,t,e]
        return torch.softmax(logits, dim=-1)

    @staticmethod
    def _choices(cfg: ArchConfig, probs):
        g, t, e = probs.shape
        k = cfg.top_k
        gate_vals, expert_idx = top_k(probs, k)                    # [g,t,k]
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
        # flatten choices k-major so primary choices win capacity ties
        flat_e = expert_idx.transpose(1, 2).reshape(g, k * t)
        flat_gate = gate_vals.transpose(1, 2).reshape(g, k * t)
        onehot = F.one_hot(flat_e, e)                              # [g,kt,e]
        rank = torch.cumsum(onehot, dim=1) - 1
        slot = torch.take_along_dim(rank, flat_e[..., None], dim=-1)[..., 0]
        keep = slot < MoEFFN.capacity(cfg, t)
        return expert_idx, flat_e, flat_gate, slot, keep

    @staticmethod
    def _routed(params, cfg: ArchConfig, x):
        """(y, MoEMetrics) of the routed experts; on DTensors through
        ``_routed_sharded``."""
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            return MoEFFN._routed_sharded(params, cfg, x)
        probs = MoEFFN._probs(params, x)
        y, ce, kept = MoEFFN._dispatch(cfg, x, probs, params["w1"],
                                       params["w3"], params["w2"])
        # --- load-balance aux loss (Switch/DeepSeek form)
        me = probs.mean(dim=(0, 1))                                # [e]
        aux = cfg.n_experts * torch.sum(me * ce)
        return y, MoEMetrics(aux.float(), 1.0 - kept)

    @staticmethod
    def _dispatch(cfg: ArchConfig, x, probs, w1, w3, w2, experts=None):
        """The choices, dispatch and experts of x [g, t, d] routed by
        ``probs`` -> (y [g,t,d], the mean share of the choices per expert
        [e], the kept share of the choices). ``experts`` (lo, n): only
        experts lo..lo+n-1 run, the expert leaves w1, w3, w2 holding just
        those (one device's block of an expert-parallel split); y is then
        their part of the sum."""
        g, t, d = x.shape
        e, k = cfg.n_experts, cfg.top_k
        cap = MoEFFN.capacity(cfg, t)
        expert_idx, flat_e, flat_gate, slot, keep = MoEFFN._choices(cfg,
                                                                    probs)
        kept = keep.float().mean()

        # --- scatter (token index, gate) into [g, e, cap] tables; a dropped
        # choice goes to the extra slot cap, which is cut off
        gi = torch.arange(g, device=x.device)[:, None]
        tok_of = torch.arange(t, device=x.device).repeat(k)[None].expand(g,
                                                                        -1)
        slot_c = torch.where(keep, slot, cap)
        src = torch.full((g, e, cap + 1), t, dtype=torch.long,
                         device=x.device)
        src[gi, flat_e, slot_c] = tok_of
        gates = torch.zeros((g, e, cap + 1), dtype=flat_gate.dtype,
                            device=x.device)
        gates[gi, flat_e, slot_c] = flat_gate
        src, gates = src[..., :cap], gates[..., :cap]
        if experts is not None:
            lo, n = experts
            src, gates = src[:, lo:lo + n], gates[:, lo:lo + n]
        valid = src < t

        # --- gather -> expert SwiGLU -> gated scatter-add
        x_pad = torch.cat([x, x.new_zeros((g, 1, d))], dim=1)
        exp_in = x_pad[gi[..., None], src]                         # [g,e,c,d]
        h = torch.einsum("gecd,edm->gecm", exp_in, w1)
        h = F.silu(h) * torch.einsum("gecd,edm->gecm", exp_in, w3)
        exp_out = torch.einsum("gecm,emd->gecd", h, w2)
        exp_out = exp_out * (gates * valid).to(exp_out.dtype)[..., None]
        y = torch.zeros((g, t + 1, d), dtype=x.dtype, device=x.device)
        y.index_put_((gi[..., None].expand_as(src), src), exp_out,
                     accumulate=True)
        ce = F.one_hot(expert_idx, e).float().sum(2).mean(dim=(0, 1)) / k
        return y[:, :t], ce, kept

    @staticmethod
    def _routed_sharded(params, cfg: ArchConfig, x):
        """The routed experts on DTensors, expert-parallel as XLA
        partitions the reference's: the router's probabilities are
        DTensor operations; each device dispatches its groups (x's group
        dim split over the data axes where x has it split, else gathered;
        d whole) to its block of the experts (``model``'s split of the
        expert leaves, their other dims gathered), so y, and the
        gradients of x and of the probabilities, are partial sums over
        ``model``, and the experts' gradients partial sums over the data
        axes the groups are split on. The choices' shares and the kept
        share (no gradient) are averaged over those axes."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        mesh = x.device_mesh
        names = tuple(mesh.mesh_dim_names or ())
        m = names.index("model") if "model" in names else None
        split = m is not None and cfg.n_experts % mesh.size(m) == 0
        x_pl, x_grad, w_pl, w_grad, y_pl, mean_pl = [], [], [], [], [], []
        for i, p in enumerate(x.placements):
            grouped = isinstance(p, Shard) and p.dim == 0 and i != m
            experts = i == m and split
            x_pl.append(Shard(0) if grouped else Replicate())
            x_grad.append(Shard(0) if grouped else
                          Partial() if experts else Replicate())
            w_pl.append(Shard(0) if experts else Replicate())
            w_grad.append(Shard(0) if experts else
                          Partial() if grouped else Replicate())
            y_pl.append(x_grad[-1])
            mean_pl.append(Partial("avg") if grouped else Replicate())

        def local(x, probs, w1, w3, w2):
            n = w1.shape[0]
            lo = mesh.get_local_rank(m) * n if split else 0
            return MoEFFN._dispatch(cfg, x, probs, w1, w3, w2,
                                    experts=(lo, n))

        probs = MoEFFN._probs(params, x)
        y, ce, kept = local_map(
            local, out_placements=(tuple(y_pl), tuple(mean_pl),
                                   tuple(mean_pl)),
            in_placements=(tuple(x_pl),) * 2 + (tuple(w_pl),) * 3,
            in_grad_placements=(tuple(x_grad),) * 2 + (tuple(w_grad),) * 3,
            device_mesh=mesh, redistribute_inputs=True)(
            x, probs, params["w1"], params["w3"], params["w2"])
        me = probs.mean(dim=(0, 1))
        aux = cfg.n_experts * torch.sum(me * ce)
        return y, MoEMetrics(aux.float(), 1.0 - kept)
