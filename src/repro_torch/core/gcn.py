"""Two-layer bipartite GCN actor (paper Eq. 12–14), batch-native.

Counterpart of ``repro/core/gcn.py``. Eq-12 message passing runs through
``kernels.ops.gcn_agg`` (4 launches per forward: 2 layers x 2 node
types) and the Eq-13/14 edge MLP through ``kernels.ops.edge_score``
(1 launch). Leading batch axes on the ``MECGraph`` leaves are flattened
into the kernels' one batch axis.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import MECGraph
from repro_torch.kernels import ops
from repro_torch.nn import Linear


def param_shapes(dev_dim: int, opt_dim: int, *, hidden=(128, 64),
                 edge_hidden: int = 64) -> dict:
    """``{layer: {"w": shape, "b": shape}}`` of the actor's params — the
    reference's names and ``[in, out]`` layout."""
    h1, h2 = hidden
    e = edge_hidden
    return {
        # layer 1: concat(self, agg) -> h1, per node type
        "dev1": {"w": (dev_dim + opt_dim, h1), "b": (h1,)},
        "opt1": {"w": (opt_dim + dev_dim, h1), "b": (h1,)},
        # layer 2: concat(self, agg) -> h2
        "dev2": {"w": (2 * h1, h2), "b": (h2,)},
        "opt2": {"w": (2 * h1, h2), "b": (h2,)},
        # edge MLP (Eq 14), concat-linear decomposed into src + dst + edge
        # projections; the per-link rate is the edge's own feature
        "edge_src": {"w": (h2, e), "b": (e,)},
        "edge_dst": {"w": (h2, e)},
        "edge_feat": {"w": (1, e)},
        "edge_out": {"w": (e, 1), "b": (1,)},
    }


def init(generator: torch.Generator, dev_dim: int, opt_dim: int, *,
         device, hidden=(128, 64), edge_hidden: int = 64) -> dict:
    shapes = param_shapes(dev_dim, opt_dim, hidden=hidden,
                          edge_hidden=edge_hidden)
    return {name: Linear.init(generator, *p["w"], use_bias="b" in p,
                              device=device)
            for name, p in shapes.items()}


def _split(p: dict, f_self: int):
    """Concat-linear [f_self + f_nbr, H] -> (w_self, w_nbr, bias)."""
    w = p["w"]
    return w[:f_self], w[f_self:], p["b"]


def _layer(p_dev, p_opt, adj, adj_t, h_dev, h_opt):
    """One Eq-12 round for both node types via the fused kernel."""
    wd_s, wd_n, bd = _split(p_dev, h_dev.shape[-1])
    wo_s, wo_n, bo = _split(p_opt, h_opt.shape[-1])
    new_dev = ops.gcn_agg(adj, h_dev, h_opt, wd_s, wd_n, bd)
    new_opt = ops.gcn_agg(adj_t, h_opt, h_dev, wo_s, wo_n, bo)
    return new_dev, new_opt


def embed(params, g: MECGraph):
    """Two rounds of message passing -> (h_dev [..., M, h2],
    h_opt [..., O, h2]); leading batch axes pass through unchanged."""
    batch = g.adj.shape[:-2]
    gf = MECGraph(*(x.reshape((-1,) + x.shape[len(batch):]) for x in g))
    # a strided view: the kernel reads adj through strides, so the
    # option-side layers cost no transpose copy
    adj_t = gf.adj.transpose(-1, -2)
    h_dev, h_opt = _layer(params["dev1"], params["opt1"], gf.adj, adj_t,
                          gf.device_feat, gf.option_feat)
    h_dev, h_opt = _layer(params["dev2"], params["opt2"], gf.adj, adj_t,
                          h_dev, h_opt)
    return (h_dev.reshape(batch + h_dev.shape[1:]),
            h_opt.reshape(batch + h_opt.shape[1:]))


def edge_logits(params, h_dev, h_opt, edge_feat):
    """Eq 14 pre-sigmoid logits for every (device, option) edge
    [..., M, O]; ``edge_feat`` [..., M, O] is the edge's own feature."""
    batch = h_dev.shape[:-2]
    hd = h_dev.reshape((-1,) + h_dev.shape[len(batch):])
    ho = h_opt.reshape((-1,) + h_opt.shape[len(batch):])
    ef = edge_feat.reshape((-1,) + edge_feat.shape[len(batch):])
    logits = ops.edge_score(
        hd, ho, ef,
        params["edge_src"]["w"], params["edge_src"]["b"],
        params["edge_dst"]["w"], params["edge_feat"]["w"][0],
        params["edge_out"]["w"][:, 0], params["edge_out"]["b"])
    return logits.reshape(batch + logits.shape[1:])


def apply(params, g: MECGraph):
    """Relaxed offloading action x̂ in (0,1)^{...×M×O}; disconnected
    edges -> 0. Batch axes on ``g`` batch the output."""
    h_dev, h_opt = embed(params, g)
    logits = edge_logits(params, h_dev, h_opt, g.adj)
    logits = torch.where(g.mask > 0.5, logits, -1e9)
    return torch.sigmoid(logits), logits
