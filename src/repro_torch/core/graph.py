"""MEC state -> bipartite graph tensors (paper §V-C).

Counterpart of ``repro/core/graph.py``. Vertices: M IoT devices and N*L
early-exit options; each device connects to every (server, exit) option
whose link is up, weighted by the normalized rate estimate of that link.
Dense [M, O] adjacency; leading batch axes pass through.
``pad_graph`` zero-pads the device axis for dynamic-M replay rings.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class MECGraph(NamedTuple):
    device_feat: torch.Tensor   # [..., M, Fd]
    option_feat: torch.Tensor   # [..., O, Fo]
    adj: torch.Tensor           # [..., M, O] edge weights (0 = disconnected)
    mask: torch.Tensor          # [..., M, O] 1.0 where an edge exists


def build_graph(obs: dict, n_servers: int, n_exits: int,
                *, device_id: bool = True) -> MECGraph:
    """Assemble graph tensors from ``MECEnv.observe`` output.

    ``device_id`` appends a per-device index feature ``m / max(M-1, 1)``,
    which breaks the symmetry a purely equivariant GCN cannot.
    """
    device = obs["device"]                      # [..., M, Fd]
    if device_id:
        m = device.shape[-2]
        ids = (torch.arange(m, dtype=device.dtype, device=device.device)
               / max(m - 1, 1))[:, None]
        ids = ids.expand(device.shape[:-1] + (1,))
        device = torch.cat([device, ids], dim=-1)
    option = obs["option"]                      # [..., N*L, Fo]
    # expand per-server link quantities over that server's L exit options
    rate = torch.repeat_interleave(obs["edge_rate"], n_exits, dim=-1)
    mask = torch.repeat_interleave(obs["connect"], n_exits, dim=-1)
    adj = rate * mask
    return MECGraph(device, option, adj, mask)


def pad_graph(g: MECGraph, max_devices: int) -> MECGraph:
    """Zero-pad the device dimension (axis -2) to ``max_devices`` so replay
    rings over dynamic-M scenarios have static shapes (padded devices have
    no edges); leading batch axes pass through unchanged."""
    pad = max_devices - g.device_feat.shape[-2]
    if pad < 0:
        raise ValueError(f"a graph of {g.device_feat.shape[-2]} devices "
                         f"cannot pad to {max_devices}")
    if pad == 0:
        return g

    def dev_pad(x):
        return F.pad(x, (0, 0, 0, pad))

    return MECGraph(dev_pad(g.device_feat), g.option_feat, dev_pad(g.adj),
                    dev_pad(g.mask))
