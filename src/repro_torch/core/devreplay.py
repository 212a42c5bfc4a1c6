"""Device-resident replay ring of (graph, decision) pairs.

Counterpart of ``repro/core/devreplay.py``: a ring held in a NamedTuple of
fixed-shape tensors, a field of ``AgentState``. Adding writes B entries at
``ptr`` (the oldest are overwritten once full); sampling draws a minibatch
without replacement over the filled region: uniform scores, +inf past
``size``, the ``batch_size`` smallest by a stable sort; while fewer than
``batch_size`` entries are stored, the rows past ``size`` are uniform
re-draws from the stored ones.

``ptr`` and ``size`` are device tensors, as in the reference (they
checkpoint with the ring); ``host_size`` mirrors ``size`` on the host. It
is a function of how many entries were added, so the train gate reads it
without a device-to-host copy. The functions are pure: they return new
tensors.

Torch cannot reproduce JAX's threefry draws, so ``replay_sample`` takes
either a ``torch.Generator`` or the indices themselves (``take``), which
is how a test or the golden replay feeds in the reference's minibatches.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.graph import MECGraph


class DeviceReplay(NamedTuple):
    """Ring buffer of (graph, decision) pairs; leading axis = capacity."""
    device_feat: torch.Tensor   # [C, M, Fd]
    option_feat: torch.Tensor   # [C, O, Fo]
    adj: torch.Tensor           # [C, M, O]
    mask: torch.Tensor          # [C, M, O]
    decisions: torch.Tensor     # [C, M] int32
    ptr: torch.Tensor           # scalar int32, next write slot
    size: torch.Tensor          # scalar int32, filled entries (<= C)
    host_size: int = 0          # ``size`` on the host

    @property
    def capacity(self) -> int:
        return self.decisions.shape[0]


def replay_init(capacity: int, graph_shapes: MECGraph, n_devices: int, *,
                device) -> DeviceReplay:
    """Empty ring; ``graph_shapes`` holds one graph's leaf shapes."""
    def z(shape):
        return torch.zeros((capacity,) + tuple(shape), dtype=torch.float32,
                           device=device)

    def i0():
        return torch.zeros((), dtype=torch.int32, device=device)

    return DeviceReplay(
        device_feat=z(graph_shapes.device_feat),
        option_feat=z(graph_shapes.option_feat),
        adj=z(graph_shapes.adj), mask=z(graph_shapes.mask),
        decisions=torch.zeros((capacity, n_devices), dtype=torch.int32,
                              device=device),
        ptr=i0(), size=i0(), host_size=0)


def replay_add(replay: DeviceReplay, graphs: MECGraph,
               decisions: torch.Tensor) -> DeviceReplay:
    """Append B entries (graph leaves lead with [B]) at ``ptr``."""
    b = decisions.shape[0]
    cap = replay.capacity
    if b > cap:
        # duplicate scatter indices would leave which entry survives to
        # the backend
        raise ValueError(f"batch of {b} entries exceeds replay capacity {cap}")
    idx = (replay.ptr + torch.arange(b, device=replay.ptr.device)) % cap

    def put(ring, x):
        return ring.index_copy(0, idx, x.to(ring.dtype))

    return DeviceReplay(
        device_feat=put(replay.device_feat, graphs.device_feat),
        option_feat=put(replay.option_feat, graphs.option_feat),
        adj=put(replay.adj, graphs.adj), mask=put(replay.mask, graphs.mask),
        decisions=put(replay.decisions, decisions),
        ptr=(replay.ptr + b) % cap,
        size=torch.clamp_max(replay.size + b, cap),
        host_size=min(replay.host_size + b, cap))


def replay_indices(replay: DeviceReplay, batch_size: int,
                   generator: torch.Generator) -> torch.Tensor:
    """[batch_size] ring indices drawn from ``generator`` by the
    reference's rule (see the module docstring). The filled region is
    read from the device ``size``, so a captured train step samples the
    ring as it stands at each replay; the host mirror only picks the
    refill branch, which a train step (always on a full minibatch) never
    takes."""
    cap, size = replay.capacity, replay.host_size
    if batch_size > cap:
        raise ValueError(f"minibatch of {batch_size} exceeds replay capacity "
                         f"{cap}")
    dev = replay.decisions.device
    scores = torch.rand((cap,), generator=generator, device=dev)
    scores = torch.where(torch.arange(cap, device=dev) < replay.size, scores,
                         torch.inf)
    take = torch.sort(scores, stable=True).indices[:batch_size]
    if size >= batch_size:
        return take
    fill = torch.randint(0, max(size, 1), (batch_size,), generator=generator,
                         device=dev)
    return torch.where(torch.arange(batch_size, device=dev) < size, take,
                       fill)


def replay_sample(replay: DeviceReplay, batch_size: int, *,
                  generator: Optional[torch.Generator] = None,
                  take: Optional[torch.Tensor] = None):
    """A minibatch -> (MECGraph [batch, ...], decisions [batch, M]), at the
    indices ``take`` [batch_size] if given, else drawn from ``generator``."""
    if take is None:
        if generator is None:
            raise ValueError("replay_sample needs a generator or take")
        take = replay_indices(replay, batch_size, generator)
    elif tuple(take.shape) != (batch_size,):
        raise ValueError(f"take shape {tuple(take.shape)}, expected "
                         f"({batch_size},)")
    take = take.to(device=replay.decisions.device, dtype=torch.int64)
    graphs = MECGraph(replay.device_feat[take], replay.option_feat[take],
                      replay.adj[take], replay.mask[take])
    return graphs, replay.decisions[take]
