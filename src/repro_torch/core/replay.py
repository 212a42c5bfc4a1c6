"""Host experience replay (paper §V-E: size 128, minibatch 64).

Counterpart of ``repro/core/replay.py``: a numpy ring of (graph,
decision) pairs with its own ``np.random.default_rng(seed)``, so the same
seed samples the reference's indices exactly. The driver and the agent
use the device ring (``core/devreplay.py``); this is the public host one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import MECGraph


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ReplayBuffer:
    def __init__(self, capacity: int = 128, seed: int = 0):
        self.capacity = capacity
        self._store: list = [None] * capacity
        self._ptr = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def add(self, graph: MECGraph, decision) -> None:
        """Store one (graph, decision) pair (tensors are copied to host
        numpy), overwriting the oldest once full."""
        self._store[self._ptr] = (tuple(_host(x) for x in graph),
                                  _host(decision))
        self._ptr = (self._ptr + 1) % self.capacity
        self._size = min(self._size + 1, self.capacity)

    def __len__(self) -> int:
        return self._size

    def sample(self, batch_size: int):
        """Random minibatch -> (MECGraph of stacked numpy arrays, decisions
        [B, M]); without replacement, shrinking to the stored count when
        fewer are held."""
        n = min(batch_size, self._size)
        idx = self._rng.choice(self._size, size=n, replace=False)
        graphs, decisions = zip(*(self._store[i] for i in idx))
        stacked = MECGraph(*(np.stack(parts) for parts in zip(*graphs)))
        return stacked, np.stack(decisions)
