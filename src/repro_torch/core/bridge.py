"""Carry weights across from the JAX package.

The caller converts a JAX GCN param tree to numpy first
(``jax.tree_util.tree_map(np.asarray, state.params)``), so this module
needs neither JAX nor anything of ``repro``. Names, shapes and dtypes are
checked against the port's layout (``core.gcn.param_shapes``) and any
mismatch raises. The msgpack checkpoint reader comes later.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import gcn
from repro_torch.core.policy import DEV_DIM, OPT_DIM, AgentState


def params_from_numpy(tree: dict, device, *, hidden=(128, 64),
                      edge_hidden: int = 64) -> dict:
    """A numpy GCN param tree -> the port's param dict on ``device``."""
    want = gcn.param_shapes(DEV_DIM, OPT_DIM, hidden=hidden,
                            edge_hidden=edge_hidden)
    if set(tree) != set(want):
        raise ValueError(f"param layers differ: missing "
                         f"{sorted(set(want) - set(tree))}, unexpected "
                         f"{sorted(set(tree) - set(want))}")
    out = {}
    for layer, leaves in want.items():
        got = tree[layer]
        if set(got) != set(leaves):
            raise ValueError(f"{layer}: leaves {sorted(got)}, expected "
                             f"{sorted(leaves)}")
        out[layer] = {}
        for name, shape in leaves.items():
            x = got[name]
            if not isinstance(x, np.ndarray):
                raise TypeError(f"{layer}/{name}: expected a numpy array, "
                                f"got {type(x).__name__}")
            if x.dtype != np.float32:
                raise TypeError(f"{layer}/{name}: dtype {x.dtype}, expected "
                                f"float32")
            if x.shape != shape:
                raise ValueError(f"{layer}/{name}: shape {x.shape}, "
                                 f"expected {shape}")
            out[layer][name] = torch.tensor(x, device=device)
    return out


def agent_state_from_numpy(params: dict, exit_mask: np.ndarray, device, *,
                           hidden=(128, 64), edge_hidden: int = 64
                           ) -> AgentState:
    """An ``AgentState`` from a numpy param tree and [N*L] exit mask."""
    if not isinstance(exit_mask, np.ndarray) or exit_mask.dtype != np.float32 \
            or exit_mask.ndim != 1:
        raise ValueError("exit_mask must be a 1-D float32 numpy array")
    return AgentState(
        params=params_from_numpy(params, device, hidden=hidden,
                                 edge_hidden=edge_hidden),
        exit_mask=torch.tensor(exit_mask, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device))
