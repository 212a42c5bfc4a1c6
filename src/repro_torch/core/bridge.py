"""Carry weights across from the JAX package.

The caller converts a JAX param tree to numpy first
(``jax.tree_util.tree_map(np.asarray, params)``), so this module needs
neither JAX nor anything of ``repro``. Names, shapes and dtypes are
checked against the port's layout (``core.gcn.param_shapes`` for the GCN
actor, ``DecoderLM.param_shapes`` for a decoder LM) and any mismatch
raises. The msgpack checkpoint reader comes later.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import gcn
from repro_torch.core.policy import DEV_DIM, OPT_DIM, AgentState
from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import DecoderLM


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


def _leaves(tree: dict, prefix: str = ""):
    """(path, leaf) pairs of a nested dict, depth first in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, x in flat.items():
        *heads, leaf = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = x
    return out


def lm_params_from_numpy(tree: dict, cfg: ArchConfig, device=None) -> dict:
    """A numpy decoder-LM param tree (the reference's ``DecoderLM.init``
    layout) -> the port's param dict on ``device`` (the card unless
    ``"cpu"``). Every leaf's name, shape and dtype must match
    ``DecoderLM.param_shapes(cfg)`` and ``DecoderLM.param_dtypes(cfg)``
    (``cfg.dtype`` but for RWKV-6's float32 ``w0`` and ``bonus_u``; a
    bfloat16 leaf is ml_dtypes' ``bfloat16``, as ``np.asarray`` gives it
    for a JAX array)."""
    device = resolve_device(device)
    want = dict(_leaves(DecoderLM.param_shapes(cfg)))
    dtypes = {path: str(dt).replace("torch.", "")
              for path, dt in _leaves(DecoderLM.param_dtypes(cfg))}
    got = dict(_leaves(tree))
    if set(got) != set(want):
        raise ValueError(f"param leaves differ: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}")
    out = {}
    for path, shape in want.items():
        x = got[path]
        if not isinstance(x, np.ndarray):
            raise TypeError(f"{path}: expected a numpy array, got "
                            f"{type(x).__name__}")
        if x.dtype.name != dtypes[path]:
            raise TypeError(f"{path}: dtype {x.dtype.name}, expected "
                            f"{dtypes[path]}")
        if x.shape != shape:
            raise ValueError(f"{path}: shape {x.shape}, expected {shape}")
        if dtypes[path] == "bfloat16":
            t = torch.from_numpy(np.array(x).view(np.uint16))
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(x))
        out[path] = t.to(device)
    return _unflatten(out)


def lm_params_numpy(cfg: ArchConfig, seed: int) -> dict:
    """Random float32 decoder-LM params drawn with numpy from ``seed``,
    leaf by leaf in the order of ``DecoderLM.param_shapes(cfg)``: weights
    Xavier-uniform per [in, out] matrix, norm scales 1 + N(0, 0.1),
    RWKV-6's decay base ``w0`` uniform in [-6, 0] (decays per step from
    ~0.9975 to ~0.37, so the state carries across chunks), every other
    leaf (biases, embedding, RWKV mixes, LoRAs, bonus) N(0, 0.02). Both
    frameworks can rebuild them from the seed alone
    (``tools/make_torch_lm_golden.py``, ``chip_smoke.py``); biases and
    scales are nonzero and not one, so a test sees them."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, shape in _leaves(DecoderLM.param_shapes(cfg)):
        leaf = path.rsplit("/", 1)[1]
        if leaf == "w":
            limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
            x = rng.uniform(-limit, limit, size=shape)
        elif leaf == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == "w0":
            x = rng.uniform(-6.0, 0.0, size=shape)
        else:
            x = 0.02 * rng.standard_normal(shape)
        flat[path] = x.astype(np.float32)
    return _unflatten(flat)
