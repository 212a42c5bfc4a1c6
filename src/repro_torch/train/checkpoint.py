"""Read and write the reference's checkpoint format.

Counterpart of ``repro/train/checkpoint.py:34-128``. A checkpoint is
zlib- or zstd-compressed msgpack of a flat map ``{path: {"dtype": str,
"shape": [int, ...], "data": bytes}}``: dict keys sorted, sequences as
``__seq{i}`` (so an ``AgentState`` is ``/__seq0`` .. ``/__seq8`` in its
field order: params, opt_state, replay, key, step, exit_mask, last_loss,
loss_sum, loss_count), the data C-ordered raw bytes.

The msgpack subset is encoded and decoded in pure Python
(``train/_msgpack.py``), since the GPU machine has no ``msgpack``. Files
are written with zlib; a zstd file (the reference writes zstd where
``zstandard`` is installed, found by its magic bytes) is read only where
``zstandard`` imports, else reading it raises and names the file.
"""
from __future__ import annotations

import os
import zlib

import numpy as np
import torch

from repro_torch.core.bridge import (REPLAY_FIELDS, STATE_FIELDS,
                                     agent_state_from_numpy)
from repro_torch.core.policy import AgentDef, AgentState
from repro_torch.nn.pytree import unflatten_dict
from repro_torch.train._msgpack import packb, unpackb

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _encode_tree(tree) -> dict:
    """The reference's flat map of a tree of dicts, sequences and arrays
    (tensors are copied to the host), in its order."""
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(f"{prefix}/{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(f"{prefix}/__seq{i}", v)
        else:
            arr = _numpy(node)
            flat[prefix] = {"dtype": str(arr.dtype), "shape": list(arr.shape),
                            "data": arr.tobytes()}

    rec("", tree)
    return flat


def save_checkpoint(path: str, tree, *, level: int = 3) -> None:
    """Write ``tree`` as the reference's ``save_checkpoint`` does, with
    zlib at ``level``; atomic by rename."""
    comp = zlib.compress(packb(_encode_tree(tree)), level)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(comp)
    os.replace(tmp, path)


def read_payload(path: str) -> bytes:
    """The file's msgpack bytes, decompressed."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] == _ZSTD_MAGIC:
        try:
            import zstandard
        except ImportError:
            raise ImportError(f"{path} is a zstd checkpoint and zstandard is "
                              f"not installed; rewrite it with zlib") from None
        return zstandard.ZstdDecompressor().decompress(raw)
    return zlib.decompress(raw)


def restore_checkpoint(path: str) -> dict:
    """The file as a flat ``{path: numpy array}``, in its order."""
    flat = unpackb(read_payload(path))
    return {k: np.frombuffer(v["data"], dtype=v["dtype"])
            .reshape(v["shape"]).copy() for k, v in flat.items()}


def _reference_tree(state: AgentState):
    """``state`` in the reference's field order, its key the bits of
    ``PRNGKey(0)`` (the port has none)."""
    fields = dict(state._asdict(), key=np.zeros(2, np.uint32),
                  replay=tuple(getattr(state.replay, f)
                               for f in REPLAY_FIELDS))
    return tuple(fields[f] for f in STATE_FIELDS)


def save_agent_state(path: str, state: AgentState, *, level: int = 3
                     ) -> None:
    """Write a full ``AgentState`` in the reference's layout, which
    ``repro.train.checkpoint.restore_agent_state`` reads. The reference's
    ``key`` leaf, which the port does not have, is written as [0, 0]."""
    save_checkpoint(path, _reference_tree(state), level=level)


def restore_agent_state(path: str, like: AgentDef, device=None
                        ) -> AgentState:
    """Read a reference ``save_agent_state`` file (or the port's) into an
    ``AgentState`` on ``device`` (default ``like.device``), every name,
    shape and dtype checked against the reference's fields and ``like``'s
    actor family and widths. The stored RNG ``key`` leaf is dropped: the port's draws come
    from the caller's generator."""
    flat = restore_checkpoint(path)
    tree = unflatten_dict({k.removeprefix("/"): v for k, v in flat.items()})
    fields = {}
    for i, name in enumerate(STATE_FIELDS):
        node = tree.get(f"__seq{i}")
        if node is None:
            raise ValueError(f"{path}: no AgentState field {name} "
                             f"(__seq{i})")
        fields[name] = node
    extra = sorted(set(tree) - {f"__seq{i}" for i in range(len(STATE_FIELDS))})
    if extra:
        raise ValueError(f"{path}: unexpected entries {extra}")
    replay = fields["replay"]
    if set(replay) != {f"__seq{i}" for i in range(len(REPLAY_FIELDS))}:
        raise ValueError(f"{path}: replay entries {sorted(replay)}")
    fields["replay"] = {f: replay[f"__seq{i}"]
                        for i, f in enumerate(REPLAY_FIELDS)}
    env = like.env
    state = agent_state_from_numpy(
        fields, like.device if device is None else device,
        hidden=like.hidden, dims=(env.M, env.N, env.L))
    if set(state.params) != set(like.param_shapes()):
        raise ValueError(f"{path}: an actor of layers {sorted(state.params)}"
                         f", the def's ({like.actor}) has "
                         f"{sorted(like.param_shapes())}")
    if state.replay.capacity != like.buffer_size or tuple(
            state.replay.adj.shape[1:]) != like.graph_shapes().adj:
        raise ValueError(
            f"{path}: a ring of {tuple(state.replay.adj.shape)}, the def "
            f"wants {like.buffer_size} graphs of {like.graph_shapes().adj}")
    return state
