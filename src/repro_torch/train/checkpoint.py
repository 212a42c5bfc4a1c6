"""Read and write the reference's checkpoint format.

Counterpart of ``repro/train/checkpoint.py:34-128``. A checkpoint is
zlib- or zstd-compressed msgpack of a flat map ``{path: {"dtype": str,
"shape": [int, ...], "data": bytes}}``: dict keys sorted, sequences as
``__seq{i}`` (so an ``AgentState`` is ``/__seq0`` .. ``/__seq8`` in its
field order: params, opt_state, replay, key, step, exit_mask, last_loss,
loss_sum, loss_count), the data C-ordered raw bytes.
``restore_checkpoint`` reads any such file back as the reference's does
(nested dicts, or the structure of a ``like`` tree), ``read_flat`` as the
flat map.

An LM's params keep their dtypes: a bfloat16 leaf is written as the
reference writes one (dtype ``"bfloat16"``, the raw 16-bit words), and
``restore_lm_params`` reads such a file straight into tensors, with no
``ml_dtypes``.

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
                                     agent_state_from_numpy,
                                     check_lm_leaves)
from repro_torch.core.policy import AgentDef, AgentState
from repro_torch.device import resolve_device
from repro_torch.nn.pytree import unflatten_dict
from repro_torch.train._msgpack import packb, unpackb

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _walk(tree, prefix=""):
    """``(path, leaf)`` of a tree of dicts, sequences and leaves in the
    reference's order: dict keys sorted, a sequence's items as
    ``__seq{i}``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}/__seq{i}")
    else:
        yield prefix, tree


def _encode_tree(tree) -> dict:
    """The reference's flat map of a tree of dicts, sequences and arrays
    (tensors are copied to the host), in its order."""
    flat = {}
    for path, node in _walk(tree):
        if isinstance(node, torch.Tensor) and node.dtype == torch.bfloat16:
            words = node.detach().cpu().contiguous().view(torch.int16)
            flat[path] = {"dtype": "bfloat16", "shape": list(node.shape),
                          "data": words.numpy().tobytes()}
        else:
            arr = _numpy(node)
            flat[path] = {"dtype": str(arr.dtype), "shape": list(arr.shape),
                          "data": arr.tobytes()}
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


def read_flat(path: str) -> dict:
    """The file as a flat ``{path: numpy array}``, in its order."""
    flat = unpackb(read_payload(path))
    return {k: np.frombuffer(v["data"], dtype=v["dtype"])
            .reshape(v["shape"]).copy() for k, v in flat.items()}


def _tensor(entry: dict) -> torch.Tensor:
    """One stored leaf as a CPU tensor of its stored dtype (a bfloat16
    leaf from its raw words, with no ``ml_dtypes``)."""
    dtype = getattr(torch, entry["dtype"])
    if not entry["data"]:
        return torch.empty(entry["shape"], dtype=dtype)
    return torch.frombuffer(bytearray(entry["data"]),
                            dtype=dtype).reshape(entry["shape"])


def _rebuild(like, flat: dict, prefix: str = ""):
    """``like``'s structure (dicts, lists, tuples, NamedTuples) with each
    leaf taken from ``flat`` by its path, on the device of ``like``'s
    leaf where that is a tensor."""
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        items = [_rebuild(v, flat, f"{prefix}/__seq{i}")
                 for i, v in enumerate(like)]
        return type(like)(*items) if hasattr(like, "_fields") \
            else type(like)(items)
    x = flat[prefix]
    return x.to(like.device) if isinstance(like, torch.Tensor) else x


def restore_checkpoint(path: str, like=None):
    """The file as the reference's ``restore_checkpoint`` returns it, with
    torch tensors for leaves: without ``like``, nested dicts keyed by path
    segment (a sequence's items stay ``__seq{i}`` keys; a tree whose root
    was a sequence sits under the key ``""``, as the reference's
    ``unflatten_dict`` leaves it), on the CPU; with ``like``, ``like``'s
    structure, each leaf matched by its path in the reference's order and
    on the device of ``like``'s leaf. A path of ``like`` that the file
    lacks raises ``KeyError``."""
    flat = {k: _tensor(v) for k, v in unpackb(read_payload(path)).items()}
    if like is None:
        return unflatten_dict(flat)
    return _rebuild(like, flat)


def restore_lm_params(path: str, cfg, device=None) -> dict:
    """The reference's ``save_checkpoint(path, params)`` of an LM (or the
    port's) -> the port's param dict on ``device`` (the card unless
    ``"cpu"``), every leaf's path, dtype and shape checked against
    ``model_for(cfg)`` (``core.bridge.check_lm_leaves``)."""
    device = resolve_device(device)
    flat = unpackb(read_payload(path))
    check_lm_leaves({k: (v["dtype"], v["shape"]) for k, v in flat.items()},
                    cfg)
    return unflatten_dict({k: _tensor(v).to(device)
                           for k, v in flat.items()})


def _reference_tree(state: AgentState):
    """``state`` in the reference's field order, its key the bits of
    ``PRNGKey(0)`` (the port has none); a stacked state's key is one such
    per member."""
    lead = tuple(state.step.shape)
    fields = dict(state._asdict(), key=np.zeros(lead + (2,), np.uint32),
                  replay=tuple(getattr(state.replay, f)
                               for f in REPLAY_FIELDS))
    return tuple(fields[f] for f in STATE_FIELDS)


def _state_fields(tree: dict, path: str) -> dict:
    """An ``AgentState``'s ``__seq`` entries of a read file -> its fields by
    name (the replay ring's too), every entry present and none extra."""
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
    return fields


def _check_against(state: AgentState, like: AgentDef, path: str) -> None:
    """``state``'s actor family and ring against the def's."""
    if set(state.params) != set(like.param_shapes()):
        raise ValueError(f"{path}: an actor of layers {sorted(state.params)}"
                         f", the def's ({like.actor}) has "
                         f"{sorted(like.param_shapes())}")
    if state.replay.capacity != like.buffer_size or tuple(
            state.replay.adj.shape[1:]) != like.graph_shapes().adj:
        raise ValueError(
            f"{path}: a ring of {tuple(state.replay.adj.shape)}, the def "
            f"wants {like.buffer_size} graphs of {like.graph_shapes().adj}")


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
    tree = _read_tree(path)
    env = like.env
    state = agent_state_from_numpy(
        _state_fields(tree, path), like.device if device is None else device,
        hidden=like.hidden, dims=(env.M, env.N, env.L))
    _check_against(state, like, path)
    return state


def _read_tree(path: str) -> dict:
    """The file as nested dicts keyed by path segment (``__seq{i}`` for a
    sequence's items)."""
    flat = read_flat(path)
    return unflatten_dict({k.removeprefix("/"): v for k, v in flat.items()})


# -------------------------------------------------------------- populations
def _population_tree(pop):
    """A ``Population`` in the reference's layout: (agents, hypers,
    generation)."""
    return (_reference_tree(pop.agents), tuple(pop.hypers), pop.generation)


def save_population(path: str, pop, *, level: int = 3) -> None:
    """Write a ``repro_torch.pop`` ``Population``, or a trainer's
    ``PopTrainState`` (population + curriculum state), in the reference's
    ``save_population`` layout: the stacked per-member ``AgentState``
    leaves (its ``key`` leaf written as zeros, [P, 2]), the
    ``MemberHypers`` arrays and the generation counter, which
    ``repro.train.checkpoint.restore_population`` reads."""
    if hasattr(pop, "cur"):
        tree = (_population_tree(pop.pop), tuple(pop.cur))
    else:
        tree = _population_tree(pop)
    save_checkpoint(path, tree, level=level)


def restore_population(path: str, like, device=None):
    """Read a population file of the reference's (or the port's) into the
    structure of ``like``: a ``Population`` or a ``PopTrainState``, whose
    def-side shapes (members, actor widths, ring) the file must match. On
    ``device`` (default ``like``'s). The stored RNG keys are dropped. A
    mid-PBT restore continues bit for bit."""
    from repro_torch.core.bridge import population_from_numpy
    from repro_torch.pop.curriculum import CurriculumState
    from repro_torch.pop.trainer import PopTrainState

    tree = _read_tree(path)
    train_state = hasattr(like, "cur")
    like_pop = like.pop if train_state else like
    node = tree
    if train_state:
        if set(tree) != {"__seq0", "__seq1"}:
            raise ValueError(f"{path}: entries {sorted(tree)}, expected a "
                             f"population and a curriculum state")
        node = tree["__seq0"]
    if set(node) != {"__seq0", "__seq1", "__seq2"}:
        raise ValueError(f"{path}: entries {sorted(node)}, expected agents, "
                         f"hypers and a generation")
    hyp = node["__seq1"]
    if set(hyp) != {"__seq0", "__seq1", "__seq2"}:
        raise ValueError(f"{path}: hypers entries {sorted(hyp)}")
    dev = like_pop.generation.device if device is None else device
    params = like_pop.agents.params
    hidden = tuple(params[k]["w"].shape[-1] for k in ("dev1", "dev2")) \
        if "dev1" in params else (128, 64)
    ring = like_pop.agents.replay
    m, o = ring.decisions.shape[-1], ring.adj.shape[-1]
    pop = population_from_numpy(
        {"agents": _state_fields(node["__seq0"], path),
         "hypers": {"lr": hyp["__seq0"], "explore_gain": hyp["__seq1"],
                    "exit_tau": hyp["__seq2"]},
         "generation": node["__seq2"]}, dev, hidden=hidden)
    want = tuple(like_pop.hypers.lr.shape)
    if tuple(pop.hypers.lr.shape) != want or tuple(
            pop.agents.replay.adj.shape) != tuple(ring.adj.shape) or set(
            pop.agents.params) != set(params):
        raise ValueError(
            f"{path}: {tuple(pop.hypers.lr.shape)} members, actor layers "
            f"{sorted(pop.agents.params)}, rings "
            f"{tuple(pop.agents.replay.adj.shape)}; the template has {want}, "
            f"{sorted(params)}, {tuple(ring.adj.shape)} (M={m}, O={o})")
    if not train_state:
        return pop
    cur = tree["__seq1"]
    if set(cur) != {"__seq0", "__seq1"}:
        raise ValueError(f"{path}: curriculum entries {sorted(cur)}")
    return PopTrainState(pop=pop, cur=CurriculumState(
        *(torch.tensor(cur[f"__seq{i}"], device=dev) for i in range(2))))
