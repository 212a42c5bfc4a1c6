"""Carry weights and agent states across from the JAX package.

The caller converts a JAX tree to numpy first
(``jax.tree_util.tree_map(np.asarray, state)``), or reads a reference
checkpoint with ``repro_torch.train.checkpoint``, so this module needs
neither JAX nor anything of ``repro``. Names, shapes and dtypes are
checked against the port's layout (``core.gcn.param_shapes`` for the GCN
actor, ``MLPActor.param_shapes`` for DROO's MLP, ``param_shapes`` of
``model_for(cfg)`` for an LM and its AdamW moments,
``VGG16EE.param_shapes`` for the multi-exit VGG-16, the reference's
``AgentState`` and ``DeviceReplay`` fields for an agent state, with a
leading [P] in a population) and any mismatch raises.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import gcn
from repro_torch.core.devreplay import DeviceReplay
from repro_torch.core.policy import (DEV_DIM, OPT_DIM, AgentDef, AgentState,
                                     MLPActor)
from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import model_for
from repro_torch.nn.pytree import flatten_dict, unflatten_dict


def _tree_from_numpy(tree: dict, want: dict, device, path: str) -> dict:
    """``tree`` checked leaf by leaf against the nested shapes ``want``
    (names, float32, shapes), as tensors on ``device``."""
    if set(tree) != set(want):
        what = "param layers differ" if not path else f"{path}: leaves"
        raise ValueError(f"{what}: missing {sorted(set(want) - set(tree))}, "
                         f"unexpected {sorted(set(tree) - set(want))}")
    out = {}
    for name, shape in want.items():
        x, where = tree[name], f"{path}/{name}" if path else name
        if isinstance(shape, dict):
            if not isinstance(x, dict):
                raise TypeError(f"{where}: expected a dict of leaves, got "
                                f"{type(x).__name__}")
            out[name] = _tree_from_numpy(x, shape, device, where)
            continue
        if not isinstance(x, np.ndarray):
            raise TypeError(f"{where}: expected a numpy array, got "
                            f"{type(x).__name__}")
        if x.dtype != np.float32:
            raise TypeError(f"{where}: dtype {x.dtype}, expected float32")
        if x.shape != shape:
            raise ValueError(f"{where}: shape {x.shape}, expected {shape}")
        out[name] = torch.tensor(x, device=device)
    return out


def actor_shapes(tree: dict, *, hidden=(128, 64), edge_hidden: int = 64,
                 dims=None) -> dict:
    """The shapes a numpy actor param tree must have: the GCN's, or, when
    its layers are ``trunk``/``head``, DROO's MLP at ``dims`` = (M, N, L)
    (needed for the MLP, whose widths depend on the network)."""
    if set(tree) == {"trunk", "head"}:
        if dims is None:
            raise ValueError("an MLP actor's shapes need dims=(M, N, L)")
        m, n, l = dims
        return MLPActor.param_shapes(m, n, n * l)
    return gcn.param_shapes(DEV_DIM, OPT_DIM, hidden=hidden,
                            edge_hidden=edge_hidden)


def params_from_numpy(tree: dict, device, *, hidden=(128, 64),
                      edge_hidden: int = 64, dims=None) -> dict:
    """A numpy actor param tree (GCN, or DROO's MLP at ``dims`` = (M, N,
    L)) -> the port's param dict on ``device``."""
    want = actor_shapes(tree, hidden=hidden, edge_hidden=edge_hidden,
                        dims=dims)
    return _tree_from_numpy(tree, want, device, "")


# the reference's AgentState fields, in order; the port keeps all but ``key``
STATE_FIELDS = ("params", "opt_state", "replay", "key", "step", "exit_mask",
                "last_loss", "loss_sum", "loss_count")
REPLAY_FIELDS = ("device_feat", "option_feat", "adj", "mask", "decisions",
                 "ptr", "size")


def _fields(x, names, what: str) -> dict:
    """A NamedTuple or mapping -> dict of ``names``, which must be exactly
    its fields."""
    d = dict(x._asdict() if hasattr(x, "_asdict") else x)
    if set(d) != set(names):
        raise ValueError(f"{what}: fields {sorted(d)}, expected "
                         f"{sorted(names)}")
    return d


def _array(path: str, x, dtype, shape) -> np.ndarray:
    """``x`` checked to be a numpy array of ``dtype`` and ``shape`` (None
    in ``shape`` matches any length)."""
    if not isinstance(x, np.ndarray):
        raise TypeError(f"{path}: expected a numpy array, got "
                        f"{type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{path}: dtype {x.dtype}, expected "
                        f"{np.dtype(dtype)}")
    if len(x.shape) != len(shape) or any(
            w is not None and g != w for g, w in zip(x.shape, shape)):
        raise ValueError(f"{path}: shape {x.shape}, expected {shape}")
    return x


def agent_state_from_numpy(state, device, *, hidden=(128, 64),
                           edge_hidden: int = 64, dims=None) -> AgentState:
    """The reference's full ``AgentState`` (a NamedTuple or mapping of its
    fields, numpy leaves) -> the port's on ``device``: params (GCN or
    DROO's MLP), Adam ``step``/``mu``/``nu``, the replay ring with
    ``ptr``/``size``, the slot counter, exit mask and loss stats. Every
    name, shape and dtype is checked. An MLP's widths come from ``dims`` =
    (M, N, L), or without it from the ring's M and O and the trunk's
    input width M*(N+2). The reference's RNG ``key`` is dropped: the
    port's draws come from the caller's generator."""
    device = resolve_device(device)
    st = _fields(state, STATE_FIELDS, "AgentState")
    opt = _fields(st["opt_state"], ("step", "mu", "nu"), "opt_state")
    rp = _fields(st["replay"], REPLAY_FIELDS, "replay")
    i32, f32 = np.int32, np.float32
    cap, m, _ = _array("replay/device_feat", rp["device_feat"], f32,
                       (None, None, DEV_DIM)).shape
    o = _array("replay/option_feat", rp["option_feat"], f32,
               (cap, None, OPT_DIM)).shape[1]
    want = {"adj": (f32, (cap, m, o)), "mask": (f32, (cap, m, o)),
            "decisions": (i32, (cap, m)), "ptr": (i32, ()),
            "size": (i32, ())}
    for name, (dt, shape) in want.items():
        _array(f"replay/{name}", rp[name], dt, shape)
    ptr, size = int(rp["ptr"]), int(rp["size"])
    if not (0 <= ptr < cap and 0 <= size <= cap):
        raise ValueError(f"replay: ptr {ptr}, size {size} outside a ring of "
                         f"{cap}")
    for name, dt in (("step", i32), ("last_loss", f32), ("loss_sum", f32),
                     ("loss_count", i32)):
        _array(name, st[name], dt, ())
    _array("opt_state/step", opt["step"], i32, ())
    _array("key", st["key"], np.uint32, (2,))
    _array("exit_mask", st["exit_mask"], f32, (o,))

    def t(x):
        return torch.tensor(np.asarray(x), device=device)

    params = st["params"]
    if dims is None and set(params) == {"trunk", "head"}:
        try:
            in_dim = int(params["trunk"]["fc1"]["w"].shape[0])
        except (KeyError, TypeError, AttributeError, IndexError):
            in_dim = 0
        n = in_dim // m - 2 if m and in_dim % m == 0 else 0
        if n < 1 or o % n:
            raise ValueError(f"params/trunk/fc1/w: input width {in_dim} is "
                             f"not M*(N+2) for M={m} and N dividing O={o}")
        dims = (m, n, o // n)
    want = actor_shapes(params, hidden=hidden, edge_hidden=edge_hidden,
                        dims=dims)

    def tree(p, what):
        if not isinstance(p, dict):
            raise TypeError(f"{what}: expected a dict, got "
                            f"{type(p).__name__}")
        return _tree_from_numpy(p, want, device, "" if what == "params"
                                else what)

    return AgentState(
        params=tree(st["params"], "params"),
        opt_state={"step": t(opt["step"]), "mu": tree(opt["mu"], "mu"),
                   "nu": tree(opt["nu"], "nu")},
        replay=DeviceReplay(*(t(rp[f]) for f in REPLAY_FIELDS),
                            host_size=size),
        step=t(st["step"]), exit_mask=t(st["exit_mask"]),
        last_loss=t(st["last_loss"]), loss_sum=t(st["loss_sum"]),
        loss_count=t(st["loss_count"]), host_step=int(st["step"]))


def population_from_numpy(pop, device, *, hidden=(128, 64),
                          edge_hidden: int = 64, dims=None):
    """The reference's ``Population`` (a NamedTuple or mapping of
    ``agents``, ``hypers``, ``generation``, numpy leaves; every agent leaf
    with a leading [P], as ``jax.vmap(adef.init)`` stacks them) -> the
    port's ``repro_torch.pop.Population`` on ``device``. Each member goes
    through ``agent_state_from_numpy`` (every name, shape and dtype
    checked; its RNG key dropped); ``hypers`` are [P] float32 ``lr``,
    ``explore_gain``, ``exit_tau``; ``generation`` a 0-d int32."""
    from repro_torch.pop.population import (MemberHypers, Population,
                                            stack_states)

    device = resolve_device(device)
    top = _fields(pop, ("agents", "hypers", "generation"), "Population")
    agents = _fields(top["agents"], STATE_FIELDS, "agents")
    hyp = _fields(top["hypers"], MemberHypers._fields, "hypers")
    n = _array("hypers/lr", hyp["lr"], np.float32, (None,)).shape[0]
    for name in MemberHypers._fields:
        _array(f"hypers/{name}", hyp[name], np.float32, (n,))
    _array("generation", top["generation"], np.int32, ())

    def member(tree, i):
        if isinstance(tree, dict) or hasattr(tree, "_asdict"):
            d = tree._asdict() if hasattr(tree, "_asdict") else tree
            return {k: member(v, i) for k, v in d.items()}
        x = np.asarray(tree)
        if x.ndim == 0 or x.shape[0] != n:
            raise ValueError(f"agents: a leaf of shape {x.shape}, expected "
                             f"a leading [{n}] members")
        return np.array(x[i])

    states = [agent_state_from_numpy(member(agents, i), device,
                                     hidden=hidden, edge_hidden=edge_hidden,
                                     dims=dims) for i in range(n)]
    if len({(s.host_step, s.replay.host_size) for s in states}) > 1:
        raise ValueError("agents: members at different slot counts or ring "
                         "sizes; a population shares one schedule")
    return Population(
        agents=stack_states(states),
        hypers=MemberHypers(*(torch.tensor(hyp[f], device=device)
                              for f in MemberHypers._fields)),
        generation=torch.tensor(top["generation"], device=device))


def agent_state_from_params(adef: AgentDef, params: dict,
                            exit_mask: np.ndarray) -> AgentState:
    """A fresh ``adef`` state (zero Adam moments, empty ring, counters at
    0) around a numpy param tree and [N*L] exit mask, on ``adef.device``."""
    env = adef.env
    _array("exit_mask", exit_mask, np.float32, (env.N * env.L,))
    return adef.init_from(
        params_from_numpy(params, adef.device, hidden=adef.hidden,
                          dims=(env.M, env.N, env.L)),
        torch.tensor(exit_mask, device=adef.device))


def lm_params_from_numpy(tree: dict, cfg: ArchConfig, device=None) -> dict:
    """A numpy LM param tree (the layout of the reference's
    ``model_for(cfg).init``: ``DecoderLM``'s, or ``EncDecLM``'s
    ``encoder``/``enc_norm``/``decoder``) -> the port's param dict on
    ``device`` (the card unless ``"cpu"``). Every leaf's name, shape and
    dtype must match ``param_shapes(cfg)`` and ``param_dtypes(cfg)`` of
    ``model_for(cfg)`` (``cfg.dtype`` but for the float32 leaves: RWKV-6's
    ``w0`` and ``bonus_u``, Mamba-2's ``a_log`` and ``dt_bias``, the MoE's
    ``router/w``; a bfloat16 leaf is ml_dtypes' ``bfloat16``, as
    ``np.asarray`` gives it for a JAX array)."""
    device = resolve_device(device)
    got = flatten_dict(tree)
    for path, x in got.items():
        if not isinstance(x, np.ndarray):
            raise TypeError(f"{path}: expected a numpy array, got "
                            f"{type(x).__name__}")
    check_lm_leaves({k: (x.dtype.name, x.shape) for k, x in got.items()},
                    cfg)
    out = {}
    for path, x in got.items():
        if x.dtype.name == "bfloat16":
            t = torch.from_numpy(np.array(x).view(np.uint16))
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(x))
        out[path] = t.to(device)
    return unflatten_dict(out)


def check_lm_leaves(leaves: dict, cfg: ArchConfig) -> None:
    """``leaves`` ``{path: (dtype name, shape)}`` of a flat LM param tree
    against ``param_shapes(cfg)`` and ``param_dtypes(cfg)`` of
    ``model_for(cfg)``: the same paths, and each leaf's dtype and shape;
    raises on the first mismatch."""
    model = model_for(cfg)
    want = flatten_dict(model.param_shapes(cfg))
    dtypes = {path: str(dt).replace("torch.", "") for path, dt
              in flatten_dict(model.param_dtypes(cfg)).items()}
    if set(leaves) != set(want):
        raise ValueError(f"param leaves differ: missing "
                         f"{sorted(set(want) - set(leaves))}, unexpected "
                         f"{sorted(set(leaves) - set(want))}")
    for path, shape in want.items():
        dtype, got = leaves[path]
        if dtype != dtypes[path]:
            raise TypeError(f"{path}: dtype {dtype}, expected "
                            f"{dtypes[path]}")
        if tuple(got) != shape:
            raise ValueError(f"{path}: shape {tuple(got)}, expected {shape}")


def train_state_from_numpy(state, cfg: ArchConfig, device=None):
    """The reference's LM ``TrainState`` (a NamedTuple or mapping of
    ``params``, ``opt_state``, ``step``, numpy leaves; ``opt_state`` Adam's
    or AdamW's ``{"step", "mu", "nu"}``) -> the port's
    ``repro_torch.train.TrainState`` on ``device``. The params and both
    moments are checked as ``lm_params_from_numpy`` checks params (the
    moments have the params' dtypes); both steps are 0-d int32."""
    from repro_torch.train.steps import TrainState

    device = resolve_device(device)
    st = _fields(state, TrainState._fields, "TrainState")
    opt = _fields(st["opt_state"], ("step", "mu", "nu"), "opt_state")
    _array("step", st["step"], np.int32, ())
    _array("opt_state/step", opt["step"], np.int32, ())

    def step(x):
        return torch.tensor(np.asarray(x), device=device)

    return TrainState(
        params=lm_params_from_numpy(st["params"], cfg, device),
        opt_state={"step": step(opt["step"]),
                   "mu": lm_params_from_numpy(opt["mu"], cfg, device),
                   "nu": lm_params_from_numpy(opt["nu"], cfg, device)},
        step=step(st["step"]))


def vgg_params_from_numpy(tree: dict, device=None, *,
                          width_mult: float = 1.0,
                          n_classes: int = 10) -> dict:
    """A numpy ``VGG16EE`` param tree (the reference's ``VGG16EE.init`` at
    ``width_mult``, float32) -> the port's on ``device`` (the card unless
    ``"cpu"``); names, dtypes and shapes checked against
    ``VGG16EE.param_shapes``."""
    from repro_torch.vgg.model import VGG16EE

    want = VGG16EE.param_shapes(n_classes=n_classes, width_mult=width_mult)
    return _tree_from_numpy(tree, want, resolve_device(device), "")


def lm_params_numpy(cfg: ArchConfig, seed: int) -> dict:
    """Random float32 LM params drawn with numpy from ``seed``, leaf by
    leaf in the order of ``model_for(cfg).param_shapes(cfg)``: weights
    Xavier-uniform per [in, out] matrix, norm scales 1 + N(0, 0.1),
    RWKV-6's decay base ``w0`` and Mamba-2's ``a_log`` uniform in [-6, 0]
    (decays per step from ~0.9975 to ~0.37 for RWKV-6, exp(-dt e^a_log)
    for Mamba-2, so the state carries across chunks), MoE experts
    ``w1``/``w2``/``w3`` normal with std 1/sqrt(in) and Mamba-2's
    ``conv_w`` with std 0.5, as the reference scales them, every other leaf (biases, embedding, RWKV
    mixes, LoRAs, bonus, MLA's up-projections, ``dt_bias``) N(0, 0.02).
    Both frameworks can rebuild them from the seed alone
    (``tools/make_torch_lm_golden.py``, ``chip_smoke.py``); biases and
    scales are nonzero and not one, so a test sees them."""
    rng = np.random.default_rng(seed)
    flat = {}
    shapes = model_for(cfg).param_shapes(cfg)
    for path, shape in flatten_dict(shapes).items():
        leaf = path.rsplit("/", 1)[1]
        if leaf == "w":
            limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
            x = rng.uniform(-limit, limit, size=shape)
        elif leaf == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf in ("w0", "a_log"):
            x = rng.uniform(-6.0, 0.0, size=shape)
        elif leaf in ("w1", "w2", "w3"):
            x = rng.standard_normal(shape) / math.sqrt(shape[-2])
        elif leaf == "conv_w":
            x = 0.5 * rng.standard_normal(shape)
        else:
            x = 0.02 * rng.standard_normal(shape)
        flat[path] = x.astype(np.float32)
    return unflatten_dict(flat)


def vgg_params_numpy(width_mult: float, seed: int, *,
                     n_classes: int = 10) -> dict:
    """Random float32 ``VGG16EE`` params drawn with numpy from ``seed``,
    leaf by leaf in ``VGG16EE.param_shapes`` order: conv kernels
    He-normal (std sqrt(2 / fan_in)), classifiers Xavier-uniform, biases
    N(0, 0.02) (nonzero, so that a test sees them). Both frameworks can
    rebuild them from the seed alone (``tools/make_torch_train_golden.py``,
    ``chip_smoke.py``)."""
    from repro_torch.vgg.model import VGG16EE

    rng = np.random.default_rng(seed)
    flat = {}
    shapes = VGG16EE.param_shapes(n_classes=n_classes, width_mult=width_mult)
    for path, shape in flatten_dict(shapes).items():
        if len(shape) == 4:
            x = rng.standard_normal(shape) * math.sqrt(
                2.0 / (shape[0] * shape[1] * shape[2]))
        elif len(shape) == 2:
            limit = math.sqrt(6.0 / (shape[0] + shape[1]))
            x = rng.uniform(-limit, limit, size=shape)
        else:
            x = 0.02 * rng.standard_normal(shape)
        flat[path] = x.astype(np.float32)
    return unflatten_dict(flat)
