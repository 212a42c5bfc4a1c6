"""Agent API: ``AgentDef`` (static spec) / ``AgentState`` (mutable state).

Counterpart of ``repro/core/policy.py``. One ``AgentDef`` family covers
the paper's four methods (§VI-C): GRLE = gcn + early exit, GRL = gcn
without, DROOE = mlp + early exit, DROO = mlp without. One slot is
Algorithm 1's fused iteration (``AgentDef.step``): the actor proposes a
relaxed x̂ over (device, option) edges, the order-preserving quantizer
turns it into candidates, K random-valid exploration candidates join
them, the Eq-15 critic scores every candidate with the FCFS simulator
and the best one is kept; the (graph, decision) pair enters the replay
ring, and every ``train_every`` slots, once the ring holds a full
minibatch, the actor takes one Eq-16 BCE + Adam step on a replay
minibatch (§VI-A). The decision path runs under ``torch.no_grad()``; the
loss differentiates through the hand-written GCN kernels
(``kernels.ops``) or, for DROO's MLP actor, plain PyTorch (the reference
has no kernel there either).

The reference's ``AgentState.key`` has no counterpart: every draw comes
from a ``torch.Generator`` the caller passes (or from injected draws,
``rand_cands=`` and ``take=``), since torch cannot reproduce threefry.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import gcn
from repro_torch.core.devreplay import (DeviceReplay, replay_add,
                                        replay_init, replay_sample)
from repro_torch.core.graph import MECGraph, build_graph
from repro_torch.core.quantize import max_candidates, one_hot_candidates
from repro_torch.device import resolve_device
from repro_torch.mec.config import ScenarioParams
from repro_torch.mec.env import MECEnv, MECState, SlotTasks
from repro_torch.nn import MLP, Linear
from repro_torch.nn.pytree import flatten_dict, unflatten_dict
from repro_torch.optim import adam, apply_updates, scale_updates

# device features: 6 observed + the device-id feature; option features: 4
DEV_DIM, OPT_DIM = 7, 4


# --------------------------------------------------------------------- actors
class MLPActor:
    """DROO's DNN actor: flat channel-state features -> edge scores.

    Per the paper (§VI-C), DROO(E) sees only wireless channel state and
    task info — no queue backlogs, no ES capacity — which is exactly its
    stated weakness vs the GCN. Params ``{"trunk": MLP, "head": Linear}``;
    the trunk is M*(N+2) -> hidden -> hidden, the head hidden -> M*O.
    """

    @staticmethod
    def param_shapes(n_devices: int, n_servers: int, n_options: int,
                     hidden: int = 256) -> dict:
        """The reference's names and ``[in, out]`` shapes."""
        in_dim, out_dim = n_devices * (n_servers + 2), n_devices * n_options
        return {
            "trunk": {"fc1": {"w": (in_dim, hidden), "b": (hidden,)},
                      "fc2": {"w": (hidden, hidden), "b": (hidden,)}},
            "head": {"w": (hidden, out_dim), "b": (out_dim,)},
        }

    @staticmethod
    def init(generator: torch.Generator, n_devices: int, n_servers: int,
             n_options: int, *, device, hidden: int = 256) -> dict:
        in_dim = n_devices * (n_servers + 2)
        return {
            "trunk": MLP.init(generator, in_dim, hidden, hidden,
                              device=device),
            "head": Linear.init(generator, hidden, n_devices * n_options,
                                device=device),
        }

    @staticmethod
    def features(g: MECGraph, n_exits: int) -> torch.Tensor:
        """Flat per-graph features [..., M*(N+2)]: each link's rate (the
        adjacency at each server's first option, which ``build_graph``
        expanded over its exits) beside the task's size and deadline."""
        rates = g.adj[..., :, ::n_exits]
        task = g.device_feat[..., :, :2]             # size, deadline
        batch = g.adj.shape[:-2]
        return torch.cat([rates, task], dim=-1).reshape(batch + (-1,))

    @staticmethod
    def apply(params, g: MECGraph, n_exits: int):
        x = MLPActor.features(g, n_exits)
        h = torch.relu(MLP.apply(params["trunk"], x))
        m, o = g.adj.shape[-2:]
        batch = g.adj.shape[:-2]
        logits = Linear.apply(params["head"], h).reshape(batch + (m, o))
        logits = torch.where(g.mask > 0.5, logits, -1e9)
        return torch.sigmoid(logits), logits


# ------------------------------------------------------------------ methods
# Method name -> (actor family, early-exit flag). The four rows of §VI-C.
METHOD_SPECS = {
    "grle": dict(actor="gcn", early_exit=True),
    "grl": dict(actor="gcn", early_exit=False),
    "drooe": dict(actor="mlp", early_exit=True),
    "droo": dict(actor="mlp", early_exit=False),
}


def actor_family(method: str) -> str:
    """'gcn' or 'mlp' — methods in one family share a param tree."""
    return METHOD_SPECS[method.lower()]["actor"]


def init_params(actor: str, env: MECEnv, generator: torch.Generator,
                hidden=(128, 64), *, device=None) -> dict:
    """Fresh actor params drawn from ``generator``, on ``device`` (default
    the env's)."""
    device = env.device if device is None else device
    if actor == "gcn":
        return gcn.init(generator, DEV_DIM, OPT_DIM, hidden=hidden,
                        device=device)
    if actor == "mlp":
        return MLPActor.init(generator, env.M, env.N, env.N * env.L,
                             device=device)
    raise ValueError(f"unknown actor {actor!r}")


def make_exit_mask(n_servers: int, n_exits: int, early_exit: bool, *,
                   device) -> torch.Tensor:
    """[N*L] option mask; without early-exit only final exits are allowed."""
    mask = np.ones((n_servers * n_exits,), np.float32)
    if not early_exit:
        mask[:] = 0.0
        mask[n_exits - 1::n_exits] = 1.0
    return torch.tensor(mask, device=device)


class AgentState(NamedTuple):
    """Every mutable piece of Algorithm 1: the reference's fields but its
    RNG key, in its order. ``host_step`` mirrors ``step`` on the host, so
    that the train gate needs no device-to-host copy."""
    params: dict               # actor parameters (gcn or mlp family)
    opt_state: dict            # Adam: {"step": int32, "mu": tree, "nu": tree}
    replay: DeviceReplay       # device-resident (graph, decision) ring
    step: torch.Tensor         # scalar int32: slots absorbed so far
    exit_mask: torch.Tensor    # [N*L] float32 — data, not structure
    last_loss: torch.Tensor    # scalar float32, NaN before the first train
    loss_sum: torch.Tensor     # scalar float32, sum of train losses
    loss_count: torch.Tensor   # scalar int32, train steps taken
    host_step: int = 0         # ``step`` on the host


class StepAux(NamedTuple):
    """Per-slot scalars out of ``AgentDef.step``."""
    q_est: torch.Tensor        # critic value of the chosen decision
    loss: torch.Tensor         # train loss this slot, NaN if not due


@dataclasses.dataclass(frozen=True)
class AgentDef:
    """Static spec of one agent; ``device=None`` means the card and must
    match the env's device."""
    env: MECEnv
    actor: str = "gcn"
    early_exit: bool = True
    hidden: Tuple[int, ...] = (128, 64)
    n_candidates: Optional[int] = None
    # exploration: K random-valid candidates join the critic's set
    n_random: int = 16
    buffer_size: int = 128
    batch_size: int = 64
    train_every: int = 10
    lr: float = 1e-3
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.actor not in ("gcn", "mlp"):
            raise ValueError(f"unknown actor {self.actor!r}")
        device = resolve_device(self.device)
        if device != self.env.device:
            raise ValueError(f"AgentDef on {device} but its env is on "
                             f"{self.env.device}")
        env = self.env
        s_max = max_candidates(env.M, env.N * env.L)
        n_cand = min(self.n_candidates or env.M * env.N * env.L, s_max)
        object.__setattr__(self, "n_candidates", int(n_cand))
        object.__setattr__(self, "hidden", tuple(self.hidden))
        object.__setattr__(self, "device", device)

    @property
    def n_exits(self) -> int:
        return self.env.L

    def exit_mask(self) -> torch.Tensor:
        """[N*L] option mask for this def's ``early_exit`` flag."""
        return make_exit_mask(self.env.N, self.env.L, self.early_exit,
                              device=self.device)

    @property
    def opt(self):
        return adam(self.lr)

    def graph_shapes(self) -> MECGraph:
        """One graph's leaf shapes, as ``build_graph`` makes them."""
        m, o = self.env.M, self.env.N * self.env.L
        return MECGraph((m, DEV_DIM), (o, OPT_DIM), (m, o), (m, o))

    def param_shapes(self) -> dict:
        """The actor's param tree as ``{name: ... {leaf: shape}}``, as
        ``init`` draws it."""
        env = self.env
        if self.actor == "gcn":
            return gcn.param_shapes(DEV_DIM, OPT_DIM, hidden=self.hidden)
        return MLPActor.param_shapes(env.M, env.N, env.N * env.L)

    def empty_replay(self) -> DeviceReplay:
        return replay_init(self.buffer_size, self.graph_shapes(), self.env.M,
                           device=self.device)

    def _scalar(self, value, dtype=torch.float32) -> torch.Tensor:
        return torch.full((), value, dtype=dtype, device=self.device)

    def init(self, generator: torch.Generator) -> AgentState:
        """Fresh agent state; params drawn from ``generator``."""
        return self.init_from(init_params(self.actor, self.env, generator,
                                          hidden=self.hidden,
                                          device=self.device))

    def init_from(self, params: dict,
                  exit_mask: Optional[torch.Tensor] = None) -> AgentState:
        """Fresh agent state around ``params`` (zero Adam moments, an empty
        ring, counters at 0); ``exit_mask`` defaults to this def's."""
        return self.episode_state(AgentState(
            params=params, opt_state=self.opt.init(params), replay=None,
            step=None,
            exit_mask=self.exit_mask() if exit_mask is None else exit_mask,
            last_loss=None, loss_sum=None, loss_count=None))

    def episode_state(self, state: AgentState) -> AgentState:
        """``state`` for a fresh episode: an empty replay ring (sized to
        *this* def's ``buffer_size``), slot counter and loss stats reset;
        params, optimizer state and exit mask carry over. (The reference
        also re-keys the state; here the episode's generator is the
        caller's.)"""
        return state._replace(
            replay=self.empty_replay(), step=self._scalar(0, torch.int32),
            last_loss=self._scalar(torch.nan), loss_sum=self._scalar(0.0),
            loss_count=self._scalar(0, torch.int32), host_step=0)

    # ----------------------------------------------------------- actor pass
    def scores(self, params, g: MECGraph, exit_mask: torch.Tensor):
        """Relaxed decision x̂ and logits over [..., M, N*L] edges;
        disallowed (masked-exit or disconnected) options get -1e9 so the
        quantizer never flips a device onto them."""
        if self.actor == "gcn":
            x_hat, logits = gcn.apply(params, g)
        else:
            x_hat, logits = MLPActor.apply(params, g, self.env.L)
        allowed = (exit_mask > 0.5) & (g.mask > 0.5)
        x_hat = torch.where(allowed, x_hat, -1e9)
        logits = torch.where(allowed, logits, -1e9)
        return x_hat, logits

    # ------------------------------------------------------------- decision
    @torch.no_grad()
    def decide_with(self, params, exit_mask: torch.Tensor,
                    mec_state: MECState, tasks: SlotTasks, *,
                    generator: Optional[torch.Generator] = None,
                    rand_cands: Optional[torch.Tensor] = None,
                    sp: Optional[ScenarioParams] = None,
                    explore_gain: Optional[torch.Tensor] = None,
                    gumbel: Optional[torch.Tensor] = None):
        """Fused actor + critic pass for ``batch`` networks (the leading
        axes of ``mec_state``'s leaves); ``sp`` overrides the env's
        scenario knobs in observe and evaluate (None: the env's own).

        The K = ``n_random`` exploration candidates are ``rand_cands``
        (``batch + (K, M)``, injected — the tests feed the reference's
        draws through it) or, without it, a Gumbel-max draw over each
        device's allowed options: uniform, or with ``explore_gain`` (a 0-d
        tensor, the population's per-member knob) over ``x_hat * gain +
        gumbel``, so that larger gains lean toward the actor's own scores
        (gain 0 is the uniform draw bit for bit). The Gumbel noise is
        ``gumbel`` (``batch + (K, M, O)``, injected: with a gain the
        candidates depend on the actor, so only the noise can carry the
        reference's draws) or drawn from ``generator``.
        Returns (decision ``batch + (M,)`` int32, q_best ``batch``, graph).
        """
        env = self.env
        obs = env.observe(mec_state, tasks, sp)
        g = build_graph(obs, env.N, env.L)
        x_hat, _ = self.scores(params, g, exit_mask)
        cands = one_hot_candidates(x_hat, self.n_candidates)  # [..., S, M]
        if self.n_random:
            want = cands.shape[:-2] + (self.n_random, env.M)
            if rand_cands is None:
                rand_cands = self._random_candidates(
                    exit_mask, g, generator, x_hat, explore_gain, gumbel)
            elif gumbel is not None or explore_gain is not None:
                raise ValueError("rand_cands are the candidates themselves; "
                                 "pass gumbel= to inject the noise under an "
                                 "explore_gain")
            elif tuple(rand_cands.shape) != want:
                raise ValueError(f"rand_cands shape {tuple(rand_cands.shape)}"
                                 f", expected {want}")
            cands = torch.cat([cands, rand_cands.to(torch.int32)], dim=-2)
        q = env.evaluate(mec_state, tasks, cands, sp)           # [..., S+K]
        best = torch.argmax(q, dim=-1, keepdim=True)            # first max
        decision = torch.take_along_dim(cands, best[..., None], -2)[..., 0, :]
        return decision, q.gather(-1, best)[..., 0], g

    def _random_candidates(self, exit_mask, g: MECGraph,
                           generator: Optional[torch.Generator],
                           x_hat=None, gain=None, gumbel=None):
        allowed = (exit_mask > 0.5) & (g.mask > 0.5)            # [..., M, O]
        shape = allowed.shape[:-2] + (self.n_random,) + allowed.shape[-2:]
        if gumbel is None:
            if generator is None:
                raise ValueError("decide_with needs a generator or rand_cands "
                                 "(or gumbel) for its exploration "
                                 "candidates")
            gumbel = self.gumbel_noise(generator, tuple(allowed.shape[:-2]))
        elif tuple(gumbel.shape) != shape:
            raise ValueError(f"gumbel shape {tuple(gumbel.shape)}, expected "
                             f"{shape}")
        noise = (gumbel if gain is None
                 else x_hat[..., None, :, :] * gain + gumbel)
        noise = torch.where(allowed[..., None, :, :], noise, -torch.inf)
        return torch.argmax(noise, dim=-1).to(torch.int32)

    def gumbel_noise(self, generator: torch.Generator,
                     batch: Tuple[int, ...]) -> torch.Tensor:
        """The exploration draw's Gumbel noise [*batch, K, M, N*L] from
        ``generator``, as ``decide_with`` draws it itself (drawn for every
        fleet and sliced, it is what a slice of the fleets draws)."""
        env = self.env
        u = torch.rand(batch + (self.n_random, env.M, env.N * env.L),
                       generator=generator, device=self.device)
        tiny = torch.finfo(u.dtype).tiny
        return -torch.log(-torch.log(u.clamp_min(tiny)))

    def decide(self, state: AgentState, mec_state: MECState,
               tasks: SlotTasks, *, generator=None, rand_cands=None,
               sp: Optional[ScenarioParams] = None, explore_gain=None,
               gumbel=None):
        """One slot's decision from the agent's own params and exit mask."""
        return self.decide_with(state.params, state.exit_mask, mec_state,
                                tasks, generator=generator,
                                rand_cands=rand_cands, sp=sp,
                                explore_gain=explore_gain, gumbel=gumbel)


    # ----------------------------------------------------------------- loss
    def loss(self, params, graphs: MECGraph, decisions: torch.Tensor,
             exit_mask: torch.Tensor) -> torch.Tensor:
        """Averaged masked BCE over edges (Eq 16), one batched pass over
        the minibatch on the graphs' leading axis. With the one-hot target
        the BCE splits into softplus over every valid edge minus the logit
        at each device's decision edge: per_edge = softplus(l) - l *
        target, softplus(l) = max(l, 0) + log1p(exp(-|l|))."""
        _, logits = self.scores(params, graphs, exit_mask)      # [B, M, O]
        valid = graphs.mask * exit_mask                         # [B, M, O]
        # masked (-1e9) edges contribute exactly 0 and are zeroed by
        # ``valid`` regardless
        softplus = torch.maximum(logits, logits.new_zeros(())) \
            + torch.log1p(torch.exp(-torch.abs(logits)))
        pos = torch.sum(softplus * valid, dim=(-2, -1))         # [B]
        dec = decisions[..., None].to(torch.int64)
        l_at = torch.take_along_dim(logits, dec, dim=-1)[..., 0]
        v_at = torch.take_along_dim(valid, dec, dim=-1)[..., 0]
        neg = torch.sum(l_at * v_at, dim=-1)                    # [B]
        denom = torch.clamp_min(valid.sum(dim=(-2, -1)), 1.0)
        return torch.mean((pos - neg) / denom)

    # ------------------------------------------------------------- training
    def train_step(self, state: AgentState, lr=None, *,
                   generator: Optional[torch.Generator] = None,
                   take: Optional[torch.Tensor] = None):
        """One Eq-16 minibatch update. The minibatch is the replay rows
        ``take`` [batch_size] (injected: the reference's draws) or drawn
        from ``generator``. Unconditional: callers gate on ``train_due``.
        ``lr`` overrides the def's learning rate by rescaling the updates
        by ``lr / self.lr``, which is exact: Adam's update is linear in lr
        and its moments do not depend on it. Returns (new state, loss)."""
        graphs, decisions = replay_sample(state.replay, self.batch_size,
                                          generator=generator, take=take)
        flat = flatten_dict(state.params)
        leaves = [p.detach().requires_grad_() for p in flat.values()]
        with torch.enable_grad():
            loss = self.loss(unflatten_dict(dict(zip(flat, leaves))),
                             graphs, decisions, state.exit_mask)
            grads = torch.autograd.grad(loss, leaves)
        updates, opt_state = self.opt.update(
            unflatten_dict(dict(zip(flat, grads))), state.opt_state)
        if lr is not None:
            updates = scale_updates(updates, lr / self.lr)
        loss = loss.detach().to(torch.float32)
        new = state._replace(
            params=apply_updates(state.params, updates),
            opt_state=opt_state, last_loss=loss,
            loss_sum=state.loss_sum + loss,
            loss_count=state.loss_count + 1)
        return new, loss

    def train_due(self, state: AgentState, n_new: int) -> bool:
        """Whether ``absorb`` of ``n_new`` entries into ``state`` trains:
        every ``train_every`` slots, and only once the ring holds a full
        minibatch (the reference's one rule). Read on the host."""
        size = min(state.replay.host_size + n_new, self.buffer_size)
        return ((state.host_step + 1) % self.train_every == 0
                and size >= self.batch_size)

    def absorb(self, state: AgentState, graphs: MECGraph,
               decisions: torch.Tensor, lr=None, *,
               generator: Optional[torch.Generator] = None,
               take: Optional[torch.Tensor] = None):
        """Record one slot's B (graph, decision) pairs (leaves lead with
        [B]), then train if ``train_due``, on ``take`` or a draw from
        ``generator``. Returns (new state, loss — NaN when no train step
        ran)."""
        due = self.train_due(state, decisions.shape[0])
        state = state._replace(
            replay=replay_add(state.replay, graphs, decisions),
            step=state.step + 1, host_step=state.host_step + 1)
        if due:
            return self.train_step(state, lr, generator=generator, take=take)
        return state, self._scalar(torch.nan)

    # ----------------------------------------------------------- slot body
    def step(self, state: AgentState, mec_state: MECState, tasks: SlotTasks,
             *, generator: Optional[torch.Generator] = None,
             rand_cands: Optional[torch.Tensor] = None,
             take: Optional[torch.Tensor] = None,
             sp: Optional[ScenarioParams] = None):
        """The fused Algorithm-1 slot body for one network (unbatched
        ``mec_state``): decide, add to the replay ring, maybe train. The
        draws come from ``generator`` unless injected (``rand_cands`` [K,
        M], ``take`` [batch_size]); ``sp`` as in ``decide_with``. The
        environment transition stays with the caller. Returns (new state,
        decision [M], StepAux)."""
        decision, q_best, g = self.decide(state, mec_state, tasks,
                                          generator=generator,
                                          rand_cands=rand_cands, sp=sp)
        g1 = MECGraph(*(x[None] for x in g))
        state, loss = self.absorb(state, g1, decision[None],
                                  generator=generator, take=take)
        return state, decision, StepAux(q_est=q_best, loss=loss)


def agent_def(method: str, env: MECEnv, *, device=None, **kw) -> AgentDef:
    """Factory for the paper's four methods by name."""
    spec = dict(METHOD_SPECS[method.lower()])
    spec.update(kw)
    return AgentDef(env=env, device=device, **spec)
