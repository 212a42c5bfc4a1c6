"""Agent API, decision half: ``AgentDef`` (static spec) / ``AgentState``.

Counterpart of ``repro/core/policy.py`` for the GCN actor's decision path
(GRLE = gcn + early exit, GRL = gcn without). One slot's decision is the
fused actor + critic pass of Algorithm 1: the GCN proposes a relaxed x̂
over (device, option) edges, the order-preserving quantizer turns it
into candidates, K random-valid exploration candidates join them, the
Eq-15 critic scores every candidate with the FCFS simulator and the best
one is kept.

Not ported yet: the MLP actor (DROO/DROOE), and the training half
(replay, Eq-16 loss, Adam) which comes with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import gcn
from repro_torch.core.graph import MECGraph, build_graph
from repro_torch.core.quantize import max_candidates, one_hot_candidates
from repro_torch.device import resolve_device
from repro_torch.mec.env import MECEnv, MECState, SlotTasks

# Method name -> (actor family, early-exit flag). The four rows of §VI-C.
METHOD_SPECS = {
    "grle": dict(actor="gcn", early_exit=True),
    "grl": dict(actor="gcn", early_exit=False),
    "drooe": dict(actor="mlp", early_exit=True),
    "droo": dict(actor="mlp", early_exit=False),
}

# device features: 6 observed + the device-id feature; option features: 4
DEV_DIM, OPT_DIM = 7, 4


def make_exit_mask(n_servers: int, n_exits: int, early_exit: bool, *,
                   device) -> torch.Tensor:
    """[N*L] option mask; without early-exit only final exits are allowed."""
    mask = np.ones((n_servers * n_exits,), np.float32)
    if not early_exit:
        mask[:] = 0.0
        mask[n_exits - 1::n_exits] = 1.0
    return torch.tensor(mask, device=device)


class AgentState(NamedTuple):
    """The mutable pieces the decision path reads. Optimizer, replay and
    loss fields come with the training slice."""
    params: dict               # GCN actor parameters
    exit_mask: torch.Tensor    # [N*L] float32 — data, not structure
    step: torch.Tensor         # scalar int32: slots absorbed so far


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
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.actor == "mlp":
            raise NotImplementedError(
                "the MLP actor (DROO/DROOE) is not ported to repro_torch yet")
        if self.actor != "gcn":
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

    def exit_mask(self) -> torch.Tensor:
        """[N*L] option mask for this def's ``early_exit`` flag."""
        return make_exit_mask(self.env.N, self.env.L, self.early_exit,
                              device=self.device)

    def init(self, generator: torch.Generator) -> AgentState:
        """Fresh agent state; params drawn from ``generator``."""
        params = gcn.init(generator, DEV_DIM, OPT_DIM, hidden=self.hidden,
                          device=self.device)
        return AgentState(params=params, exit_mask=self.exit_mask(),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=self.device))

    # ----------------------------------------------------------- actor pass
    def scores(self, params, g: MECGraph, exit_mask: torch.Tensor):
        """Relaxed decision x̂ and logits over [..., M, N*L] edges;
        disallowed (masked-exit or disconnected) options get -1e9 so the
        quantizer never flips a device onto them."""
        x_hat, logits = gcn.apply(params, g)
        allowed = (exit_mask > 0.5) & (g.mask > 0.5)
        x_hat = torch.where(allowed, x_hat, -1e9)
        logits = torch.where(allowed, logits, -1e9)
        return x_hat, logits

    # ------------------------------------------------------------- decision
    def decide_with(self, params, exit_mask: torch.Tensor,
                    mec_state: MECState, tasks: SlotTasks, *,
                    generator: Optional[torch.Generator] = None,
                    rand_cands: Optional[torch.Tensor] = None):
        """Fused actor + critic pass for ``batch`` networks (the leading
        axes of ``mec_state``'s leaves).

        The K = ``n_random`` exploration candidates are ``rand_cands``
        (``batch + (K, M)``, injected — the tests feed the reference's
        draws through it) or, without it, uniform over each device's
        allowed options by Gumbel-max on noise from ``generator``.
        Returns (decision ``batch + (M,)`` int32, q_best ``batch``, graph).
        """
        env = self.env
        obs = env.observe(mec_state, tasks)
        g = build_graph(obs, env.N, env.L)
        x_hat, _ = self.scores(params, g, exit_mask)
        cands = one_hot_candidates(x_hat, self.n_candidates)  # [..., S, M]
        if self.n_random:
            want = cands.shape[:-2] + (self.n_random, env.M)
            if rand_cands is None:
                rand_cands = self._random_candidates(exit_mask, g, generator)
            elif tuple(rand_cands.shape) != want:
                raise ValueError(f"rand_cands shape {tuple(rand_cands.shape)}"
                                 f", expected {want}")
            cands = torch.cat([cands, rand_cands.to(torch.int32)], dim=-2)
        q = env.evaluate(mec_state, tasks, cands)               # [..., S+K]
        best = torch.argmax(q, dim=-1, keepdim=True)            # first max
        decision = torch.take_along_dim(cands, best[..., None], -2)[..., 0, :]
        return decision, q.gather(-1, best)[..., 0], g

    def _random_candidates(self, exit_mask, g: MECGraph,
                           generator: Optional[torch.Generator]):
        if generator is None:
            raise ValueError("decide_with needs a generator or rand_cands "
                             "for its exploration candidates")
        allowed = (exit_mask > 0.5) & (g.mask > 0.5)            # [..., M, O]
        shape = allowed.shape[:-2] + (self.n_random,) + allowed.shape[-2:]
        u = torch.rand(shape, generator=generator, device=allowed.device)
        tiny = torch.finfo(u.dtype).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        noise = torch.where(allowed[..., None, :, :], gumbel, -torch.inf)
        return torch.argmax(noise, dim=-1).to(torch.int32)

    def decide(self, state: AgentState, mec_state: MECState,
               tasks: SlotTasks, *, generator=None, rand_cands=None):
        """One slot's decision from the agent's own params and exit mask."""
        return self.decide_with(state.params, state.exit_mask, mec_state,
                                tasks, generator=generator,
                                rand_cands=rand_cands)


def agent_def(method: str, env: MECEnv, *, device=None, **kw) -> AgentDef:
    """Factory for the paper's methods by name (GCN ones: grle, grl)."""
    spec = dict(METHOD_SPECS[method.lower()])
    spec.update(kw)
    return AgentDef(env=env, device=device, **spec)
