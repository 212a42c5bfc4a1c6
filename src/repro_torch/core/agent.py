"""Deprecated stateful agent shim over ``repro_torch.core.policy``.

Counterpart of ``repro/core/agent.py``. ``OffloadingAgent`` predates the
functional agent API (``AgentDef`` + ``AgentState``); it remains as a thin
wrapper whose every call delegates to the ``AgentDef`` methods the
rollout and serving layers use. New code should do::

    from repro_torch.core import agent_def
    adef = agent_def("grle", env)      # or "grl"/"drooe"/"droo"
    state = adef.init(generator)
    state, decision, aux = adef.step(state, mec_state, tasks,
                                     generator=generator)

The reference's agent carries its RNG key in its state; this one owns a
``torch.Generator`` (the one it was built with, or one seeded from an
int) for its parameter init and every later draw.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional, Union

import torch

from repro_torch.core.policy import (  # noqa: F401  (compat re-exports)
    METHOD_SPECS,
    AgentDef,
    AgentState,
    MLPActor,
    actor_family,
    agent_def,
    init_params,
    make_exit_mask,
)
from repro_torch.mec.env import MECEnv, MECState, SlotTasks


class OffloadingAgent:
    """Mutable facade over an ``AgentDef`` + ``AgentState`` pair, on its
    env's device. Construction emits a ``DeprecationWarning``; behaviour
    tracks the functional API exactly (one full-minibatch train gate)."""

    def __init__(self, env: MECEnv,
                 generator: Union[int, torch.Generator], *,
                 actor: str = "gcn", early_exit: bool = True,
                 hidden=(128, 64), buffer_size: int = 128,
                 batch_size: int = 64, train_every: int = 10,
                 lr: float = 1e-3, n_candidates: Optional[int] = None,
                 seed: int = 0, use_kernel: bool = False):
        warnings.warn(
            "OffloadingAgent is deprecated; use repro_torch.core.AgentDef / "
            "AgentState (see repro_torch.core.policy) instead",
            DeprecationWarning, stacklevel=2)
        del seed, use_kernel          # legacy knobs; draws come from generator
        self.adef = AgentDef(env=env, actor=actor, early_exit=early_exit,
                             hidden=tuple(hidden), n_candidates=n_candidates,
                             buffer_size=buffer_size, batch_size=batch_size,
                             train_every=train_every, lr=lr,
                             device=env.device)
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=env.device).manual_seed(
                int(generator))
        self.generator = generator
        self.state: AgentState = self.adef.init(generator)
        self.loss_history: list[float] = []

    # ------------------------------------------------------- legacy surface
    @property
    def env(self) -> MECEnv:
        return self.adef.env

    @property
    def actor_type(self) -> str:
        return self.adef.actor

    @property
    def early_exit(self) -> bool:
        return self.adef.early_exit

    @property
    def batch_size(self) -> int:
        return self.adef.batch_size

    @property
    def train_every(self) -> int:
        return self.adef.train_every

    @property
    def n_exits(self) -> int:
        return self.adef.n_exits

    @property
    def n_candidates(self) -> int:
        return self.adef.n_candidates

    @property
    def n_random(self) -> int:
        return self.adef.n_random

    @property
    def params(self):
        return self.state.params

    @params.setter
    def params(self, value) -> None:
        self.state = self.state._replace(params=value)

    @property
    def opt_state(self):
        return self.state.opt_state

    @opt_state.setter
    def opt_state(self, value) -> None:
        self.state = self.state._replace(opt_state=value)

    # --------------------------------------------------------------- acting
    def act(self, state: MECState, tasks: SlotTasks, *, train: bool = True,
            sp=None, rand_cands=None, take=None):
        """Algorithm 1, one slot. Returns (decision [M], info dict). The
        exploration candidates (``rand_cands`` [K, M]) and, on a train
        step, the minibatch's replay rows (``take`` [batch_size]) are drawn
        from the agent's generator unless injected (the reference's
        draws)."""
        if train:
            self.state, decision, aux = self.adef.step(
                self.state, state, tasks, generator=self.generator, sp=sp,
                rand_cands=rand_cands, take=take)
            info = {"q_est": float(aux.q_est),
                    "n_candidates": self.adef.n_candidates}
            loss = float(aux.loss)
            if not math.isnan(loss):
                info["loss"] = loss
                self.loss_history.append(loss)
            return decision, info
        decision, q_best, _ = self.adef.decide(
            self.state, state, tasks, generator=self.generator, sp=sp,
            rand_cands=rand_cands)
        return decision, {"q_est": float(q_best),
                          "n_candidates": self.adef.n_candidates}

    # ------------------------------------------------------------- training
    def train_minibatch(self) -> float:
        if self.state.replay.host_size < 1:
            raise ValueError("replay buffer is empty — nothing to train on")
        self.state, loss = self.adef.train_step(self.state,
                                                generator=self.generator)
        loss = float(loss)
        self.loss_history.append(loss)
        return loss


def make_agent(method: str, env: MECEnv,
               generator: Union[int, torch.Generator],
               **kw) -> OffloadingAgent:
    """Deprecated factory for the four methods; prefer ``agent_def``."""
    spec = dict(METHOD_SPECS[method.lower()])
    spec.update(kw)
    return OffloadingAgent(env, generator, **spec)
