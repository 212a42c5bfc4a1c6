"""Episode driver: Algorithm 1 for B fleets, slot by slot.

Counterpart of ``repro/rollout/driver.py`` in its ``mode="loop"`` form.
Each slot, for all B fleets at once: draw the tasks, observe and build
the graph, run the GCN actor (4 ``gcn_agg`` launches + 1 ``edge_score``
launch for the whole fleet batch), quantize, score every candidate with
the Eq-15 critic, realize the best one with ``env.step`` and fold the
metrics. With ``train=True`` (the reference's default) one shared learner
then absorbs the B fleets' (graph, decision) pairs in fleet order, and
every ``train_every`` slots, once the ring holds a full minibatch, takes
one Eq-16 + Adam step, whose forward runs the same kernels on the
minibatch (4 + 1 more launches). The train gate is read on the host
(``AgentDef.train_due``); nothing in the loop waits on the device, and
the trace is stacked at the end.

Phases are wrapped in ``torch.profiler.record_function`` (``sample``,
``actor``, ``env_step``, ``train``) as the reference wraps them in
``phase()``. Capturing the slot body as a CUDA graph (the analogue of
``mode="scan"``) comes in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch
from torch.profiler import record_function

from repro_torch.core.policy import AgentDef, AgentState
from repro_torch.device import resolve_device
from repro_torch.mec.env import MECState, SlotTasks
from repro_torch.rollout.metrics import (CellMetrics, metrics_finalize,
                                         metrics_init, metrics_update)
from repro_torch.rollout.vecenv import VecMECEnv
from repro_torch.rollout.workloads import make_workload


class SlotDraws(NamedTuple):
    """Injected random draws for a whole episode (tests, golden replay)."""
    tasks: SlotTasks            # leaves [T, B, ...]
    rand_cands: torch.Tensor    # [T, B, K, M] exploration candidates
    # [n_train, batch_size] replay rows of each train step, in order
    replay_take: Optional[torch.Tensor] = None


class RolloutCarry(NamedTuple):
    """What persists across slots."""
    env_state: MECState        # [B, ...]
    agent_state: AgentState
    metrics: CellMetrics


class RolloutTrace(NamedTuple):
    """Per-slot outputs stacked over time (leading [T] axis)."""
    decisions: torch.Tensor   # [T, B, M] int32
    reward: torch.Tensor      # [T, B]
    success: torch.Tensor     # [T, B, M] bool
    accuracy: torch.Tensor    # [T, B, M]
    active: torch.Tensor      # [T, B, M]
    q_est: torch.Tensor       # [T, B]
    loss: torch.Tensor        # [T], NaN on slots without a train step


class RolloutDriver:
    """Drives B fleets of one agent for T slots; ``train=False`` runs the
    decision path alone. ``replay_capacity``, ``batch_size`` and
    ``train_every`` override the def's for this driver, as in the
    reference."""

    def __init__(self, adef: AgentDef, n_fleets: int = 1, *,
                 train: bool = True, replay_capacity: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 train_every: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        if self.device != adef.device:
            raise ValueError(f"RolloutDriver on {self.device} but its agent "
                             f"is on {adef.device}")
        overrides = {k: v for k, v in (("buffer_size", replay_capacity),
                                       ("batch_size", batch_size),
                                       ("train_every", train_every))
                     if v is not None}
        self.adef = (dataclasses.replace(adef, **overrides) if overrides
                     else adef)
        self.env = self.adef.env
        self.vec = VecMECEnv(self.env, n_fleets)
        self.workload = make_workload(self.env)
        self.n_fleets = n_fleets
        self.train = train
        self.batch_size = self.adef.batch_size
        self.train_every = self.adef.train_every
        self.replay_capacity = self.adef.buffer_size
        if train and self.replay_capacity < self.batch_size:
            raise ValueError("replay capacity smaller than minibatch: "
                             "training would never trigger")
        if train and self.replay_capacity < n_fleets:
            raise ValueError(
                f"replay capacity {self.replay_capacity} cannot hold one "
                f"slot's {n_fleets} fleet transitions")

    def _generator(self, seed_or_generator: Union[int, torch.Generator]
                  ) -> torch.Generator:
        if isinstance(seed_or_generator, torch.Generator):
            if seed_or_generator.device.type != self.device.type:
                raise ValueError(f"generator on {seed_or_generator.device}, "
                                 f"driver on {self.device}")
            return seed_or_generator
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed_or_generator))
        return gen

    def run(self, seed_or_generator: Union[int, torch.Generator],
            n_slots: int, *, agent_state: Optional[AgentState] = None,
            draws: Optional[SlotDraws] = None):
        """Roll B fleets for ``n_slots``; returns (final carry, trace).

        The tasks, exploration candidates and replay minibatches come from
        the generator (an int seeds a new one on the driver's device)
        unless ``draws`` injects them. ``agent_state`` defaults to a fresh
        ``adef.init`` from the same generator; whatever state comes in
        starts the episode through ``adef.episode_state`` (empty ring, slot
        counter and loss stats reset; params and optimizer carry over).
        """
        gen = self._generator(seed_or_generator)
        if agent_state is None:
            agent_state = self.adef.init(gen)
        agent_state = self.adef.episode_state(agent_state)
        if draws is not None:
            want = (n_slots, self.n_fleets)
            if tuple(draws.rand_cands.shape[:2]) != want or any(
                    tuple(x.shape[:2]) != want for x in draws.tasks):
                raise ValueError(f"draws must lead with [T, B] = {want}")
        carry = RolloutCarry(self.vec.reset(), agent_state,
                             metrics_init(self.device))
        no_loss = torch.full((), torch.nan, device=self.device)
        outs, n_train = [], 0
        for t in range(n_slots):
            take = None
            if (self.train and draws is not None
                    and draws.replay_take is not None
                    and self.adef.train_due(carry.agent_state,
                                            self.n_fleets)):
                take = draws.replay_take[n_train]
                n_train += 1
            carry, out = self._slot(carry, gen, draws, t, no_loss, take)
            outs.append(out)
        trace = RolloutTrace(*(torch.stack(xs) for xs in zip(*outs)))
        return carry, trace

    def _slot(self, carry: RolloutCarry, gen, draws, t, no_loss, take):
        with record_function("sample"):
            if draws is None:
                tasks, rand = self.workload.sample(gen, self.n_fleets), None
            else:
                tasks = SlotTasks(*(x[t] for x in draws.tasks))
                rand = draws.rand_cands[t]
        agent = carry.agent_state
        with record_function("actor"):
            decision, q_best, graphs = self.adef.decide(
                agent, carry.env_state, tasks, generator=gen,
                rand_cands=rand)
        with record_function("env_step"):
            env_state, result = self.env.step(carry.env_state, tasks,
                                              decision)
        loss = no_loss
        if self.train:
            with record_function("train"):
                agent, loss = self.adef.absorb(agent, graphs, decision,
                                               generator=gen, take=take)
        active = tasks.active.to(torch.float32)
        metrics = metrics_update(carry.metrics, reward=result.reward,
                                 success=result.success,
                                 accuracy=result.accuracy, active=active,
                                 loss=loss)
        out = RolloutTrace(decision.to(torch.int32), result.reward,
                           result.success, result.accuracy, active,
                           q_best, loss)
        return RolloutCarry(env_state, agent, metrics), out

    def metrics(self, carry: RolloutCarry) -> dict:
        """Host-side §VI-D summary of the carry's running metrics."""
        out = metrics_finalize(carry.metrics, slot_s=self.env.cfg.slot_s,
                               n_fleets=self.n_fleets)
        return {k: float(v) for k, v in out.items()}
