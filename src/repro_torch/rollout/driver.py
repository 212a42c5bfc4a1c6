"""Episode driver: Algorithm 1's decision path for B fleets, slot by slot.

Counterpart of ``repro/rollout/driver.py`` in its ``mode="loop"`` form,
evaluation only (``train=False``). Each slot, for all B fleets at once:
draw the tasks, observe and build the graph, run the GCN actor (4
``gcn_agg`` launches + 1 ``edge_score`` launch for the whole fleet
batch), quantize, score every candidate with the Eq-15 critic, realize
the best one with ``env.step`` and fold the metrics. Nothing in the loop
waits on the device; the trace is stacked at the end.

Phases are wrapped in ``torch.profiler.record_function`` (``sample``,
``actor``, ``env_step``) as the reference wraps them in ``phase()``.
Capturing the slot body as a CUDA graph (the analogue of
``mode="scan"``) and training (``train=True``) come in later slices.
"""
from __future__ import annotations

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
    loss: torch.Tensor        # [T], NaN: no train step in this slice


class RolloutDriver:
    """Drives B fleets of one agent for T slots (decision path)."""

    def __init__(self, adef: AgentDef, n_fleets: int = 1, *,
                 train: bool = False, device=None):
        if train:
            raise NotImplementedError(
                "RolloutDriver(train=True) comes with the training slice "
                "(replay, Eq-16 loss, Adam and the kernels' backwards)")
        self.device = resolve_device(device)
        if self.device != adef.device:
            raise ValueError(f"RolloutDriver on {self.device} but its agent "
                             f"is on {adef.device}")
        self.adef = adef
        self.env = adef.env
        self.vec = VecMECEnv(self.env, n_fleets)
        self.workload = make_workload(self.env)
        self.n_fleets = n_fleets

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

        The tasks and exploration candidates come from the generator (an
        int seeds a new one on the driver's device) unless ``draws``
        injects them. ``agent_state`` defaults to a fresh ``adef.init``
        from the same generator.
        """
        gen = self._generator(seed_or_generator)
        if agent_state is None:
            agent_state = self.adef.init(gen)
        if draws is not None:
            want = (n_slots, self.n_fleets)
            if tuple(draws.rand_cands.shape[:2]) != want or any(
                    tuple(x.shape[:2]) != want for x in draws.tasks):
                raise ValueError(f"draws must lead with [T, B] = {want}")
        carry = RolloutCarry(self.vec.reset(), agent_state,
                             metrics_init(self.device))
        no_loss = torch.full((), torch.nan, device=self.device)
        outs = []
        for t in range(n_slots):
            carry, out = self._slot(carry, gen, draws, t, no_loss)
            outs.append(out)
        trace = RolloutTrace(*(torch.stack(xs) for xs in zip(*outs)))
        return carry, trace

    def _slot(self, carry: RolloutCarry, gen, draws, t, no_loss):
        with record_function("sample"):
            if draws is None:
                tasks, rand = self.workload.sample(gen, self.n_fleets), None
            else:
                tasks = SlotTasks(*(x[t] for x in draws.tasks))
                rand = draws.rand_cands[t]
        with record_function("actor"):
            decision, q_best, _ = self.adef.decide(
                carry.agent_state, carry.env_state, tasks, generator=gen,
                rand_cands=rand)
        with record_function("env_step"):
            env_state, result = self.env.step(carry.env_state, tasks,
                                              decision)
        active = tasks.active.to(torch.float32)
        metrics = metrics_update(carry.metrics, reward=result.reward,
                                 success=result.success,
                                 accuracy=result.accuracy, active=active,
                                 loss=no_loss)
        out = RolloutTrace(decision.to(torch.int32), result.reward,
                           result.success, result.accuracy, active,
                           q_best, no_loss)
        return RolloutCarry(env_state, carry.agent_state, metrics), out

    def metrics(self, carry: RolloutCarry) -> dict:
        """Host-side §VI-D summary of the carry's running metrics."""
        out = metrics_finalize(carry.metrics, slot_s=self.env.cfg.slot_s,
                               n_fleets=self.n_fleets)
        return {k: float(v) for k, v in out.items()}
