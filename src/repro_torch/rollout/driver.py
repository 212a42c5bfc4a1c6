"""Episode driver: Algorithm 1 for B fleets, slot by slot, or compiled.

Counterpart of ``repro/rollout/driver.py``. Each slot, for all B fleets at
once: draw the tasks, observe and build the graph, run the GCN actor (4
``gcn_agg`` launches + 1 ``edge_score`` launch for the whole fleet batch),
quantize, score every candidate with the Eq-15 critic, realize the best
one with ``env.step`` and fold the metrics (and, with ``telemetry=True``,
the rollout telemetry registry). With ``train=True`` (the reference's
default) one shared learner then absorbs the B fleets' (graph, decision)
pairs in fleet order, and every ``train_every`` slots, once the ring
holds a full minibatch, takes one Eq-16 + Adam step, whose forward runs
the same kernels on the minibatch (4 + 1 more launches). The train gate
is read on the host (``AgentDef.train_due``); nothing in a slot waits on
the device.

Both modes run the same slot body, ``_slot``:

* ``mode="loop"`` calls it from Python slot by slot (hundreds of kernel
  launches a slot, each paid on the host) and stacks the trace at the end;
* ``mode="scan"`` (the default, as in the reference) is the compiled
  episode, the reference's answer to per-slot host dispatch: the carry and
  a [T, ...] trace live in static buffers, and on the card each slot is
  one CUDA-graph launch. There are two graphs, a slot without a train
  step and a slot with one, captured once per driver and episode shape
  into one memory pool; the host picks between them by ``train_due`` on
  its own mirrors of the step count and ring size. A graph runs
  ``_slot`` on the static carry, copies the new carry's tensors back
  into it and writes the slot's trace row at a device slot counter. Draws
  come from the caller's generator, registered with both graphs, or from
  injected [T, B, ...] draws read at that counter (minibatch rows at a
  device train-step counter). Before capture, one eager slot of each kind
  runs on a side stream with CUDA's sync debug mode set to raise, which
  builds the kernels, sets up cuBLAS and fails on any host sync. A failed
  capture raises; scan never falls back to the loop. On the CPU (which the
  caller asks for with ``device="cpu"``) scan runs the same static-buffer
  episode without capture, so it equals the loop bit for bit.

Phases are wrapped in ``torch.profiler.record_function`` (``sample``,
``actor``, ``env_step``, ``train``) as the reference wraps them in
``phase()``; inside a graph they appear once, at capture.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.policy import AgentDef, AgentState
from repro_torch.device import resolve_device
from repro_torch.mec.env import MECState, SlotTasks
from repro_torch.obs.telemetry import (Telemetry, rollout_telemetry,
                                       telemetry_host, telemetry_summary,
                                       telemetry_update)
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
    # the telemetry registry; None when the driver runs without it
    telemetry: Optional[Telemetry] = None

    @property
    def params(self):
        """The learner's params."""
        return self.agent_state.params


class RolloutTrace(NamedTuple):
    """Per-slot outputs stacked over time (leading [T] axis)."""
    decisions: torch.Tensor   # [T, B, M] int32
    reward: torch.Tensor      # [T, B]
    success: torch.Tensor     # [T, B, M] bool
    accuracy: torch.Tensor    # [T, B, M]
    active: torch.Tensor      # [T, B, M]
    q_est: torch.Tensor       # [T, B]
    loss: torch.Tensor        # [T], NaN on slots without a train step


# ------------------------------------------------------------ carry leaves
def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a carry (NamedTuples, dicts), in a fixed order; host
    ints and None are skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _tensors(v)]
    return []


def _refill(tree, leaves):
    """``tree`` with its tensors replaced, in ``_tensors`` order, by the
    items of the iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        return {k: _refill(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_refill(v, leaves) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _with_mirrors(carry: RolloutCarry, host_step: int,
                  host_size: int) -> RolloutCarry:
    """``carry`` whose agent's host mirrors read (step, ring size)."""
    st = carry.agent_state
    return carry._replace(agent_state=st._replace(
        host_step=host_step, replay=st.replay._replace(host_size=host_size)))


def _copy_into(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    """``dst[i].copy_(src[i])`` for every pair that is not one tensor, one
    multi-tensor copy per dtype."""
    groups: dict = {}
    for d, s in zip(dst, src):
        if d is not s:
            pair = groups.setdefault(d.dtype, ([], []))
            pair[0].append(d)
            pair[1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


class RolloutDriver:
    """Drives B fleets of one agent for T slots; ``train=False`` runs the
    decision path alone, ``telemetry=True`` carries the rollout telemetry
    registry. ``replay_capacity``, ``batch_size`` and ``train_every``
    override the def's for this driver, as in the reference."""

    def __init__(self, adef: AgentDef, n_fleets: int = 1, *,
                 train: bool = True, replay_capacity: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 train_every: Optional[int] = None,
                 telemetry: bool = False, device=None):
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
        self.telemetry = telemetry
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
        self._seeded: Optional[torch.Generator] = None
        self._episode: Optional[_ScanEpisode] = None

    def _generator(self, seed_or_generator: Union[int, torch.Generator]
                  ) -> torch.Generator:
        """The caller's generator, or for an int the driver's own one
        seeded with it (one object, so the compiled episode keeps its
        graphs from run to run)."""
        if isinstance(seed_or_generator, torch.Generator):
            if seed_or_generator.device.type != self.device.type:
                raise ValueError(f"generator on {seed_or_generator.device}, "
                                 f"driver on {self.device}")
            return seed_or_generator
        if self._seeded is None:
            self._seeded = torch.Generator(device=self.device)
        return self._seeded.manual_seed(int(seed_or_generator))

    # ------------------------------------------------------------------ carry
    def init_carry(self, seed_or_generator: Union[int, torch.Generator], *,
                   agent_state: Optional[AgentState] = None) -> RolloutCarry:
        """Fresh episode state. ``agent_state`` defaults to a fresh
        ``adef.init`` from the generator; whatever state comes in starts the
        episode through ``adef.episode_state`` (empty ring, slot counter and
        loss stats reset; params and optimizer carry over)."""
        gen = self._generator(seed_or_generator)
        if agent_state is None:
            agent_state = self.adef.init(gen)
        return RolloutCarry(
            self.vec.reset(), self.adef.episode_state(agent_state),
            metrics_init(self.device),
            rollout_telemetry(self.env.N, self.env.L, device=self.device)
            if self.telemetry else None)

    # -------------------------------------------------------------- episodes
    def run(self, seed_or_generator: Union[int, torch.Generator],
            n_slots: int, *, mode: str = "scan",
            agent_state: Optional[AgentState] = None,
            draws: Optional[SlotDraws] = None):
        """Roll B fleets for ``n_slots``; returns (final carry, trace).

        ``mode="scan"`` runs the compiled episode (CUDA graphs on the
        card), ``mode="loop"`` the same slot body from Python. The tasks,
        exploration candidates and replay minibatches come from the
        generator (an int seeds the driver's own, on its device) unless
        ``draws`` injects them. ``agent_state`` defaults to a fresh
        ``adef.init`` from the same generator (see ``init_carry``).
        """
        if mode not in ("scan", "loop"):
            raise ValueError(f"unknown mode {mode!r}")
        gen = self._generator(seed_or_generator)
        carry = self.init_carry(gen, agent_state=agent_state)
        if draws is not None:
            want = (n_slots, self.n_fleets)
            if tuple(draws.rand_cands.shape[:2]) != want or any(
                    tuple(x.shape[:2]) != want for x in draws.tasks):
                raise ValueError(f"draws must lead with [T, B] = {want}")
        if mode == "loop":
            return self._run_loop(carry, gen, n_slots, draws)
        key = (n_slots, id(gen), None if draws is None
               else tuple(x.shape for x in _tensors(draws)))
        if self._episode is None or self._episode.key != key:
            self._episode = None        # free the old graphs and buffers
            self._episode = _ScanEpisode(self, key, carry, n_slots, draws,
                                         gen)
        return self._episode.run(self, carry, draws)

    def _run_loop(self, carry, gen, n_slots, draws):
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
            tasks = rand = None
            if draws is not None:
                tasks = SlotTasks(*(x[t] for x in draws.tasks))
                rand = draws.rand_cands[t]
            carry, out = self._slot(carry, gen, tasks, rand, take, no_loss)
            outs.append(out)
        trace = RolloutTrace(*(torch.stack(xs) for xs in zip(*outs)))
        return carry, trace

    def _schedule(self, agent_state: AgentState, n_slots: int):
        """The host mirrors before each slot, [(train_due, host_step,
        host_size)] * n_slots, and after the last (host_step, host_size):
        what ``absorb`` and ``replay_add`` do to them, without the device."""
        step, size = agent_state.host_step, agent_state.replay.host_size
        cap, out = agent_state.replay.capacity, []
        for _ in range(n_slots):
            st = agent_state._replace(host_step=step, replay=agent_state
                                      .replay._replace(host_size=size))
            due = self.train and self.adef.train_due(st, self.n_fleets)
            out.append((due, step, size))
            if self.train:
                step, size = step + 1, min(size + self.n_fleets, cap)
        return out, (step, size)

    # ------------------------------------------------------------- slot body
    def _slot(self, carry: RolloutCarry, gen, tasks, rand, take, no_loss):
        """One slot for all fleets: the slot's injected ``tasks`` and
        exploration candidates ``rand`` (None: drawn from ``gen``) and, on
        a train step, its minibatch rows ``take`` (None: drawn)."""
        with record_function("sample"):
            if tasks is None:
                tasks = self.workload.sample(gen, self.n_fleets)
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
        decision = decision.to(torch.int32)
        active = tasks.active.to(torch.float32)
        metrics = metrics_update(carry.metrics, reward=result.reward,
                                 success=result.success,
                                 accuracy=result.accuracy, active=active,
                                 loss=loss)
        telemetry = carry.telemetry
        if telemetry is not None:
            replay_frac = (agent.replay.size.to(torch.float32)
                           / float(self.replay_capacity))
            telemetry = telemetry_update(
                telemetry, decisions=decision, result=result, active=active,
                deadline_s=self.env.params.deadline_s,
                replay_frac=replay_frac, loss=loss, n_exits=self.env.L)
        out = RolloutTrace(decision, result.reward, result.success,
                           result.accuracy, active, q_best, loss)
        return RolloutCarry(env_state, agent, metrics, telemetry), out

    def metrics(self, carry: RolloutCarry) -> dict:
        """Host-side §VI-D summary of the carry's running metrics."""
        out = metrics_finalize(carry.metrics, slot_s=self.env.cfg.slot_s,
                               n_fleets=self.n_fleets)
        return {k: float(v) for k, v in out.items()}


class _ScanEpisode:
    """The compiled episode of one driver at one shape: static carry, trace
    and draw buffers, device counters, and on the card the two captured
    slot graphs (see the module docstring). It holds no reference to its
    driver, so that a dropped driver frees its graphs at once, not in a
    later pass of the cyclic collector, which could fall inside another
    capture (CUDA forbids destroying a graph while a stream captures)."""

    def __init__(self, drv: RolloutDriver, key, carry: RolloutCarry,
                 n_slots: int, draws: Optional[SlotDraws], gen):
        self.key, self.n_slots, self.gen = key, n_slots, gen
        dev = drv.device
        self.static = _refill(carry, iter(
            [torch.empty_like(x) for x in _tensors(carry)]))
        self.leaves = _tensors(self.static)
        b, m = drv.n_fleets, drv.env.M

        def z(shape, dtype=torch.float32):
            return torch.zeros((n_slots,) + shape, dtype=dtype, device=dev)

        self.trace = RolloutTrace(z((b, m), torch.int32), z((b,)),
                                  z((b, m), torch.bool), z((b, m)),
                                  z((b, m)), z((b,)), z(()))
        self.draws = (None if draws is None else _refill(draws, iter(
            [torch.empty_like(x) for x in _tensors(draws)])))
        self.t_dev = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.n_dev = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.no_loss = torch.full((), torch.nan, device=dev)
        self.graphs: Optional[dict] = None

    def _body(self, drv: RolloutDriver, carry: RolloutCarry, gen,
              write: bool) -> None:
        """One slot on the static buffers: ``drv._slot`` on ``carry`` (the
        static carry with its host mirrors set), then, with ``write``, the
        new carry copied into the static one, the trace row written at the
        slot counter and the counters advanced."""
        tasks = rand = take = None
        t = self.t_dev
        if self.draws is not None:
            tasks = SlotTasks(*(x.index_select(0, t)[0]
                                for x in self.draws.tasks))
            rand = self.draws.rand_cands.index_select(0, t)[0]
        due = drv.train and drv.adef.train_due(carry.agent_state,
                                                drv.n_fleets)
        if due and self.draws is not None \
                and self.draws.replay_take is not None:
            take = self.draws.replay_take.index_select(0, self.n_dev)[0]
        new, out = drv._slot(carry, gen, tasks, rand, take, self.no_loss)
        if not write:
            return
        _copy_into(self.leaves, _tensors(new))
        for buf, row in zip(self.trace, out):
            buf.index_copy_(0, t, row.unsqueeze(0))
        t.add_(1)
        if take is not None:
            self.n_dev.add_(1)

    def _capture(self, drv: RolloutDriver, kinds: dict) -> dict:
        """Warm up one eager slot of each kind on a side stream under the
        sync debug mode "error", then capture each into one pool, with the
        cyclic collector run first and held off during capture (a pass
        inside a capture that frees someone else's graph would invalidate
        it). ``kinds`` maps train_due -> the static carry with mirrors that
        give it."""
        dev = drv.device
        warm = torch.Generator(device=dev).manual_seed(0)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        prev = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(side):
            torch.cuda.set_sync_debug_mode("error")
            try:
                for carry in kinds.values():
                    self._body(drv, carry, warm, write=False)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        pool = torch.cuda.graph_pool_handle()
        graphs = {}
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            for due, carry in kinds.items():
                g = torch.cuda.CUDAGraph()
                g.register_generator_state(self.gen)
                with torch.cuda.graph(g, pool=pool):
                    self._body(drv, carry, self.gen, write=True)
                graphs[due] = g
        finally:
            if collecting:
                gc.enable()
        return graphs

    def run(self, drv: RolloutDriver, carry: RolloutCarry,
            draws: Optional[SlotDraws]):
        _copy_into(self.leaves, _tensors(carry))
        if draws is not None:
            _copy_into(_tensors(self.draws), _tensors(draws))
        self.t_dev.zero_()
        self.n_dev.zero_()
        plan, (step, size) = drv._schedule(carry.agent_state, self.n_slots)
        if drv.device.type == "cuda":
            if self.graphs is None:
                kinds = {}
                for due, s, z in plan:
                    kinds.setdefault(due, _with_mirrors(self.static, s, z))
                self.graphs = self._capture(drv, kinds)
            for due, _, _ in plan:
                self.graphs[due].replay()
        else:
            for _, s, z in plan:
                self._body(drv, _with_mirrors(self.static, s, z), self.gen,
                           write=True)
        final = _refill(self.static, (x.clone() for x in self.leaves))
        trace = RolloutTrace(*(x.clone() for x in self.trace))
        return _with_mirrors(final, step, size), trace


# ------------------------------------------------------------- host views
def carry_metrics(carry: RolloutCarry, *, slot_s: float,
                  n_fleets: int) -> dict:
    """Host-side view of the carry's running accumulator (floats/None):
    the streaming counterpart of ``trace_metrics``, eight scalars instead
    of the trace. ``ssp``/``avg_accuracy``/``deadline_miss`` are
    fractions pooled over all fleets, ``throughput_tps`` successful tasks
    per second per fleet; ``tasks`` and ``train_steps`` are ints and
    ``final_loss`` is None before the first train step."""
    out = metrics_finalize(carry.metrics, slot_s=slot_s, n_fleets=n_fleets)
    host = torch.stack([v.to(torch.float32) for v in out.values()]).cpu()
    out = dict(zip(out, map(float, host)))
    out["tasks"] = int(out["tasks"])
    out["train_steps"] = int(out["train_steps"])
    if not np.isfinite(out["final_loss"]):
        out["final_loss"] = None
    return out


def carry_telemetry(carry: RolloutCarry, *, index: Optional[int] = None,
                    summarize: bool = True) -> Optional[dict]:
    """Host-side view of the carry's telemetry registry (one transfer);
    None when the driver ran without it. ``index`` slices a stacked
    registry down to one cell; ``summarize`` adds ``telemetry_summary``
    under ``"summary"``."""
    if carry.telemetry is None:
        return None
    host = telemetry_host(carry.telemetry, index=index)
    if summarize:
        host["summary"] = telemetry_summary(host)
    return host


def trace_metrics(trace: RolloutTrace, *, slot_s: float) -> dict:
    """Aggregate a [T, B, ...] trace into the paper's §VI-D metrics (all
    fleets pooled; ``slot_s`` seconds, ``throughput_tps`` per fleet)."""
    active = trace.active.cpu().numpy() > 0.5
    success = trace.success.cpu().numpy() & active
    acc = trace.accuracy.cpu().numpy()
    n_tasks = int(active.sum())
    t, b = trace.reward.shape
    losses = trace.loss.cpu().numpy()
    losses = losses[~np.isnan(losses)]
    return {
        "ssp": float(success.sum() / max(n_tasks, 1)),
        "avg_accuracy": float((acc * success).sum() / max(n_tasks, 1)),
        "throughput_tps": float(success.sum() / max(t * slot_s, 1e-9) / b),
        "avg_reward": float(trace.reward.cpu().numpy().mean()),
        "tasks": n_tasks,
        "final_loss": float(losses[-1]) if losses.size else None,
    }
