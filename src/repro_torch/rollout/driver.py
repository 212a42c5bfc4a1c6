"""Episode driver: Algorithm 1 for B fleets, slot by slot, or compiled.

Counterpart of ``repro/rollout/driver.py``. Each slot, for all B fleets at
once: draw the tasks from the workload (``iid``, or the ``poisson``/``mmpp``
arrival processes, whose state rides in the carry), observe and build the
graph, run the actor (GRLE/GRL: 4 ``gcn_agg`` launches + 1 ``edge_score``
launch for the whole fleet batch; DROO/DROOE: the MLP in plain PyTorch),
quantize, score every candidate with the Eq-15 critic, realize the best
one with ``env.step`` and fold the metrics (and, with ``telemetry=True``,
the rollout telemetry registry). With ``train=True`` (the reference's
default) one shared learner then absorbs the B fleets' (graph, decision)
pairs in fleet order, and every ``train_every`` slots, once the ring
holds a full minibatch, takes one Eq-16 + Adam step, whose forward runs
the same actor on the minibatch (4 + 1 more launches for the GCN). The
train gate is read on the host (``AgentDef.train_due``); nothing in a
slot waits on the device.

Scenario knobs enter as an optional ``ScenarioParams`` ``sp`` on ``run``
and ``init_carry``, shared by every fleet, or with
``per_fleet_scenarios=True`` one per fleet (leaves with a leading [B]:
domain randomization over ``mec.scenarios.ScenarioSpace`` draws), where
the reference ``vmap``s the slot over a [B]-leading ``sp``.

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
  device train-step counter); ``sp`` sits in static buffers too, copied in
  before each replay, so another ``sp`` of the same shapes replays the
  same graphs. Before capture, one eager slot of each kind
  runs on a side stream with CUDA's sync debug mode set to raise, which
  builds the kernels, sets up cuBLAS and fails on any host sync. A failed
  capture raises; scan never falls back to the loop. On the CPU (which the
  caller asks for with ``device="cpu"``) scan runs the same static-buffer
  episode without capture, so it equals the loop bit for bit.

Per-episode hyperparameters enter as ``hypers`` on ``run`` (anything
with 0-d tensor attributes ``lr`` and ``explore_gain``: the population's
``MemberHypers`` row): ``lr`` rescales each train step's Adam updates and
``explore_gain`` leans the exploration draw toward the actor's scores
(``AgentDef.decide_with``). The scan episode keeps them in static buffers
beside ``sp``, so members of one population replay the same graphs;
``hypers=None`` is the def's own settings, the path as it was.

``run_sharded(..., mesh=)`` splits the fleets over the ranks of a
``fleet`` mesh (``sharding.fleet``: one process a card). The slot body is
two halves, ``_fleets`` (sample, actor, env step: each rank on its block
of the fleets, with what it draws drawn for all B and sliced) and
``_learner`` (ring add, train step, metrics: every rank on all B), with
one all-gather of the fleets' rows between them; unsharded, ``_slot``
runs both halves back to back.

Phases are wrapped in ``obs.profile.phase`` (``obs/sample``,
``obs/actor``, ``obs/env_step``, ``obs/train``: ``torch.profiler.
record_function`` spans), as the reference wraps them in ``phase()``;
inside a graph they appear once, at capture.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.core.policy import AgentDef, AgentState
from repro_torch.device import resolve_device
from repro_torch.mec.config import ScenarioParams
from repro_torch.core.graph import MECGraph
from repro_torch.mec.env import MECState, SlotResult, SlotTasks
from repro_torch.nn.pytree import tree_refill, tree_tensors
from repro_torch.obs.compile import (CAPTURE_EVENT, EPISODE_EVENT,
                                     record_build)
from repro_torch.obs.profile import phase
from repro_torch.obs.telemetry import (Telemetry, rollout_telemetry,
                                       telemetry_host, telemetry_summary,
                                       telemetry_update)
from repro_torch.rollout.metrics import (CellMetrics, metrics_finalize,
                                         metrics_init, metrics_update)
from repro_torch.rollout.vecenv import VecMECEnv
from repro_torch.rollout.workloads import (InitDraws, WorkloadDraws,
                                           WorkloadState, make_workload)
from repro_torch.sharding.fleet import (gather_leading, gather_rows,
                                        local_slice, pack_rows, replicate,
                                        unpack_rows)


class SlotDraws(NamedTuple):
    """Injected random draws for a whole episode (tests, golden replay).

    The slot's tasks come ready-made (``tasks``, leaves [T, B, ...]; the
    workload state is then not advanced), or from the workload's own
    state fed its raw uniforms (``workload``, a ``poisson``/``mmpp``
    ``WorkloadDraws`` with leaves [T, B, ...]; ``init`` [B, ...] seeds the
    state), or, both None, from the generator. The exploration
    candidates come ready-made (``rand_cands``) or from the Gumbel noise
    that picks them (``gumbel``, which an ``explore_gain`` needs: its
    candidates depend on the actor), or, both None, from the generator."""
    tasks: Optional[SlotTasks]  # leaves [T, B, ...], or None
    rand_cands: Optional[torch.Tensor]  # [T, B, K, M] exploration candidates
    # [n_train, batch_size] replay rows of each train step, in order
    replay_take: Optional[torch.Tensor] = None
    init: Optional[InitDraws] = None          # leaves [B, ...]
    workload: Optional[WorkloadDraws] = None  # leaves [T, B, ...]
    gumbel: Optional[torch.Tensor] = None     # [T, B, K, M, O] their noise


class RolloutCarry(NamedTuple):
    """What persists across slots."""
    env_state: MECState        # [B, ...]
    # the workload's state [B, ...]; None for iid, whose draws read none
    wl_state: Optional[WorkloadState]
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


def _signature(tree):
    """The structure and shapes of a tree of tensors (a cache key)."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape)
    if isinstance(tree, dict):
        return tuple((k, _signature(v)) for k, v in tree.items())
    if isinstance(tree, tuple):
        return (type(tree).__name__,) + tuple(_signature(v) for v in tree)
    return tree


def _at(tree, t):
    """Row ``t`` of every tensor of ``tree``: an int, or a [1] device
    index (read on the device, as a captured graph must)."""
    if isinstance(t, int):
        return tree_refill(tree, (x[t] for x in tree_tensors(tree)))
    return tree_refill(tree, (x.index_select(0, t)[0]
                              for x in tree_tensors(tree)))


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


class _SlotOut(NamedTuple):
    """What a slot's fleets hand its learner, leaves [B, ...] (a rank's
    block of the fleets before the all-gather of a sharded episode)."""
    decision: torch.Tensor            # [B, M] int32
    q_best: torch.Tensor              # [B]
    graphs: Optional[MECGraph]        # the actor's input graphs; with train
    result: SlotResult                # the env step's [B, ...] outcome
    active: torch.Tensor              # [B, M] float32


class _Shard:
    """This rank's block of a driver's fleet axis on a ``fleet`` mesh."""

    def __init__(self, mesh, n_fleets: int, per_fleet_scenarios: bool):
        self.mesh = mesh
        self.slice = local_slice(n_fleets, mesh)
        self.n = n_fleets // mesh.size()
        self.per_fleet = per_fleet_scenarios

    def take(self, tree, dim: int = 0):
        """This rank's fleets of every tensor of ``tree`` (fleets on
        ``dim``)."""
        index = (slice(None),) * dim + (self.slice,)
        return tree_refill(tree, (x[index] for x in tree_tensors(tree)))

    def sp(self, sp):
        """``sp`` for this rank's fleets: sliced when per fleet."""
        return self.take(sp) if (sp is not None and self.per_fleet) else sp

    def draws(self, draws: Optional[SlotDraws]) -> Optional[SlotDraws]:
        """Injected draws for this rank's fleets: [T, B, ...] leaves on
        their B, ``init`` [B, ...] on its leading axis; the minibatch rows
        are every rank's."""
        if draws is None:
            return None
        return draws._replace(
            tasks=self.take(draws.tasks, 1),
            rand_cands=self.take(draws.rand_cands, 1),
            init=self.take(draws.init), workload=self.take(draws.workload, 1),
            gumbel=self.take(draws.gumbel, 1))


class RolloutDriver:
    """Drives B fleets of one agent for T slots; ``train=False`` runs the
    decision path alone, ``telemetry=True`` carries the rollout telemetry
    registry. ``replay_capacity``, ``batch_size`` and ``train_every``
    override the def's for this driver, as in the reference.

    ``agent`` is an ``AgentDef``, or the deprecated ``OffloadingAgent``
    shim, whose def and current state are taken (``sync_agent`` writes a
    run's result back into it). With ``per_fleet_scenarios=True`` an
    ``sp`` given to ``run``/``init_carry`` has a leading [B] on every leaf,
    one scenario per fleet; otherwise it is shared.

    ``episodes_built`` counts the scan episodes this driver built (one per
    episode shape, the port's "compile") and ``graphs_captured`` the CUDA
    graphs captured for them. Each build is also reported, with its
    seconds and under ``label`` (None, or a name its owner sets), to the
    active ``obs.compile.CompileTracker``s.
    """

    def __init__(self, agent, n_fleets: int = 1, *,
                 train: bool = True, replay_capacity: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 train_every: Optional[int] = None,
                 per_fleet_scenarios: bool = False,
                 telemetry: bool = False, device=None):
        if isinstance(agent, AgentDef):
            adef, self._shim = agent, None
        else:                         # the deprecated OffloadingAgent shim
            adef, self._shim = agent.adef, agent
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
        self.per_fleet_scenarios = per_fleet_scenarios
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
        self.label: Optional[str] = None
        self.episodes_built = 0
        self.graphs_captured = 0

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

    def _check_sp(self, sp: Optional[ScenarioParams]) -> None:
        """``sp`` must have the env's knob shapes, behind a leading [B]
        with ``per_fleet_scenarios``, on the driver's device."""
        if sp is None:
            return
        lead = (self.n_fleets,) if self.per_fleet_scenarios else ()
        for name, mine, got in zip(ScenarioParams._fields, self.env.params,
                                   sp):
            want = lead + tuple(mine.shape)
            if tuple(got.shape) != want:
                raise ValueError(
                    f"sp.{name} of shape {tuple(got.shape)}, expected {want}"
                    + (" (per_fleet_scenarios: a leading [B])"
                       if self.per_fleet_scenarios else ""))
            if got.device.type != self.device.type:
                raise ValueError(f"sp.{name} on {got.device}, driver on "
                                 f"{self.device}")

    # ------------------------------------------------------------------ carry
    def init_carry(self, seed_or_generator: Union[int, torch.Generator], *,
                   agent_state: Optional[AgentState] = None,
                   sp: Optional[ScenarioParams] = None,
                   draws: Optional[InitDraws] = None) -> RolloutCarry:
        """Fresh episode state. ``agent_state`` defaults to the shim's live
        state or a fresh ``adef.init`` from the generator; whatever state
        comes in starts the episode through ``adef.episode_state`` (empty
        ring, slot counter and loss stats reset; params and optimizer
        carry over). A ``poisson``/``mmpp`` workload's state is drawn next
        (or from ``draws``), its rate and capacity marginals from ``sp``
        (None: the env's own knobs)."""
        self._check_sp(sp)
        gen = self._generator(seed_or_generator)
        if agent_state is None:
            agent_state = (self._shim.state if self._shim is not None
                           else self.adef.init(gen))
        wl_state = None
        if self.workload.kind != "iid":
            wl_state = self.workload.init(gen, sp, batch=(self.n_fleets,),
                                          draws=draws)
        return RolloutCarry(
            self.vec.reset(), wl_state, self.adef.episode_state(agent_state),
            metrics_init(self.device),
            rollout_telemetry(self.env.N, self.env.L, device=self.device)
            if self.telemetry else None)

    # -------------------------------------------------------------- episodes
    def run(self, seed_or_generator: Union[int, torch.Generator],
            n_slots: int, *, mode: str = "scan",
            agent_state: Optional[AgentState] = None,
            draws: Optional[SlotDraws] = None,
            sp: Optional[ScenarioParams] = None, hypers=None):
        """Roll B fleets for ``n_slots``; returns (final carry, trace).

        ``mode="scan"`` runs the compiled episode (CUDA graphs on the
        card), ``mode="loop"`` the same slot body from Python. The tasks,
        exploration candidates and replay minibatches come from the
        generator (an int seeds the driver's own, on its device) unless
        ``draws`` injects them. ``agent_state`` defaults to a fresh
        ``adef.init`` from the same generator (see ``init_carry``). ``sp``
        overrides the env's scenario knobs (shared, or [B]-leading with
        ``per_fleet_scenarios``); another ``sp`` of the same shapes
        replays the same compiled episode, and so do other ``hypers``
        (0-d ``lr`` and ``explore_gain``; None: the def's own).
        """
        if mode not in ("scan", "loop"):
            raise ValueError(f"unknown mode {mode!r}")
        if draws is not None:
            self._check_draws(draws, n_slots)
        gen = self._generator(seed_or_generator)
        carry = self.init_carry(gen, agent_state=agent_state, sp=sp,
                                draws=None if draws is None else draws.init)
        if mode == "loop":
            return self._run_loop(carry, gen, n_slots, draws, sp, hypers)
        key = (n_slots, id(gen), _signature(draws), _signature(sp),
               _signature(hypers))
        return self._episode_for(key, carry, n_slots, draws, gen, sp,
                                 hypers).run(self, carry, draws, sp, hypers)

    def _episode_for(self, key, carry, n_slots, draws, gen, sp, hypers,
                     shard: Optional[_Shard] = None) -> "_ScanEpisode":
        """The compiled episode for ``key``: the cached one, or a new one
        built in its place (the old graphs and buffers freed first)."""
        if self._episode is None or self._episode.key != key:
            self._episode = None
            t0 = time.perf_counter()
            self._episode = _ScanEpisode(self, key, carry, n_slots, draws,
                                         gen, sp, hypers, shard)
            self.episodes_built += 1
            record_build(self.label, EPISODE_EVENT,
                         time.perf_counter() - t0)
        return self._episode

    def run_sharded(self, seed_or_generator: Union[int, torch.Generator],
                    n_slots: int, *, mesh=None,
                    sp: Optional[ScenarioParams] = None,
                    agent_state: Optional[AgentState] = None,
                    draws: Optional[SlotDraws] = None, mode: str = "scan"):
        """The episode with the fleet axis split over ``mesh``'s ranks
        (``sharding.fleet.fleet_mesh()``), the reference's
        ``run_sharded``; ``mesh=None`` is ``run(..., mode=mode)``, its
        single-device fallback.

        Each rank runs every slot's fleets' half (sample, actor, env step)
        on its contiguous block of B / world fleets: the env and workload
        state, a per-fleet ``sp`` and injected draws are sliced, and what
        comes from the generator (every rank seeds the same one) is drawn
        for all B fleets and sliced, so each fleet sees the numbers of the
        unsharded run. The B-fleets -> one-learner fan-in is one
        all-gather a slot of the fleets' (graph, decision, outcome) rows
        in fleet order; every rank then runs the same learner's half
        (ring add, the Eq-16 train step when due, the metrics and
        telemetry over all B in fleet order), so the ``AgentState`` (from
        rank 0, ``replicate``), the metrics and the [T, B] trace are the
        same on every rank and equal the unsharded run's bit for bit where
        the fleets' halves agree. The final carry's env and workload
        states are gathered back to all B. On the card ``mode="scan"``
        replays two CUDA graphs a slot, the fleets' half and the learner's
        half, with the all-gather between them outside the graphs;
        ``mode="loop"`` runs the same halves from Python.
        """
        if mesh is None:
            return self.run(seed_or_generator, n_slots, mode=mode,
                            agent_state=agent_state, draws=draws, sp=sp)
        if mode not in ("scan", "loop"):
            raise ValueError(f"unknown mode {mode!r}")
        if self.n_fleets % mesh.size() != 0:
            raise ValueError(f"n_fleets={self.n_fleets} not divisible by "
                             f"{mesh.size()} devices")
        if draws is not None:
            self._check_draws(draws, n_slots)
        gen = self._generator(seed_or_generator)
        carry = self.init_carry(gen, agent_state=agent_state, sp=sp,
                                draws=None if draws is None else draws.init)
        shard = _Shard(mesh, self.n_fleets, self.per_fleet_scenarios)
        shared = None if self.per_fleet_scenarios else sp
        agent, shared = replicate((carry.agent_state, shared), mesh)
        if not self.per_fleet_scenarios:
            sp = shared
        carry = carry._replace(env_state=shard.take(carry.env_state),
                               wl_state=shard.take(carry.wl_state),
                               agent_state=agent)
        draws = shard.draws(draws)
        if mode == "loop":
            carry, trace = self._run_loop(carry, gen, n_slots, draws, sp,
                                          None, shard)
        else:
            key = ("fleet", mesh.size(), mesh.get_local_rank(), n_slots,
                   id(gen), _signature(draws), _signature(sp))
            carry, trace = self._episode_for(
                key, carry, n_slots, draws, gen, sp, None, shard).run(
                    self, carry, draws, sp, None)
        env_state, wl_state = gather_leading(
            (carry.env_state, carry.wl_state), mesh)
        return carry._replace(env_state=env_state, wl_state=wl_state), trace

    def _check_draws(self, draws: SlotDraws, n_slots: int) -> None:
        want = (n_slots, self.n_fleets)
        if draws.rand_cands is not None and draws.gumbel is not None:
            raise ValueError("draws carry rand_cands or the gumbel noise "
                             "that picks them, not both")
        per_slot = (tree_tensors((draws.rand_cands, draws.gumbel))
                    + tree_tensors(draws.tasks)
                    + tree_tensors(draws.workload))
        if any(tuple(x.shape[:2]) != want for x in per_slot):
            raise ValueError(f"draws must lead with [T, B] = {want}")
        if any(x.shape[0] != self.n_fleets for x in tree_tensors(draws.init)):
            raise ValueError(f"init draws must lead with [B] = "
                             f"{self.n_fleets}")
        if self.workload.kind == "iid" and (draws.workload is not None
                                            or draws.init is not None):
            raise ValueError("an iid workload has no state to feed "
                             "workload or init draws to")

    def sync_agent(self, carry: RolloutCarry) -> None:
        """Write the learned ``AgentState`` back into the legacy shim.

        Only meaningful when the driver was built from an
        ``OffloadingAgent``; with an ``AgentDef``, ``carry.agent_state``
        *is* the result — keep it.
        """
        if self._shim is None:
            raise ValueError(
                "driver was built from an AgentDef; carry.agent_state is "
                "the trained state — thread it explicitly")
        self._shim.state = carry.agent_state

    def _run_loop(self, carry, gen, n_slots, draws, sp, hypers=None,
                  shard: Optional[_Shard] = None):
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
            tasks = wdraws = rand = gumbel = None
            if draws is not None:
                tasks, wdraws = _at(draws.tasks, t), _at(draws.workload, t)
                rand, gumbel = _at((draws.rand_cands, draws.gumbel), t)
            if shard is None:
                carry, out = self._slot(carry, gen, tasks, wdraws, rand,
                                        take, no_loss, sp, hypers, gumbel)
            else:
                env_state, wl_state, mine = self._fleets(
                    carry, gen, tasks, wdraws, rand, shard.sp(sp), hypers,
                    gumbel, shard)
                carry, out = self._learner(
                    carry, env_state, wl_state,
                    gather_leading(mine, shard.mesh), gen, take, no_loss, sp,
                    hypers)
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
    def _slot(self, carry: RolloutCarry, gen, tasks, wdraws, rand, take,
              no_loss, sp, hypers=None, gumbel=None):
        """One slot for all fleets under scenario ``sp`` and ``hypers``:
        the slot's injected ``tasks``, or the workload's draw from its
        state (on the injected uniforms ``wdraws``, or ``gen``'s),
        exploration candidates ``rand`` (None: picked by the Gumbel noise
        ``gumbel``, or by noise drawn from ``gen``) and, on a train step,
        its minibatch rows ``take`` (None: drawn). The fleets' half
        (``_fleets``) hands the learner's half (``_learner``) its
        [B]-leading ``_SlotOut``; the fleet-sharded episode all-gathers it
        in between."""
        env_state, wl_state, out = self._fleets(carry, gen, tasks, wdraws,
                                                rand, sp, hypers, gumbel)
        return self._learner(carry, env_state, wl_state, out, gen, take,
                             no_loss, sp, hypers)

    def _fleets(self, carry: RolloutCarry, gen, tasks, wdraws, rand, sp,
                hypers, gumbel, shard: Optional["_Shard"] = None):
        """The fleets' half of a slot: sample, decide and step the envs of
        ``carry``'s fleets -> (env state, workload state, ``_SlotOut``).
        With ``shard`` the carry, ``sp`` and the injected draws are this
        rank's block of the fleets, and what is drawn from ``gen`` is
        drawn for every fleet and sliced, so that each fleet sees the
        numbers of the unsharded run."""
        n = self.n_fleets if shard is None else shard.n
        wl_state = carry.wl_state
        with phase("sample"):
            if tasks is None:
                if shard is not None and wdraws is None:
                    wdraws = shard.take(self.workload.draws(
                        gen, (self.n_fleets,)))
                wl_state, tasks = self.workload.sample(
                    wl_state, gen, sp, batch=(n,), draws=wdraws)
        with phase("actor"):
            if (shard is not None and rand is None and gumbel is None
                    and self.adef.n_random):
                gumbel = shard.take(self.adef.gumbel_noise(
                    gen, (self.n_fleets,)))
            decision, q_best, graphs = self.adef.decide(
                carry.agent_state, carry.env_state, tasks, generator=gen,
                rand_cands=rand, sp=sp, gumbel=gumbel,
                explore_gain=None if hypers is None else hypers.explore_gain)
        with phase("env_step"):
            env_state, result = self.env.step(carry.env_state, tasks,
                                              decision, sp)
        out = _SlotOut(decision.to(torch.int32), q_best,
                       graphs if self.train else None, result,
                       tasks.active.to(torch.float32))
        return env_state, wl_state, out

    def _learner(self, carry: RolloutCarry, env_state, wl_state,
                 out: "_SlotOut", gen, take, no_loss, sp, hypers):
        """The learner's half of a slot, on every fleet's ``out``: absorb
        the (graph, decision) pairs in fleet order (and train when due),
        fold the metrics and telemetry -> (new carry, trace row)."""
        agent = carry.agent_state
        loss = no_loss
        if self.train:
            with phase("train"):
                agent, loss = self.adef.absorb(
                    agent, out.graphs, out.decision,
                    None if hypers is None else hypers.lr, generator=gen,
                    take=take)
        result = out.result
        metrics = metrics_update(carry.metrics, reward=result.reward,
                                 success=result.success,
                                 accuracy=result.accuracy, active=out.active,
                                 loss=loss)
        telemetry = carry.telemetry
        if telemetry is not None:
            replay_frac = (agent.replay.size.to(torch.float32)
                           / float(self.replay_capacity))
            telemetry = telemetry_update(
                telemetry, decisions=out.decision, result=result,
                active=out.active, deadline_s=self.env._sp(sp).deadline_s,
                replay_frac=replay_frac, loss=loss, n_exits=self.env.L)
        row = RolloutTrace(out.decision, result.reward, result.success,
                           result.accuracy, out.active, out.q_best, loss)
        return RolloutCarry(env_state, wl_state, agent, metrics,
                            telemetry), row

    def metrics(self, carry: RolloutCarry) -> dict:
        """Host-side §VI-D summary of the carry's running metrics."""
        out = metrics_finalize(carry.metrics, slot_s=self.env.cfg.slot_s,
                               n_fleets=self.n_fleets)
        return {k: float(v) for k, v in out.items()}


class _ScanEpisode:
    """The compiled episode of one driver at one shape: static carry, trace
    and draw buffers, device counters, and on the card the two captured
    slot graphs (see the module docstring); fleet-sharded, three: the
    fleets' half and the learner's half of each kind, with the all-gather
    of the fleets' rows between them outside any graph. It holds no
    reference to its driver, so that a dropped driver frees its graphs at
    once, not in a later pass of the cyclic collector, which could fall
    inside another capture (CUDA forbids destroying a graph while a
    stream captures)."""

    def __init__(self, drv: RolloutDriver, key, carry: RolloutCarry,
                 n_slots: int, draws: Optional[SlotDraws], gen,
                 sp: Optional[ScenarioParams], hypers,
                 shard: Optional[_Shard] = None):
        self.key, self.n_slots, self.gen = key, n_slots, gen
        # fleet-sharded: this rank's block of the fleets (the static carry's
        # env and workload state, the draws), and the fleets' packed
        # _SlotOut rows sent and every rank's received, built at the first
        # slot (the rows' layout is the fleets' half's output)
        self.shard = shard
        self.send = self.recv = self.out_like = None
        dev = drv.device
        self.static = tree_refill(carry, iter(
            [torch.empty_like(x) for x in tree_tensors(carry)]))
        self.sp, self.hypers = (None if x is None else tree_refill(x, iter(
            [torch.empty_like(y) for y in tree_tensors(x)]))
            for x in (sp, hypers))
        self.leaves = tree_tensors(self.static)
        b, m = drv.n_fleets, drv.env.M

        def z(shape, dtype=torch.float32):
            return torch.zeros((n_slots,) + shape, dtype=dtype, device=dev)

        self.trace = RolloutTrace(z((b, m), torch.int32), z((b,)),
                                  z((b, m), torch.bool), z((b, m)),
                                  z((b, m)), z((b,)), z(()))
        self.draws = (None if draws is None else tree_refill(draws, iter(
            [torch.empty_like(x) for x in tree_tensors(draws)])))
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
        tasks, wdraws, rand, gumbel = self._draws_at()
        take = self._take(drv, carry)
        new, out = drv._slot(carry, gen, tasks, wdraws, rand, take,
                             self.no_loss, self.sp, self.hypers, gumbel)
        if write:
            self._write(new, out, take)

    def _draws_at(self):
        """The injected draws of the slot at the slot counter."""
        if self.draws is None:
            return None, None, None, None
        t = self.t_dev
        rand, gumbel = _at((self.draws.rand_cands, self.draws.gumbel), t)
        return (_at(self.draws.tasks, t), _at(self.draws.workload, t), rand,
                gumbel)

    def _take(self, drv: RolloutDriver, carry: RolloutCarry):
        """The injected minibatch rows at the train-step counter when a
        train step is due (by ``carry``'s host mirrors), else None."""
        if (drv.train and self.draws is not None
                and self.draws.replay_take is not None
                and drv.adef.train_due(carry.agent_state, drv.n_fleets)):
            return self.draws.replay_take.index_select(0, self.n_dev)[0]
        return None

    def _fleets_body(self, drv: RolloutDriver, carry: RolloutCarry, gen,
                     write: bool) -> None:
        """The fleets' half of a sharded slot on the static buffers: with
        ``write``, the new env and workload states copied into the static
        carry and the ``_SlotOut`` rows packed into ``send``."""
        tasks, wdraws, rand, gumbel = self._draws_at()
        env_state, wl_state, out = drv._fleets(
            carry, gen, tasks, wdraws, rand, self.shard.sp(self.sp),
            self.hypers, gumbel, self.shard)
        if self.send is None:
            self.out_like = out
            self.send = pack_rows(tree_tensors(out))
            self.recv = self.send.new_zeros(
                (self.shard.mesh.size() * self.send.shape[0],
                 self.send.shape[1]))
        if write:
            _copy_into(tree_tensors((self.static.env_state,
                                 self.static.wl_state)),
                       tree_tensors((env_state, wl_state)))
            self.send.copy_(pack_rows(tree_tensors(out)))

    def _learner_body(self, drv: RolloutDriver, carry: RolloutCarry, gen,
                      write: bool) -> None:
        """The learner's half of a sharded slot on every rank's rows in
        ``recv``; with ``write`` as ``_body`` writes."""
        out = tree_refill(self.out_like, iter(unpack_rows(
            self.recv, tree_tensors(self.out_like))))
        take = self._take(drv, carry)
        new, row = drv._learner(carry, carry.env_state, carry.wl_state, out,
                                gen, take, self.no_loss, self.sp,
                                self.hypers)
        if write:
            self._write(new, row, take)

    def _write(self, new: RolloutCarry, row: RolloutTrace, take) -> None:
        """The new carry into the static one, the trace row at the slot
        counter, the counters advanced."""
        t = self.t_dev
        _copy_into(self.leaves, tree_tensors(new))
        for buf, x in zip(self.trace, row):
            buf.index_copy_(0, t, x.unsqueeze(0))
        t.add_(1)
        if take is not None:
            self.n_dev.add_(1)

    def _exchange(self) -> None:
        """Every rank's packed fleet rows into ``recv``, in fleet order
        (outside any graph)."""
        gather_rows(self.recv, self.send, self.shard.mesh)

    def _sharded_slot(self, drv: RolloutDriver, carry: RolloutCarry, gen,
                      write: bool) -> None:
        """A whole sharded slot uncaptured: both halves and the exchange."""
        self._fleets_body(drv, carry, gen, write)
        self._exchange()
        self._learner_body(drv, carry, gen, write)

    def _bodies(self, kinds: dict) -> dict:
        """The graphs to capture, {name: (body, static carry)}: a whole
        slot per train_due kind, or, sharded, the fleets' half (first: it
        sizes the packed rows) and the learner's half per kind."""
        if self.shard is None:
            return {due: (self._body, c) for due, c in kinds.items()}
        out = {"fleets": (self._fleets_body, next(iter(kinds.values())))}
        out.update({due: (self._learner_body, c) for due, c in kinds.items()})
        return out

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
        bodies = self._bodies(kinds)
        with torch.cuda.stream(side):
            torch.cuda.set_sync_debug_mode("error")
            try:
                for body, carry in bodies.values():
                    body(drv, carry, warm, write=False)
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
            for name, (body, carry) in bodies.items():
                g = torch.cuda.CUDAGraph()
                g.register_generator_state(self.gen)
                with torch.cuda.graph(g, pool=pool):
                    body(drv, carry, self.gen, write=True)
                graphs[name] = g
        finally:
            if collecting:
                gc.enable()
        return graphs

    def run(self, drv: RolloutDriver, carry: RolloutCarry,
            draws: Optional[SlotDraws], sp: Optional[ScenarioParams],
            hypers):
        _copy_into(self.leaves, tree_tensors(carry))
        for static, given in ((self.draws, draws), (self.sp, sp),
                              (self.hypers, hypers)):
            if given is not None:
                _copy_into(tree_tensors(static), tree_tensors(given))
        self.t_dev.zero_()
        self.n_dev.zero_()
        plan, (step, size) = drv._schedule(carry.agent_state, self.n_slots)
        if drv.device.type == "cuda":
            if self.graphs is None:
                kinds = {}
                for due, s, z in plan:
                    kinds.setdefault(due, _with_mirrors(self.static, s, z))
                t0 = time.perf_counter()
                self.graphs = self._capture(drv, kinds)
                drv.graphs_captured += len(self.graphs)
                record_build(drv.label, CAPTURE_EVENT,
                             time.perf_counter() - t0, len(self.graphs))
            for due, _, _ in plan:
                if self.shard is not None:
                    self.graphs["fleets"].replay()
                    self._exchange()
                self.graphs[due].replay()
        else:
            body = self._body if self.shard is None else self._sharded_slot
            for _, s, z in plan:
                body(drv, _with_mirrors(self.static, s, z), self.gen,
                     write=True)
        final = tree_refill(self.static, (x.clone() for x in self.leaves))
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
