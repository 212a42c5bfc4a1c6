"""``Population``: P agents as stacked leaves, trained member by member.

Counterpart of ``repro/pop/population.py``. A population is an
``AgentState`` whose tensors carry a leading member axis [P] (the
reference's storage, so PBT's gathers are one ``index_select`` per leaf and
a checkpoint has the reference's layout leaf for leaf), per-member
hyperparameters as [P] float32 tensors (``MemberHypers``) and a generation
counter.

Every knob is data, as in the reference:

* ``lr``: passed to ``AgentDef.absorb`` as a 0-d tensor, which rescales
  each train step's Adam updates (exact: Adam's update is linear in lr);
* ``explore_gain``: leans the exploration draw toward the actor's own
  relaxed scores (0 = the def's uniform draw, bit for bit);
* ``exit_tau``: a per-member accuracy floor on early exits, turned into the
  member's exit mask at generation start (``exit_mask_from_tau``).

``PopulationDriver`` runs a generation by looping over the members through
one ``RolloutDriver(train=True)``, as the sweep's ``PackProgram`` loops
over cells: member i is ``drv.run(seed_i, T, mode="scan", agent_state=
member_i, sp=sps[i], hypers=hypers[i])`` with an int seed (the driver's
own generator), so the episode key stays the same and every member replays
the same two captured slot graphs; the member's exit mask, ``sp`` and
hypers are copied into the episode's static buffers. The reference
``vmap``s members into one program; the actor kernels here take one weight
set per launch. Member scores come from the driver's device-resident
accumulator (``metrics_finalize``), stacked to [P] tensors.

With a ``fleet`` mesh (``mesh="auto"``: ``sharding.fleet.fleet_mesh()``,
a process group of one rank per card) the member axis is split over the
ranks as the reference's ``shard_leading_axis`` splits it: each rank runs
its contiguous block of P / world members through its own driver's
graphs, and the trained agents and the [P] metrics are all-gathered in
member order, so every rank holds the whole population and ``pbt_update``
runs the same on each. P must divide the rank count: padding with phantom
members would distort PBT's ranks.

Every episode starts from ``adef.episode_state`` (an empty ring, step 0),
so all members share one host schedule of train steps. Draws come from
the driver's generator, seeded per member with ``member_seed``, or are
injected (``draws=``, one ``SlotDraws`` per member: the tests feed the
reference's through it, since torch cannot reproduce threefry).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.policy import AgentDef, AgentState
from repro_torch.mec.config import ScenarioParams
from repro_torch.nn.pytree import tree_refill, tree_tensors
from repro_torch.rollout.driver import RolloutDriver, SlotDraws
from repro_torch.rollout.metrics import metrics_finalize
from repro_torch.sharding.fleet import (fleet_mesh, gather_leading,
                                        local_slice, mesh_size)
from repro_torch.sweep.spec import seed_of

# Default search box for sampled member hyperparameters (lr is drawn
# log-uniformly; gain/tau uniformly). PBT perturbations clip back into
# the same box (``pbt.PBTConfig``).
LR_RANGE = (3e-4, 3e-3)
GAIN_RANGE = (0.0, 2.0)
TAU_RANGE = (0.0, 0.6)

Seed = Union[int, Sequence[int]]


class MemberHypers(NamedTuple):
    """Per-member hyperparameters as data: [P] float32 tensors (a member's
    row, ``hypers_row``, has 0-d ones)."""
    lr: torch.Tensor            # per-member learning rate
    explore_gain: torch.Tensor  # exploration bias toward actor scores (>= 0)
    exit_tau: torch.Tensor      # accuracy floor for allowed early exits


class Population(NamedTuple):
    """P agents + their hyperparameters + the generation counter (0-d
    int32). The agents' host mirrors (``host_step``, the ring's
    ``host_size``) are one pair for all members: they share a schedule."""
    agents: AgentState       # tensors stacked on a leading [P] axis
    hypers: MemberHypers     # [P] leaves
    generation: torch.Tensor


def member_seed(seed: Seed, i: int) -> int:
    """Member ``i``'s seed under ``seed``: ``SeedSequence([*seed, i])``, so
    growing a population never changes an existing member's draws."""
    base = [seed] if isinstance(seed, (int, np.integer)) else list(seed)
    return seed_of([*base, int(i)])


def generator_of(entropy: Seed, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed_of(entropy)``."""
    return torch.Generator(device=device).manual_seed(seed_of(entropy))


def n_members(pop: Population) -> int:
    return int(pop.hypers.lr.shape[0])


def stack_states(states: Sequence[AgentState]) -> AgentState:
    """P member states -> one state with a leading [P] on every tensor; the
    host mirrors are the first's (members share a schedule)."""
    cols = zip(*(tree_tensors(s) for s in states))
    return tree_refill(states[0], (torch.stack(c) for c in cols))


def member_state(agents: AgentState, i: int) -> AgentState:
    """Member ``i`` of stacked agents (views of the stacked tensors)."""
    return tree_refill(agents, (x[i] for x in tree_tensors(agents)))


def gather_members(tree, index: torch.Tensor):
    """``tree`` (stacked agents or hypers) with every tensor's member axis
    reordered by ``index`` [P] (one ``index_select`` per leaf)."""
    return tree_refill(tree, (x.index_select(0, index)
                              for x in tree_tensors(tree)))


def hypers_row(hypers: MemberHypers, i: int) -> MemberHypers:
    """Member ``i``'s hyperparameters as 0-d tensors (what ``RolloutDriver.
    run(hypers=)`` takes)."""
    return MemberHypers(*(x[i] for x in hypers))


def default_hypers(adef: AgentDef, n_members: int) -> MemberHypers:
    """Every member at the def's own settings (gain 0 = uniform
    exploration, tau 0 = the def's unmodified exit mask)."""
    def f(v):
        return torch.full((n_members,), v, dtype=torch.float32,
                          device=adef.device)
    return MemberHypers(lr=f(adef.lr), explore_gain=f(0.0), exit_tau=f(0.0))


def sample_hypers(generator: Optional[torch.Generator], n_members: int, *,
                  lr_range=LR_RANGE, gain_range=GAIN_RANGE,
                  tau_range=TAU_RANGE, uniforms=None,
                  device=None) -> MemberHypers:
    """Independent uniform draws per member (log-uniform for lr): three [P]
    uniforms in [0, 1) (lr, gain, tau) from ``generator``, or given as
    ``uniforms`` (the seam the tests feed with the reference's), on
    ``device`` (default the generator's)."""
    if device is None:
        device = generator.device if generator is not None else "cpu"
    dev = torch.device(device)
    if uniforms is None:
        uniforms = [torch.rand((n_members,), generator=generator,
                               device=dev) for _ in range(3)]
    u_lr, u_gain, u_tau = (torch.as_tensor(u, dtype=torch.float32,
                                           device=dev) for u in uniforms)

    def scaled(u, lo, hi):
        # the reference's uniform(minval, maxval): max(lo, u*(hi-lo) + lo)
        # in float32
        lo, hi = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                  for x in (lo, hi))
        return torch.maximum(lo, u * (hi - lo) + lo)

    log_lo, log_hi = torch.log(torch.tensor(lr_range, dtype=torch.float32,
                                            device=dev))
    return MemberHypers(lr=torch.exp(scaled(u_lr, log_lo, log_hi)),
                        explore_gain=scaled(u_gain, *gain_range),
                        exit_tau=scaled(u_tau, *tau_range))


def exit_mask_from_tau(adef: AgentDef, tau) -> torch.Tensor:
    """[N*L] exit-mask data for one member's accuracy floor ``tau`` (a
    float or a 0-d tensor; read on the device, no host copy).

    Exits whose profile accuracy ``exit_acc[l]`` falls below ``tau`` are
    masked off; the final exit always stays allowed (a member must be able
    to serve every task), and the def's own static mask still applies —
    with ``early_exit=False`` tau changes nothing.
    """
    env = adef.env
    acc = env.params.exit_acc                            # [L]
    tau = torch.as_tensor(tau, dtype=torch.float32, device=acc.device)
    allow = (acc >= tau).to(torch.float32)
    allow[env.L - 1] = 1.0
    return adef.exit_mask() * allow.repeat(env.N)


def init_population(adef: AgentDef, seed: Seed, n_members: int,
                    hypers: Optional[MemberHypers] = None) -> Population:
    """Fresh P-member population: member i's params drawn by ``adef.init``
    from a generator seeded with ``member_seed(seed, i)``, so growing the
    population never perturbs existing members. ``hypers`` defaults to
    every member at the def's own settings — pass ``sample_hypers`` draws
    for a PBT search population."""
    agents = stack_states([adef.init(torch.Generator(device=adef.device)
                                     .manual_seed(member_seed(seed, i)))
                           for i in range(n_members)])
    return Population(
        agents=agents,
        hypers=hypers if hypers is not None else
        default_hypers(adef, n_members),
        generation=torch.zeros((), dtype=torch.int32, device=adef.device))


class PopulationDriver:
    """One generation for P members through one ``RolloutDriver``.

    ``drv`` (``train=True``, labelled ``pop_episode``) runs every member's
    training episode: one scan episode built and, on the card, two graphs
    captured per driver, however many members and generations. The
    evaluation driver (``train=False``, ``pop_eval``: one episode, one
    graph) is built at the first ``evaluate``. ``mesh`` splits the member
    axis over the ranks of a ``fleet`` mesh ("auto": ``fleet_mesh()``,
    None on one rank).
    """

    def __init__(self, adef: AgentDef, *, n_fleets: int = 1,
                 n_slots: int = 100, mesh="auto",
                 replay_capacity: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 train_every: Optional[int] = None):
        self.drv = RolloutDriver(adef, n_fleets=n_fleets, train=True,
                                 replay_capacity=replay_capacity,
                                 batch_size=batch_size,
                                 train_every=train_every,
                                 device=adef.device)
        self.drv.label = "pop_episode"
        self.adef = self.drv.adef
        self.device = self.adef.device
        self.n_fleets = n_fleets
        self.n_slots = int(n_slots)
        self.mesh = fleet_mesh() if mesh == "auto" else mesh
        self._eval_drv: Optional[RolloutDriver] = None

    def tracked_programs(self) -> dict:
        """The drivers a compile guard should track, by label."""
        progs = {"pop_episode": self.drv}
        if self._eval_drv is not None:
            progs["pop_eval"] = self._eval_drv
        return progs

    @property
    def eval_driver(self) -> RolloutDriver:
        if self._eval_drv is None:
            self._eval_drv = RolloutDriver(self.adef, n_fleets=self.n_fleets,
                                           train=False, device=self.device)
            self._eval_drv.label = "pop_eval"
        return self._eval_drv

    def _members(self, drv: RolloutDriver, pop: Population, seed: Seed,
                 sp_of, draws, mode: str):
        """Run this rank's members' episodes on ``drv`` (every member
        without a mesh): ([final carries], [traces])."""
        n = n_members(pop)
        if draws is not None and len(draws) != n:
            raise ValueError(f"{len(draws)} draws for {n} members")
        if n % mesh_size(self.mesh):
            raise ValueError(
                f"population size {n} not divisible by "
                f"{mesh_size(self.mesh)} devices (padding would distort PBT "
                f"ranks)")
        carries, traces = [], []
        mine = local_slice(n, self.mesh)
        for i in range(mine.start, mine.stop):
            agent = member_state(pop.agents, i)
            agent = agent._replace(exit_mask=exit_mask_from_tau(
                self.adef, pop.hypers.exit_tau[i]))
            carry, trace = drv.run(member_seed(seed, i), self.n_slots,
                                   mode=mode, agent_state=agent, sp=sp_of(i),
                                   hypers=hypers_row(pop.hypers, i),
                                   draws=None if draws is None else draws[i])
            carries.append(carry)
            traces.append(trace)
        return carries, traces

    def _metrics(self, carries) -> dict:
        """The members' ``metrics_finalize`` dicts as one of [P] tensors,
        every rank's in member order."""
        mets = [metrics_finalize(c.metrics,
                                 slot_s=float(self.adef.env.cfg.slot_s),
                                 n_fleets=self.n_fleets) for c in carries]
        return gather_leading({k: torch.stack([m[k] for m in mets])
                               for k in mets[0]}, self.mesh)

    def run_generation(self, pop: Population, seed: Seed,
                       sps: ScenarioParams, *,
                       draws: Optional[Sequence[SlotDraws]] = None,
                       mode: str = "scan", traces: bool = False):
        """One training generation for the whole population.

        ``sps`` is a [P]-leading ``ScenarioParams`` (one scenario per
        member, shared by its fleets: the curriculum's draws); member i's
        stream is ``member_seed(seed, i)``. Returns ``(pop with trained
        agents, metrics dict of [P] tensors)``, and with ``traces`` each
        member's ``RolloutTrace`` third; the generation counter is the
        caller's (PBT advances it).
        """
        carries, member_traces = self._members(
            self.drv, pop, seed,
            lambda i: ScenarioParams(*(x[i] for x in sps)), draws, mode)
        agents = gather_leading(stack_states([c.agent_state
                                              for c in carries]), self.mesh)
        out = pop._replace(agents=agents), self._metrics(carries)
        if not traces:
            return out
        if self.mesh is not None:
            stacked = gather_leading(
                type(member_traces[0])(*map(torch.stack,
                                            zip(*member_traces))), self.mesh)
            member_traces = [member_state(stacked, i)
                             for i in range(n_members(pop))]
        return out + (member_traces,)

    def evaluate(self, pop: Population, seed: Seed, sp: ScenarioParams, *,
                 n_slots: Optional[int] = None,
                 draws: Optional[Sequence[SlotDraws]] = None,
                 mode: str = "scan") -> dict:
        """Score every member on one shared scenario ``sp`` (unbatched),
        training off, so scores are directly comparable; same seed => same
        scores. Returns the ``metrics_finalize`` dict of [P] tensors."""
        if n_slots is not None and n_slots != self.n_slots:
            raise ValueError("evaluate shares the driver's n_slots; build "
                             "a second PopulationDriver for other lengths")
        carries, _ = self._members(self.eval_driver, pop, seed,
                                   lambda i: sp, draws, mode)
        return self._metrics(carries)
