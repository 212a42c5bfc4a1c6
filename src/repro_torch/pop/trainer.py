"""The population generation loop: rollout -> rank -> exploit/explore ->
curriculum resample, checkpointable between any two generations.

Counterpart of ``repro/pop/trainer.py``. ``PopulationTrainer`` owns the
static pieces (driver, PBT config, curriculum, telemetry/history sinks);
everything mutable lives in ``PopTrainState`` — the ``Population``
(including its generation counter) plus the ``CurriculumState`` — which
round-trips through ``train.checkpoint.save_population`` bit for bit.

Determinism contract: every random draw of generation g comes from a
generator seeded by ``SeedSequence([seed, tag, g])`` (tag 1 the
curriculum's draws, 3 PBT's), and member i's episode stream by
``[seed, 2, g, i]``, with g read *from the state*, as
``sweep/spec.py::cell_seeds`` derives its seeds; the initial population
draws from ``[seed, 0]`` (hyperparameters) and ``[seed, 0, 0, i]``
(member i's params). So restoring a checkpoint and continuing reproduces
the uninterrupted run exactly. Every draw can also be injected
(``GenerationDraws``), the seam the tests feed with the reference's.

A generation runs one driver's graphs for every member: ``CompileTracker``
reads one episode built and two graphs captured for ``pop_episode`` on the
card, whatever P (``tracked_programs``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.policy import AgentDef
from repro_torch.mec.scenarios import interpolate_params
from repro_torch.obs.telemetry import pop_telemetry, pop_telemetry_update
from repro_torch.pop.curriculum import Curriculum, CurriculumState
from repro_torch.pop.pbt import PBTConfig, PBTDraws, pbt_update
from repro_torch.pop.population import (Population, PopulationDriver,
                                        generator_of, init_population,
                                        sample_hypers)
from repro_torch.rollout.driver import SlotDraws
from repro_torch.sharding.fleet import is_lead


class PopTrainState(NamedTuple):
    """Everything mutable across generations, as one checkpointable
    tuple."""
    pop: Population
    cur: CurriculumState


class GenerationDraws(NamedTuple):
    """Injected draws of one generation (each None: the trainer's own):
    the curriculum's ``region`` [P] and ``offset`` [P], one ``SlotDraws``
    per member, and the PBT step's ``PBTDraws``."""
    region: Optional[torch.Tensor] = None
    offset: Optional[torch.Tensor] = None
    members: Optional[Sequence[SlotDraws]] = None
    pbt: Optional[PBTDraws] = None


class GenerationDetail(NamedTuple):
    """What ``generation(..., detail=True)`` also returns: the curriculum's
    draw, the members' metrics ([P] tensors) and traces, and the PBT
    step's ``PBTStats`` (None on generations without one)."""
    region: torch.Tensor
    sps: object
    metrics: dict
    traces: list
    stats: Optional[object]


class PopulationTrainer:
    """Runs PBT generations for P members over a scenario curriculum.

    ``curriculum.uniform=True`` turns the same trainer into the
    domain-randomized control arm. ``telemetry=True`` attaches a
    ``pop_telemetry`` registry (member-rank / region-visitation
    histograms, exploit counters); ``history`` (an
    ``obs.history.HistoryStore``) gets one ``pop`` record per generation,
    from rank 0 only. Runs on the agent def's device; ``mesh`` splits the
    members over the ranks of a ``fleet`` mesh (``PopulationDriver``).
    """

    def __init__(self, adef: AgentDef, curriculum: Curriculum, *,
                 n_members: int = 8, n_fleets: int = 1, n_slots: int = 60,
                 pbt: PBTConfig = PBTConfig(), pbt_every: int = 1,
                 seed: int = 0, mesh="auto",
                 replay_capacity: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 train_every: Optional[int] = None,
                 telemetry: bool = False, history=None,
                 history_name: str = "pop_train"):
        self.driver = PopulationDriver(
            adef, n_fleets=n_fleets, n_slots=n_slots, mesh=mesh,
            replay_capacity=replay_capacity, batch_size=batch_size,
            train_every=train_every)
        self.mesh = self.driver.mesh
        self.adef = self.driver.adef
        self.device = self.adef.device
        self.curriculum = curriculum
        self.pbt_cfg = pbt
        self.pbt_every = int(pbt_every)
        self.n_members = int(n_members)
        self.seed = int(seed)
        self.telemetry = (pop_telemetry(self.n_members, curriculum.n_regions,
                                        device=self.device)
                          if telemetry else None)
        self.history = history
        self.history_name = history_name

    def tracked_programs(self) -> dict:
        """The drivers one generation (and ``evaluate``) runs, by label —
        what the compile guard asserts stays one episode each as P
        grows."""
        return self.driver.tracked_programs()

    # ----------------------------------------------------------------- state
    def init_state(self, *, sampled_hypers: bool = True) -> PopTrainState:
        """Fresh population (+ sampled per-member hyperparameters unless
        ``sampled_hypers=False``) and a blank curriculum."""
        hyp = (sample_hypers(generator_of((self.seed, 0), self.device),
                             self.n_members)
               if sampled_hypers else None)
        pop = init_population(self.adef, (self.seed, 0, 0), self.n_members,
                              hyp)
        return PopTrainState(pop=pop, cur=self.curriculum.init_state())

    def _generator(self, tag: int, generation: int) -> torch.Generator:
        return generator_of((self.seed, tag, generation), self.device)

    # ------------------------------------------------------------ generation
    def generation(self, ts: PopTrainState, *,
                   draws: Optional[GenerationDraws] = None,
                   detail: bool = False):
        """One full generation; returns ``(new state, report dict)``, and
        with ``detail`` a ``GenerationDetail`` third.

        resample -> rollout (train) -> rank by device-resident
        ``avg_reward`` -> curriculum update -> PBT exploit/explore (every
        ``pbt_every`` generations). All draws derive from the state's
        generation counter, so the loop is resumable mid-stream.
        """
        draws = draws or GenerationDraws()
        g = int(ts.pop.generation)
        region, sps = self.curriculum.resample(
            ts.cur, self._generator(1, g), self.n_members,
            region=draws.region, offset=draws.offset)
        pop, mets, traces = self.driver.run_generation(
            ts.pop, (self.seed, 2, g), sps, draws=draws.members,
            traces=True)
        scores = mets["avg_reward"]
        cur = self.curriculum.update(ts.cur, region, scores)
        stats = None
        if (g + 1) % self.pbt_every == 0:
            pop, stats = pbt_update(pop, scores, self._generator(3, g),
                                    self.pbt_cfg, draws=draws.pbt)
        else:
            pop = pop._replace(generation=pop.generation + 1)

        if self.telemetry is not None:
            self.telemetry = pop_telemetry_update(
                self.telemetry, region=region,
                src_ranks=None if stats is None else stats.ranks[
                    stats.src.to(torch.int64)],
                copied=None if stats is None else stats.copied)
        report = self._report(g, mets, region, stats)
        if self.history is not None and is_lead(self.mesh):
            self.history.append(
                "pop", self.history_name, report["metrics"],
                generation=report["generation"], arm=report["arm"])
        out = PopTrainState(pop=pop, cur=cur), report
        if detail:
            return out + (GenerationDetail(region, sps, mets, traces,
                                           stats),)
        return out

    def train(self, ts: PopTrainState, n_generations: int):
        """Run ``n_generations``; returns ``(state, list of reports)``."""
        reports = []
        for _ in range(n_generations):
            ts, rep = self.generation(ts)
            reports.append(rep)
        return ts, reports

    def evaluate(self, pop: Population, seed, sp, **kw) -> dict:
        """Member scores on one held-out scenario, training off (see
        ``PopulationDriver.evaluate``)."""
        return self.driver.evaluate(pop, seed, sp, **kw)

    # -------------------------------------------------------------- reporting
    def _report(self, generation: int, mets: dict, region, stats) -> dict:
        host = {k: mets[k].cpu().numpy().astype(np.float64)
                for k in ("avg_reward", "ssp", "avg_accuracy")}
        scores = host["avg_reward"]
        best = int(scores.argmax())
        metrics = {
            "mean_reward": float(scores.mean()),
            "best_reward": float(scores[best]),
            "worst_reward": float(scores.min()),
            "mean_ssp": float(host["ssp"].mean()),
            "mean_accuracy": float(host["avg_accuracy"].mean()),
            "exploits": (0.0 if stats is None
                         else float(stats.copied.sum().cpu())),
        }
        return {
            "generation": generation,
            "arm": "dr" if self.curriculum.uniform else "curriculum",
            "best_member": best,
            "region_visits": np.bincount(
                region.cpu().numpy(),
                minlength=self.curriculum.n_regions).tolist(),
            "metrics": metrics,
        }


def compare_curriculum_dr(adef: AgentDef, space, *, n_members: int = 8,
                          n_fleets: int = 2, n_slots: int = 80,
                          generations: int = 6, n_regions: int = 6,
                          temperature: float = 0.3, seed: int = 0,
                          pbt: PBTConfig = PBTConfig(),
                          pbt_every: int = 1,
                          eval_points=(0.8, 0.9, 1.0),
                          eval_seed: int = 7, mesh="auto",
                          replay_capacity: Optional[int] = None,
                          batch_size: Optional[int] = None,
                          train_every: Optional[int] = None) -> dict:
    """Train a curriculum arm and a DR control arm, evaluate both on
    held-out *hard* scenarios (high-t points of the space), paired seeds.

    Both arms share the agent def, population seed, PBT config and every
    evaluation seed (``(eval_seed, i)`` for point i) — the only difference
    is ``Curriculum.uniform`` — so the returned margin isolates the
    curriculum's contribution.
    """
    out = {"eval_points": list(eval_points), "arms": {}}
    for arm, uniform in (("curriculum", False), ("dr", True)):
        cur = Curriculum(space.lo, space.hi, n_regions=n_regions,
                         temperature=temperature, uniform=uniform)
        tr = PopulationTrainer(
            adef, cur, n_members=n_members, n_fleets=n_fleets,
            n_slots=n_slots, pbt=pbt, pbt_every=pbt_every, seed=seed,
            mesh=mesh, replay_capacity=replay_capacity, batch_size=batch_size,
            train_every=train_every)
        ts, reports = tr.train(tr.init_state(), generations)
        evals = []
        for i, t in enumerate(eval_points):
            sp = interpolate_params(space.lo, space.hi, float(t))
            mets = tr.evaluate(ts.pop, (eval_seed, i), sp)
            evals.append(float(mets["avg_reward"].mean()))
        out["arms"][arm] = {
            "eval_rewards": evals,
            "eval_mean": float(np.mean(evals)),
            "final_train": reports[-1]["metrics"],
            "region_visits": np.sum(
                [r["region_visits"] for r in reports], axis=0).tolist(),
        }
    cur_mean = out["arms"]["curriculum"]["eval_mean"]
    dr_mean = out["arms"]["dr"]["eval_mean"]
    out["margin"] = cur_mean - dr_mean
    out["curriculum_wins"] = bool(cur_mean > dr_mean)
    return out


def format_comparison(result: dict) -> str:
    """The curriculum-vs-DR summary table, one line per held-out point."""
    lines = ["arm         " + "".join(f"  t={t:<6g}" for t
                                      in result["eval_points"])
             + "  mean"]
    for arm in ("curriculum", "dr"):
        row = result["arms"][arm]
        lines.append(f"{arm:<12}"
                     + "".join(f"  {v:<8.4f}" for v in row["eval_rewards"])
                     + f"  {row['eval_mean']:.4f}")
    lines.append(f"margin (curriculum - dr): {result['margin']:+.4f}")
    return "\n".join(lines)
