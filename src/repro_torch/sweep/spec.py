"""Declarative sweep grids and their expansion into hashed cells.

Counterpart of ``repro/sweep/spec.py``. A ``SweepSpec`` is the
experiment section of the paper as data: which scenarios (figure
columns), which methods (table rows), how many seeds (error bars), plus
the run-shape knobs every cell shares. ``expand()`` produces one ``Cell``
per grid point; ``cell_hash`` canonically hashes everything that can
change a cell's numbers, which keys the resumable result store (same
hash => same result, safe to reuse). The hash is the reference's, so a
port store and a reference store line up cell by cell.

Seeds: the reference derives a cell's two streams from threefry keys,
which torch cannot reproduce. ``cell_seeds`` derives two 63-bit ints
from ``SeedSequence([seed, 1])`` and ``[seed, 2]`` instead, with the
same sharing: every method of a seed gets the same pair.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import NamedTuple, Tuple

import numpy as np

from repro_torch.mec.scenarios import (SCENARIOS, is_space_scenario,
                                       parse_space_scenario,
                                       space_scenario_name)


class Cell(NamedTuple):
    """One grid point. ``overrides`` is a sorted (key, value) tuple so
    cells stay hashable.

    Units/shape: ``slot_ms`` is milliseconds (converted to seconds at
    env construction — everything inside the simulator is s/bits/bps);
    ``n_devices`` is M, ``n_fleets`` the driver's fleet axis B,
    ``n_slots`` the episode length T. A cell's execution position (which
    pack, which index) never affects its numbers — seeds come from
    ``cell_seeds`` alone."""
    scenario: str
    method: str
    seed: int
    n_devices: int
    slot_ms: float
    n_slots: int
    n_fleets: int
    replay_capacity: int
    batch_size: int
    train_every: int
    overrides: Tuple[Tuple[str, object], ...] = ()

    @property
    def cell_hash(self) -> str:
        payload = json.dumps(self._asdict(), sort_keys=True, default=str)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def label(self) -> str:
        return f"{self.scenario}/{self.method}/s{self.seed}"


def seed_of(entropy) -> int:
    """A 63-bit torch seed from an int or a sequence of ints, by
    ``numpy.random.SeedSequence``: the port's derivation of every
    sub-stream (cells here, population members and generations in
    ``pop/``), where the reference folds keys."""
    if isinstance(entropy, (int, np.integer)):
        entropy = [int(entropy)]
    state = np.random.SeedSequence([int(e) for e in entropy]
                                   ).generate_state(2)
    return (int(state[0]) | int(state[1]) << 32) & (2 ** 63 - 1)


def cell_seeds(cell: Cell):
    """(params_seed, run_seed) for a cell — THE seed derivation.

    ``params_seed`` seeds the generator the initial ``AgentState`` is
    drawn from, ``run_seed`` the episode's (the driver's own generator).
    Both the packed runner and the sequential reference path use this, so
    a cell's numbers are independent of how it was executed (packed vs
    per-cell, resumed vs fresh). Methods share the same pair per seed
    (paired-seed comparisons, as in the paper's per-figure ablations).
    """
    return seed_of([int(cell.seed), 1]), seed_of([int(cell.seed), 2])


# the reference's name for the derivation (its keys are threefry keys)
cell_keys = cell_seeds


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """The grid: scenarios x methods x seeds, plus shared run shape."""
    scenarios: Tuple[str, ...]
    methods: Tuple[str, ...] = ("grle", "grl", "drooe", "droo")
    seeds: Tuple[int, ...] = (0,)
    n_devices: int = 14
    slot_ms: float = 30.0
    n_slots: int = 300
    n_fleets: int = 1
    replay_capacity: int = 128
    batch_size: int = 64
    train_every: int = 10
    overrides: Tuple[Tuple[str, object], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "scenarios", tuple(self.scenarios))
        object.__setattr__(self, "methods",
                           tuple(m.lower() for m in self.methods))
        object.__setattr__(self, "seeds", tuple(int(s) for s in self.seeds))
        object.__setattr__(self, "overrides",
                           tuple(sorted(tuple(self.overrides))))
        unknown = [s for s in self.scenarios
                   if s not in SCENARIOS and not is_space_scenario(s)]
        if unknown:
            raise ValueError(f"unknown scenarios {unknown}; "
                             f"known: {sorted(SCENARIOS)}")
        for s in self.scenarios:
            if is_space_scenario(s):
                parse_space_scenario(s)  # raises on malformed names

    @classmethod
    def from_names(cls, scenarios: str, methods: str, seeds, **kw):
        """CLI-friendly constructor: comma-separated names, int seed count."""
        if isinstance(seeds, int):
            seeds = tuple(range(seeds))
        return cls(scenarios=tuple(s for s in scenarios.split(",") if s),
                   methods=tuple(m for m in methods.split(",") if m),
                   seeds=tuple(seeds), **kw)

    @classmethod
    def from_space(cls, lo: str, hi: str, draws: int, *,
                   space_seed: int = 0, **kw):
        """A grid whose scenario axis is ``draws`` deterministic samples
        from the (lo, hi) ``ScenarioSpace``.

        Each draw becomes a ``space:<lo>:<hi>:<draw>:<seed>`` scenario
        column: cells stay plain hashable tuples (the name pins the
        draw), so hashes are stable, stores resume, and — since every
        draw shares the lo corner's static structure — the whole axis
        still packs into one episode per actor family.
        """
        return cls(scenarios=tuple(
            space_scenario_name(lo, hi, d, space_seed)
            for d in range(int(draws))), **kw)

    def expand(self) -> list:
        """Grid -> cells, in deterministic (scenario, method, seed) order."""
        return [
            Cell(scenario=sc, method=me, seed=se, n_devices=self.n_devices,
                 slot_ms=self.slot_ms, n_slots=self.n_slots,
                 n_fleets=self.n_fleets,
                 replay_capacity=self.replay_capacity,
                 batch_size=self.batch_size, train_every=self.train_every,
                 overrides=self.overrides)
            for sc in self.scenarios
            for me in self.methods
            for se in self.seeds
        ]
