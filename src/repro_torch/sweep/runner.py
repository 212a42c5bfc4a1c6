"""Execute sweep cells: packed by default, per-cell as reference.

Counterpart of ``repro/sweep/runner.py``. ``PackProgram`` is the pack
path: one template env/``AgentDef``/``RolloutDriver`` per pack (cell 0's
env, the pack's actor family), and for each cell in pack order a fresh
``AgentState`` drawn from a generator seeded with the cell's
``params_seed``, its exit mask swapped in as data, then one
``drv.run(run_seed, T, mode="scan", agent_state=..., sp=...)`` with the
cell's scenario knobs (its ``space:`` draw, or its config's own ones).
The driver's scan episode is keyed by shapes and by its own generator
(an int seed reseeds it), so every cell of a pack replays the same two
captured slot graphs: one episode built and two graphs captured per pack
on the card, however many cells it holds. Where the reference ``vmap``s a
pack's cells into one program, the port loops over them (the actor
kernels take one weight set per launch). Per-cell metrics come from the
driver's device-resident accumulator (``carry_metrics``). With a
``fleet`` mesh (``sharding.fleet.fleet_mesh()``: one rank per card) a
pack's cells are padded to the rank count with ``pad_to_devices``, as the
reference pads them, and split over the ranks in contiguous blocks; each
rank runs its real cells through its own driver, the padding produces no
row and runs nothing, and the rows are all-gathered in cell order, so
every rank returns the whole pack's. Only rank 0 writes the store and the
history.

``run_cell`` is the sequential reference: a fresh ``RolloutDriver`` per
cell, ``sp=None`` for named scenarios, the same seeds — used by the
equivalence tests and as the sequential baseline. Its keyword seams
(``agent_state=``, ``draws=``, ``sp=``) take the reference's initial
state and draws. Units in result rows: accuracies and SSP are fractions
in [0, 1], ``throughput_tps`` is successful tasks per second per fleet,
times are seconds. Every row carries ``backend`` (``"torch-cuda"`` or
``"torch-cpu"``) and ``device_name``.
"""
from __future__ import annotations

import platform
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.policy import (METHOD_SPECS, AgentDef, agent_def,
                                     make_exit_mask)
from repro_torch.device import resolve_device
from repro_torch.mec.config import MECConfig
from repro_torch.mec.env import MECEnv
from repro_torch.mec.scenarios import resolve_scenario
from repro_torch.obs.log import json_safe
from repro_torch.rollout.driver import (RolloutDriver, carry_metrics,
                                        carry_telemetry)
from repro_torch.sharding.fleet import (gather_objects, is_lead,
                                        local_slice, pad_to_devices)
from repro_torch.sweep.packer import Pack, cell_config, pack_cells
from repro_torch.sweep.spec import Cell, SweepSpec, cell_seeds
from repro_torch.sweep.store import SweepStore


def backend_of(device: torch.device) -> str:
    """The ``backend`` a row run on ``device`` carries."""
    return f"torch-{device.type}"


def device_name(device: torch.device) -> str:
    """The card's name, or the host's processor for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return platform.processor() or platform.machine() or "cpu"


def _resolve_cell(cell: Cell, device) -> tuple:
    """(cfg, sp): the cell's ``MECConfig`` plus its sampled
    ``ScenarioParams`` on ``device`` — None for named scenarios (the
    config's own params apply), the deterministic draw for ``space:``
    cells."""
    return resolve_scenario(cell.scenario, device=device,
                            n_devices=cell.n_devices, slot_ms=cell.slot_ms,
                            **dict(cell.overrides))


def _cell_def(cell: Cell, env: MECEnv, *,
              actor: Optional[str] = None) -> AgentDef:
    """The cell's agent spec; ``actor=`` builds the pack-template def
    (family only — per-cell exit masks are swapped in as state data)."""
    kw = dict(buffer_size=cell.replay_capacity, batch_size=cell.batch_size,
              train_every=cell.train_every, device=env.device)
    if actor is not None:
        return AgentDef(env=env, actor=actor, **kw)
    return agent_def(cell.method, env, **kw)


def _param_generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _finish_row(row: dict, cell: Cell, device: torch.device) -> dict:
    row["tasks"] = int(row["tasks"])
    row["train_steps"] = int(row["train_steps"])
    if row["final_loss"] is not None and not np.isfinite(row["final_loss"]):
        row["final_loss"] = None
    row.update(scenario=cell.scenario, method=cell.method, seed=cell.seed,
               cell=cell.cell_hash, backend=backend_of(device),
               device_name=device_name(device))
    return row


def _row(carry, cell: Cell, cfg: MECConfig, device: torch.device,
         telemetry: bool) -> dict:
    row = carry_metrics(carry, slot_s=cfg.slot_s, n_fleets=cell.n_fleets)
    if telemetry:
        row["telemetry"] = json_safe(carry_telemetry(carry))
    return _finish_row(row, cell, device)


# ------------------------------------------------------------------ packed
class PackProgram:
    """One pack's episode program: the template driver (``driver``, whose
    ``label`` is the pack's) and the cells it runs.

    ``run()`` executes every cell in pack order (on a ``mesh``, this rank's
    block of them, then every rank's rows in cell order), ``run_one(i)``
    cell ``i`` alone, in ``mode`` (``"loop"`` for a cost count: a graph replay
    dispatches nothing). In scan mode the first cell builds the episode
    (on the card: warm-up and capture of its two graphs); every later
    one, and a second ``run()``, replays them. ``cell_s`` holds the
    seconds of each cell run so far (host clock; each ends in the
    metrics' host copy).
    """

    def __init__(self, pack: Pack, *, mesh=None, telemetry: bool = False,
                 device=None, mode: str = "scan"):
        self.pack = pack
        self.mode = mode
        self.mesh = mesh
        # this rank's block of the cells padded to the rank count; the
        # padding (past the last cell) runs nothing
        n = len(pack.cells)
        block = local_slice(pad_to_devices(n, mesh), mesh)
        self.mine = range(block.start, min(block.stop, n))
        ref = pack.cells[0]
        self.device = resolve_device(device)
        env = MECEnv(_resolve_cell(ref, self.device)[0], device=self.device)
        adef = _cell_def(ref, env, actor=pack.family)
        self.driver = RolloutDriver(adef, n_fleets=ref.n_fleets,
                                    telemetry=telemetry, device=self.device)
        self.driver.label = pack.label()
        # one exit mask per method: the rule ``agent_def`` applies, on the
        # pack's shared (N, L)
        self._exit_masks = {
            m: make_exit_mask(env.N, env.L, spec["early_exit"],
                              device=self.device)
            for m, spec in METHOD_SPECS.items()}
        self._telemetry = telemetry
        self.cell_s: list = []

    def run_one(self, i: int) -> dict:
        """Cell ``i``'s metrics row (with its telemetry snapshot and
        summary under ``row["telemetry"]`` when the program carries it)."""
        t0 = time.perf_counter()
        cell = self.pack.cells[i]
        drv = self.driver
        cfg, sp = _resolve_cell(cell, self.device)
        params_seed, run_seed = cell_seeds(cell)
        # per-cell exit masks (GRLE vs GRL, DROOE vs DROO) are AgentState
        # data — methods of one family differ only by state
        state = drv.adef.init(_param_generator(self.device, params_seed))
        state = state._replace(
            exit_mask=self._exit_masks[cell.method.lower()])
        # always an sp (the draw, or the config's own knobs): the episode
        # is keyed by sp's shapes, so every cell replays the same graphs
        carry, _ = drv.run(run_seed, cell.n_slots, mode=self.mode,
                           agent_state=state,
                           sp=cfg.scenario_params(self.device)
                           if sp is None else sp)
        row = _row(carry, cell, cfg, self.device, self._telemetry)
        self.cell_s.append(time.perf_counter() - t0)
        return row

    def run(self) -> list:
        """Execute the pack; one metrics row per cell, in pack order (on a
        mesh every rank's, gathered)."""
        return gather_objects([self.run_one(i) for i in self.mine],
                              self.mesh)


def run_pack(pack: Pack, *, mesh=None, telemetry: bool = False,
             device=None) -> list:
    """Run every cell of a pack through one episode program (on ``mesh``,
    the cells split over its ranks).

    Returns one metrics row per cell, in pack order. ``telemetry=True``
    attaches each cell's registry snapshot + summary under
    ``row["telemetry"]`` (JSON-safe).
    """
    return PackProgram(pack, mesh=mesh, telemetry=telemetry,
                       device=device).run()


# -------------------------------------------------------------- sequential
def _run_cell(cell: Cell, *, telemetry: bool = False, device=None,
              agent_state=None, draws=None, sp=None):
    """``run_cell``'s work: (row, final carry, trace)."""
    dev = resolve_device(device)
    cfg, cell_sp = _resolve_cell(cell, dev)
    env = MECEnv(cfg, device=dev)
    params_seed, run_seed = cell_seeds(cell)
    adef = _cell_def(cell, env)
    drv = RolloutDriver(adef, n_fleets=cell.n_fleets, telemetry=telemetry,
                        device=env.device)
    if agent_state is None:
        agent_state = adef.init(_param_generator(env.device, params_seed))
    # sp is None for named scenarios (the env's own knobs); a space
    # cell's draw rides in as data shared across fleets
    carry, trace = drv.run(run_seed, cell.n_slots, mode="scan",
                           agent_state=agent_state, draws=draws,
                           sp=cell_sp if sp is None else sp)
    return _row(carry, cell, cfg, dev, telemetry), carry, trace


def run_cell(cell: Cell, *, telemetry: bool = False, device=None,
             agent_state=None, draws=None, sp=None) -> dict:
    """One cell through a fresh ``RolloutDriver`` (reference/baseline).

    The seams default to the cell's own: ``agent_state`` to a fresh
    ``init`` from its ``params_seed``, ``draws`` (a ``SlotDraws``) to the
    driver's generator seeded with its ``run_seed``, ``sp`` to its
    scenario's (None for a named one).
    """
    return _run_cell(cell, telemetry=telemetry, device=device,
                     agent_state=agent_state, draws=draws, sp=sp)[0]


# ------------------------------------------------------------------- sweep
def run_sweep(spec: SweepSpec, *, store: Optional[SweepStore] = None,
              mesh=None, packed: bool = True, log=print,
              telemetry: bool = False, history=None, device=None) -> list:
    """Run the whole grid; returns rows in ``spec.expand()`` order.

    With a store, finished cells are loaded instead of recomputed and
    never rewritten; a stored row of another backend (or the
    reference's) is an error naming the store, never a finished cell.
    The execution unit is the *pack*: a pack runs iff any member cell is
    missing (pack composition depends only on the grid, so a resumed
    sweep recomputes missing cells in the same program it would have run
    the first time), and only its missing cells are stored. After each
    pack that ran, ``log`` gets its cells, wall seconds, the first
    cell's seconds (the episode's build and capture included) and the
    others' ms per slot per cell.

    ``history`` (a ``repro_torch.obs.HistoryStore``) appends one
    manifest-stamped ``sweep`` record per *executed* cell — cached rows
    were recorded by the run that produced them.

    With a ``fleet`` ``mesh`` each pack's cells (or, ``packed=False``,
    its missing cells) are split over the ranks and every rank returns
    every row; which cells are missing is read from the store before any
    pack runs, and only rank 0 logs, writes the store and appends to the
    history.
    """
    dev = resolve_device(device)
    backend = backend_of(dev)
    cells = spec.expand()
    packs = pack_cells(cells)
    lead = is_lead(mesh)
    if not lead:
        log = _quiet
    stored = {c for c in cells if store is not None and store.has(c)}
    results: dict = {}
    for pack in packs:
        missing = [c for c in pack.cells if c not in stored]
        for c in pack.cells:
            if c not in missing:
                results[c] = store.load(c, backend=backend)
        if not missing:
            log(f"  [sweep] {pack.label()}: all "
                f"{len(pack.cells)} cells cached")
            continue
        log(f"  [sweep] {pack.label()}: running "
            f"({len(pack.cells) - len(missing)} cached)")
        t0 = time.perf_counter()
        kw = {"device": dev}
        if telemetry:
            kw["telemetry"] = True
        if packed:
            # the whole pack runs (one episode program), but cached cells
            # keep their stored rows — never recomputed results
            prog = PackProgram(pack, mesh=mesh, **kw)
            rows = prog.run()
            cell_s = prog.cell_s
            del prog            # free its graphs before the next pack's
            pairs = [(c, row) for c, row in zip(pack.cells, rows)
                     if c in missing]
        else:
            # per-cell runs are independent: execute only the missing ones
            # (on a mesh, this rank's block of them)
            block = local_slice(pad_to_devices(len(missing), mesh), mesh)
            rows, cell_s = [], []
            for c in missing[block.start:block.stop]:
                t1 = time.perf_counter()
                rows.append(run_cell(c, **kw))
                cell_s.append(time.perf_counter() - t1)
            pairs = list(zip(missing, gather_objects(rows, mesh)))
        wall = time.perf_counter() - t0
        rest = (f", then {sum(cell_s[1:]) / (len(cell_s) - 1) / pack.cells[0].n_slots * 1e3:.4f}"
                f" ms a slot per cell" if len(cell_s) > 1 else "")
        if cell_s:
            log(f"  [sweep] {pack.label()}: ran {len(cell_s)} cells in "
                f"{wall:.4f} s (first {cell_s[0]:.4f} s with its build"
                f"{rest})" + (f" on rank 0 of {mesh.size()}"
                              if mesh is not None else ""))
        for c, row in pairs:
            results[c] = row
            if store is not None and lead:
                store.save(c, row)
            if history is not None and lead:
                _append_history(history, c, row, device=dev)
    return [results[c] for c in cells]


def _quiet(msg: str) -> None:
    """The log of ranks other than 0."""


def _append_history(history, cell: Cell, row: dict, *,
                    device: torch.device) -> dict:
    """One ``sweep`` history record for an executed cell's row."""
    from repro_torch.obs.history import history_manifest

    metrics = {k: v for k, v in row.items()
               if k != "seed"  # label (already in the record name)
               and isinstance(v, (int, float)) and not isinstance(v, bool)
               and np.isfinite(v)}
    tel = row.get("telemetry") or {}
    for k, v in (tel.get("summary") or {}).items():
        if isinstance(v, (int, float)) and not isinstance(v, bool) \
                and np.isfinite(v):
            metrics[f"tel_{k}"] = v
    return history.append(
        "sweep", f"{cell.scenario}/{cell.method}/s{cell.seed}", metrics,
        manifest=history_manifest(
            config_signature=cell_config(cell).static_signature(),
            use_pallas=device.type == "cuda", backend=device.type),
        cell=cell.cell_hash, n_slots=cell.n_slots)
