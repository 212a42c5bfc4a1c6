"""Pack same-shape cells into one episode program — across scenarios.

Counterpart of ``repro/sweep/packer.py``. Two cells can share one
compiled episode iff their *structure* agrees: the MEC network shape
(device/server/exit counts), the workload family and slot length
(``MECConfig.static_signature()``), the actor param structure (gcn vs
mlp), and the run shape (slots, fleets, replay, batch, cadence).
Everything numeric — scenario knobs (``ScenarioParams``), seeds, exit
masks (GRLE vs GRL, DROOE vs DROO), params — is data.

So the pack key is (actor family, static/shape signature) only: a full
4-method x S-seed x K-scenario grid packs into **2** packs (one per actor
family, 2·S·K cells each), whose cells replay one driver's two captured
slot graphs. Scenarios that change structure (different ``n_devices``,
``workload`` family, slot length) still split, as they must. The packs
equal the reference's for any grid.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

from repro_torch.core.policy import actor_family
from repro_torch.mec.scenarios import (is_space_scenario, make_scenario,
                                       parse_space_scenario)
from repro_torch.sweep.spec import Cell


class Pack(NamedTuple):
    """Cells that execute together through one episode program.

    ``cells`` is the cell axis, in deterministic (scenario, method, seed)
    order — the runner runs them in exactly this order.
    """
    family: str              # "gcn" | "mlp"
    cells: Tuple[Cell, ...]

    @property
    def scenarios(self) -> Tuple[str, ...]:
        """Distinct member scenarios, in first-appearance order."""
        return tuple(dict.fromkeys(c.scenario for c in self.cells))

    def label(self) -> str:
        names = self.scenarios
        shown = "+".join(names[:3]) + ("+…" if len(names) > 3 else "")
        return f"{shown}/{self.family}[{len(self.cells)}]"


def cell_config(cell: Cell):
    """The cell's ``MECConfig``: its named scenario's, or for a ``space:``
    draw its lo corner's (``resolve_scenario``'s config, without drawing
    the knobs)."""
    name = cell.scenario
    if is_space_scenario(name):
        name = parse_space_scenario(name)[0]
    return make_scenario(name, n_devices=cell.n_devices,
                         slot_ms=cell.slot_ms, **dict(cell.overrides))


def _shape_sig(cell: Cell):
    """Everything that must match for cells to share an episode program.

    Combines the run shape (cell fields) with the scenario's static
    structure (``MECConfig.static_signature()``: counts, workload family,
    early-exit flag, slot length) — numeric knobs are deliberately absent,
    they travel as ``ScenarioParams`` data. ``space:`` draw cells resolve
    to their lo corner's structure, so a whole draw axis shares one pack
    per actor family.
    """
    return (actor_family(cell.method), cell.n_slots, cell.n_fleets,
            cell.replay_capacity, cell.batch_size, cell.train_every,
            cell_config(cell).static_signature())


def pack_cells(cells, *, split_scenarios: bool = False) -> list:
    """Group cells by shape signature, preserving deterministic order.

    Pack membership depends only on the full grid — never on which cells
    already have stored results — so a resumed sweep re-packs identically.
    ``split_scenarios=True`` restores the per-scenario grouping (one pack
    per scenario per family).
    """
    groups: dict = {}
    for cell in cells:
        sig = _shape_sig(cell)
        if split_scenarios:
            sig = (cell.scenario,) + sig
        groups.setdefault(sig, []).append(cell)
    packs = []
    for sig in sorted(groups, key=str):
        members = sorted(groups[sig], key=lambda c: (c.scenario, c.method,
                                                     c.seed))
        packs.append(Pack(family=actor_family(members[0].method),
                          cells=tuple(members)))
    return packs
