"""Experiment sweeps (PyTorch port): (scenario x method x seed) grids in
one launch.

Counterpart of ``repro/sweep/``. The paper's headline numbers are
comparative (Figs 5-8: GRLE vs GRL / DROOE / DROO across dynamic
scenarios); this subsystem turns those comparisons into one command.
Five layers:

  spec    — declarative grid (scenarios x methods x seeds + overrides)
            expanded into hashed Cells (the reference's hashes)
  packer  — groups same-shape cells into packs; scenarios are data
            (ScenarioParams), so cells pack *across* scenarios and a whole
            4-method x S-seed x K-scenario grid is one pack per actor
            family
  runner  — runs each pack's cells through one RolloutDriver, replaying
            the same two captured CUDA graphs cell after cell
  store   — resumable on-disk results keyed by cell hash; finished cells
            are never recomputed or rewritten; rows carry their backend
  report  — per-scenario aggregation over seeds + GRLE-vs-baseline
            ratios in the style of the paper's Fig 5-8 / Table VI

Units: ``slot_ms`` is milliseconds; everything inside the simulator is
seconds/bits/bps; result rows report fractions (ssp, accuracies) and
tasks-per-second (``throughput_tps``, per fleet).
"""
from repro_torch.sweep.spec import Cell, SweepSpec, cell_keys, cell_seeds
from repro_torch.sweep.packer import Pack, pack_cells
from repro_torch.sweep.runner import (PackProgram, run_cell, run_pack,
                                      run_sweep)
from repro_torch.sweep.store import ForeignRowError, SweepStore
from repro_torch.sweep.report import (build_report, format_markdown,
                                      format_telemetry, write_report)

__all__ = [
    "Cell", "SweepSpec", "cell_keys",
    "Pack", "pack_cells",
    "run_cell", "run_pack", "run_sweep",
    "SweepStore",
    "build_report", "format_markdown", "format_telemetry", "write_report",
]
