"""Fig 6: scenario 'fig6_capacity' — GRLE vs GRL vs DROOE vs DROO.

Counterpart of ``benchmarks/vary_capacity.py``. Sweeps the number of IoT
devices M at the slot length τ = 30 ms, reporting average inference
accuracy, service success probability and throughput (§VI-D
definitions), and saves the rows as
``results/torch_vary_capacity.json``.

    PYTHONPATH=src python -m repro_torch.figures --only vary_capacity [--quick]
"""
from __future__ import annotations

from repro_torch.figures.common import figure_run

SCENARIO = "fig6_capacity"
# Figs 6–8 keep τ = 30 ms; only Fig 5 sweeps it (``vary_devices``)
TAUS_MS = (30.0,)


def run(quick: bool = False, *, device=None, log=print) -> list:
    return figure_run("vary_capacity", SCENARIO, TAUS_MS, quick, device=device,
                      log=log)
