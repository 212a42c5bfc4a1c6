"""Fig 5: scenario 'fig5_baseline' — GRLE vs GRL vs DROOE vs DROO.

Counterpart of ``benchmarks/vary_devices.py``. Sweeps the number of IoT
devices M and the slot length τ, reporting average inference accuracy,
service success probability and throughput (§VI-D definitions), and
saves the rows as ``results/torch_vary_devices.json``.

    PYTHONPATH=src python -m repro_torch.figures --only vary_devices [--quick]
"""
from __future__ import annotations

from repro_torch.figures.common import figure_run

SCENARIO = "fig5_baseline"
# Fig 5 alone sweeps the slot length τ: the reference spells this as
# ``(10.0, 30.0) if "vary_devices" == "vary_devices" else (30.0,)``
TAUS_MS = (10.0, 30.0)


def run(quick: bool = False, *, device=None, log=print) -> list:
    return figure_run("vary_devices", SCENARIO, TAUS_MS, quick, device=device,
                      log=log)
