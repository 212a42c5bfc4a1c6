"""Fig 8: scenario 'fig8_csi' — GRLE vs GRL vs DROOE vs DROO.

Counterpart of ``benchmarks/imperfect_csi.py``. Sweeps the number of IoT
devices M at the slot length τ = 30 ms, reporting average inference
accuracy, service success probability and throughput (§VI-D
definitions), and saves the rows as
``results/torch_imperfect_csi.json``.

    PYTHONPATH=src python -m repro_torch.figures --only imperfect_csi [--quick]
"""
from __future__ import annotations

from repro_torch.figures.common import figure_run

SCENARIO = "fig8_csi"
# Figs 6–8 keep τ = 30 ms; only Fig 5 sweeps it (``vary_devices``)
TAUS_MS = (30.0,)


def run(quick: bool = False, *, device=None, log=print) -> list:
    return figure_run("imperfect_csi", SCENARIO, TAUS_MS, quick, device=device,
                      log=log)
