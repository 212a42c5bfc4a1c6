"""Named experiment scenarios — one per paper figure (§VI-D).

Counterpart of ``repro/mec/scenarios.py`` (named scenarios only; the
scenario spaces come later). The ``dyn_*`` entries with a ``poisson`` or
``mmpp`` workload run through ``rollout/workloads.py`` (the serving
engines and the load generator); ``RolloutDriver`` still takes ``iid``
scenarios only.
"""
from __future__ import annotations

from repro_torch.mec.config import MECConfig


def make_scenario(name: str, *, n_devices: int = 14, slot_ms: float = 30.0,
                  early_exit: bool = True, **overrides) -> MECConfig:
    base = dict(n_devices=n_devices, slot_s=slot_ms * 1e-3, early_exit=early_exit)
    base.update(SCENARIOS[name])
    base.update(overrides)
    return MECConfig(**base)


# Fig 5: ideal ESs. Fig 6: stochastic capacity 25..100%. Fig 7: + ±25%
# inference-time jitter. Fig 8: + ±20% CSI error.
SCENARIOS = {
    "fig5_baseline": dict(),
    "fig6_capacity": dict(capacity_range=(0.25, 1.0)),
    "fig7_jitter": dict(capacity_range=(0.25, 1.0), inference_jitter=0.25),
    "fig8_csi": dict(capacity_range=(0.25, 1.0), inference_jitter=0.25,
                     csi_error=0.20),
    # extra (beyond-paper) stressor: dynamic topology
    "dyn_topology": dict(capacity_range=(0.25, 1.0), inference_jitter=0.25,
                         csi_error=0.20, connectivity_drop=0.15),
    "dyn_poisson": dict(capacity_range=(0.25, 1.0), workload="poisson",
                        arrival_rate=0.7),
    "dyn_bursty": dict(capacity_range=(0.25, 1.0), workload="mmpp",
                       mmpp_rates=(0.2, 0.95), mmpp_switch=(0.05, 0.2)),
    "dyn_churn": dict(capacity_range=(0.25, 1.0), workload="poisson",
                      arrival_rate=0.8, churn_prob=0.02),
    "dyn_markov_channel": dict(capacity_range=(0.25, 1.0), workload="poisson",
                               arrival_rate=0.9, ar1_rho=0.9,
                               inference_jitter=0.25, csi_error=0.20),
}

# Scenario families, in paper order.
PAPER_FIGURES = ("fig5_baseline", "fig6_capacity", "fig7_jitter", "fig8_csi")
DYNAMIC_SCENARIOS = tuple(n for n in SCENARIOS if n.startswith("dyn_"))
