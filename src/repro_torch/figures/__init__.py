"""The paper's §VI experiments through the port (Figs 4–8).

Counterparts of ``benchmarks/convergence.py`` (Fig 4), ``vary_devices.py``,
``vary_capacity.py``, ``vary_inference_time.py`` and ``imperfect_csi.py``
(Figs 5–8), with ``benchmarks/common.py``'s rollout as ``common.py``, and
``learning.py``: the check that the port learns like the reference, by
statistics over seeds. ``python -m repro_torch.figures`` runs them.
"""
from repro_torch.figures.common import (METHODS, RunDraws, accuracy_ratios,
                                        rollout_method, sweep_methods)

FIGURES = ("convergence", "vary_devices", "vary_capacity",
           "vary_inference_time", "imperfect_csi")

__all__ = ["FIGURES", "METHODS", "RunDraws", "accuracy_ratios",
           "rollout_method", "sweep_methods"]
