"""Deterministic load generator: arrival processes -> request traces.

Counterpart of ``repro/serve/loadgen.py``. Bridges the rollout layer's
arrival processes (Poisson / two-state MMPP, ``rollout/workloads.py``)
to the serving layer: ``WorkloadGen.arrival_trace`` rolls the arrival
process over a population of user devices, and every fired (slot,
device) cell becomes one ``ServeRequest`` with an arrival instant on the
serving clock and an absolute admission deadline. The draws come from a
CPU ``torch.Generator`` seeded with ``seed``, so the trace is a pure
function of (scenario, seed) on any machine; it follows the reference's
distributions, not its threefry bits.

    trace = make_trace(n_users=64, n_slots=200, slot_s=eng.env.cfg.slot_s,
                       deadline_slack_s=0.5, seed=0)
    reports = eng.run(trace)
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.mec.env import MECEnv
from repro_torch.mec.scenarios import make_scenario
from repro_torch.rollout.workloads import make_workload
from repro_torch.serve.queue import ServeRequest


def make_trace(*, n_users: int = 64, n_slots: int = 200,
               slot_s: float = 15e-3, deadline_slack_s: float = 0.5,
               seed: int = 0, scenario: str = "dyn_bursty",
               workload: Optional[str] = None,
               arrival_rate: Optional[float] = None,
               priorities: Sequence[int] = (0,),
               prompt_len: int = 8, max_new: int = 8,
               max_requests: Optional[int] = None) -> List[ServeRequest]:
    """Sample an arrival trace as a list of ``ServeRequest``s.

    ``scenario`` names the arrival dynamics (default ``dyn_bursty`` =
    two-state MMPP with churn + AR(1) channels); ``workload`` /
    ``arrival_rate`` override its process family/rate. ``n_users``
    devices are polled for ``n_slots`` slots of ``slot_s`` seconds (use
    the serving engine's own ``env.cfg.slot_s`` so arrival instants land
    on its step grid); each arrival at slot t becomes a request with
    ``arrival_s = t * slot_s`` and ``deadline_s = arrival_s +
    deadline_slack_s`` (absolute). ``priorities`` cycles over the user
    axis — two classes via ``(0, 1)``. Requests are ordered by
    (arrival, user) with sequential rids; ``max_requests`` truncates the
    tail. Deterministic in all arguments.
    """
    overrides = {}
    if workload is not None:
        overrides["workload"] = workload
    if arrival_rate is not None:
        overrides["arrival_rate"] = arrival_rate
    cfg = make_scenario(scenario, n_devices=n_users,
                        slot_ms=slot_s * 1e3, **overrides)
    if cfg.workload == "iid":
        raise ValueError(
            "load generation needs an arrival process; scenario "
            f"{scenario!r} resolves to workload='iid' (every slot full). "
            "Pass workload='poisson' or 'mmpp'.")
    gen = make_workload(MECEnv(cfg, device="cpu"))
    generator = torch.Generator().manual_seed(int(seed))
    state = gen.init(generator)
    _, active = gen.arrival_trace(state, generator, n_slots)
    active = active.numpy() > 0.5                 # [T, M]

    trace: List[ServeRequest] = []
    rid = 0
    for t, row in enumerate(active):
        arrival = t * slot_s
        for m in np.flatnonzero(row):
            trace.append(ServeRequest(
                rid=rid, arrival_s=arrival,
                deadline_s=arrival + deadline_slack_s,
                priority=int(priorities[int(m) % len(priorities)]),
                prompt_len=prompt_len, max_new=max_new))
            rid += 1
            if max_requests is not None and rid >= max_requests:
                return trace
    return trace
