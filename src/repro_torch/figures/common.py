"""Shared rollout machinery of the paper's §VI figures (Figs 5–8).

Counterpart of ``benchmarks/common.py``'s ``METHODS``, ``rollout_method``
and ``sweep_methods``. One run is Algorithm 1 slot by slot from Python, as
the reference runs it: a fresh ``MECEnv`` per (method, M, τ), the
deprecated ``OffloadingAgent`` shim (``core.agent.make_agent``) and the
§VI-D ``RunningMetrics``; each slot draws the tasks, acts with training
on (``act(train=True)``), steps the env and folds the metrics. GRLE and
GRL run the hand-written ``gcn_agg`` (4 launches) and ``edge_score`` (1)
per decision and once more per train step; DROO and DROOE run none.

Torch cannot reproduce the reference's threefry streams, so one seam takes
injected draws (``RunDraws``: the agent's initial params, the slot's
tasks, the exploration candidates and each train step's replay rows) and
replays the reference's run; without it every draw comes from one
generator seeded with ``seed``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.agent import make_agent
from repro_torch.device import resolve_device
from repro_torch.mec import MECEnv, RunningMetrics, SlotTasks, make_scenario
from repro_torch.obs.rows import save_rows, timed

METHODS = ("grle", "grl", "drooe", "droo")
QUICK_DEVICES, FULL_DEVICES = (6, 10), (6, 10, 14)
QUICK_SLOTS, FULL_SLOTS = 150, 500


class RunDraws(NamedTuple):
    """The injected draws of one ``rollout_method`` run, on its device."""
    params: dict               # the agent's initial params
    tasks: SlotTasks           # each slot's tasks, leaves [T, ...]
    rand_cands: torch.Tensor   # [T, K, M] exploration candidates
    replay_take: torch.Tensor  # [n_train, batch_size] replay rows per step


def _at(tasks: SlotTasks, t: int) -> SlotTasks:
    return SlotTasks(*(x[t] for x in tasks))


def rollout_method(method: str, scenario: str, *, n_devices: int,
                   slot_ms: float, slots: int, seed: int = 0, device=None,
                   draws: Optional[RunDraws] = None) -> dict:
    """One (method, scenario, M, τ) run of ``slots`` slots with training;
    the §VI-D summary row with the run's labels and ``wall_s`` (the loop's
    seconds, the card synchronized before the clock stops). ``draws``
    replays injected draws instead of the generator's."""
    dev = resolve_device(device)
    cfg = make_scenario(scenario, n_devices=n_devices, slot_ms=slot_ms)
    env = MECEnv(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    agent = make_agent(method, env, gen, seed=seed)
    if draws is not None:
        agent.params = draws.params
    metrics = RunningMetrics(slot_s=cfg.slot_s)

    def episode():
        state = env.reset()
        n_train = 0
        for t in range(slots):
            rand = take = None
            if draws is None:
                tasks = env.sample_slot(gen)
            else:
                tasks, rand = _at(draws.tasks, t), draws.rand_cands[t]
                if agent.adef.train_due(agent.state, 1):
                    take = draws.replay_take[n_train]
                    n_train += 1
            dec, _ = agent.act(state, tasks, rand_cands=rand, take=take)
            state, res = env.step(state, tasks, dec)
            metrics.update(res, tasks.active)
        return state

    _, wall_s = timed(episode, dev)
    out = metrics.summary()
    out.update(method=method, scenario=scenario, n_devices=n_devices,
               slot_ms=slot_ms, slots=slots, wall_s=wall_s)
    return out


def sweep_methods(scenario: str, *, device_counts, slot_lengths_ms, slots,
                  seed: int = 0, methods=METHODS, device=None,
                  log=print) -> list:
    """``rollout_method`` for every method × M × τ, in that order."""
    rows = []
    for method in methods:
        for m in device_counts:
            for tau in slot_lengths_ms:
                row = rollout_method(method, scenario, n_devices=m,
                                     slot_ms=tau, slots=slots, seed=seed,
                                     device=device)
                rows.append(row)
                log(f"  {method:6s} M={m:3d} tau={tau:4.0f}ms  "
                    f"acc={row['avg_accuracy']:.3f} ssp={row['ssp']:.3f} "
                    f"thr={row['throughput_tps']:.1f}/s "
                    f"wall={row['wall_s']:.2f}s")
    return rows


def figure_run(name: str, scenario: str, taus_ms, quick: bool,
               device=None, log=print) -> list:
    """One of Figs 5–8: the four methods over M ∈ {6, 10, 14} (``quick``:
    {6, 10}) and ``taus_ms`` on ``scenario``, 500 slots a run (``quick``:
    150), saved as ``results/torch_<name>.json``."""
    dev = resolve_device(device)
    rows = sweep_methods(scenario,
                         device_counts=QUICK_DEVICES if quick
                         else FULL_DEVICES,
                         slot_lengths_ms=taus_ms,
                         slots=QUICK_SLOTS if quick else FULL_SLOTS,
                         device=dev, log=log)
    save_rows(name, rows, dev)
    return rows


def accuracy_ratios(rows) -> dict:
    """GRLE's ``avg_accuracy`` over GRL's and over DROOE's at each (M, τ)
    the rows share: {"grl": [...], "drooe": [...]} (the paper's headline
    claims: up to 3.41x GRL's and 1.45x DROOE's)."""
    acc = {(r["method"], r["n_devices"], r["slot_ms"]): r["avg_accuracy"]
           for r in rows}
    out = {}
    for other in ("grl", "drooe"):
        out[other] = [a / max(acc[(other, m, tau)], 1e-12)
                      for (meth, m, tau), a in acc.items()
                      if meth == "grle" and (other, m, tau) in acc]
    return out
