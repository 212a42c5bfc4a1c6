"""Fig 4: convergence of the normalized reward Q̂ (Eq 17) and the loss.

Counterpart of ``benchmarks/convergence.py``. GRLE against DROOE at M=14
(``MECConfig(n_devices=14)``, §VI-A's defaults), slot by slot with
training: every ``CHECK_EVERY`` slots Q̂ is the critic's value of the
agent's decision over that of the greedy + local-search oracle
(``env.greedy_decision(sweeps=1)``), kept as a moving average over
``CHECK_EVERY``-slot checks spanning 50 slots; the loss trajectory is the
agent's ``loss_history`` and ``final_loss`` the mean of its last 5.

Also the scan-fused fleet variant: ``RolloutDriver(mode="scan")`` with B
fleets feeding one learner (on the card, CUDA-graph replays). The oracle
runs on the host side of the loop only, so these curves report the raw
reward (Q̂'s numerator) averaged over fleets, with a moving window of 50
slots, and the non-NaN losses.

    PYTHONPATH=src python -m repro_torch.figures --only convergence [--quick]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.agent import make_agent
from repro_torch.device import resolve_device
from repro_torch.mec import MECConfig, MECEnv
from repro_torch.obs.rows import save_rows, timed
from repro_torch.rollout import RolloutDriver

METHODS = ("grle", "drooe")
N_DEVICES = 14
CHECK_EVERY = 10
WINDOW_SLOTS = 50
QUICK = dict(slots=400, n_fleets=2)
FULL = dict(slots=1500, n_fleets=8)


def _final_loss(losses) -> float | None:
    return float(np.mean(losses[-5:])) if len(losses) else None


def loop_row(method: str, ratios, slots_at, losses) -> dict:
    """The per-slot run's row from its Q̂ checks (``ratios`` at
    ``slots_at``) and its losses, by the reference's formulas."""
    ratios = np.asarray(ratios)
    win = max(1, WINDOW_SLOTS // CHECK_EVERY)
    moving = np.convolve(ratios, np.ones(win) / win, mode="valid")
    return {
        "method": method,
        "final_moving_Qhat": float(moving[-1]),
        "max_moving_Qhat": float(moving.max()),
        "final_loss": _final_loss(losses),
        "Qhat_curve_slots": list(slots_at),
        "Qhat_curve": [round(float(x), 4) for x in ratios],
        "loss_curve": [round(float(v), 4) for v in losses],
    }


def scan_row(method: str, n_fleets: int, reward, losses) -> dict:
    """The fleet run's row from its [T, B] rewards and [T] losses (NaN
    where no train step ran), by the reference's formulas."""
    reward = np.asarray(reward).mean(axis=1)                 # [T] fleet mean
    moving = np.convolve(reward, np.ones(WINDOW_SLOTS) / WINDOW_SLOTS,
                         mode="valid")
    losses = np.asarray(losses)
    losses = losses[~np.isnan(losses)]
    return {
        "method": f"{method}_scan_B{n_fleets}",
        "final_moving_reward": float(moving[-1]),
        "max_moving_reward": float(moving.max()),
        "final_loss": _final_loss(losses),
        "reward_curve_slots": list(range(0, reward.shape[0], CHECK_EVERY)),
        "reward_curve": [round(float(x), 4)
                         for x in reward[::CHECK_EVERY]],
        "loss_curve": [round(float(v), 4) for v in losses],
    }


def loop_convergence(method: str, *, slots: int, device=None,
                     seed: int = 0) -> dict:
    """GRLE or DROOE slot by slot at M=14 with Q̂ against the oracle every
    ``CHECK_EVERY`` slots; the row carries the run's ``wall_s`` too."""
    dev = resolve_device(device)
    env = MECEnv(MECConfig(n_devices=N_DEVICES), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    agent = make_agent(method, env, gen)
    ratios, slots_at = [], []

    def episode():
        state = env.reset()
        for i in range(slots):
            tasks = env.sample_slot(gen)
            dec, _ = agent.act(state, tasks)
            if i % CHECK_EVERY == 0:
                q = float(env.evaluate(state, tasks, dec[None])[0])
                oracle = env.greedy_decision(state, tasks, sweeps=1)
                qo = float(env.evaluate(state, tasks, oracle[None])[0])
                ratios.append(q / max(qo, 1e-9))
                slots_at.append(i)
            state, _ = env.step(state, tasks, dec)

    _, wall_s = timed(episode, dev)
    row = loop_row(method, ratios, slots_at, agent.loss_history)
    row["wall_s"] = wall_s
    return row


def scan_convergence(method: str, *, slots: int, n_fleets: int,
                     device=None, seed: int = 0) -> dict:
    """The batched convergence curve from one compiled fleet episode; the
    row carries the run's ``wall_s`` too (the episode's build included)."""
    dev = resolve_device(device)
    env = MECEnv(MECConfig(n_devices=N_DEVICES), device=dev)
    agent = make_agent(method, env, torch.Generator(device=dev)
                       .manual_seed(seed))
    driver = RolloutDriver(agent, n_fleets=n_fleets, device=dev)
    (carry, trace), wall_s = timed(
        lambda: driver.run(seed, slots, mode="scan"), dev)
    driver.sync_agent(carry)
    row = scan_row(method, n_fleets, trace.reward.cpu().numpy(),
                   trace.loss.cpu().numpy())
    row["wall_s"] = wall_s
    return row


def run(quick: bool = False, *, device=None, log=print) -> list:
    """Fig 4's four rows (two per-slot runs, two fleet runs), saved as
    ``results/torch_convergence.json``."""
    dev = resolve_device(device)
    size = QUICK if quick else FULL
    rows = []
    for method in METHODS:
        row = loop_convergence(method, slots=size["slots"], device=dev)
        rows.append(row)
        log(f"  {method:6s} final Q̂(ma)={row['final_moving_Qhat']:.3f} "
            f"loss={row['final_loss']:.4f} wall={row['wall_s']:.2f}s")
    for method in METHODS:
        row = scan_convergence(method, slots=size["slots"],
                               n_fleets=size["n_fleets"], device=dev)
        rows.append(row)
        log(f"  {row['method']:14s} final reward(ma)="
            f"{row['final_moving_reward']:.3f} loss={row['final_loss']:.4f} "
            f"wall={row['wall_s']:.2f}s")
    save_rows("convergence", rows, dev)
    return rows
