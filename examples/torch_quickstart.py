"""Quickstart on the PyTorch port: GRLE offloading on the paper's MEC setup
(§VI-A).

Trains the GRLE agent online for a few hundred slots on the 14-device /
2-ES network with VGG-16 Table-I exit profiles, and compares against DROO
(no GCN, no early exit), using the pure-functional agent API:
``agent_def(method, env)`` builds a static ``AgentDef`` spec, ``init``
returns the ``AgentState`` tuple, and ``step`` is the fused Algorithm-1
slot body (decide + replay-add + train when due).

    PYTHONPATH=src python examples/torch_quickstart.py [--slots 400] [--legacy]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --slots 60

``--legacy`` drives the same loop through the deprecated
``OffloadingAgent`` compatibility shim instead; under
``PYTHONWARNINGS="error,ignore:OffloadingAgent is deprecated:DeprecationWarning"``
it runs clean, the shim's own warning being its only one. Runs on the GPU
unless ``--device cpu``; each method's draws come from one
``torch.Generator`` seeded from 0.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import agent_def, make_agent  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.mec import MECConfig, MECEnv, RunningMetrics  # noqa: E402


def run(method: str, slots: int, seed: int = 0, legacy: bool = False,
        device=None) -> tuple:
    """``slots`` slots of one network -> (``RunningMetrics.summary()``,
    train steps taken)."""
    dev = resolve_device(device)
    env = MECEnv(MECConfig(n_devices=14), device=dev)    # paper defaults
    gen = torch.Generator(device=dev).manual_seed(seed)
    metrics = RunningMetrics(slot_s=env.cfg.slot_s)
    state = env.reset()

    if legacy:
        # deprecated shim; same batch_size as the pure path so both
        # variants train on the same schedule under the unified gate
        agent = make_agent(method, env, gen, batch_size=32)
        act = lambda s, t: agent.act(s, t)[0]            # noqa: E731
        train_steps = lambda: int(agent.state.loss_count)  # noqa: E731
    else:
        adef = agent_def(method, env, batch_size=32, device=dev)
        agent_state = adef.init(gen)

        def act(s, t):
            nonlocal agent_state
            agent_state, decision, _ = adef.step(agent_state, s, t,
                                                 generator=gen)
            return decision

        train_steps = lambda: int(agent_state.loss_count)  # noqa: E731

    for i in range(slots):
        tasks = env.sample_slot(gen)
        decision = act(state, tasks)
        state, result = env.step(state, tasks, decision)
        metrics.update(result)
        if i % 100 == 0:
            print(f"[{method}] slot {i:4d}  reward {float(result.reward):.3f}"
                  f"  acc {metrics.avg_accuracy:.3f}  ssp {metrics.ssp:.3f}",
                  flush=True)
    return metrics.summary(), train_steps()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=400)
    ap.add_argument("--legacy", action="store_true",
                    help="use the deprecated OffloadingAgent shim")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = {"train_steps": {}}
    print("=== GRLE (the paper's method) ===")
    out["grle"], out["train_steps"]["grle"] = run(
        "grle", args.slots, legacy=args.legacy, device=args.device)
    print("=== DROO (baseline, no early exit) ===")
    out["droo"], out["train_steps"]["droo"] = run(
        "droo", args.slots, legacy=args.legacy, device=args.device)
    print("\nmethod   accuracy   SSP     throughput")
    for name in ("grle", "droo"):
        m = out[name]
        print(f"{name.upper():6s}  {m['avg_accuracy']:.3f}     {m['ssp']:.3f}"
              f"   {m['throughput_tps']:.1f} tasks/s")
    return out


if __name__ == "__main__":
    main()
