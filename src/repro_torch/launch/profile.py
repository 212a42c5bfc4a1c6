"""Profile launcher: one instrumented rollout, fully observed.

    PYTHONPATH=src python -m repro_torch.launch.profile \\
        --scenario fig5_baseline --method grle --slots 200 --fleets 2 \\
        --out results/torch_profile_run [--trace] [--episodes 2]
    PYTHONPATH=src python -m repro_torch.launch.profile --device cpu \\
        --slots 20 --devices 4 --replay 16 --batch 4 --train-every 5 \\
        --out build/profile_cpu --trace

Counterpart of ``repro/launch/profile.py``. Runs telemetry-enabled
episodes through ``RolloutDriver`` (the compiled episode, ``mode="scan"``)
with every observability leg on: the device-resident ``Telemetry``
registry (exit/latency/margin histograms, Eq-9 reward decomposition),
``CompileTracker`` around the episodes (scan episodes built and CUDA graphs
captured), optional ``torch.profiler`` trace capture (``--trace``: a
Chrome/Perfetto ``trace.json`` under ``<out>/trace``), and a JSONL run log
under ``--out`` (manifest -> per-episode telemetry -> compile summary).
The first episode pays the build (on the card: a warm-up slot of each
kind and the capture of two graphs); later episodes replay the graphs and
are the steady-state rate.

``--trace`` profiles every episode, the first included, where the
reference traces the last: a graph replay runs no host code, so the
slot body's ``obs/<phase>`` spans are recorded only where the slot runs
eagerly (the first episode's warm-up and capture), while the replays'
kernels (``gcn_agg``, ``edge_score``, the critic's) appear in every
episode. Runs on the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.core.policy import agent_def
from repro_torch.device import resolve_device
from repro_torch.mec.env import MECEnv
from repro_torch.mec.scenarios import SCENARIOS, make_scenario
from repro_torch.obs import CompileTracker, RunLog, run_manifest, trace_capture
from repro_torch.rollout import RolloutDriver, carry_metrics, carry_telemetry
from repro_torch.sweep.spec import seed_of


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.profile", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenario", default="fig5_baseline",
                    choices=sorted(SCENARIOS))
    ap.add_argument("--method", default="grle")
    ap.add_argument("--slots", type=int, default=200)
    ap.add_argument("--fleets", type=int, default=2)
    ap.add_argument("--devices", type=int, default=8,
                    help="IoT devices M per network")
    ap.add_argument("--slot-ms", type=float, default=30.0)
    ap.add_argument("--replay", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--train-every", type=int, default=10)
    ap.add_argument("--episodes", type=int, default=2,
                    help="episode 1 pays the build and capture; the rest "
                         "are the steady-state rate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the GPU; "
                         "'cpu' for the plain PyTorch path)")
    ap.add_argument("--out", default="results/torch_profile_run",
                    help="run directory: events.jsonl + trace artifacts")
    ap.add_argument("--trace", action="store_true",
                    help="capture a torch.profiler trace of the episodes "
                         "into <out>/trace/trace.json")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = make_scenario(args.scenario, n_devices=args.devices,
                        slot_ms=args.slot_ms)
    env = MECEnv(cfg, device=device)
    adef = agent_def(args.method, env, buffer_size=args.replay,
                     batch_size=args.batch, train_every=args.train_every,
                     device=device)
    drv = RolloutDriver(adef, n_fleets=args.fleets, telemetry=True,
                        device=device)
    drv.label = f"episode[T={args.slots}]"
    n_episodes = max(args.episodes, 1)

    manifest = run_manifest(
        config_signature=cfg.static_signature(), backend=device.type,
        scenario=args.scenario, method=args.method, n_slots=args.slots,
        n_fleets=args.fleets, n_devices=args.devices, seed=args.seed)
    summary: dict = {}
    trace_dir = os.path.join(args.out, "trace")
    with RunLog(args.out, manifest=manifest) as log, CompileTracker() as ct, \
            trace_capture(trace_dir, enabled=args.trace) as cap:
        for ep in range(n_episodes):
            t0 = time.perf_counter()
            carry, _ = drv.run(seed_of((args.seed, ep)), args.slots,
                               mode="scan")
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall_s = time.perf_counter() - t0
            tel = carry_telemetry(carry)
            met = carry_metrics(carry, slot_s=cfg.slot_s,
                                n_fleets=args.fleets)
            log.emit("episode", episode=ep, wall_s=round(wall_s, 4),
                     traced=bool(args.trace), metrics=met, telemetry=tel)
            s = tel["summary"]
            p50, p99 = s["latency_p50"], s["latency_p99"]
            print(f"[profile] ep{ep}: {wall_s:.2f}s wall, "
                  f"{met['tasks']} tasks, hit={s['deadline_hit_rate']:.3f}, "
                  f"lat p50/p99={p50 if p50 is None else round(p50, 2)}/"
                  f"{p99 if p99 is None else round(p99, 2)} "
                  f"(deadline units), "
                  f"reward/task={s['avg_reward_per_task']:.3f}", flush=True)
            summary = {"episode": ep, "wall_s": wall_s,
                       "metrics": met, "telemetry_summary": s}
        ct.track(drv.label, drv)
        log.emit("compile", **ct.summary())
    print(f"[profile] compile: {ct.summary()}", flush=True)
    print(f"[profile] run log -> {os.path.join(args.out, 'events.jsonl')}",
          flush=True)
    if cap is not None:
        print(f"[profile] trace -> {cap.path}", flush=True)
    summary["compile"] = ct.summary()
    summary["trace"] = None if cap is None else cap.path
    return summary


if __name__ == "__main__":
    main()
