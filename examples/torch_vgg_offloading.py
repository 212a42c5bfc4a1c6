"""The paper's full pipeline end to end on the PyTorch port:

1. train the multi-exit VGG-16 (two-stage, §VI-B) on the synthetic image
   task,
2. profile its candidate exits (accuracy + latency on this device -> a
   Table-I analogue),
3. run GRLE offloading on an MEC network whose two edge servers use that
   profile (the first at the measured latencies, the second twice as
   slow), through the port's agent and rollout driver.

    PYTHONPATH=src python examples/torch_vgg_offloading.py
    PYTHONPATH=src python examples/torch_vgg_offloading.py --device cpu \
        --quick --width-mult 0.125 --slots 60

Runs on the GPU unless ``--device cpu``. VGG-16 runs at its full width
(``--width-mult 1.0``) unless told otherwise; ``--quick`` trains 120 + 120
steps (400 + 400 without it) and profiles on fewer images.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import agent_def  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.mec import MECConfig, MECEnv  # noqa: E402
from repro_torch.rollout import RolloutDriver  # noqa: E402
from repro_torch.vgg import profile_exits, train_vgg_ee  # noqa: E402

NOISE = 1.2


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--slots", type=int, default=300)
    ap.add_argument("--width-mult", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def train_stage(args, *, steps=None):
    """Stages 1 and 2 -> (params, history)."""
    steps = steps or (120 if args.quick else 400)
    return train_vgg_ee(args.seed, width_mult=args.width_mult,
                        steps_main=steps, steps_exits=steps,
                        batch=args.batch, noise=NOISE, log_every=50,
                        device=args.device)


def profile_stage(params, args):
    """Table-I rows of the five candidate exits: accuracy, GFLOPs, the
    measured ``ms`` and the H100 roofline's ``roofline_ms``."""
    return profile_exits(params, width_mult=args.width_mult,
                         eval_batches=2 if args.quick else 4, batch=128,
                         noise=NOISE)


def offload_config(rows) -> MECConfig:
    """The MEC network on the measured profile: ES0 at the measured
    latencies, ES1 a twice-slower edge box; the paper's 30 ms deadline and
    slot."""
    times = np.array([[r["ms"] * 1e-3 for r in rows]])
    times = np.concatenate([times, times * 2.0])
    acc = np.array([r["accuracy"] for r in rows])
    return MECConfig(
        n_devices=10, n_servers=2,
        exit_times_s=tuple(map(tuple, times.tolist())),
        exit_accuracy=tuple(acc.tolist()),
        deadline_s=30e-3, slot_s=30e-3,
        capacity_range=(0.25, 1.0))


def offload_stage(rows, args, *, mode="scan"):
    """GRLE trained online over ``args.slots`` slots of one fleet ->
    (driver, final carry, trace)."""
    device = resolve_device(args.device)
    env = MECEnv(offload_config(rows), device=device)
    drv = RolloutDriver(agent_def("grle", env, device=device), 1,
                        train=True, device=device)
    carry, trace = drv.run(args.seed + 1, args.slots, mode=mode)
    return drv, carry, trace


def main(argv=None) -> None:
    args = parse_args(argv)
    print("=== stage 1+2: train multi-exit VGG-16 ===", flush=True)
    params, _ = train_stage(args)
    print("=== profile candidate exits ===", flush=True)
    rows = profile_stage(params, args)
    for r in rows:
        print(f"  exit {r['exit']:2d}: acc {r['accuracy']:.3f}  "
              f"measured {r['ms']:.3f} ms  roofline {r['roofline_ms']:.4f} "
              f"ms  {r['gflops']:.4f} GFLOPs")
    print("=== stage 3: GRLE offloading on the measured profile ===",
          flush=True)
    drv, carry, _ = offload_stage(rows, args)
    print("summary:", drv.metrics(carry))


if __name__ == "__main__":
    main()
