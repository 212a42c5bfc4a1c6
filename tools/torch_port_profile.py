"""Where a slot of repro_torch's GRLE decision path spends its time on one
NVIDIA GPU.

    python3 tools/torch_port_profile.py [--fleets 1,64,1024] [--slots 20]

For each fleet count B it runs the port's ``RolloutDriver`` on
fig5_baseline at full width with random weights (seed 0): a warm-up
episode, a timed episode (host clock around work that ends in a
synchronize) for fleet-slots/s, and a ``torch.profiler`` window over
``--slots`` slots for the breakdown: host time per phase
(``sample``/``actor``/``env_step``), device kernel time in total and for
the two hand-written kernels, CUDA kernel launches per slot, and the
device's busy share (kernel time over wall time). Prints one JSON line
per B. Needs a GPU; refuses to run without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import agent_def  # noqa: E402
from repro_torch.mec import MECEnv, make_scenario  # noqa: E402
from repro_torch.rollout import RolloutDriver  # noqa: E402

PHASES = ("sample", "actor", "env_step")
OUR_KERNELS = ("gcn_agg_kernel", "edge_score_kernel")


def device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def measure(n_fleets: int, n_slots: int, timed_slots: int) -> dict:
    dev = torch.device("cuda")
    env = MECEnv(make_scenario("fig5_baseline"), device=dev)
    drv = RolloutDriver(agent_def("grle", env, device=dev), n_fleets,
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = drv.adef.init(gen)
    drv.run(gen, 5, agent_state=state)                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = drv.run(gen, timed_slots, agent_state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    metrics = drv.metrics(carry)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        drv.run(gen, n_slots, agent_state=state)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    # record_function ranges also appear as device-side annotations named
    # like the phase; they are spans, not kernels, and are left out
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kernels = [e for e in prof.key_averages() if device_us(e) > 0
               and e.device_type == cuda and e.key not in PHASES]
    total_dev = sum(device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    phase_host = {p: sum(e.time_range.elapsed_us() for e in prof.events()
                         if e.device_type == cpu and e.name == p) / n_slots
                  for p in PHASES}
    ours = {k: sum(device_us(e) for e in kernels if k in e.key) / n_slots
            for k in OUR_KERNELS}
    top = sorted(kernels, key=device_us, reverse=True)[:8]
    return {
        "fleets": n_fleets,
        "fleet_slots_per_s": n_fleets * timed_slots / wall,
        "slot_ms": wall / timed_slots * 1e3,
        "ssp": metrics["ssp"], "avg_accuracy": metrics["avg_accuracy"],
        "profiled_slot_ms": prof_wall / n_slots * 1e3,
        "device_us_per_slot": total_dev / n_slots,
        "device_busy_share": total_dev / (prof_wall * 1e6),
        "kernel_launches_per_slot": launches / n_slots,
        "host_us_per_slot_by_phase": phase_host,
        "our_kernels_device_us_per_slot": ours,
        "top_kernels_device_us_per_slot": {
            e.key[:60]: device_us(e) / n_slots for e in top},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fleets", default="1,64,1024")
    ap.add_argument("--slots", type=int, default=20,
                    help="slots in the profiler window")
    ap.add_argument("--timed-slots", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_port_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card)
    for b in (int(x) for x in args.fleets.split(",")):
        row = measure(b, args.slots, args.timed_slots)
        row["card"] = card
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
