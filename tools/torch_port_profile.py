"""Where a slot of repro_torch's GRLE decision path (or, with
``--train``, its training path) spends its time on one NVIDIA GPU.

    python3 tools/torch_port_profile.py [--fleets 1,64,1024] [--slots 20]
        [--train] [--mode loop|scan]

For each fleet count B it runs the port's ``RolloutDriver`` on
fig5_baseline at full width with random weights (seed 0): a warm-up
episode, a timed episode (host clock around work that ends in a
synchronize) for fleet-slots/s, and a ``torch.profiler`` window over
``--slots`` slots for the breakdown: host time per phase
(``sample``/``actor``/``env_step``, and ``train`` with ``--train``),
device kernel time in total and for the two hand-written kernels, CUDA
kernel launches per slot, and the device's busy share (kernel time over
wall time). With ``--train`` the driver trains (replay 128, minibatch 64,
a step every 10 slots); every episode starts from an empty ring, so the
warm-up and the window are stretched to the first slot that trains (slot
70 at B=1), and ``train_step`` alone is profiled over 10 calls on the
timed episode's final state: host µs, device µs and CUDA launches per
train step. ``--mode scan`` measures the compiled episode
(``run(mode="scan")``, one CUDA-graph launch a slot, captured before the
timed episode and before the window) and, in the same call and before
it, the loop: one row per mode, with ``cudaGraphLaunch`` calls per slot.
Prints one JSON line per B and mode. Needs a GPU; refuses to run without
one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import agent_def  # noqa: E402
from repro_torch.mec import MECEnv, make_scenario  # noqa: E402
from repro_torch.obs.profile import PHASE_SPANS  # noqa: E402
from repro_torch.rollout import RolloutDriver  # noqa: E402
from torch_profiling import card, device_summary, profiled  # noqa: E402

# the driver's phase spans (obs.profile.phase), by their recorded names
PHASES = PHASE_SPANS
TRAIN_STEPS = 10
# name fragments of the hand-written kernels: every template instance
# (gcn_agg_kernel<K, KS>, edge_score_kernel<H, E>) contains one
OUR_KERNELS = ("gcn_agg_kernel", "edge_score_kernel")


def first_train_slot(adef, n_fleets: int) -> int:
    """The first slot whose ``absorb`` trains in a fresh episode."""
    full = -(-adef.batch_size // n_fleets)
    return -(-full // adef.train_every) * adef.train_every


def measure(n_fleets: int, n_slots: int, timed_slots: int,
            train: bool = False, mode: str = "loop") -> dict:
    dev = torch.device("cuda")
    env = MECEnv(make_scenario("fig5_baseline"), device=dev)
    drv = RolloutDriver(agent_def("grle", env, device=dev), n_fleets,
                        train=train, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = drv.adef.init(gen)
    warm = first_train_slot(drv.adef, n_fleets) if train else 5
    drv.run(gen, warm, agent_state=state, mode="loop")     # warm-up
    if mode == "scan":                                     # capture
        drv.run(gen, timed_slots, agent_state=state, mode=mode)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = drv.run(gen, timed_slots, agent_state=state, mode=mode)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    metrics = drv.metrics(carry)

    if train:
        n_slots = max(n_slots, warm)
    if mode == "scan":                       # capture at the window's length
        drv.run(gen, n_slots, agent_state=state, mode=mode)
    prof, prof_wall = profiled(
        lambda: drv.run(gen, n_slots, agent_state=state, mode=mode))
    cpu = torch.autograd.DeviceType.CPU
    phase_host = {p: sum(e.time_range.elapsed_us() for e in prof.events()
                         if e.device_type == cpu and e.name == p) / n_slots
                  for p in PHASES}
    row = {
        "fleets": n_fleets, "train": train, "mode": mode,
        "fleet_slots_per_s": n_fleets * timed_slots / wall,
        "slot_ms": wall / timed_slots * 1e3,
        "ssp": metrics["ssp"], "avg_accuracy": metrics["avg_accuracy"],
        "train_steps": metrics["train_steps"],
        "profiled_slots": n_slots,
        "profiled_slot_ms": prof_wall / n_slots * 1e3,
        "host_us_per_slot_by_phase": phase_host,
        "graph_launches_per_slot": sum(
            1 for e in prof.events() if e.name == "cudaGraphLaunch") / n_slots,
        # the phases' record_function spans are not kernels
        **device_summary(prof, prof_wall, n_slots, "slot", OUR_KERNELS,
                         spans=PHASES, top=8),
    }
    if train:
        final = carry.agent_state

        def step():
            return drv.adef.train_step(final, generator=gen)

        step()
        torch.cuda.synchronize()
        prof, prof_wall = profiled(step, TRAIN_STEPS)
        row["train_step"] = {
            "host_us": prof_wall / TRAIN_STEPS * 1e6,
            **device_summary(prof, prof_wall, TRAIN_STEPS, "train_step",
                             OUR_KERNELS, spans=PHASES, top=8)}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fleets", default="1,64,1024")
    ap.add_argument("--slots", type=int, default=20,
                    help="slots in the profiler window")
    ap.add_argument("--timed-slots", type=int, default=200)
    ap.add_argument("--train", action="store_true",
                    help="profile the training path (train=True)")
    ap.add_argument("--mode", choices=("loop", "scan"), default="loop",
                    help="scan: the compiled episode, beside the loop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_port_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card_name = card()
    print(card_name)
    modes = ("loop", "scan") if args.mode == "scan" else ("loop",)
    for b in (int(x) for x in args.fleets.split(",")):
        for mode in modes:
            row = measure(b, args.slots, args.timed_slots, args.train, mode)
            row["card"] = card_name
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
