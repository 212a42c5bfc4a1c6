"""Whether torch.profiler sees every device record of a compiled GRLE
episode, and how long its window must stay open around the episode.

    python3 tools/torch_profiler_window.py [--reps 15] [--pads 0:0,0:0.2]

Runs the port's ``RolloutDriver(train=True)`` on fig5_baseline at full
width (B=64, T=200, random weights, seed 0) with ``run(mode="scan")``,
captured once, then profiles the episode ``--reps`` times for each pad
``lead:tail``: seconds the window stays idle after it opens, before the
episode, and after the episode's closing synchronize, before it closes
(pads interleaved). Each window starts with a marker kernel
(``spin_kernel``), launched as the window opens, and a second (``exp2``)
just before the episode. Per window it prints one JSON line: whether
each marker was seen, the device records in all, the 200
``cudaGraphLaunch`` calls, and the launches (slot index) that carry
fewer device records (by correlation id) than the most any window saw
for them. The last line sums each pad. Needs a GPU; refuses to run
without one.
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
from repro_torch.rollout import RolloutDriver  # noqa: E402
from torch_profiling import card  # noqa: E402

N_FLEETS, N_SLOTS, SEED = 64, 200, 0


def window(drv, lead: float, tail: float, marks: torch.Tensor) -> dict:
    """One profiled scan episode, ``lead`` seconds into its window and
    ``tail`` seconds before it closes."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)                 # as the window opens
        torch.cuda.synchronize()
        time.sleep(lead)
        marks.exp2_()                           # just before the episode
        drv.run(SEED, N_SLOTS, mode="scan")
        torch.cuda.synchronize()
        time.sleep(tail)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    launches = sorted((e.time_range.start, e.id) for e in events
                      if e.name == "cudaGraphLaunch")
    slot_of = {corr: i for i, (_, corr) in enumerate(launches)}
    per = [0] * len(launches)
    seen = {"open": False, "before_episode": False}
    device = 0
    for e in events:
        if e.device_type != cuda:
            continue
        device += 1
        if e.id in slot_of:
            per[slot_of[e.id]] += 1
        elif "spin_kernel" in e.name:
            seen["open"] = True
        elif "exp2" in e.name:
            seen["before_episode"] = True
    return {"pad_s": f"{lead}:{tail}", "markers_seen": seen,
            "device_records": device, "graph_launches": len(launches),
            "per_launch": per}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--pads", default="0:0,0:0.2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profiler_window: needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    pads = [tuple(map(float, p.split(":"))) for p in args.pads.split(",")]
    dev = torch.device("cuda")
    print(card(), flush=True)
    env = MECEnv(make_scenario("fig5_baseline"), device=dev)
    adef = agent_def("grle", env, device=dev)
    drv = RolloutDriver(adef, N_FLEETS, train=True, device=dev)
    drv.run(SEED, N_SLOTS, mode="scan")         # warm-up and capture
    marks = torch.zeros(4, device=dev)
    rows = []
    for rep in range(args.reps):
        for lead, tail in pads:
            rows.append(dict(rep=rep, **window(drv, lead, tail, marks)))
    most = [max((r["per_launch"][i] for r in rows
                 if len(r["per_launch"]) > i), default=0)
            for i in range(N_SLOTS)]
    summary = {}
    for r in rows:
        per = r.pop("per_launch")
        r["launches_short"] = {i: [n, most[i]] for i, n in enumerate(per)
                               if n < most[i]}
        print(json.dumps(r), flush=True)
        s = summary.setdefault(r["pad_s"], {
            "windows": 0, "open_marker_missing": 0,
            "before_episode_marker_missing": 0, "windows_short": 0,
            "device_records": []})
        s["windows"] += 1
        s["open_marker_missing"] += not r["markers_seen"]["open"]
        s["before_episode_marker_missing"] += (
            not r["markers_seen"]["before_episode"])
        s["windows_short"] += bool(r["launches_short"]) or (
            r["graph_launches"] != N_SLOTS)
        s["device_records"].append(r["device_records"])
    for s in summary.values():
        recs = s.pop("device_records")
        s["device_records_min_max"] = [min(recs), max(recs)]
    print(json.dumps({"by_pad": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
