"""Device time of each actor-kernel launch of a GRLE slot on one NVIDIA GPU.

    python3 tools/torch_actor_kernels.py [--root DIR] [--fleets 1,64,1024]

Times the five launches of one actor forward (``gcn_agg`` layers 1 and 2,
device and option side, then ``edge_score``) on the main path's inputs at
each fleet count B, by CUDA-graph replay, as ``chip_smoke.py`` phase 3
does, with the kernels of the checkout at ``--root`` (default: this one).
Run it on two trees in turn in one call (old, new, new, old) to compare
their kernels on one card. Prints the card, the launch floor (a
one-element in-place add) and one JSON line per B. Needs a GPU; refuses to
run without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose src/repro_torch kernels are timed")
    ap.add_argument("--fleets", default="1,64,1024")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    # the package of --root first; chip_smoke (this tree's) only for its
    # input construction and timing, which both trees' wrappers accept
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch_actor_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.core import agent_def
    from repro_torch.mec import MECEnv, make_scenario
    sys.path.insert(1, HERE)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.card_line())
    env = MECEnv(make_scenario("fig5_baseline"), device=dev)
    adef = agent_def("grle", env, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    params = adef.init(gen).params
    floor_us = cs.launch_floor_ms(dev) * 1e3
    for b in (int(x) for x in args.fleets.split(",")):
        us = {}
        for kernel, name, a, fn, _, _ in cs.actor_cases(env, params, gen, b):
            us[f"{kernel}/{name}"] = cs.graph_ms(lambda: fn(*a)) * 1e3
        print(json.dumps({"root": root, "fleets": b, "floor_us": floor_us,
                          "us_per_launch": us,
                          "gcn_agg_us_per_slot": sum(
                              v for k, v in us.items()
                              if k.startswith("gcn_agg")),
                          "edge_score_us_per_slot": us["edge_score/edge"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
