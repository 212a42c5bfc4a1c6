"""The curriculum-vs-DR margin of the population ablation over several
seeds, in the port or in the JAX reference.

    python3 tools/pop_curriculum_margins.py --package torch --seeds 0-7
    PYTHONPATH=src python tools/pop_curriculum_margins.py --package jax \
        --seeds 0-7

Each seed runs ``compare_curriculum_dr`` exactly as
``examples/pop_curriculum.py`` (``--package jax``, on the CPU) or
``examples/torch_pop_curriculum.py`` (``--package torch``, on the card
unless ``--device cpu``) call it at their defaults (16 members, 6
generations, 20 slots, M=8, fig5_baseline -> fig6_capacity, held-out t in
{0.9, 1.0}) with ``--seed`` set to the seed, and prints the margin
(curriculum's mean held-out reward minus DR's), both means and the
wall seconds; the last line is a JSON object with every seed's row and
how many the curriculum won. The examples assert a positive margin at
seed 0; this measures how often that holds. The torch side needs no JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def seeds_of(text: str) -> list:
    if "-" in text:
        lo, hi = (int(x) for x in text.split("-"))
        return list(range(lo, hi + 1))
    return [int(x) for x in text.split(",")]


def torch_compare(device):
    path = os.path.join(ROOT, "examples", "torch_pop_curriculum.py")
    spec = importlib.util.spec_from_file_location("torch_pop_curriculum",
                                                  path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)

    def run(seed):
        argv = ["--seed", str(seed)]
        if device:
            argv += ["--device", device]
        return ex.compare(ex.parse_args(argv))
    return run


def jax_compare():
    from repro.core import agent_def
    from repro.mec import MECEnv, make_scenario, scenario_space
    from repro.pop import compare_curriculum_dr

    # examples/pop_curriculum.py's defaults
    cfg = make_scenario("fig5_baseline", n_devices=8)
    adef = agent_def("grle", MECEnv(cfg), buffer_size=32, batch_size=8,
                     train_every=5)
    space = scenario_space("fig5_baseline", "fig6_capacity", n_devices=8)

    def run(seed):
        return compare_curriculum_dr(
            adef, space, n_members=16, n_fleets=1, n_slots=20,
            generations=6, n_regions=6, temperature=0.3,
            eval_points=(0.9, 1.0), seed=seed, replay_capacity=32,
            batch_size=8, train_every=5)
    return run


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--seeds", default="0-7",
                    help="a range lo-hi or a comma-separated list")
    ap.add_argument("--device", default=None,
                    help="the port's device: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run = (torch_compare(args.device) if args.package == "torch"
           else jax_compare())
    rows = []
    for seed in seeds_of(args.seeds):
        t0 = time.perf_counter()
        r = run(seed)
        row = {"seed": seed, "margin": r["margin"],
               "curriculum": r["arms"]["curriculum"]["eval_mean"],
               "dr": r["arms"]["dr"]["eval_mean"],
               "wins": r["curriculum_wins"],
               "s": time.perf_counter() - t0}
        rows.append(row)
        print(f"seed {seed}: margin {row['margin']:+.6f} (curriculum "
              f"{row['curriculum']:.6f}, dr {row['dr']:.6f}) in "
              f"{row['s']:.1f} s", flush=True)
    out = {"package": args.package, "rows": rows,
           "wins": sum(r["wins"] for r in rows), "seeds": len(rows)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
