"""Auto-curriculum vs domain randomization, a paired population ablation,
on the PyTorch port.

Trains two GRLE populations over the scenario box spanned by
fig5_baseline (ideal edge servers) and fig6_capacity (edge capacity
drawn from (0.25, 1.0): congested servers where offloading decisions
actually bite):

* the **curriculum** arm samples training scenarios where the
  population currently scores worst (``Curriculum``: region score EMAs,
  softmax(-score/T); see ``src/repro_torch/pop/curriculum.py``);
* the **DR** arm draws regions uniformly: same population seed, same
  PBT config, same eval seeds, same *everything* except the sampling
  distribution (``Curriculum(uniform=True)``).

Both arms are then evaluated on held-out *hard* scenarios (high-t
points of the axis, never a training draw) and the script asserts the
curriculum arm wins, as the reference's does:

    PYTHONPATH=src python examples/torch_pop_curriculum.py [--generations 10]
    PYTHONPATH=src python examples/torch_pop_curriculum.py --device cpu \
        --members 4 --generations 2 --slots 10 --devices 4

The members of a population share one rollout driver and its CUDA
graphs (``PopulationDriver``); run as one process per card (``torchrun
--nproc-per-node N examples/torch_pop_curriculum.py``, ``--members``
divisible by N) the members are split over the cards and only rank 0
prints. Runs on the GPU unless ``--device cpu``;
the draws come from generators seeded from ``--seed`` (the port's RNG,
not the reference's threefry streams).
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import agent_def  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.mec import MECEnv, make_scenario, scenario_space  # noqa: E402
from repro_torch.pop import (compare_curriculum_dr,  # noqa: E402
                             format_comparison)
from repro_torch.sharding.fleet import (fleet_mesh,  # noqa: E402
                                        init_from_env, is_lead, leave,
                                        mesh_note)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--members", type=int, default=16)
    ap.add_argument("--generations", type=int, default=6)
    ap.add_argument("--slots", type=int, default=20,
                    help="slots per member per generation")
    ap.add_argument("--fleets", type=int, default=1)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--regions", type=int, default=6)
    ap.add_argument("--temperature", type=float, default=0.3,
                    help="softmax temperature over region -score")
    ap.add_argument("--space-lo", default="fig5_baseline")
    ap.add_argument("--space-hi", default="fig6_capacity")
    ap.add_argument("--eval-points", default="0.9,1.0",
                    help="held-out hard points (t along lo->hi)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def compare(args, mesh=None) -> dict:
    """Both arms trained and evaluated -> ``compare_curriculum_dr``'s
    result (margin and ``curriculum_wins`` included); ``mesh`` splits the
    members over its ranks."""
    dev = resolve_device(args.device)
    cfg = make_scenario(args.space_lo, n_devices=args.devices)
    adef = agent_def("grle", MECEnv(cfg, device=dev), buffer_size=32,
                     batch_size=8, train_every=5, device=dev)
    space = scenario_space(args.space_lo, args.space_hi,
                           n_devices=args.devices, device=dev)
    return compare_curriculum_dr(
        adef, space, n_members=args.members, n_fleets=args.fleets,
        n_slots=args.slots, generations=args.generations,
        n_regions=args.regions, temperature=args.temperature,
        eval_points=tuple(float(t) for t in args.eval_points.split(",")),
        seed=args.seed, mesh=mesh, replay_capacity=32, batch_size=8,
        train_every=5)


def main(argv=None) -> dict:
    args = parse_args(argv)
    started = init_from_env(resolve_device(args.device))
    try:
        return run(args)
    finally:
        leave(started)


def run(args) -> dict:
    mesh = fleet_mesh()
    result = compare(args, mesh)
    if not is_lead(mesh):
        return result

    print(f"members: {mesh_note(mesh, 'member', 'pop')}")
    print(f"{args.space_lo} -> {args.space_hi}, {args.members} members x "
          f"{args.generations} generations x {args.slots} slots")
    print(format_comparison(result))
    visits = result["arms"]["curriculum"]["region_visits"]
    print(f"curriculum region visits (easy -> hard): {visits}")
    print(f"dr region visits         (easy -> hard): "
          f"{result['arms']['dr']['region_visits']}")

    assert result["curriculum_wins"], (
        f"curriculum must beat DR on held-out hard scenarios, margin "
        f"{result['margin']:+.4f}")
    print(f"OK: curriculum beats DR by {result['margin']:+.4f} "
          f"on held-out t={result['eval_points']}")
    return result


if __name__ == "__main__":
    main()
