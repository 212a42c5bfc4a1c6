"""Domain-randomized fleet training over a continuous scenario space, on
the PyTorch port.

The paper trains and evaluates on four fixed scenarios (Figs 5-8). With
scenario-as-data (``ScenarioParams``), a scenario is just a point in
knob-space, so instead of picking one, sample a fresh MEC world per
fleet from the box spanned by two named scenarios and train a single
GRLE agent across all of them in one compiled episode:

    PYTHONPATH=src python examples/torch_scenario_fleet.py [--fleets 8] [--slots 300]
    PYTHONPATH=src python examples/torch_scenario_fleet.py --device cpu \
        --fleets 2 --slots 20 --devices 4

The script then evaluates the domain-randomized agent on both corner
scenarios (fig5_baseline: ideal ESs; fig8_csi: stochastic capacity +
jitter + CSI error) and on the midpoint (``interpolate_params``) without
retraining: swapping ``sp`` is a data change, and on the card the
evaluation driver's CUDA graphs are captured once and replayed for all
three (an int seed: the driver's own generator, one object from run to
run). Runs on the GPU unless ``--device cpu``; the init, the fleets'
scenarios, the training run and the evaluation each draw from their own
generator, seeded ``4 * seed + 0..3`` (the reference's
``fold_in(key, 0..3)``).
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import agent_def  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.mec import (MECEnv, interpolate_params,  # noqa: E402
                             make_scenario, scenario_params, scenario_space)
from repro_torch.rollout import RolloutDriver, carry_metrics  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleets", type=int, default=8)
    ap.add_argument("--slots", type=int, default=300)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = make_scenario("fig5_baseline", n_devices=args.devices)
    env = MECEnv(cfg, device=dev)
    adef = agent_def("grle", env, buffer_size=256, batch_size=32,
                     train_every=10, device=dev)

    def generator(stream: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(
            args.seed * 4 + stream)

    # --- train: every fleet draws its own dynamics from the fig5->fig8 box
    space = scenario_space("fig5_baseline", "fig8_csi",
                           n_devices=args.devices, device=dev)
    sp_fleet = space.sample_batch(generator(1), args.fleets)
    driver = RolloutDriver(adef, n_fleets=args.fleets,
                           per_fleet_scenarios=True, device=dev)
    carry, _ = driver.run(args.seed * 4 + 2, args.slots, sp=sp_fleet,
                          agent_state=adef.init(generator(0)))
    trained = carry.agent_state            # the result IS the state
    train = carry_metrics(carry, slot_s=cfg.slot_s, n_fleets=args.fleets)
    print(f"[train] {args.fleets} randomized fleets x {args.slots} slots: "
          f"ssp {train['ssp']:.3f}  acc {train['avg_accuracy']:.3f}")

    # --- eval on fixed scenarios: the same episode, new sp data
    eval_driver = RolloutDriver(adef, n_fleets=args.fleets, train=False,
                                device=dev)
    corners = {
        "fig5_baseline": scenario_params("fig5_baseline",
                                         n_devices=args.devices, device=dev),
        "fig8_csi": scenario_params("fig8_csi", n_devices=args.devices,
                                    device=dev),
    }
    corners["midpoint"] = interpolate_params(
        corners["fig5_baseline"], corners["fig8_csi"], 0.5)
    out = {"train": train, "eval": {}}
    print("\nscenario        SSP     accuracy  throughput")
    for name, sp in corners.items():
        c, _ = eval_driver.run(args.seed * 4 + 3, args.slots // 2, sp=sp,
                               agent_state=trained)
        m = carry_metrics(c, slot_s=cfg.slot_s, n_fleets=args.fleets)
        out["eval"][name] = m
        print(f"{name:14s}  {m['ssp']:.3f}   {m['avg_accuracy']:.3f}"
              f"     {m['throughput_tps']:.1f} tasks/s")
    return out


if __name__ == "__main__":
    main()
