"""Population training launcher: PBT + auto-curriculum in one command.

    PYTHONPATH=src python -m repro_torch.launch.pop \\
        --members 16 --generations 8 --slots 80 --fleets 2
    PYTHONPATH=src python -m repro_torch.launch.pop --device cpu \\
        --members 4 --generations 2 --slots 10 --devices 4 --replay 16 \\
        --batch 4 --train-every 5 --checkpoint build/pop.ckpt

Counterpart of ``repro/launch/pop.py``. Trains a P-member population
over the continuous scenario space between ``--space-lo`` and
``--space-hi``: every generation each member draws its own scenario from
the curriculum (hard regions oversampled; ``--dr`` switches to the
uniform domain-randomized control arm), rolls B fleets for T slots
through one driver's captured CUDA graphs, member after member, then PBT
copies the best members over the worst and perturbs the copies'
per-member hyperparameters (lr / explore_gain / exit_tau — all state
data, no new capture). ``--checkpoint`` makes the run resumable bit for
bit: re-invoking with the same flags continues where the saved
generation counter left off. Runs on the GPU unless ``--device cpu``;
history records default to ``results/torch_history``. Under ``torchrun
--nproc-per-node N`` (one process per card; gloo processes with
``--device cpu``) the member axis is split over the N ranks
(``sharding.fleet.fleet_mesh``; ``--members`` must divide N) and rank 0
alone prints and writes the checkpoint and the history:

    torchrun --nproc-per-node 4 -m repro_torch.launch pop --members 16
"""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.pop", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--method", default="grle",
                    help="agent method (grle/grl/drooe/droo)")
    ap.add_argument("--members", type=int, default=16,
                    help="population size P")
    ap.add_argument("--generations", type=int, default=8)
    ap.add_argument("--slots", type=int, default=80,
                    help="slots per member-episode per generation")
    ap.add_argument("--fleets", type=int, default=1,
                    help="fleets per member (share one learner)")
    ap.add_argument("--devices", type=int, default=8,
                    help="IoT devices M per network")
    ap.add_argument("--space-lo", default="fig5_baseline",
                    help="easy corner of the scenario space")
    ap.add_argument("--space-hi", default="fig8_csi",
                    help="hard corner of the scenario space")
    ap.add_argument("--regions", type=int, default=6,
                    help="curriculum regions along the lo->hi axis")
    ap.add_argument("--dr", action="store_true",
                    help="domain-randomized control arm (uniform region "
                         "draws) instead of the auto-curriculum")
    ap.add_argument("--pbt-every", type=int, default=1,
                    help="generations between exploit/explore rounds")
    ap.add_argument("--pbt-frac", type=float, default=0.25,
                    help="fraction of members replaced per round")
    ap.add_argument("--replay", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--train-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the GPU; "
                         "'cpu' for the plain PyTorch path)")
    ap.add_argument("--checkpoint", default="",
                    help="population checkpoint path; resumes if present")
    ap.add_argument("--history", nargs="?", const="default", default="",
                    help="append one manifest-stamped history record per "
                         "generation (optional value: store dir; bare "
                         "flag uses REPRO_HISTORY/results/torch_history)")
    ap.add_argument("--eval-points", default="0.8,0.9,1.0",
                    help="held-out lo->hi interpolation points scored "
                         "after training")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from repro_torch.device import resolve_device
    from repro_torch.sharding.fleet import init_from_env, leave

    device = resolve_device(args.device)
    started = init_from_env(device)
    try:
        return _main(args, device)
    finally:
        leave(started)


def _main(args, device) -> dict:
    from repro_torch.core.policy import agent_def
    from repro_torch.mec.env import MECEnv
    from repro_torch.mec.scenarios import (interpolate_params, make_scenario,
                                           scenario_space)
    from repro_torch.pop import Curriculum, PBTConfig, PopulationTrainer
    from repro_torch.sharding.fleet import fleet_mesh, is_lead, mesh_note
    from repro_torch.train import restore_population, save_population

    mesh = fleet_mesh()
    lead = is_lead(mesh)

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    cfg = make_scenario(args.space_lo, n_devices=args.devices)
    adef = agent_def(args.method, MECEnv(cfg, device=device),
                     buffer_size=args.replay, batch_size=args.batch,
                     train_every=args.train_every, device=device)
    space = scenario_space(args.space_lo, args.space_hi,
                           n_devices=args.devices, device=device)
    history = None
    if args.history:
        from repro_torch.obs.history import HistoryStore, default_store
        history = (default_store() if args.history == "default"
                   else HistoryStore(args.history))
    trainer = PopulationTrainer(
        adef, Curriculum(space.lo, space.hi, n_regions=args.regions,
                         uniform=args.dr),
        n_members=args.members, n_fleets=args.fleets, n_slots=args.slots,
        pbt=PBTConfig(frac=args.pbt_frac), pbt_every=args.pbt_every,
        seed=args.seed, mesh=mesh, telemetry=True, history=history,
        history_name=f"pop_{'dr' if args.dr else 'curriculum'}")
    ts = trainer.init_state()
    if args.checkpoint and os.path.exists(args.checkpoint):
        ts = restore_population(args.checkpoint, like=ts)
        say(f"[pop] resumed {args.checkpoint} at generation "
            f"{int(ts.pop.generation)}")
    arm = "dr" if args.dr else "curriculum"
    say(f"[pop] {arm} arm: P={args.members} members x {args.fleets} "
        f"fleets x {args.slots} slots, {args.generations} generations "
        f"on {device}, {mesh_note(mesh, 'member', 'pop')}")

    reports = []
    for _ in range(args.generations):
        ts, rep = trainer.generation(ts)
        m = rep["metrics"]
        say(f"[pop] gen {rep['generation']:>3}: "
            f"reward mean {m['mean_reward']:.4f} "
            f"best {m['best_reward']:.4f} (member {rep['best_member']}) "
            f"exploits {int(m['exploits'])} "
            f"regions {rep['region_visits']}")
        reports.append(rep)
        if args.checkpoint and lead:
            save_population(args.checkpoint, ts)
    if args.checkpoint:
        say(f"[pop] checkpoint -> {args.checkpoint}")
    if history is not None:
        say(f"[pop] history -> {history.path}")

    evals = {}
    points = [float(t) for t in args.eval_points.split(",") if t]
    for i, t in enumerate(points):
        sp = interpolate_params(space.lo, space.hi, t)
        mets = trainer.evaluate(ts.pop, (args.seed, i), sp)
        evals[t] = float(mets["avg_reward"].mean())
        say(f"[pop] eval t={t:g}: population mean reward {evals[t]:.4f}")
    return {"arm": arm, "reports": reports, "evals": evals}


if __name__ == "__main__":
    main()
