"""Sweep launcher: the paper's results section as one command.

    PYTHONPATH=src python -m repro_torch.launch.sweep \\
        --scenarios fig5_baseline,fig6_capacity,fig7_jitter,fig8_csi,dyn_bursty \\
        --methods grle,grl,drooe,droo --seeds 3
    PYTHONPATH=src python -m repro_torch.launch.sweep --device cpu \\
        --scenarios fig5_baseline --methods grle,droo --slots 20 --devices 3 \\
        --replay 16 --batch 4 --train-every 5

Counterpart of ``repro/launch/sweep.py``. Expands the (scenario x method
x seed) grid, packs same-shape cells — across scenarios: per-cell
scenario knobs are data (``ScenarioParams``), so the whole grid above is
one pack per actor family, each replaying one driver's two captured CUDA
graphs cell after cell — and writes per-cell results (resumable store)
plus an aggregate report with GRLE-vs-baseline ratios. Re-invoking with
the same grid skips finished cells. Runs on the GPU unless ``--device
cpu``. Under ``torchrun --nproc-per-node N`` (one process per card; gloo
processes with ``--device cpu``) the cell axis is split over the N ranks
(``sharding.fleet.fleet_mesh``) and rank 0 alone prints, writes the store,
the report and the history:

    torchrun --nproc-per-node 4 -m repro_torch.launch sweep \\
        --scenarios fig5_baseline,fig8_csi --seeds 2
 The store and report default to ``results/torch_sweep`` and
``results/torch_sweep_report.json``, apart from the reference's, and a
store holding another backend's rows is refused.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.device import resolve_device
from repro_torch.sharding.fleet import (fleet_mesh, init_from_env, is_lead,
                                        leave, mesh_note)
from repro_torch.sweep import (SweepSpec, SweepStore, build_report,
                               format_markdown, format_telemetry, run_sweep,
                               write_report)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.sweep", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenarios", required=True,
                    help="comma-separated scenario names (see "
                         "repro_torch.mec.SCENARIOS)")
    ap.add_argument("--methods", default="grle,grl,drooe,droo")
    ap.add_argument("--seeds", type=int, default=1,
                    help="number of seeds (0..N-1) per (scenario, method)")
    ap.add_argument("--slots", type=int, default=300)
    ap.add_argument("--fleets", type=int, default=1)
    ap.add_argument("--devices", type=int, default=14,
                    help="IoT devices M per network")
    ap.add_argument("--slot-ms", type=float, default=30.0)
    ap.add_argument("--replay", type=int, default=128)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--train-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the GPU; "
                         "'cpu' for the plain PyTorch path)")
    ap.add_argument("--store", default="results/torch_sweep",
                    help="result-store dir ('' disables resume)")
    ap.add_argument("--report", default="results/torch_sweep_report.json")
    ap.add_argument("--sequential", action="store_true",
                    help="per-cell loop instead of packed execution "
                         "(reference/debug)")
    ap.add_argument("--telemetry", action="store_true",
                    help="carry the device-resident telemetry registry "
                         "(exit/latency histograms, reward decomposition) "
                         "and print the per-cell table")
    ap.add_argument("--history", nargs="?", const="default", default="",
                    help="append one manifest-stamped history record per "
                         "executed cell (optional value: store dir; bare "
                         "flag uses REPRO_HISTORY/results/torch_history)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    started = init_from_env(device)
    try:
        return _main(args, device)
    finally:
        leave(started)


def _main(args, device) -> dict:
    mesh = fleet_mesh()
    lead = is_lead(mesh)

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    spec = SweepSpec.from_names(
        args.scenarios, args.methods, args.seeds, n_devices=args.devices,
        slot_ms=args.slot_ms, n_slots=args.slots, n_fleets=args.fleets,
        replay_capacity=args.replay, batch_size=args.batch,
        train_every=args.train_every)
    store = SweepStore(args.store) if args.store else None
    n_cells = len(spec.expand())
    say(f"[sweep] {len(spec.scenarios)} scenarios x "
        f"{len(spec.methods)} methods x {len(spec.seeds)} seeds "
        f"= {n_cells} cells on {device}, "
        f"{mesh_note(mesh, 'cell', 'sweep')}")

    history = None
    if args.history:
        from repro_torch.obs.history import HistoryStore, default_store
        history = (default_store() if args.history == "default"
                   else HistoryStore(args.history))
    rows = run_sweep(spec, store=store, mesh=mesh,
                     packed=not args.sequential, telemetry=args.telemetry,
                     history=history, device=device, log=say)
    if history is not None:
        say(f"[sweep] history -> {history.path}")
    if store is not None:
        say(f"[sweep] store {store.root}: {store.completed()} cells on disk")
    report = build_report(rows)
    if args.report and lead:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        path = write_report(report, args.report)
        say(f"[sweep] report -> {path}")
    say(format_markdown(report))
    if args.telemetry:
        say(format_telemetry(rows))
    return report


if __name__ == "__main__":
    main()
