"""Reproduce the paper's comparison figures with one sweep call, on the
PyTorch port.

Runs the Fig 5-8 scenario columns (plus one beyond-paper dynamic
workload) for all four methods over several seeds, packed (one driver
and its CUDA graphs per pack of cells), then prints the per-scenario
comparison tables with GRLE-vs-baseline ratios: the programmatic version
of

    PYTHONPATH=src python -m repro_torch.launch.sweep \
        --scenarios fig5_baseline,fig6_capacity,fig7_jitter,fig8_csi,dyn_bursty \
        --methods grle,grl,drooe,droo --seeds 3

    PYTHONPATH=src python examples/torch_sweep_paper_figures.py
    PYTHONPATH=src python examples/torch_sweep_paper_figures.py --device cpu \
        --slots 10 --seeds 1 --store build/sweep_figures \
        --report build/sweep_figures_report.json

Defaults are scaled down (--slots 150, M=8), as the reference's; pass
--paper-scale for the §VI-A shape (M=14, 1000 slots), or --device-grid
6,10,14 for Fig 5's x-axis (fig5_baseline at each fleet size M). The
cells are split over a fleet mesh (``repro_torch.sharding.fleet_mesh()``)
when the script runs as one process per card, and only rank 0 prints and
writes:

    torchrun --nproc-per-node 4 examples/torch_sweep_paper_figures.py

Re-running resumes from the store; a row stored by another backend is
refused. Runs on the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.mec import PAPER_FIGURES, expand_grid  # noqa: E402
from repro_torch.sharding.fleet import (fleet_mesh,  # noqa: E402
                                        init_from_env, is_lead, leave,
                                        mesh_note)
from repro_torch.sweep import (SweepSpec, SweepStore,  # noqa: E402
                               build_report, format_markdown, run_sweep,
                               write_report)


def device_grid(args, mesh) -> dict:
    """Fig 5's x-axis: the same comparison at several fleet sizes M."""
    counts = tuple(int(m) for m in args.device_grid.split(","))
    store = SweepStore(args.store)
    combined = {}
    for name, ov in expand_grid(("fig5_baseline",), n_devices=counts):
        spec = SweepSpec(
            scenarios=(name,), methods=("grle", "grl", "drooe", "droo"),
            seeds=tuple(range(args.seeds)), n_devices=ov["n_devices"],
            n_slots=args.slots, replay_capacity=64, batch_size=16,
            train_every=10)
        rows = run_sweep(spec, store=store, mesh=mesh, device=args.device)
        report = build_report(rows)
        combined[f"M={ov['n_devices']}"] = report
        if is_lead(mesh):
            print(f"## M = {ov['n_devices']}")
            print(format_markdown(report))
    if is_lead(mesh):
        write_report(combined, args.report)
        print(f"report -> {args.report}   (one entry per device count)")
    return combined


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=150)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--paper-scale", action="store_true")
    ap.add_argument("--device-grid", default="",
                    help="comma-separated device counts: run fig5 per M "
                         "instead of the figure columns (e.g. 6,10,14)")
    ap.add_argument("--store", default="results/torch_sweep_figures")
    ap.add_argument("--report",
                    default="results/torch_sweep_figures_report.json")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    started = init_from_env(resolve_device(args.device))
    try:
        return run(args)
    finally:
        leave(started)


def run(args) -> dict:
    mesh = fleet_mesh()
    if is_lead(mesh):
        print(f"cells: {mesh_note(mesh, 'cell', 'sweep')}")
    if args.device_grid:
        return device_grid(args, mesh)

    n_devices, n_slots = (14, 1000) if args.paper_scale else (8, args.slots)
    spec = SweepSpec(
        scenarios=PAPER_FIGURES + ("dyn_bursty",),
        methods=("grle", "grl", "drooe", "droo"),
        seeds=tuple(range(args.seeds)),
        n_devices=n_devices, n_slots=n_slots,
        replay_capacity=64, batch_size=16, train_every=10)

    rows = run_sweep(spec, store=SweepStore(args.store), mesh=mesh,
                     device=args.device)
    report = build_report(rows)
    if is_lead(mesh):
        write_report(report, args.report)
        print(format_markdown(report))
        print(f"report -> {args.report}   (re-running resumes from "
              f"{args.store})")
    return report


if __name__ == "__main__":
    main()
