"""Does the port learn like the reference? Statistics over seeds.

Torch cannot reproduce the reference's threefry streams, so runs on the
port's own generator are held against the reference's by statistics over
seeds (the RNG convention). Per method (GRLE and DROOE) on fig5_baseline
with the paper's learner (ring 128, minibatch 64, a train step every 10
slots), the port's mean ``final_loss``, ``ssp`` and ``avg_accuracy`` over
the seeds must lie within ``LEARN_SE`` standard errors of the reference's
mean, the standard error being that of the reference's mean, s_ref / √n.
The runs go through ``sweep.run_sweep``, so one episode (on the card: one
capture of its two CUDA graphs) serves every seed of a method family.

``final_loss`` (the last train step's loss) is what needs learning: the
control, the cells of the spec's first ``CONTROL_SEEDS`` seeds with every
train step's Adam updates scaled to a learning rate of ``CONTROL_LR``
(``RolloutDriver.run``'s ``hypers``, as the population drives it), must
fall outside the band.

The reference's side is ``tests/data/torch_figures_golden.npz``
(``tools/make_torch_figures_golden.py``): per seed and method its rows at
``CPU_SPEC`` (the CPU test's cut: M=6, eight fleets, 50 slots, five train
steps) and at ``CARD_SPEC`` (M=14, one fleet, 600 slots, 54 train steps).
"""
from __future__ import annotations

import functools
import json
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sweep import SweepSpec, run_sweep
from repro_torch.sweep.packer import pack_cells
from repro_torch.sweep.runner import PackProgram

LEARN_SE = 3.0        # |port mean - reference mean| within 3 standard errors
LEARN_KEYS = ("final_loss", "ssp", "avg_accuracy")
CONTROL_LR = 1e-12
CONTROL_SEEDS = 4     # the control runs the spec's first 4 seeds
_LEARNER = dict(scenarios=("fig5_baseline",), methods=("grle", "drooe"),
                seeds=tuple(range(16)), slot_ms=30.0, replay_capacity=128,
                batch_size=64, train_every=10)
CPU_SPEC = dict(_LEARNER, n_devices=6, n_fleets=8, n_slots=50)
CARD_SPEC = dict(_LEARNER, n_devices=14, n_fleets=1, n_slots=600)


class _Rate(NamedTuple):
    """``hypers`` with only a learning rate (0-d tensor)."""
    lr: torch.Tensor
    explore_gain: Optional[torch.Tensor] = None


def spec_json(spec: dict) -> str:
    """A spec's canonical text, as the golden file stores it."""
    return json.dumps({k: list(v) if isinstance(v, tuple) else v
                       for k, v in sorted(spec.items())})


def learning_rows(spec: dict, *, device=None, lr: Optional[float] = None,
                  log=print) -> list:
    """The sweep's rows for ``spec`` (``SweepSpec`` keywords) through
    ``run_sweep``; with ``lr``, the same cells through the same pack
    programs with each train step's updates scaled to ``lr``."""
    dev = resolve_device(device)
    sweep = SweepSpec(**spec)
    if lr is None:
        return run_sweep(sweep, device=dev, log=log)
    rows = []
    for pack in pack_cells(sweep.expand()):
        prog = PackProgram(pack, device=dev)
        prog.driver.run = functools.partial(
            prog.driver.run,
            hypers=_Rate(torch.tensor(lr, dtype=torch.float32, device=dev)))
        rows += prog.run()
    return rows


def gaps(rows, ref: dict) -> list:
    """Per method and key of ``LEARN_KEYS``: the port's and the reference's
    means over seeds, the reference mean's standard error and the gap in
    standard errors. ``ref`` maps "<method>/<key>" to the reference's
    per-seed values."""
    out = []
    for method in sorted({r["method"] for r in rows}):
        for key in LEARN_KEYS:
            a = np.asarray([r[key] for r in rows if r["method"] == method],
                           np.float64)
            b = np.asarray(ref[f"{method}/{key}"], np.float64)
            se = b.std(ddof=1) / np.sqrt(b.size)
            gap = abs(a.mean() - b.mean())
            out.append(dict(method=method, key=key, port=float(a.mean()),
                            ref=float(b.mean()), se=float(se),
                            n=int(a.size),
                            gap_se=float(gap / se) if se > 0
                            else (0.0 if gap == 0 else float("inf"))))
    return out


def learning_check(spec: dict, ref: dict, *, device=None,
                   log=print) -> dict:
    """The check at ``spec`` against the reference's per-seed values
    ``ref``: {"trained": gaps, "control": gaps, "ok": every trained gap
    within ``LEARN_SE``, "control_rejected": each method's control
    ``final_loss`` outside it}. Prints every gap; asserts nothing."""
    trained = gaps(learning_rows(spec, device=device, log=_quiet), ref)
    control = gaps(learning_rows(
        dict(spec, seeds=spec["seeds"][:CONTROL_SEEDS]), device=device,
        lr=CONTROL_LR, log=_quiet), ref)
    for label, rows in (("trained", trained), (f"lr {CONTROL_LR:g}",
                                               control)):
        for g in rows:
            log(f"  learning {label:9s} {g['method']:6s} {g['key']:13s} "
                f"port {g['port']:.6f} ref {g['ref']:.6f} "
                f"se {g['se']:.3g} gap {g['gap_se']:.2f} se")
    return {
        "trained": trained, "control": control,
        "ok": all(g["gap_se"] <= LEARN_SE for g in trained),
        "control_rejected": all(g["gap_se"] > LEARN_SE for g in control
                                if g["key"] == "final_loss"),
    }


def _quiet(*_args) -> None:
    """A log that prints nothing."""
