"""Figure runner — one module per paper figure.

    PYTHONPATH=src python -m repro_torch.figures [--quick] [--only NAME,...]
        [--device cpu]

| module              | paper artifact |
|---------------------|----------------|
| convergence         | Fig 4          |
| vary_devices        | Fig 5          |
| vary_capacity       | Fig 6          |
| vary_inference_time | Fig 7          |
| imperfect_csi       | Fig 8          |

The counterpart of ``benchmarks/run.py`` for the port's figures. Each
module saves its rows as ``results/torch_<name>.json`` (``REPRO_RESULTS``
overrides the directory), stamped with where they were measured (on the
card its name and power limit), and appends them to the run-history store
(``REPRO_HISTORY``; the empty string disables it). Runs on the card unless
``--device cpu``. ``--only`` with an unknown module name is an error, not
a silent skip.
"""
from __future__ import annotations

import argparse
import difflib
import importlib
import time

from repro_torch.figures import FIGURES, accuracy_ratios


def digest(name: str, rows) -> None:
    """A module's rows as the reference's CSV digest lines, and for Figs
    5–8 GRLE's accuracy ratios."""
    for r in rows:
        if "avg_accuracy" in r:
            print(f"{name}/{r['method']}-M{r['n_devices']}"
                  f"-t{int(r['slot_ms'])},,acc={r['avg_accuracy']:.3f};"
                  f"ssp={r['ssp']:.3f};thr={r['throughput_tps']:.1f}")
        elif "final_moving_Qhat" in r:
            print(f"{name}/{r['method']},,Qhat={r['final_moving_Qhat']:.3f}")
        elif "final_moving_reward" in r:
            print(f"{name}/{r['method']},,"
                  f"reward={r['final_moving_reward']:.3f}")
    ratios = accuracy_ratios([r for r in rows if "avg_accuracy" in r])
    for other, vals in ratios.items():
        if vals:
            print(f"{name}/grle_over_{other},,max={max(vals):.3f};"
                  f"mean={sum(vals) / len(vals):.3f}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.figures",
        description="the paper's §VI figures through the port")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default="",
                    help=f"comma-separated subset of: {', '.join(FIGURES)}")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: the card)")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else set(FIGURES)
    unknown = sorted(only - set(FIGURES))
    if unknown:
        hints = []
        for name in unknown:
            close = difflib.get_close_matches(name, FIGURES, n=2)
            hints.append(name + (f" (did you mean {' or '.join(close)}?)"
                                 if close else ""))
        ap.error(f"unknown figure module(s): {'; '.join(hints)} "
                 f"(choose from {', '.join(FIGURES)})")
    all_rows = {}
    for name in FIGURES:
        if name not in only:
            continue
        t0 = time.perf_counter()
        print(f"=== {name} ===", flush=True)
        mod = importlib.import_module(f"repro_torch.figures.{name}")
        all_rows[name] = mod.run(quick=args.quick, device=args.device)
        print(f"=== {name} done in {time.perf_counter() - t0:.1f}s ===",
              flush=True)
    print("\n# digest")
    for name, rows in all_rows.items():
        digest(name, rows)
    return all_rows


if __name__ == "__main__":
    main()
