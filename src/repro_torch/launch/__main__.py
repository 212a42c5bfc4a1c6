"""Subcommand dispatch: ``python -m repro_torch.launch <command> [args...]``.

Commands:
  sweep       (scenario x method x seed) experiment grids, packed on one card
  pop         population training: PBT + scenario auto-curriculum
  serve       GRLE-scheduled early-exit LM serving driver
  serve-bench serving throughput: the sync slot loop vs continuous batching
  train       LLM training-step driver
  dryrun      one-card dry run: static bytes and analytic cost per arch x shape
  profile     instrumented rollout: telemetry + compile/trace + JSONL log
  history     run-history trend tables + noise-aware regression verdicts

``python -m repro_torch.launch.serve`` style module paths keep working;
this entry point just gives the drivers one front door. Every command runs
on the card unless its ``--device cpu`` asks otherwise (``dryrun`` builds
on the meta device and needs none).
"""
from __future__ import annotations

import importlib
import sys

COMMANDS = ("sweep", "pop", "serve", "serve-bench", "train", "dryrun",
            "profile", "history")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0 if argv else 2)
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; choose from {', '.join(COMMANDS)}")
        raise SystemExit(2)
    module = cmd.replace("-", "_")
    importlib.import_module(f"repro_torch.launch.{module}").main(rest)


if __name__ == "__main__":
    main()
