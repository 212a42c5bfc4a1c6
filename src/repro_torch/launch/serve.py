"""Serving driver: GRLE-scheduled early-exit LM inference.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_1b \
        --slots 10 --decode
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_2_7b \
        --slots 10 --decode
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch qwen1_5_0_5b --reduced --slots 2

Any config of ``configs/`` serves (Whisper decodes against zero encoder
output, as the reference's engine does). Runs on the GPU unless
``--device cpu``; the LM's weights are random (from ``--seed``).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.serve import EdgeServingEngine, Replica, Request

PROMPT_LEN, MAX_NEW, DEADLINE_S = 8, 4, 0.05


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--scheduler", default="grle",
                    choices=["grle", "grl", "static"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def make_engine(args) -> EdgeServingEngine:
    """The engine this CLI serves with: two replicas (the second at half
    speed), ``--batch`` slots, random LM weights from ``--seed``."""
    cfg = get_arch(args.arch, reduced=args.reduced)
    return EdgeServingEngine(
        cfg, [Replica("fast-pod", 1.0), Replica("slow-pod", 0.5)],
        scheduler=None if args.scheduler == "static" else args.scheduler,
        batch_slots=args.batch, seed=args.seed, device=args.device)


def slot_requests(rng: np.random.Generator, vocab: int, n: int) -> list:
    """One slot's ``n`` requests: ``PROMPT_LEN`` random tokens each,
    ``MAX_NEW`` new tokens, a deadline of ``DEADLINE_S``."""
    return [Request(tokens=rng.integers(0, vocab, size=PROMPT_LEN,
                                        dtype=np.int32),
                    deadline_s=DEADLINE_S, max_new=MAX_NEW)
            for _ in range(n)]


def main(argv=None) -> None:
    args = parse_args(argv)
    engine = make_engine(args)
    rng = np.random.default_rng(args.seed)
    for slot in range(args.slots):
        reqs = slot_requests(rng, engine.cfg.vocab, args.batch)
        assignments, info = engine.serve_slot(reqs, decode=args.decode)
        line = ", ".join(f"{r}@exit{e}" for r, e in assignments)
        print(f"slot {slot:3d} reward {info['reward']:.3f}  [{line}]",
              flush=True)
    print("summary:", engine.metrics.summary())


if __name__ == "__main__":
    main()
