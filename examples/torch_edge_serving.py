"""End-to-end edge serving on the PyTorch port: GRLE schedules early-exit
LM inference.

Two heterogeneous replicas ("edge servers") serve a multi-exit
Qwen-family model; the GRLE agent picks (replica, exit depth) per request
under deadlines, and with ``--decode`` the engine decodes tokens at the
chosen exit through ``make_serve_step(cfg, exit_layer=e)`` (its attention
through the ``decode_attention`` kernel on the card).

    PYTHONPATH=src python examples/torch_edge_serving.py [--slots 12 --decode]
    PYTHONPATH=src python examples/torch_edge_serving.py --device cpu \
        --slots 3 --decode

The reduced Qwen1.5-0.5B (float32) serves, as in the reference; its
weights and the agent come from the engine's seed (0), the requests'
tokens from numpy seed 0. The replicas' names say what they stand for
here: an H100 and an edge box a quarter as fast. Runs on the GPU unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.serve import EdgeServingEngine, Replica, Request  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--decode", action="store_true",
                    help="run real greedy decoding at the scheduled exits")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch("qwen1_5_0_5b", reduced=True)
    engine = EdgeServingEngine(
        cfg,
        replicas=[Replica("h100", speed=1.0),
                  Replica("edge-box", speed=0.25)],
        batch_slots=args.batch, device=args.device,
    )
    print(f"exit layers: {cfg.exit_layers}")
    print(f"per-exit latency table (s):\n{engine.exit_times}")

    rng = np.random.default_rng(0)
    slots = []
    for slot in range(args.slots):
        reqs = [Request(tokens=rng.integers(0, cfg.vocab, size=6,
                                            dtype=np.int32),
                        deadline_s=engine.env.cfg.deadline_s, max_new=4)
                for _ in range(args.batch)]
        assignments, info = engine.serve_slot(reqs, decode=args.decode)
        slots.append({"assignments": assignments, "reward": info["reward"],
                      "texts": info["texts"]})
        picks = ", ".join(f"{r}@L{e}" for r, e in assignments)
        extra = ""
        if args.decode:
            extra = f"  first-out={info['texts'][0]}"
        print(f"slot {slot:3d}  reward {info['reward']:.3f}  [{picks}]{extra}")
    summary = engine.metrics.summary()
    print("\nsummary:", summary)
    return {"summary": summary, "slots": slots,
            "train_steps": int(engine.agent_state.loss_count)}


if __name__ == "__main__":
    main()
