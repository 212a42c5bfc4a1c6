"""End-to-end training driver on the PyTorch port: the ~100M-parameter
multi-exit LM, a few hundred steps on synthetic Markov data.

The config is a scaled llama3-family decoder (12 layers, d_model 768, 12
heads over 4 KV heads, vocab 32768, float32, no remat; 125,851,392
params) with early-exit heads at layers {3, 6, 9, 12}: the paper's
mechanism trained exactly as the multi-exit VGG is (weighted multi-exit
CE), under AdamW with a linear warm-up and cosine decay. Attention runs the
``flash_attention`` kernel forward (head_dim 64, float32) with the plain
version's float32 backward. The params are saved in the reference's
checkpoint layout, zlib-compressed (the GPU machine has no
``zstandard``).

    PYTHONPATH=src python examples/torch_train_100m.py --steps 300
    PYTHONPATH=src python examples/torch_train_100m.py --device cpu \
        --steps 3 --batch 1 --seq 16 --checkpoint ''

Runs on the GPU unless ``--device cpu``; the params come from a generator
seeded 0, the batches from ``TokenStream(seed=0)`` walked by a generator
seeded 1.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.nn import tree_size  # noqa: E402
from repro_torch.optim import adamw, linear_warmup_cosine  # noqa: E402
from repro_torch.train.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.train.steps import (make_train_state,  # noqa: E402
                                     make_train_step)

CONFIG_100M = ArchConfig(
    arch_id="llama-100m", family="dense",
    n_layers=12, d_model=768, d_ff=2048, vocab=32768,
    attn_kind="gqa", n_heads=12, n_kv_heads=4,
    dtype="float32", remat=False,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--checkpoint", default="results/torch_llama100m.ckpt")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def train(args, *, log=print) -> dict:
    """``args.steps`` train steps of CONFIG_100M -> ``{"n_params",
    "losses", "metrics", "step_s", "state", "step_fn", "next_batch"}``:
    every step's loss, the last step's metrics (floats), every step's wall
    seconds (batch drawn, step taken, its loss read back), the final
    ``TrainState``, and the step function and batch source, with which a
    caller can take further steps."""
    cfg = CONFIG_100M
    dev = resolve_device(args.device)
    opt = adamw(linear_warmup_cosine(args.lr, 20, args.steps))
    state, opt = make_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), opt, device=dev)
    n_params = tree_size(state.params)
    log(f"params: {n_params:,}")
    step_fn = make_train_step(cfg, opt)

    stream = TokenStream(cfg.vocab, branching=64, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def next_batch():
        tokens, labels = stream.sample(gen, args.batch, args.seq)
        return {"tokens": tokens, "labels": labels}

    losses, step_s, metrics = [], [], {}
    t0 = time.time()
    for i in range(args.steps):
        ts = time.perf_counter()
        state, metrics = step_fn(state, next_batch())
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - ts)
        if i % 10 == 0 or i == args.steps - 1:
            exits = {k: round(float(v), 3) for k, v in metrics.items()
                     if k.startswith("ce_")}
            log(f"step {i:4d}  loss {losses[-1]:.4f}  per-exit {exits}  "
                f"({time.time() - t0:.0f}s)")
    return {"n_params": n_params, "losses": losses,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "step_s": step_s, "state": state, "step_fn": step_fn,
            "next_batch": next_batch}


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = train(args, log=lambda line: print(line, flush=True))
    if args.checkpoint:
        save_checkpoint(args.checkpoint, out["state"].params)
        print(f"saved -> {args.checkpoint}")
    out["checkpoint"] = args.checkpoint
    return out


if __name__ == "__main__":
    main()
