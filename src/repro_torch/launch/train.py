"""Training driver: real LM train steps on one card (or the CPU).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \
        --steps 20 --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch llama3_2_1b --reduced --steps 5 --batch 2 --seq 32

The reference's CLI (``repro/launch/train.py``) and flags, plus
``--device`` (the GPU unless ``cpu``): random weights from ``--seed``,
AdamW under ``linear_warmup_cosine`` (warm-up a tenth of ``--steps``),
batches from ``TokenStream`` (Whisper also gets N(0, 1) audio frames
[batch, n_audio_frames, d_model] in the config's dtype), the loss printed
every ``--log-every`` steps and at the last, and the params saved in the
reference's checkpoint format with ``--checkpoint``. Every config
trains, RWKV-6 and Zamba2 through the differentiable ``ops.ssm_scan``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.steps import make_train_state, make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def train(args, *, log=print, cfg=None) -> dict:
    """Run ``args.steps`` train steps -> ``{"state", "losses", "step_s",
    "step_fn", "next_batch"}``: the final ``TrainState``, every step's
    loss, every step's wall seconds (batch drawn, step taken and its loss
    read back, which waits for the card), and the step function and batch
    source, with which a caller can take further steps. ``cfg``, if given,
    replaces ``args.arch``'s config (a caller's cut of it, such as a
    smaller depth)."""
    cfg = cfg or get_arch(args.arch, reduced=args.reduced)
    device = resolve_device(args.device)
    opt = adamw(linear_warmup_cosine(args.lr, args.steps // 10, args.steps))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state, opt = make_train_state(cfg, gen, opt, device=device)
    step_fn = make_train_step(cfg, opt)
    stream = TokenStream(cfg.vocab, seed=args.seed, device=device)
    dgen = torch.Generator(device=device).manual_seed(args.seed + 1)
    def next_batch():
        tokens, labels = stream.sample(dgen, args.batch, args.seq)
        batch = {"tokens": tokens, "labels": labels}
        if cfg.enc_layers:
            batch["audio"] = torch.randn(
                (args.batch, cfg.n_audio_frames, cfg.d_model),
                generator=dgen, device=device, dtype=cfg.torch_dtype)
        return batch

    losses, step_s = [], []
    t0 = time.time()
    for i in range(args.steps):
        ts = time.perf_counter()
        state, metrics = step_fn(state, next_batch())
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - ts)
        if i % args.log_every == 0 or i == args.steps - 1:
            log(f"step {i:5d}  loss {losses[-1]:.4f}  "
                f"({(time.time() - t0):.1f}s)")
    return {"state": state, "losses": losses, "step_s": step_s,
            "step_fn": step_fn, "next_batch": next_batch}


def main(argv=None) -> None:
    args = parse_args(argv)
    out = train(args, log=lambda line: print(line, flush=True))
    if args.checkpoint:
        save_checkpoint(args.checkpoint, out["state"].params)
        print(f"saved params -> {args.checkpoint}")


if __name__ == "__main__":
    main()
