"""Training and exit profiling of the multi-exit VGG-16 (paper §VI-B).

Counterpart of ``repro/vgg/train.py``. The paper first trains the main
branch on CIFAR-10, then trains the exit classifiers on top of the
pretrained backbone. The same two-stage recipe runs on the synthetic image
task:

  stage 1: backbone + main head, cross-entropy on exit 17;
  stage 2: exit heads only (the trunk frozen: only ``params["exits"]``
  requires grad), the mean CE over exits 1-16.

Both stages use Adam (the port's ``optim.adam``, the reference's
arithmetic) and run their convolutions, forward and backward, without
TF32 (``nn.f32_convolutions``). ``profile_exits`` then gives a
Table-I-shaped table: per-exit accuracy on held-out data, the measured
latency of a one-image forward on the params' device (``ms``; the
reference's ``cpu_ms``) and an analytic roofline latency (``roofline_ms``;
the reference's ``tpu_v5e_ms``) at ``peak_flops``/``hbm_bw``, the NVIDIA
H100's figures unless given.
"""
from __future__ import annotations

import time

import torch

from repro_torch.data import SyntheticImages
from repro_torch.device import resolve_device
from repro_torch.mec.profiles import (H100_HBM_BW, H100_PEAK_BF16_FLOPS,
                                      STEP_OVERHEAD_S)
from repro_torch.nn import f32_convolutions
from repro_torch.nn.pytree import flatten_dict, unflatten_dict
from repro_torch.optim import adam, apply_updates
from repro_torch.vgg.model import N_EXITS, VGG16EE


def _ce(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[:, None]))


def _generator(seed_or_generator, device) -> torch.Generator:
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    return torch.Generator(device=device).manual_seed(int(seed_or_generator))


def _adam_step(opt, loss_fn, trained: dict, state: dict):
    """One Adam step of the leaves of ``trained`` on ``loss_fn(trained)``;
    a leaf the loss does not reach gets a zero gradient, as under
    ``jax.value_and_grad``. Returns (trained, state, loss)."""
    flat = {k: v.detach().requires_grad_() for k, v
            in flatten_dict(trained).items()}
    with f32_convolutions():
        loss = loss_fn(unflatten_dict(flat))
        grads = torch.autograd.grad(loss, list(flat.values()),
                                    allow_unused=True, materialize_grads=True)
    with torch.no_grad():
        upd, state = opt.update(unflatten_dict(dict(zip(flat, grads))),
                                state, trained)
        trained = apply_updates(trained, upd)
    return trained, state, loss.detach()


def train_vgg_ee(seed_or_generator=0, *, width_mult: float = 0.25,
                 steps_main: int = 300, steps_exits: int = 300,
                 batch: int = 64, lr: float = 1e-3, noise: float = 0.8,
                 log_every: int = 0, device=None, params=None,
                 batches=None):
    """Two-stage training; returns (params, history dict of
    ``main_loss``/``exit_loss`` lists).

    The params (``VGG16EE.init`` at ``width_mult``) and every batch of
    ``SyntheticImages(noise=noise)`` are drawn from one generator (an int
    seeds one on ``device``, the card unless ``"cpu"``), unless ``params``
    (a tree on ``device``) or ``batches`` (an iterable of ``steps_main +
    steps_exits`` (images, labels) pairs) inject them.
    """
    device = resolve_device(device)
    gen = _generator(seed_or_generator, device)
    if params is None:
        params = VGG16EE.init(gen, width_mult=width_mult, device=device)
    data = SyntheticImages(noise=noise, device=device)
    feed = iter(batches) if batches is not None else None
    opt = adam(lr)

    def next_batch():
        if feed is not None:
            return next(feed)
        return data.sample(gen, batch)

    def log(stage, i, loss):
        if log_every and i % log_every == 0:
            print(f"[vgg stage{stage}] step {i} loss {float(loss):.3f}",
                  flush=True)

    # ---------------------------------------------------------- stage 1: main
    main_loss, state = [], opt.init(params)
    for i in range(steps_main):
        images, labels = next_batch()
        params, state, loss = _adam_step(
            opt, lambda p: _ce(VGG16EE.apply(p, images)[N_EXITS], labels),
            params, state)
        main_loss.append(loss)
        log(1, i, loss)

    # ------------------------------------------------- stage 2: frozen trunk
    def loss_exits(p_exits):
        outs = VGG16EE.apply({**params, "exits": p_exits}, images)
        losses = [_ce(v, labels) for k, v in outs.items() if k != N_EXITS]
        return sum(losses) / max(len(losses), 1)

    exit_loss, p_exits = [], params["exits"]
    state = opt.init(p_exits)
    for i in range(steps_exits):
        images, labels = next_batch()
        p_exits, state, loss = _adam_step(opt, loss_exits, p_exits, state)
        exit_loss.append(loss)
        log(2, i, loss)
    params = {**params, "exits": p_exits}
    hist = {"main_loss": [float(x) for x in main_loss],
            "exit_loss": [float(x) for x in exit_loss]}
    return params, hist


def roofline_ms(gflops: float, *, peak_flops: float = H100_PEAK_BF16_FLOPS,
                hbm_bw: float = H100_HBM_BW) -> float:
    """The reference's analytic exit latency, ms: the larger of the compute
    term at 15% of ``peak_flops`` and a memory term of 5% of the FLOPs in
    bytes at ``hbm_bw``, plus the fixed 50 us overhead."""
    t_comp = gflops * 1e9 / (peak_flops * 0.15)
    t_mem = gflops * 1e9 * 0.05 / hbm_bw     # ~bytes ≈ 5% of FLOPs
    return (max(t_comp, t_mem) + STEP_OVERHEAD_S) * 1e3


def _device_of(params) -> torch.device:
    return next(iter(flatten_dict(params).values())).device


@torch.no_grad()
def profile_exits(params, *, width_mult: float = 0.25,
                  eval_batches: int = 20, batch: int = 256,
                  noise: float = 0.8, data_seed: int = 0,
                  eval_seed: int = 10_000,
                  candidate_exits=(1, 3, 4, 7, 17), measure_ms: bool = True,
                  peak_flops: float = H100_PEAK_BF16_FLOPS,
                  hbm_bw: float = H100_HBM_BW, batches=None):
    """Accuracy and latency per candidate exit (the paper's Table I
    analogue), one row each: ``exit``, ``accuracy``, ``gflops``, ``ms``
    (with ``measure_ms``) and ``roofline_ms``.

    The eval split is the training task (``data_seed`` fixes the class
    prototypes) sampled from a generator seeded with ``eval_seed`` on the
    params' device, or ``batches`` ((images, labels) pairs) injected. An
    exit's prediction is the argmax of its own logits (``outs[max(outs)]``
    of the forward truncated there). ``ms`` is the mean of 10 one-image
    forwards after a warm-up, each waited for (a CUDA synchronize on the
    card)."""
    device = _device_of(params)
    data = SyntheticImages(noise=noise, seed=data_seed, device=device)
    gen = _generator(eval_seed, device)
    if batches is None:
        batches = [data.sample(gen, batch) for _ in range(eval_batches)]
    correct = {e: torch.zeros((), dtype=torch.long, device=device)
               for e in candidate_exits}
    n = 0
    with f32_convolutions():
        for images, labels in batches:
            for e in candidate_exits:
                outs = VGG16EE.apply(params, images, up_to_exit=e)
                pred = torch.argmax(outs[max(outs)], dim=-1)
                correct[e] += torch.sum(pred == labels)
            n += int(labels.shape[0])

        def wait():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        flops = VGG16EE.exit_flops(width_mult)
        rows = []
        for e in candidate_exits:
            row = {"exit": e, "accuracy": int(correct[e]) / n,
                   "gflops": flops[e]}
            if measure_ms:
                img1, _ = data.sample(gen, 1)
                VGG16EE.apply(params, img1, up_to_exit=e)     # warm-up
                wait()
                t0 = time.perf_counter()
                for _ in range(10):
                    VGG16EE.apply(params, img1, up_to_exit=e)
                    wait()
                row["ms"] = (time.perf_counter() - t0) * 100.0
            row["roofline_ms"] = roofline_ms(flops[e], peak_flops=peak_flops,
                                             hbm_bw=hbm_bw)
            rows.append(row)
    return rows
