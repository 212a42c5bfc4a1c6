"""Where repro_torch's LM serving paths spend their time on one NVIDIA GPU.

    python3 tools/torch_lm_profile.py [--steps 20] [--arch ARCH ...]

Llama-3.2-1B and RWKV-6-7B (``--arch`` picks; both by default) at full
width in bf16 with random weights (torch.Generator seed 0). Under
``torch.profiler`` it runs, for Llama:

* one prefill at B=4, S=2048;
* ``--steps`` decode steps at B=8 against a 256-row cache holding a
  128-token prefill (positions 128..), at each exit (4, 8, 12, 16);
* 5 decode steps at B=64 against a full 4096-row cache (pos 4095), at
  each exit;

and for RWKV-6 (no cache length: the state is fixed-size):

* one prefill at B=4, S=2048;
* ``--steps`` decode steps at B=8 from the state of a 128-token prefill,
  at each exit (8, 16, 24, 32);
* 5 decode steps at B=64 from the state of a 256-token prefill, at each
  exit.

For each it prints one JSON line: wall ms per call (host clock, ends in a
synchronize; the profiler adds its own overhead), device kernel time,
the device's busy share (kernel time over wall time), CUDA kernel
launches per call, the hand-written kernels' device time and the top
kernels. Needs a GPU; refuses to run without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import DecoderLM  # noqa: E402
from repro_torch.train import make_prefill_step, make_serve_step  # noqa: E402
from torch_profiling import card, device_summary, profiled  # noqa: E402

# name fragments: "ssm_scan_" matches the bf16 (ssm_scan_bf16_kernel) and
# the float32 (ssm_scan_kernel) scan
OUR_KERNELS = ("flash_attention_kernel", "decode_attention_kernel",
               "ssm_scan_")
ARCHS = ("llama3_2_1b", "rwkv6_7b")


def measure(fn, n_calls: int) -> dict:
    """One warm-up call, then ``n_calls`` under the profiler; per call."""
    fn()
    torch.cuda.synchronize()
    prof, wall = profiled(fn, n_calls)
    return {"wall_ms_per_call": wall / n_calls * 1e3,
            **device_summary(prof, wall, n_calls, "call", OUR_KERNELS)}


def profile_llama(dev, steps, emit):
    cfg = get_arch("llama3_2_1b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = DecoderLM.init(gen, cfg, device=dev)
    prefill = make_prefill_step(cfg)

    toks = torch.randint(0, cfg.vocab, (4, 2048), generator=gen, device=dev)
    emit("prefill B=4 S=2048",
         measure(lambda: prefill(params, {"tokens": toks}), 1))

    # B=8: a 256-row cache holding a 128-token prefill
    b, p0 = 8, 128
    toks = torch.randint(0, cfg.vocab, (b, p0 + steps + 1),
                         generator=gen, device=dev)
    _, filled = prefill(params, {"tokens": toks[:, :p0]})
    for e in cfg.exit_layers:
        cache = DecoderLM.init_cache(cfg, b, 256, device=dev)
        cache["layers"].k[:, :, :p0] = filled["layers"].k
        cache["layers"].v[:, :, :p0] = filled["layers"].v
        step = make_serve_step(cfg, exit_layer=e)
        pos = [p0]

        def one():
            i = pos[0]
            step(params, cache, toks[:, i - p0],
                 torch.full((b,), i, dtype=torch.int64, device=dev))
            pos[0] += 1

        emit(f"decode B=8 cache 256 exit {e}", measure(one, steps))
        del cache
    del filled

    # B=64 against a full 4096-row cache, prefilled 16 sequences at a time
    b, s = 64, 4096
    cache = DecoderLM.init_cache(cfg, b, s, device=dev)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    for i in range(0, b, 16):
        _, c = prefill(params, {"tokens": toks[i:i + 16]})
        cache["layers"].k[:, i:i + 16] = c["layers"].k
        cache["layers"].v[:, i:i + 16] = c["layers"].v
        del c
    pos = torch.full((b,), s - 1, dtype=torch.int64, device=dev)
    for e in cfg.exit_layers:
        step = make_serve_step(cfg, exit_layer=e)
        emit(f"decode B=64 cache 4096 exit {e}",
             measure(lambda: step(params, cache, toks[:, -1], pos), 5))


def profile_rwkv(dev, steps, emit):
    cfg = get_arch("rwkv6_7b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = DecoderLM.init(gen, cfg, device=dev)
    prefill = make_prefill_step(cfg)

    toks = torch.randint(0, cfg.vocab, (4, 2048), generator=gen, device=dev)
    emit("prefill B=4 S=2048",
         measure(lambda: prefill(params, {"tokens": toks}), 1))

    # decode from the state of a prefill: B=8 after 128 tokens, B=64 after
    # 256; each step continues the sequence (the state is updated in place)
    for b, p0, n in ((8, 128, steps), (64, 256, 5)):
        toks = torch.randint(0, cfg.vocab, (b, p0 + n + 1), generator=gen,
                             device=dev)
        _, filled = prefill(params, {"tokens": toks[:, :p0]})
        for e in cfg.exit_layers:
            cache = {"layers": type(filled["layers"])(
                *(x.clone() for x in filled["layers"]))}
            step = make_serve_step(cfg, exit_layer=e)
            pos = [p0]

            def one():
                i = pos[0]
                step(params, cache, toks[:, i],
                     torch.full((b,), i, dtype=torch.int64, device=dev))
                pos[0] = min(i + 1, p0 + n)

            emit(f"decode B={b} after a {p0}-token prefill exit {e}",
                 measure(one, n))
            del cache
        del filled


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20,
                    help="decode steps in the profiler window at B=8")
    ap.add_argument("--arch", nargs="+", choices=ARCHS, default=list(ARCHS),
                    help="models to profile (default: both)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_lm_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card_name = card()
    print(card_name)
    dev = torch.device("cuda")
    for arch in args.arch:
        def emit(name, row):
            print(json.dumps({"arch": arch, "case": name, **row,
                              "card": card_name}), flush=True)

        {"llama3_2_1b": profile_llama, "rwkv6_7b": profile_rwkv}[arch](
            dev, args.steps, emit)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
