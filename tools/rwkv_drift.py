"""How far RWKV-6's prefill state and its teacher-forced decode state drift
apart, in the JAX reference and in the port.

    PYTHONPATH=src python tools/rwkv_drift.py [--layers 32] [--tokens 128]
    python3 tools/rwkv_drift.py --device cuda      # the port alone, no JAX

Both packages run the same model: ``get_arch("rwkv6_7b").reduced(
n_layers=32, d_model=512, d_ff=1792, vocab=4096, ssm_head_dim=64,
ssm_chunk=64)``, in bfloat16 and in float32, on B=2 sequences of
numpy-drawn tokens. Each prefills the tokens, then feeds the same tokens
one by one through ``serve_step`` from an empty state, and prints the
relative L2 distance between the two runs' last logits and every layer's
wkv, shift_tm and shift_cm. This is what ``chip_smoke.py`` phase 15
measures on the card at full width.

On the CPU (the default) both run the reference's own random init
(``repro.models.lm.DecoderLM.init``, key 0), carried into the port with
``lm_params_from_numpy``; there the port's prefill runs the plain
recurrence (``ops.ssm_scan`` on CPU tensors), the same arithmetic as its
decode step. With ``--device cuda`` only the port runs, its prefill
through the ``ssm_scan`` kernel, on params from the port's
``DecoderLM.init`` (the reference's distributions, torch seed 0); JAX is
not needed there. Takes a few minutes on the CPU, seconds on a GPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.bridge import lm_params_from_numpy  # noqa: E402
from repro_torch.models import DecoderLM  # noqa: E402
from repro_torch.train import make_prefill_step, make_serve_step  # noqa: E402

FIELDS = ("wkv", "shift_tm", "shift_cm")
B = 2


def rel(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


def drift(logits_p, cache_p, logits_d, cache_d, n_layers):
    out = {"logits": rel(as_numpy(logits_d), as_numpy(logits_p))}
    for f in FIELDS:
        a = as_numpy(getattr(cache_d["layers"], f))
        b = as_numpy(getattr(cache_p["layers"], f))
        out.update({f"{f}[{i}]": rel(a[i], b[i]) for i in range(n_layers)})
    return out


def run_jax(dtype, kw, toks):
    """The reference on its own init (key 0) -> (drift, params as numpy)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as jax_get_arch
    from repro.models.lm import DecoderLM as JaxLM
    from repro.train.steps import make_prefill_step as jax_prefill
    from repro.train.steps import make_serve_step as jax_serve

    cfg = jax_get_arch("rwkv6_7b").reduced(dtype=dtype, **kw)
    params = JaxLM.init(jax.random.PRNGKey(0), cfg)
    logits_p, cache_p = jax.jit(jax_prefill(cfg))(
        params, {"tokens": jnp.asarray(toks)})
    step = jax.jit(jax_serve(cfg))
    cache = JaxLM.init_cache(cfg, B, toks.shape[1])
    for t in range(toks.shape[1]):
        logits_d, cache = step(params, cache, jnp.asarray(toks[:, t]),
                               jnp.full((B,), t, jnp.int32))
    return (drift(logits_p, cache_p, logits_d, cache, cfg.n_layers),
            jax.tree_util.tree_map(np.asarray, params))


def run_port(cfg, params, toks, device):
    toks = torch.tensor(toks, device=device)
    logits_p, cache_p = make_prefill_step(cfg)(params, {"tokens": toks})
    step = make_serve_step(cfg)
    cache = DecoderLM.init_cache(cfg, B, toks.shape[1], device=device)
    for t in range(toks.shape[1]):
        logits_d, cache = step(params, cache, toks[:, t],
                               torch.full((B,), t, device=device))
    return drift(logits_p, cache_p, logits_d, cache, cfg.n_layers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    kw = dict(n_layers=args.layers, d_model=512, d_ff=1792, vocab=4096,
              ssm_head_dim=64, ssm_chunk=64)
    toks = np.random.default_rng(1).integers(
        0, kw["vocab"], size=(B, args.tokens)).astype(np.int32)
    shown = sorted({0, 1, args.layers // 4, args.layers // 2,
                    args.layers - 1})
    for dtype in ("bfloat16", "float32"):
        cfg = get_arch("rwkv6_7b").reduced(dtype=dtype, **kw)
        if args.device == "cpu":
            ref_row, np_params = run_jax(dtype, kw, toks)
            params = lm_params_from_numpy(np_params, cfg, "cpu")
            rows = (("reference", ref_row),
                    ("port", run_port(cfg, params, toks, "cpu")))
        else:
            params = DecoderLM.init(
                torch.Generator(device=args.device).manual_seed(0), cfg,
                device=args.device)
            rows = (("port", run_port(cfg, params, toks, args.device)),)
        for name, row in rows:
            worst = max(row.values())
            print(f"{dtype:8s} {name:9s} {args.device:4s} relative L2, "
                  f"decode vs prefill: logits {row['logits']:.3e}; "
                  + "; ".join(f"{f} " + " ".join(
                      f"[{i}] {row[f'{f}[{i}]']:.3e}" for i in shown)
                      for f in FIELDS)
                  + f"; worst {worst:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
