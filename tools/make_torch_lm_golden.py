"""Write ``tests/data/torch_lm_golden.npz`` and
``tests/data/torch_rwkv_golden.npz``: reduced Llama-3.2-1B and RWKV-6-7B
runs of the JAX package that the port's LM path is replayed against on
the GPU, where JAX is not installed.

    PYTHONPATH=src python tools/make_torch_lm_golden.py [lm] [rwkv]

(both files without arguments; a file is rewritten only when named, as
``np.savez_compressed`` stamps the time into it).

``torch_lm_golden.npz``: ``get_arch("llama3_2_1b").reduced(n_layers=4,
n_kv_heads=2)`` (4 query heads over 2 KV heads, head_dim 64, exits
(1, 2, 3, 4), float32; the ``reduced/*`` entries hold those arguments).
Its params are drawn with numpy from ``SEED`` by
``repro_torch.core.bridge.lm_params_numpy``, so the file holds the seed,
the tokens and the JAX outputs, and no weights:

* ``prefill/logits`` [B, V]: ``make_prefill_step`` on the first ``P``
  tokens;
* ``prefill/k``, ``prefill/v`` [L, B, P, KVH, hd]: the cache that JAX's
  ``serve_step`` writes when it is teacher-forced over the same ``P``
  tokens — the cache a prefill must return (the reference's own prefill
  cache is built from the ln2 output; see ``repro_torch/models/blocks.py``);
* ``serve/logits_<e>`` [T, B, V] for every exit ``e``: ``serve_step`` with
  ``exit_layer=e`` over all ``T`` tokens from an empty cache of ``T`` rows.

``torch_rwkv_golden.npz``: ``get_arch("rwkv6_7b").reduced(n_layers=4)``
(d_model 256, 8 heads of 32, chunk 32, exits (1, 2, 3, 4), float32),
params from ``lm_params_numpy`` as above:

* ``prefill/logits`` [B, V] and the prefill state ``prefill/wkv``
  [L, B, H, 32, 32], ``prefill/shift_tm``, ``prefill/shift_cm`` [L, B, d]:
  JAX's ``make_prefill_step`` over ``RWKV_P`` tokens (two chunks);
* ``serve/logits_<e>`` [T, B, V]: ``serve_step`` at exit ``e`` over the
  first ``T`` tokens from an empty state.

``tests/test_torch_models.py::test_lm_golden_is_current`` and
``::test_rwkv_golden_is_current`` rebuild them.
"""
from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro.configs import get_arch  # noqa: E402
from repro.models.lm import DecoderLM  # noqa: E402
from repro.train.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.core.bridge import lm_params_numpy  # noqa: E402

PATH = os.path.join(ROOT, "tests", "data", "torch_lm_golden.npz")
RWKV_PATH = os.path.join(ROOT, "tests", "data", "torch_rwkv_golden.npz")
ARCH, SEED, TOKEN_SEED = "llama3_2_1b", 0, 1
REDUCED = {"n_layers": 4, "n_kv_heads": 2}
B, P, T = 2, 8, 12
RWKV_ARCH, RWKV_REDUCED, RWKV_P = "rwkv6_7b", {"n_layers": 4}, 64
STATE_FIELDS = ("wkv", "shift_tm", "shift_cm")


def config(arch: str = ARCH):
    return get_arch(arch).reduced(**REDUCED)


def jax_params(cfg, seed: int = SEED):
    return jax.tree_util.tree_map(jnp.asarray, lm_params_numpy(cfg, seed))


def tokens(cfg, b: int = B, t: int = T, seed: int = TOKEN_SEED):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, t)).astype(np.int32)


def prefill(cfg, params, toks):
    """JAX prefill logits [B, V] of ``toks`` [B, S]."""
    logits, _ = jax.jit(make_prefill_step(cfg))(params,
                                                {"tokens": jnp.asarray(toks)})
    return np.asarray(logits)


def serve(cfg, params, toks, cache_len: int, exit_layer=None):
    """JAX ``serve_step`` teacher-forced over ``toks`` [B, S] from an empty
    cache of ``cache_len`` rows -> (logits [S, B, V], k, v [L, B, C, ...])."""
    step = jax.jit(make_serve_step(cfg, exit_layer=exit_layer))
    b, s = toks.shape
    cache = DecoderLM.init_cache(cfg, b, cache_len)
    out = []
    for t in range(s):
        logits, cache = step(params, cache, jnp.asarray(toks[:, t]),
                             jnp.full((b,), t, jnp.int32))
        out.append(np.asarray(logits))
    return (np.stack(out), np.asarray(cache["layers"].k),
            np.asarray(cache["layers"].v))


def build() -> dict:
    cfg = config()
    params = jax_params(cfg)
    toks = tokens(cfg)
    _, k, v = serve(cfg, params, toks[:, :P], P)
    gold = {"arch": np.array(ARCH), "seed": np.array(SEED),
            **{f"reduced/{name}": np.array(n) for name, n in REDUCED.items()},
            "tokens": toks, "prefill_len": np.array(P),
            "exits": np.array(cfg.exit_layers, np.int32),
            "prefill/logits": prefill(cfg, params, toks[:, :P]),
            "prefill/k": k, "prefill/v": v}
    for e in cfg.exit_layers:
        gold[f"serve/logits_{e}"], _, _ = serve(cfg, params, toks, T, e)
    return gold


def rwkv_config():
    return get_arch(RWKV_ARCH).reduced(**RWKV_REDUCED)


def rwkv_prefill(cfg, params, toks):
    """JAX prefill of ``toks`` [B, S] -> (logits [B, V], {field: [L, ...]}
    of the returned ``RWKVState``)."""
    logits, cache = jax.jit(make_prefill_step(cfg))(
        params, {"tokens": jnp.asarray(toks)})
    return np.asarray(logits), {f: np.asarray(getattr(cache["layers"], f))
                                for f in STATE_FIELDS}


def rwkv_serve(cfg, params, toks, exit_layer=None):
    """JAX ``serve_step`` teacher-forced over ``toks`` [B, S] from an empty
    state -> (logits [S, B, V], {field: [L, ...]} of the final state)."""
    step = jax.jit(make_serve_step(cfg, exit_layer=exit_layer))
    b, s = toks.shape
    cache = DecoderLM.init_cache(cfg, b, s)
    out = []
    for t in range(s):
        logits, cache = step(params, cache, jnp.asarray(toks[:, t]),
                             jnp.full((b,), t, jnp.int32))
        out.append(np.asarray(logits))
    return np.stack(out), {f: np.asarray(getattr(cache["layers"], f))
                           for f in STATE_FIELDS}


def build_rwkv() -> dict:
    cfg = rwkv_config()
    params = jax_params(cfg)
    toks = tokens(cfg, B, RWKV_P)
    logits, state = rwkv_prefill(cfg, params, toks)
    gold = {"arch": np.array(RWKV_ARCH), "seed": np.array(SEED),
            **{f"reduced/{name}": np.array(n)
               for name, n in RWKV_REDUCED.items()},
            "tokens": toks, "serve_len": np.array(T),
            "exits": np.array(cfg.exit_layers, np.int32),
            "prefill/logits": logits,
            **{f"prefill/{f}": x for f, x in state.items()}}
    for e in cfg.exit_layers:
        gold[f"serve/logits_{e}"], _ = rwkv_serve(cfg, params, toks[:, :T], e)
    return gold


def load(path: str = PATH) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


FILES = {"lm": (PATH, build), "rwkv": (RWKV_PATH, build_rwkv)}


def main(argv=None) -> None:
    for name in (argv if argv is not None else sys.argv[1:]) or list(FILES):
        path, make = FILES[name]
        gold = make()
        np.savez_compressed(path, **gold)
        print(f"wrote {path} ({os.path.getsize(path)} bytes): "
              f"{sorted(gold)}")


if __name__ == "__main__":
    main()
