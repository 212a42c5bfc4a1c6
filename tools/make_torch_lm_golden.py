"""Write ``tests/data/torch_lm_golden.npz``,
``tests/data/torch_rwkv_golden.npz`` and
``tests/data/torch_lm_zoo_golden.npz``: reduced Llama-3.2-1B, RWKV-6-7B,
Zamba2, DeepSeek-MoE, DeepSeek-V2 and Whisper runs of the JAX package
that the port's LM path is replayed against on the GPU, where JAX is not
installed.

    PYTHONPATH=src python tools/make_torch_lm_golden.py [lm] [rwkv] [zoo]

(every file without arguments; a file is rewritten only when named, as
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

``torch_lm_zoo_golden.npz``: the four families of the rest of the zoo,
``get_arch(a).reduced(n_layers=4)`` for ``a`` in ``ZOO`` (Zamba2: Mamba-2
layers of d_state 16 and heads of 32, chunk 32, the shared block every 2
layers; DeepSeek-MoE: 4 experts, top 2, one shared; DeepSeek-V2: MLA at
rank 64 with the same MoE; Whisper: 2 encoder layers over 16 frames),
float32, exits (1, 2, 3, 4), params from ``lm_params_numpy``, per arch
``a``:

* ``a/tokens`` [B, ZOO_P]; ``a/prefill/logits`` [B, V]:
  ``make_prefill_step`` over them (two Mamba chunks); Whisper's prefill
  also takes the frames ``zoo_audio(cfg)`` (numpy, ``ZOO_AUDIO_SEED``);
* ``a/serve/logits_<e>`` [T, B, V]: ``serve_step`` at exit ``e`` over the
  first ``T`` tokens from an empty cache of ``T`` rows (Whisper's
  ``enc_out`` the encoder's output over those frames);
* for the MoE archs ``a/experts`` [B, ZOO_P, k] and ``a/keep`` [B, k P]:
  layer 0's routing of the embedded prompt (top-k experts; which choices
  fit the capacity).

``tests/test_torch_models.py::test_lm_golden_is_current``,
``::test_rwkv_golden_is_current`` and
``tests/test_torch_models_zoo.py::test_zoo_golden_is_current`` rebuild
them.
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
from repro.models.lm import DecoderLM, EncDecLM, model_for  # noqa: E402
from repro.nn import Embedding, Linear  # noqa: E402
from repro.train.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.core.bridge import lm_params_numpy  # noqa: E402

PATH = os.path.join(ROOT, "tests", "data", "torch_lm_golden.npz")
RWKV_PATH = os.path.join(ROOT, "tests", "data", "torch_rwkv_golden.npz")
ZOO_PATH = os.path.join(ROOT, "tests", "data", "torch_lm_zoo_golden.npz")
ARCH, SEED, TOKEN_SEED = "llama3_2_1b", 0, 1
REDUCED = {"n_layers": 4, "n_kv_heads": 2}
B, P, T = 2, 8, 12
RWKV_ARCH, RWKV_REDUCED, RWKV_P = "rwkv6_7b", {"n_layers": 4}, 64
STATE_FIELDS = ("wkv", "shift_tm", "shift_cm")
ZOO = ("zamba2_2_7b", "deepseek_moe_16b", "deepseek_v2_236b",
       "whisper_medium")
ZOO_REDUCED, ZOO_P, ZOO_AUDIO_SEED = {"n_layers": 4}, 64, 3


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


def zoo_config(arch: str):
    return get_arch(arch).reduced(**ZOO_REDUCED)


def zoo_audio(cfg, b: int = B, seed: int = ZOO_AUDIO_SEED):
    """Whisper's stub frontend output [b, n_audio_frames, d]: N(0, 1)."""
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)


def zoo_prefill(cfg, params, toks, audio=None):
    """JAX prefill logits [B, V] of ``toks`` (and Whisper's frames)."""
    batch = {"tokens": jnp.asarray(toks)}
    if cfg.enc_layers:
        batch["audio"] = jnp.asarray(audio)
        return np.asarray(jax.jit(make_prefill_step(cfg))(params, batch))
    return np.asarray(jax.jit(make_prefill_step(cfg))(params, batch)[0])


def zoo_serve(cfg, params, toks, cache_len: int, exit_layer=None,
              audio=None):
    """JAX ``serve_step`` teacher-forced over ``toks`` [B, S] from an empty
    cache of ``cache_len`` rows (Whisper's ``enc_out`` the encoder's output
    over ``audio``) -> (logits [S, B, V], the final cache)."""
    model = model_for(cfg)
    step = jax.jit(make_serve_step(cfg, exit_layer=exit_layer))
    b, s = toks.shape
    cache = model.init_cache(cfg, b, cache_len)
    if cfg.enc_layers:
        cache["enc_out"] = EncDecLM.encode(params, cfg, jnp.asarray(audio))
    out = []
    for t in range(s):
        logits, cache = step(params, cache, jnp.asarray(toks[:, t]),
                             jnp.full((b,), t, jnp.int32))
        out.append(np.asarray(logits))
    return np.stack(out), cache


def moe_routing(cfg, ffn, x):
    """The MoE routing of x [g, t, d] by one layer's ``ffn`` params, the
    steps of the reference's ``MoEFFN._routed`` (which returns none of
    them): (top-k experts [g, t, k], keep [g, k t] of the k-major
    choices)."""
    x = jnp.asarray(x).astype(jnp.float32)
    b, t, _ = x.shape
    k, e = cfg.top_k, cfg.n_experts
    probs = jax.nn.softmax(Linear.apply(ffn["router"], x), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    flat_e = idx.transpose(0, 2, 1).reshape(b, k * t)
    rank = jnp.cumsum(jax.nn.one_hot(flat_e, e, dtype=jnp.int32), axis=1) - 1
    slot = jnp.take_along_axis(rank, flat_e[..., None], -1)[..., 0]
    # the capacity as the reference's MoEFFN._routed computes it
    cap = min(max(1, int(np.ceil(t * k / e * cfg.capacity_factor))), t)
    return np.asarray(idx, np.int32), np.asarray(slot < cap)


def zoo_routing(cfg, params, toks):
    """Layer 0's MoE routing of the embedded ``toks`` [B, S]."""
    ffn = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["ffn"])
    return moe_routing(cfg, ffn, Embedding.apply(params["embed"],
                                                 jnp.asarray(toks)))


def build_zoo() -> dict:
    gold = {"seed": np.array(SEED), "archs": np.array(ZOO),
            "prefill_len": np.array(ZOO_P), "serve_len": np.array(T),
            "audio_seed": np.array(ZOO_AUDIO_SEED),
            **{f"reduced/{name}": np.array(n)
               for name, n in ZOO_REDUCED.items()}}
    for arch in ZOO:
        cfg = zoo_config(arch)
        params = jax_params(cfg)
        toks = tokens(cfg, B, ZOO_P)
        audio = zoo_audio(cfg) if cfg.enc_layers else None
        gold[f"{arch}/tokens"] = toks
        gold[f"{arch}/exits"] = np.array(cfg.exit_layers, np.int32)
        gold[f"{arch}/prefill/logits"] = zoo_prefill(cfg, params, toks, audio)
        for e in cfg.exit_layers:
            gold[f"{arch}/serve/logits_{e}"], _ = zoo_serve(
                cfg, params, toks[:, :T], T, e, audio)
        if cfg.is_moe:
            gold[f"{arch}/experts"], gold[f"{arch}/keep"] = zoo_routing(
                cfg, params, toks)
    return gold


def load(path: str = PATH) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


FILES = {"lm": (PATH, build), "rwkv": (RWKV_PATH, build_rwkv),
         "zoo": (ZOO_PATH, build_zoo)}


def main(argv=None) -> None:
    for name in (argv if argv is not None else sys.argv[1:]) or list(FILES):
        path, make = FILES[name]
        gold = make()
        np.savez_compressed(path, **gold)
        print(f"wrote {path} ({os.path.getsize(path)} bytes): "
              f"{sorted(gold)}")


if __name__ == "__main__":
    main()
