"""The port's LM steps partitioned on DTensors (``train.steps``, the
models' DTensor routes, ``ops``' ``local_map`` kernels, ``sharding/
runtime.py``'s constraints) on a ("data", "model") 2x2 mesh of four gloo
CPU ranks, against the unsharded port and the JAX reference.

Reduced Llama (flash path; exits (1, 2), remat), RWKV-6 (``ssm_scan``
path; remat, chunks of 8 rows) and DeepSeek-MoE (expert-parallel MoE), in
float32, on ``lm_params_numpy`` params and the batches of
``tests/data/torch_train_golden.npz`` (``tools/make_torch_train_golden.
py``, whose configs these are): the partitioned prefill's logits and
cache, one decode step after it (logits and cache), the gradients at the
initial params, and the golden's two AdamW steps (metrics, then params,
mu and nu). Tolerances are the repo's LM ones: logits, caches and decode
1e-4 of the largest |value|; gradients 1e-4 of the leaf's largest
|value|; losses 1e-5 relative; params after Adam by ``chip_smoke.
adam_rule``. The JAX side: prefill and decode run live
(``make_prefill_step``/``make_serve_step`` of the reference on the same
params and cache), the train steps come from the golden file. Every rank
returns the same whole tensors, bit for bit. ``seq_parallel`` (the
block-boundary sequence split) gives the numbers the default gives; the
attention kernels on DTensors (K/V heads split with the query, or
sliced from the whole set) equal the whole call at 1e-5.
"""
from __future__ import annotations

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_tasks as T
from repro.configs import get_arch as jax_get_arch
from repro.models.lm import model_for as jax_model_for
from repro.train.steps import make_prefill_step as jax_prefill_step
from repro.train.steps import make_serve_step as jax_serve_step
from repro_torch.sharding.ranks import RankPool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

sys.path.pop(0)

ARCHS = ("llama3_2_1b", "rwkv6_7b", "deepseek_moe_16b")
MODEL_TOL = 1e-4
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
ATTN_TOL = 1e-5
GOLD = np.load(chip_smoke.LM_TRAIN_GOLDEN)


def overrides(arch: str) -> dict:
    kw = {"exit_layers": tuple(int(e) for e in GOLD[f"{arch}/exit_layers"]),
          "remat": bool(GOLD[f"{arch}/remat"])}
    if f"{arch}/ssm_chunk" in GOLD:
        kw["ssm_chunk"] = int(GOLD[f"{arch}/ssm_chunk"])
    return kw


def spec(arch: str, **extra) -> dict:
    steps = GOLD[f"{arch}/loss"].shape[0]
    batches = [{k: GOLD[f"{arch}/{k}"][t] for k in ("tokens", "labels")}
               for t in range(steps)]
    rng = np.random.default_rng(5)
    lr, warm, decay = (float(x) for x in GOLD["lm_schedule"])
    return {"arch": arch, "overrides": overrides(arch),
            "seed": int(GOLD["lm_seed"]), "batches": batches,
            "next": rng.integers(0, 512, size=batches[0]["tokens"].shape[0]),
            "schedule": (lr, int(warm), int(decay)),
            "weight_decay": float(GOLD["lm_weight_decay"]), **extra}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (every rank's run, the unsharded run)}: each arch, and
    Llama under seq_parallel; plus the attention kernels' cases."""
    torch.set_num_threads(1)
    rdv = tmp_path_factory.mktemp("rdv") / "file"
    cases = {a: spec(a) for a in ARCHS}
    cases["llama3_2_1b+seq_parallel"] = spec("llama3_2_1b",
                                            seq_parallel=True)
    out = {}
    with RankPool(4, init_method=f"file://{rdv}") as pool:
        for name, sp in cases.items():
            out[name] = (pool.run(T.partitioned_lm, sp),
                         T.partitioned_lm(sp, sharded=False))
        for kvh in (1, 2):
            out[f"attention/{kvh}"] = pool.run(
                T.sharded_attention, {"seed": 3, "kvh": kvh})
    return out


def close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= tol, f"{what}: {err:.3e} of the largest |value|"


@functools.lru_cache(maxsize=None)
def jax_side(arch: str):
    """The reference's config and params (jnp) for ``arch``."""
    cfg = jax_get_arch(arch).reduced(**overrides(arch))
    from repro_torch.core.bridge import lm_params_numpy
    params = jax.tree_util.tree_map(
        jnp.asarray, lm_params_numpy(cfg, int(GOLD["lm_seed"])))
    return cfg, params


@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_return_the_same_tensors(runs, arch):
    ranks, _ = runs[arch]
    for r in ranks[1:]:
        for key in ("prefill_logits", "decode_logits"):
            np.testing.assert_array_equal(r[key], ranks[0][key])
        for a, b in zip(r["decode_cache"], ranks[0]["decode_cache"]):
            np.testing.assert_array_equal(a, b)
        for path, g in r["grads"].items():
            np.testing.assert_array_equal(g, ranks[0]["grads"][path])
        for name, tree in r["state"].items():
            for path, x in tree.items():
                np.testing.assert_array_equal(
                    x, ranks[0]["state"][name][path])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_unsharded_and_reference(runs, arch):
    (got, *_), whole = runs[arch]
    close(got["prefill_logits"], whole["prefill_logits"], MODEL_TOL)
    for a, b in zip(got["prefill_cache"], whole["prefill_cache"]):
        close(a, b, MODEL_TOL, "cache")
    cfg, params = jax_side(arch)
    want = jax.jit(jax_prefill_step(cfg))(
        params, {"tokens": jnp.asarray(spec(arch)["batches"][0]["tokens"])})
    close(got["prefill_logits"], want[0] if isinstance(want, tuple)
          else want, MODEL_TOL, "reference")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_unsharded_and_reference(runs, arch):
    """One decode step at position S after the prefill: the sharded step
    against the unsharded one, and against the reference's serve step on
    the unsharded run's cache."""
    (got, *_), whole = runs[arch]
    close(got["decode_logits"], whole["decode_logits"], MODEL_TOL)
    for a, b in zip(got["decode_cache"], whole["decode_cache"]):
        close(a, b, MODEL_TOL, "cache")
    cfg, params = jax_side(arch)
    sp = spec(arch)
    b, s = sp["batches"][0]["tokens"].shape
    like = jax_model_for(cfg).init_cache(cfg, b, s + 1)
    leaves, tree = jax.tree_util.tree_flatten(like)
    assert [x.shape for x in leaves] == [a.shape
                                         for a in whole["prefill_cache"]] \
        or len(leaves) == len(whole["prefill_cache"])
    filled = []
    for x, a in zip(leaves, whole["prefill_cache"]):
        z = np.zeros(x.shape, dtype=np.asarray(x).dtype)
        z[tuple(slice(0, n) for n in a.shape)] = a
        filled.append(jnp.asarray(z))
    logits, _ = jax.jit(jax_serve_step(cfg))(
        params, jax.tree_util.tree_unflatten(tree, filled),
        jnp.asarray(sp["next"], jnp.int32), jnp.full((b,), s, jnp.int32))
    close(got["decode_logits"], logits, MODEL_TOL, "reference")


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_unsharded_and_reference(runs, arch):
    (got, *_), whole = runs[arch]
    assert sorted(got["grads"]) == sorted(whole["grads"]) == sorted(
        got["state"]["params"])
    for path, g in got["grads"].items():
        close(g, whole["grads"][path], GRAD_TOL, path)
        idx = GOLD[f"{arch}/idx/{path}"]
        want = GOLD[f"{arch}/grads/0/{path}"]
        m = float(GOLD[f"{arch}/grad_max/0/{path}"])
        err = float(np.abs(g.reshape(-1)[idx] - want).max()) / max(m, 1e-30)
        assert err <= GRAD_TOL, f"{path}: {err:.3e} of the leaf's max |g|"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_unsharded_and_reference(runs, arch):
    """The golden's AdamW steps: each step's loss, CE and MoE metrics
    against the unsharded run and the reference's (1e-5 relative, the
    dropped fraction exactly); the params against the reference's and
    the unsharded run's by the Adam rule (the unsharded run's first
    gradients mark its near-ties), mu and nu against the unsharded
    run's."""
    (got, *_), whole = runs[arch]
    for t, (m, w) in enumerate(zip(got["metrics"], whole["metrics"])):
        assert sorted(m) == sorted(w)
        for k, v in m.items():
            if k == "moe_dropped":
                assert v == w[k] == float(GOLD[f"{arch}/moe_dropped"][t])
                continue
            assert abs(v - w[k]) <= LOSS_RTOL * max(abs(w[k]), 1e-30), k
            if f"{arch}/{k}" in GOLD:
                ref = float(GOLD[f"{arch}/{k}"][t])
                assert abs(v - ref) <= LOSS_RTOL * max(abs(ref), 1e-30), k
    n_steps = len(got["metrics"])
    for path, x in got["state"]["params"].items():
        idx = GOLD[f"{arch}/idx/{path}"]
        bad, _ = chip_smoke.adam_rule(
            x.reshape(-1)[idx], GOLD[f"{arch}/params/{path}"],
            *chip_smoke._step_grads(GOLD, arch, path, n_steps))
        assert bad == 0, f"params {path}: {bad} entries off the reference"
    for path, x in got["state"]["params"].items():
        g = whole["grads"][path]
        bad, _ = chip_smoke.adam_rule(
            x, whole["state"]["params"][path], [g],
            [float(np.abs(g).max())])
        assert bad == 0, f"params {path}: {bad} entries off"
    # the moments are sums of the steps' gradients (mu) and their squares
    # (nu): the gradients' tolerance of the leaf's largest |value|, twice
    # it for the squares
    for name, tol in (("mu", GRAD_TOL), ("nu", 2 * GRAD_TOL)):
        for path, x in got["state"][name].items():
            close(x, whole["state"][name][path], tol, f"{name} {path}")


def test_seq_parallel_gives_the_same_numbers(runs):
    """``REPRO_OPT=seq_parallel``'s block-boundary sequence split changes
    where the collectives fall, not the numbers."""
    (sp, *_), _ = runs["llama3_2_1b+seq_parallel"]
    (base, *_), _ = runs["llama3_2_1b"]
    close(sp["prefill_logits"], base["prefill_logits"], MODEL_TOL)
    close(sp["decode_logits"], base["decode_logits"], MODEL_TOL)
    for path, g in sp["grads"].items():
        close(g, base["grads"][path], GRAD_TOL, path)
    for m, w in zip(sp["metrics"], base["metrics"]):
        assert abs(m["loss"] - w["loss"]) <= LOSS_RTOL * abs(w["loss"])


@pytest.mark.parametrize("kvh", (1, 2))
def test_attention_kernels_on_dtensors(runs, kvh):
    """``ops.flash_attention`` (window 6; q, k, v gradients) and
    ``ops.decode_attention`` with q heads over ``model``: K/V heads split
    with them (2 over 2) or each device slicing its one from the whole
    set (1 over 2), against the whole call."""
    for rank in runs[f"attention/{kvh}"]:
        got, want = rank["sharded"], rank["whole"]
        assert len(got["grads"]) == len(want["grads"]) == 3
        close(got["flash"], want["flash"], ATTN_TOL, "flash")
        close(got["decode"], want["decode"], ATTN_TOL, "decode")
        for a, b in zip(got["grads"], want["grads"]):
            close(a, b, ATTN_TOL, "grad")
