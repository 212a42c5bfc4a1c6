"""The port's decoder LM against the JAX package, module by module and as
a whole: prefill and early-exit decode of reduced Llama-3.2-1B,
InternLM2-20B and Chameleon-34B (GQA, 4 heads over 2 KV heads),
Qwen1.5-0.5B (MHA with QKV bias) and StableLM-3B (MHA), float32 on the
CPU, on numpy-drawn params carried across with
``lm_params_from_numpy``. ``tests/data/torch_lm_golden.npz`` carries such
a run to the GPU machine, where JAX is not installed; the last test here
keeps it current.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_arch as jax_get_arch
from repro.models.attention import GQAAttention as JaxGQA
from repro.models.ffn import DenseFFN as JaxFFN
from repro.models.lm import DecoderLM as JaxLM
from repro.models.rope import apply_rope as jax_rope
from repro.nn import Embedding as JaxEmbedding
from repro.nn import RMSNorm as JaxRMSNorm
from repro.train.steps import make_prefill_step as jax_make_prefill_step
from repro_torch.configs import get_arch
from repro_torch.core.bridge import lm_params_from_numpy, lm_params_numpy
from repro_torch.kernels import ops
from repro_torch.models import DecoderLM
from repro_torch.models.attention import GQAAttention
from repro_torch.models.ffn import DenseFFN
from repro_torch.models.rope import apply_rope
from repro_torch.nn import Embedding, RMSNorm
from repro_torch.train import make_prefill_step, make_serve_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
import make_torch_lm_golden as golden_tool  # noqa: E402

sys.path.pop(0)
sys.path.pop(0)
torch.set_num_threads(1)

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)   # f32, one module
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)    # f32, logits through the model
PORTED = ("llama3_2_1b", "qwen1_5_0_5b", "stablelm_3b", "internlm2_20b",
          "chameleon_34b")
# the configs with fewer KV heads than heads at full width
GQA = ("llama3_2_1b", "internlm2_20b", "chameleon_34b")
B, P, T = 2, 8, 16


def configs(arch):
    """(port cfg, JAX cfg) of the reduced variant the tests run: 4 layers,
    exits (1, 2, 3, 4); the GQA configs keep GQA with 4 heads over 2 KV
    heads."""
    kw = dict(n_layers=4)
    if arch in GQA:
        kw["n_kv_heads"] = 2
    return get_arch(arch).reduced(**kw), jax_get_arch(arch).reduced(**kw)


def params(cfg, seed=0):
    """(port params, JAX params) of one numpy draw."""
    tree = lm_params_numpy(cfg, seed)
    return (lm_params_from_numpy(tree, cfg, "cpu"),
            jax.tree_util.tree_map(jnp.asarray, tree))


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_copy_equals_reference(arch):
    ref, port = jax_get_arch(arch), get_arch(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(
        ref.reduced())
    assert port.torch_dtype == {"bfloat16": torch.bfloat16,
                                "float32": torch.float32}[ref.dtype]


@pytest.mark.parametrize("arch", PORTED)
def test_param_shapes_equal_reference_init(arch):
    for port, ref in ((get_arch(arch), jax_get_arch(arch)),
                      configs(arch)):
        shapes = jax.eval_shape(lambda k: JaxLM.init(k, ref),
                                jax.random.PRNGKey(0))
        want = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
        assert DecoderLM.param_shapes(port) == want
        dtypes = {str(s.dtype) for s in jax.tree_util.tree_leaves(shapes)}
        assert dtypes == {port.dtype}


# --------------------------------------------------------------- modules
def test_rope_matches_reference():
    x = rand(0, 2, 7, 4, 64)
    pos = np.random.default_rng(1).integers(0, 5000, (2, 7))
    for theta in (10_000.0, 500_000.0):
        close(apply_rope(torch.tensor(x), torch.tensor(pos), theta),
              jax_rope(jnp.asarray(x), jnp.asarray(pos), theta), MODULE_TOL)


def test_rmsnorm_and_embedding_match_reference():
    x, scale = rand(0, 3, 5, 48), 1 + 0.1 * rand(1, 48)
    close(RMSNorm.apply({"scale": torch.tensor(scale)}, torch.tensor(x),
                        eps=1e-5),
          JaxRMSNorm.apply({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           eps=1e-5), MODULE_TOL)
    table = rand(2, 50, 16)
    ids = np.random.default_rng(3).integers(0, 50, (3, 4))
    close(Embedding.apply({"table": torch.tensor(table)}, torch.tensor(ids)),
          JaxEmbedding.apply({"table": jnp.asarray(table)}, jnp.asarray(ids)),
          dict(rtol=0, atol=0))


def test_dense_ffn_matches_reference():
    cfg, jcfg = configs("llama3_2_1b")
    p, jp = params(cfg)
    x = rand(4, 2, 5, cfg.d_model)
    layer = lambda tree: jax.tree_util.tree_map(lambda a: a[1], tree)  # noqa
    close(DenseFFN.apply({k: {"w": v["w"][1]} for k, v in
                          p["blocks"]["ffn"].items()}, torch.tensor(x)),
          JaxFFN.apply(layer(jp["blocks"]["ffn"]), jnp.asarray(x)),
          MODULE_TOL)


@pytest.mark.parametrize("arch", PORTED)
def test_attention_dense_and_decode_match_reference(arch):
    cfg, jcfg = configs(arch)
    p, jp = params(cfg)
    ap = {k: {n: t[0] for n, t in v.items()}
          for k, v in p["blocks"]["attn"].items()}
    jap = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["attn"])
    x = rand(5, B, P, cfg.d_model)
    pos = jnp.broadcast_to(jnp.arange(P)[None], (B, P))
    y, cache = GQAAttention.apply_dense(ap, cfg, torch.tensor(x),
                                        want_cache=True)
    close(y, JaxGQA.apply_dense(jap, jcfg, jnp.asarray(x), pos), MODULE_TOL)
    _, jk, jv = JaxGQA._qkv(jap, jcfg, jnp.asarray(x), pos)
    close(cache.k, jk, MODULE_TOL)
    close(cache.v, jv, MODULE_TOL)
    # decode: 6-row cache, positions 0..7 so the last two steps wrap
    c = GQAAttention.init_cache(cfg, B, 6, device="cpu")
    jc = JaxGQA.init_cache(jcfg, B, 6)
    jax_decode = jax.jit(JaxGQA.apply_decode, static_argnums=1)
    for t in range(P):
        xt = x[:, t:t + 1]
        pos_t = np.full((B,), t, np.int32)
        y, c2 = GQAAttention.apply_decode(ap, cfg, torch.tensor(xt), c,
                                          torch.tensor(pos_t))
        assert c2.k is c.k and c2.v is c.v     # updated in place
        jy, jc = jax_decode(jap, jcfg, jnp.asarray(xt), jc,
                            jnp.asarray(pos_t))
        close(y, jy, MODULE_TOL)
        close(c.k, jc.k, MODULE_TOL)
        close(c.v, jc.v, MODULE_TOL)


def test_window_decode_raises():
    """Under a window the decode cache is a ring of at most ``window`` rows
    (``init_cache``, the prefill ring); a longer cache would let decode
    attend rows outside the window, and raises. The ring decode itself is
    held in tests/test_torch_window.py."""
    cfg = dataclasses.replace(configs("llama3_2_1b")[0], window=4)
    ap = {k: {n: t[0] for n, t in v.items()} for k, v in
          params(cfg)[0]["blocks"]["attn"].items()}
    assert GQAAttention.init_cache(cfg, 1, 8, device="cpu").k.shape[1] == 4
    c = GQAAttention.init_cache(dataclasses.replace(cfg, window=None), 1, 8,
                                device="cpu")
    with pytest.raises(ValueError, match="window"):
        GQAAttention.apply_decode(ap, cfg, torch.zeros(1, 1, cfg.d_model), c,
                                  torch.zeros(1, dtype=torch.int64))


# ----------------------------------------------------------- whole model
@pytest.mark.parametrize("arch", PORTED)
def test_prefill_matches_reference(arch):
    cfg, jcfg = configs(arch)
    p, jp = params(cfg)
    toks = golden_tool.tokens(cfg, B, P, seed=7)
    ops.reset_launch_counts()
    logits, cache = make_prefill_step(cfg)(p, {"tokens": torch.tensor(toks)})
    assert sum(ops.launch_counts().values()) == 0      # plain versions
    close(logits, golden_tool.prefill(jcfg, jp, toks), MODEL_TOL)
    # the cache a prefill returns is the one serve_step writes (ln1 K/V)
    _, jk, jv = golden_tool.serve(jcfg, jp, toks, P)
    assert cache["layers"].k.shape == (cfg.n_layers, B, P, cfg.n_kv_heads,
                                       cfg.head_dim)
    close(cache["layers"].k, jk, MODULE_TOL)
    close(cache["layers"].v, jv, MODULE_TOL)


def test_reference_prefill_cache_is_not_its_decode_cache():
    """The reference's fault that the port does not copy (ROADMAP §3): the
    K/V that JAX's ``DecoderLM.prefill`` returns are those of the ln2
    output, not the ln1 K/V that its ``serve_step`` writes over the same
    tokens, while its prefill logits agree with the decode's. If this
    fails, the reference changed: revisit ROADMAP §3."""
    cfg, jcfg = configs("llama3_2_1b")
    _, jp = params(cfg)
    toks = golden_tool.tokens(cfg, B, P, seed=7)
    logits, cache = jax.jit(jax_make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    want, jk, jv = golden_tool.serve(jcfg, jp, toks, P)
    close(torch.tensor(np.asarray(logits)), want[-1], MODEL_TOL)
    per_layer = lambda a: np.abs(a).max(axis=(1, 2, 3, 4))  # noqa: E731
    dk = per_layer(np.asarray(cache["layers"].k) - jk)
    dv = per_layer(np.asarray(cache["layers"].v) - jv)
    # every layer's cache is off by a sizeable share of its largest entry
    assert (dk > 0.25 * per_layer(jk)).all(), (dk, per_layer(jk))
    assert (dv > 0.25 * per_layer(jv)).all(), (dv, per_layer(jv))


@pytest.mark.parametrize("arch", PORTED)
def test_serve_step_every_exit_matches_reference(arch):
    """T=16 teacher-forced steps into a 15-row cache: the last step wraps."""
    cfg, jcfg = configs(arch)
    p, jp = params(cfg)
    toks = golden_tool.tokens(cfg, B, T, seed=8)
    cache_len = T - 1
    for e in cfg.exit_layers:
        want, jk, jv = golden_tool.serve(jcfg, jp, toks, cache_len, e)
        step = make_serve_step(cfg, exit_layer=e)
        cache = DecoderLM.init_cache(cfg, B, cache_len, device="cpu")
        for t in range(T):
            logits, out = step(p, cache, torch.tensor(toks[:, t]),
                               torch.full((B,), t, dtype=torch.int64))
            assert out is cache
            close(logits, want[t], MODEL_TOL)
        close(cache["layers"].k[:e], jk[:e], MODULE_TOL)
        close(cache["layers"].v[:e], jv[:e], MODULE_TOL)
        # the layers past the exit never ran: their cache is untouched
        assert not cache["layers"].k[e:].any()
        assert not cache["layers"].v[e:].any()
        assert not np.asarray(jk[e:]).any()


def test_lm_params_from_numpy_checks_every_leaf():
    cfg = configs("llama3_2_1b")[0]
    tree = lm_params_numpy(cfg, 0)
    p = lm_params_from_numpy(tree, cfg, "cpu")
    assert p["blocks"]["attn"]["wq"]["w"].shape == (4, 256, 256)
    bad = lm_params_numpy(cfg, 0)
    bad["blocks"]["attn"]["wq"]["b"] = np.zeros((4, 256), np.float32)
    with pytest.raises(ValueError, match="unexpected.*blocks/attn/wq/b"):
        lm_params_from_numpy(bad, cfg, "cpu")
    bad = lm_params_numpy(cfg, 0)
    del bad["lm_head"]
    with pytest.raises(ValueError, match="missing.*lm_head/w"):
        lm_params_from_numpy(bad, cfg, "cpu")
    bad = lm_params_numpy(cfg, 0)
    bad["blocks"]["ln1"]["scale"] = bad["blocks"]["ln1"]["scale"][:3]
    with pytest.raises(ValueError, match="blocks/ln1/scale: shape"):
        lm_params_from_numpy(bad, cfg, "cpu")
    bad = lm_params_numpy(cfg, 0)
    bad["embed"]["table"] = bad["embed"]["table"].astype(np.float64)
    with pytest.raises(TypeError, match="embed/table: dtype float64"):
        lm_params_from_numpy(bad, cfg, "cpu")
    bad = lm_params_numpy(cfg, 0)
    bad["final_norm"]["scale"] = torch.ones(cfg.d_model)
    with pytest.raises(TypeError, match="numpy array"):
        lm_params_from_numpy(bad, cfg, "cpu")


def test_lm_params_from_numpy_takes_bfloat16():
    cfg = dataclasses.replace(configs("llama3_2_1b")[0], dtype="bfloat16")
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
        lm_params_numpy(cfg, 0))
    p = lm_params_from_numpy(tree, cfg, "cpu")
    w = p["blocks"]["attn"]["wk"]["w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(), tree["blocks"]["attn"]["wk"]["w"].astype(np.float32))


def test_init_draws_the_reference_layout_on_the_requested_device():
    cfg = configs("qwen1_5_0_5b")[0]
    p = DecoderLM.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), p)
    assert shapes == DecoderLM.param_shapes(cfg)
    assert not p["blocks"]["attn"]["wq"]["b"].any()
    assert bool((p["final_norm"]["scale"] == 1).all())
    w = p["blocks"]["ffn"]["w1"]["w"]
    assert float(w.abs().max()) <= (6 / (cfg.d_model + cfg.d_ff)) ** 0.5
    assert not torch.equal(w[0], w[1])      # each layer draws its own


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_equals_stacked_draws_bit_for_bit(dtype, monkeypatch):
    """Each dense ``w`` leaf is written a matrix at a time into its slice,
    and each unstacked one (the LM head) goes through ``_staged_matrix``,
    here in blocks of a few rows, as on the card: the same draws, in the
    same order, as casting every matrix and stacking them
    (``chip_smoke.stacked_init``, which phase 41 runs on the card), bit for
    bit, so a seed's params are unchanged while init's peak drops to the
    params plus one matrix's draw."""
    from repro_torch.models import lm

    monkeypatch.setattr(lm, "_STAGE_BYTES", 4096)
    cfg = dataclasses.replace(configs("internlm2_20b")[0], dtype=dtype)
    got = DecoderLM.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    want = chip_smoke.stacked_init(torch.Generator().manual_seed(3), cfg,
                                   "cpu")
    flat = jax.tree_util.tree_flatten_with_path
    assert len(flat(got)[0]) == len(flat(want)[0])
    for (path, a), (_, b) in zip(flat(got)[0], flat(want)[0]):
        assert a.dtype == cfg.torch_dtype, path
        assert chip_smoke.same_bits(a, b), path


def test_staged_matrix_is_the_cast_draw(monkeypatch):
    """The LM head's route off the CPU (cast a block of rows at a time into
    host memory, the draw freed, then copied back) gives the draw's cast
    bit for bit; here on the CPU with blocks of 7 rows."""
    from repro_torch.models import lm

    monkeypatch.setattr(lm, "_STAGE_BYTES", 7 * 4 * 70)
    got = lm._staged_matrix(torch.Generator().manual_seed(5), (61, 70),
                            device=torch.device("cpu"), dtype=torch.bfloat16)
    limit = (6.0 / (61 + 70)) ** 0.5
    u = torch.rand((61, 70), generator=torch.Generator().manual_seed(5))
    want = (u * (2.0 * limit) - limit).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (61, 70)
    assert chip_smoke.same_bits(got, want)


def test_lm_golden_is_current():
    """Rebuilding the golden run with the JAX package gives the stored
    tokens and outputs (floats to 1e-6: XLA's CPU code may round
    differently on another CPU model)."""
    gold = golden_tool.load()
    fresh = golden_tool.build()
    assert sorted(gold) == sorted(fresh)
    for k, v in fresh.items():
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(gold[k], v, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(gold[k], v, err_msg=k)


def test_rwkv_golden_is_current():
    """As test_lm_golden_is_current, for the reduced RWKV-6 run."""
    gold = golden_tool.load(golden_tool.RWKV_PATH)
    fresh = golden_tool.build_rwkv()
    assert sorted(gold) == sorted(fresh)
    for k, v in fresh.items():
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(gold[k], v, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(gold[k], v, err_msg=k)


def test_port_replays_the_rwkv_golden_file():
    """What chip_smoke.py does on the card, here with the plain versions."""
    gold = golden_tool.load(golden_tool.RWKV_PATH)
    cfg = get_arch(str(gold["arch"])).reduced(
        **{k.split("/")[1]: int(gold[k]) for k in gold
           if k.startswith("reduced/")})
    p = lm_params_from_numpy(lm_params_numpy(cfg, int(gold["seed"])), cfg,
                             "cpu")
    toks = torch.tensor(gold["tokens"])
    logits, cache = make_prefill_step(cfg)(p, {"tokens": toks})
    close(logits, gold["prefill/logits"], MODEL_TOL)
    for f in golden_tool.STATE_FIELDS:
        close(getattr(cache["layers"], f), gold[f"prefill/{f}"], MODEL_TOL)
    n = int(gold["serve_len"])
    for e in gold["exits"]:
        step = make_serve_step(cfg, exit_layer=int(e))
        c = DecoderLM.init_cache(cfg, toks.shape[0], n, device="cpu")
        for t in range(n):
            lg, c = step(p, c, toks[:, t], torch.full((toks.shape[0],), t))
            close(lg, gold[f"serve/logits_{int(e)}"][t], MODEL_TOL)


def test_port_replays_the_lm_golden_file():
    """What chip_smoke.py does on the card, here with the plain versions."""
    gold = golden_tool.load()
    cfg = get_arch(str(gold["arch"])).reduced(
        **{k.split("/")[1]: int(gold[k]) for k in gold
           if k.startswith("reduced/")})
    p = lm_params_from_numpy(lm_params_numpy(cfg, int(gold["seed"])), cfg,
                             "cpu")
    toks = torch.tensor(gold["tokens"])
    n = int(gold["prefill_len"])
    logits, cache = make_prefill_step(cfg)(p, {"tokens": toks[:, :n]})
    close(logits, gold["prefill/logits"], MODEL_TOL)
    close(cache["layers"].k, gold["prefill/k"], MODEL_TOL)
    close(cache["layers"].v, gold["prefill/v"], MODEL_TOL)
    for e in gold["exits"]:
        step = make_serve_step(cfg, exit_layer=int(e))
        c = DecoderLM.init_cache(cfg, toks.shape[0], toks.shape[1],
                                 device="cpu")
        for t in range(toks.shape[1]):
            lg, c = step(p, c, toks[:, t], torch.full((toks.shape[0],), t))
            close(lg, gold[f"serve/logits_{int(e)}"][t], MODEL_TOL)


def test_entry_points_default_to_the_card():
    cfg = configs("llama3_2_1b")[0]
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecoderLM.init(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecoderLM.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_numpy(lm_params_numpy(cfg, 0), cfg)
