"""The rest of the model zoo in the port against the JAX package: Zamba2
(Mamba-2 layers and a shared attention block), DeepSeek-MoE (MoE FFN),
DeepSeek-V2 (MLA and MoE) and Whisper (encoder-decoder with
cross-attention). Module by module (``sdpa``, ``MLAAttention``,
``CrossAttention``, ``MoEFFN`` with exact expert choices, ``Mamba2Block``,
``EncoderBlock``) and as whole reduced models (4 layers, float32): param
layouts, prefill logits and caches, every exit's ``serve_step`` logits,
the reference's decode-vs-dense parity, Whisper's ``make_prefill_step``,
``EdgeServingEngine`` against the JAX engine on injected draws, and the
golden file ``tests/data/torch_lm_zoo_golden.npz`` that carries such runs
to the GPU machine, where JAX is not installed. Inputs are numpy from a
seed, params ``lm_params_numpy`` carried into both packages.
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
from repro.models.attention import CrossAttention as JaxCross
from repro.models.attention import MLAAttention as JaxMLA
from repro.models.attention import sdpa as jax_sdpa
from repro.models.blocks import EncoderBlock as JaxEncoderBlock
from repro.models.blocks import MambaBlockWrap as JaxMambaWrap
from repro.models.blocks import block_kind as jax_block_kind
from repro.models.ffn import MoEFFN as JaxMoE
from repro.models.lm import model_for as jax_model_for
from repro.models.ssm import Mamba2Block as JaxMamba
from repro.train.steps import make_prefill_step as jax_make_prefill_step
from repro_torch.configs import get_arch
from repro_torch.core.bridge import (agent_state_from_numpy,
                                     lm_params_from_numpy, lm_params_numpy)
from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops
from repro_torch.mec import SlotTasks
from repro_torch.models import DecoderLM, EncDecLM, model_for
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import CrossAttention, MLAAttention, sdpa
from repro_torch.models.blocks import (EncoderBlock, MambaBlockWrap,
                                       block_kind)
from repro_torch.models.ffn import MoEFFN
from repro_torch.models.lm import n_shared_applications
from repro_torch.models.ssm import Mamba2Block, MambaState
from repro_torch.nn import Embedding
from repro_torch.nn.pytree import flatten_dict
from repro_torch.serve import EdgeServingEngine, Replica, ServeDraws
from repro_torch.train import make_prefill_step, make_serve_step

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import make_torch_lm_golden as golden_tool  # noqa: E402
import make_torch_port_golden as port_golden  # noqa: E402

sys.path.pop(0)
torch.set_num_threads(1)

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)   # f32, one module
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)    # f32, logits through the model
PARITY_TOL = dict(rtol=2e-3, atol=2e-3)   # tests/test_models.py's parity
ZOO = golden_tool.ZOO
B, P, T = 2, golden_tool.ZOO_P, 12


def configs(arch, **over):
    """(port cfg, JAX cfg) of the golden file's reduced variant: 4 layers,
    exits (1, 2, 3, 4)."""
    kw = dict(golden_tool.ZOO_REDUCED, **over)
    return get_arch(arch).reduced(**kw), jax_get_arch(arch).reduced(**kw)


def params(cfg, seed=0):
    """(port params, JAX params) of one numpy draw."""
    tree = lm_params_numpy(cfg, seed)
    return (lm_params_from_numpy(tree, cfg, "cpu"),
            jax.tree_util.tree_map(jnp.asarray, tree))


def layer(tree, i=0):
    """Layer ``i`` of a stacked tree, torch or JAX."""
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close(got, want, tol, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=msg, **tol)


def close_tree(got, want, tol):
    for name, g, w in zip(got._fields, got, want):
        close(g, w, tol, name)


def audio(cfg):
    return golden_tool.zoo_audio(cfg)


# ---------------------------------------------------------------- sdpa
# (Sq, Sk, H, KVH, dk, dv, causal, window, positions)
SDPA_CASES = {
    "causal": (12, 12, 4, 2, 16, 16, True, None, "arange"),
    "not_causal": (12, 12, 4, 2, 16, 16, False, None, "arange"),
    "window": (12, 12, 4, 2, 16, 16, True, 5, "arange"),
    "sq_ne_sk": (5, 9, 4, 4, 16, 16, False, None, "arange"),
    "dk_ne_dv": (10, 10, 4, 1, 24, 16, True, None, "arange"),
    "positions": (6, 20, 4, 2, 16, 16, True, 7, "random"),
    "chunked_1500": (1500, 1500, 2, 1, 8, 8, False, None, "arange"),
}


@pytest.mark.parametrize("case", list(SDPA_CASES))
def test_sdpa_matches_reference(case):
    sq, sk, h, kvh, dk, dv, causal, window, kind = SDPA_CASES[case]
    q, k, v = rand(1, B, sq, h, dk), rand(2, B, sk, kvh, dk), \
        rand(3, B, sk, kvh, dv)
    if kind == "arange":
        qp = np.broadcast_to(np.arange(sq), (B, sq))
        kp = np.broadcast_to(np.arange(sk), (B, sk))
    else:       # a query block past a longer stretch of keys, per batch
        rng = np.random.default_rng(4)
        kp = np.stack([rng.permutation(sk) for _ in range(B)])
        qp = rng.integers(0, sk, (B, sq))
    qp, kp = qp.astype(np.int32), kp.astype(np.int32)
    scale = 1.0 / np.sqrt(dk)
    got = sdpa(*map(torch.tensor, (q, k, v, qp, kp)), scale=scale,
               causal=causal, window=window)
    want = jax_sdpa(*map(jnp.asarray, (q, k, v, qp, kp)), scale=scale,
                    causal=causal, window=window)
    assert got.shape == (B, sq, h, dv)
    close(got, want, MODULE_TOL)


# ------------------------------------------------------------------- MLA
def test_mla_dense_and_decode_match_reference():
    """The dense pass and its latents, then absorbed decode over positions
    0..P-1 into a cache of P-2 rows: the last two steps write where the
    reference's dynamic_update_slice clamps (the last row)."""
    cfg, jcfg = configs("deepseek_v2_236b")
    p, jp = params(cfg)
    ap, jap = layer(p["blocks"]["attn"]), layer(jp["blocks"]["attn"])
    n = 10
    x = rand(5, B, n, cfg.d_model)
    pos = jnp.broadcast_to(jnp.arange(n)[None], (B, n))
    y, cache = MLAAttention.apply_dense(ap, cfg, torch.tensor(x),
                                        want_cache=True)
    close(y, JaxMLA.apply_dense(jap, jcfg, jnp.asarray(x), pos), MODULE_TOL)
    close_tree(cache, JaxMLA._latents(jap, jcfg, jnp.asarray(x), pos),
               MODULE_TOL)
    c = MLAAttention.init_cache(cfg, B, n - 2, device="cpu")
    jc = JaxMLA.init_cache(jcfg, B, n - 2)
    step = jax.jit(JaxMLA.apply_decode, static_argnums=1)
    for t in range(n):
        pos_t = np.full((B,), t, np.int32)
        y, c2 = MLAAttention.apply_decode(ap, cfg, torch.tensor(x[:, t:t + 1]),
                                          c, torch.tensor(pos_t))
        assert c2.c_kv is c.c_kv               # updated in place
        jy, jc = step(jap, jcfg, jnp.asarray(x[:, t:t + 1]), jc,
                      jnp.asarray(pos_t))
        close(y, jy, MODULE_TOL, f"step {t}")
        close_tree(c, jc, MODULE_TOL)


# ------------------------------------------------------- cross-attention
@pytest.mark.parametrize("sq", [1, 5])
def test_cross_attention_matches_reference(sq, monkeypatch):
    """Both routes: one query through ops.decode_attention over all Se
    encoder rows, several through sdpa without a mask."""
    cfg, jcfg = configs("whisper_medium")
    p, jp = params(cfg)
    cp = layer(p["decoder"]["blocks"]["cross"])
    jcp = layer(jp["decoder"]["blocks"]["cross"])
    x, enc = rand(6, B, sq, cfg.d_model), rand(7, B, 16, cfg.d_model)
    calls = []
    real = ops.decode_attention

    def spy(*args, **kw):
        calls.append(args[3].tolist())
        return real(*args, **kw)

    monkeypatch.setattr(attn_mod.ops, "decode_attention", spy)
    got = CrossAttention.apply(cp, cfg, torch.tensor(x), torch.tensor(enc))
    close(got, JaxCross.apply(jcp, jcfg, jnp.asarray(x), jnp.asarray(enc)),
          MODULE_TOL)
    assert calls == ([[16] * B] if sq == 1 else [])


# ------------------------------------------------------------------- MoE
def moe_case(case):
    """(cfg, jcfg, ffn params (port, JAX), x [b, s, d]) of one case."""
    over = {"overflow": dict(capacity_factor=0.5),
            "decode": dict(n_experts=32)}.get(case, {})
    cfg, jcfg = configs("deepseek_moe_16b", **over)
    p, jp = params(cfg)
    fp, jfp = layer(p["blocks"]["ffn"]), layer(jp["blocks"]["ffn"])
    if case == "tie":
        # experts 1, 2 and 3 score alike for every token: a tie is broken
        # by the lower index, so top-2 picks 1 (and 2) and never 3
        w = fp["router"]["w"].clone()
        w[:, 1] = w[:, 3] = w[:, 2]
        fp = dict(fp, router={"w": w})
        jfp = dict(jfp, router={"w": jnp.asarray(w.numpy())})
    shape = (8, 1) if case == "decode" else (B, 16)
    return cfg, jcfg, fp, jfp, rand(8, *shape, cfg.d_model)


@pytest.mark.parametrize("case", ["prefill", "overflow", "decode", "tie"])
def test_moe_matches_reference(case):
    """Outputs, aux loss and dropped fraction at 1e-5; expert choices and
    kept slots exactly. ``overflow`` halves the capacity factor; ``decode``
    is 8 one-token rows over 32 experts, one group of capacity 1, as
    DeepSeek-MoE's decode at B = 8 over 64; ``tie`` makes three experts
    score alike."""
    cfg, jcfg, fp, jfp, x = moe_case(case)
    y, m = MoEFFN.apply(fp, cfg, torch.tensor(x))
    jy, jm = JaxMoE.apply(jfp, jcfg, jnp.asarray(x))
    close(y, jy, MODULE_TOL)
    close(m.aux_loss, jm.aux_loss, MODULE_TOL)
    assert float(m.dropped_frac) == pytest.approx(float(jm.dropped_frac),
                                                  abs=1e-7)
    xg = x.reshape(1, 8, -1) if case == "decode" else x
    _, idx, _, _, _, keep = MoEFFN.route(fp, cfg, torch.tensor(xg))
    want_idx, want_keep = golden_tool.moe_routing(jcfg, jfp, xg)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if case in ("overflow", "decode"):
        assert float(m.dropped_frac) > 0
    if case == "decode":
        assert MoEFFN.capacity(cfg, 8) == 1
    if case == "tie":
        assert (want_idx == 1).any() and not (want_idx == 3).any()


def test_moe_capacity_at_full_width():
    """DeepSeek-MoE-16B: one decode step at B = 8 keeps one slot per
    expert (the reference's quirk, kept), a 2048-token row 240."""
    cfg = get_arch("deepseek_moe_16b")
    assert MoEFFN.capacity(cfg, 8) == 1
    assert MoEFFN.capacity(cfg, 2048) == 240


# ---------------------------------------------------------------- Mamba-2
def test_mamba2_block_matches_reference():
    """A 64-token dense pass (two chunks) from zero state, a second one
    from its state, then five decode steps carrying SSD and conv state."""
    cfg, jcfg = configs("zamba2_2_7b")
    p, jp = params(cfg)
    mp, jmp = layer(p["blocks"]["core"]), layer(jp["blocks"]["core"])
    x = rand(9, B, P + 32 + 5, cfg.d_model)
    y, st = Mamba2Block.apply_dense(mp, cfg, torch.tensor(x[:, :P]))
    jy, jst = JaxMamba.apply_dense(jmp, jcfg, jnp.asarray(x[:, :P]))
    close(y, jy, MODULE_TOL)
    close_tree(st, jst, MODULE_TOL)
    assert float(st.conv.abs().min()) > 0 and float(st.ssd.abs().max()) > 0
    y, st = Mamba2Block.apply_dense(mp, cfg, torch.tensor(x[:, P:P + 32]),
                                    st)
    jy, jst = JaxMamba.apply_dense(jmp, jcfg, jnp.asarray(x[:, P:P + 32]),
                                   jst)
    close(y, jy, MODULE_TOL)
    close_tree(st, jst, MODULE_TOL)
    step = jax.jit(JaxMamba.apply_decode, static_argnums=1)
    for t in range(P + 32, x.shape[1]):
        y, st = Mamba2Block.apply_decode(mp, cfg, torch.tensor(x[:, t:t + 1]),
                                         st)
        jy, jst = step(jmp, jcfg, jnp.asarray(x[:, t:t + 1]), jst)
        close(y, jy, MODULE_TOL, f"step {t}")
        close_tree(st, jst, MODULE_TOL)


def test_mamba2_carried_state_matters():
    """The prefill state after 64 tokens, dropped: the next 32 tokens'
    outputs move by far more than the tolerance (the slow decays of
    lm_params_numpy carry the state across chunks)."""
    cfg, _ = configs("zamba2_2_7b")
    mp = layer(params(cfg)[0]["blocks"]["core"])
    x = torch.tensor(rand(9, B, P + 32, cfg.d_model))
    _, st = Mamba2Block.apply_dense(mp, cfg, x[:, :P])
    y, _ = Mamba2Block.apply_dense(mp, cfg, x[:, P:], st)
    y0, _ = Mamba2Block.apply_dense(
        mp, cfg, x[:, P:], MambaState(torch.zeros_like(st.ssd), st.conv))
    assert float((y - y0).abs().max()) > 1e3 * MODULE_TOL["atol"]


def test_mamba_block_wrap_matches_reference():
    cfg, jcfg = configs("zamba2_2_7b")
    p, jp = params(cfg)
    bp, jbp = layer(p["blocks"], 1), layer(jp["blocks"], 1)
    x = rand(10, B, 32, cfg.d_model)
    pos = jnp.broadcast_to(jnp.arange(32)[None], (B, 32))
    y, st, aux = MambaBlockWrap.apply_dense(bp, cfg, torch.tensor(x),
                                            want_cache=True)
    jy, jst, _ = JaxMambaWrap.apply_dense(jbp, jcfg, jnp.asarray(x), pos,
                                          want_cache=True)
    close(y, jy, MODULE_TOL)
    close_tree(st, jst, MODULE_TOL)
    assert aux == (0.0, 0.0)
    xt = rand(11, B, 1, cfg.d_model)
    y, st, _ = MambaBlockWrap.apply_decode(bp, cfg, torch.tensor(xt), st,
                                           None)
    jy, jst, _ = JaxMambaWrap.apply_decode(jbp, jcfg, jnp.asarray(xt), jst,
                                           None)
    close(y, jy, MODULE_TOL)
    close_tree(st, jst, MODULE_TOL)


# ----------------------------------------------------------------- encoder
def test_encoder_block_matches_reference(monkeypatch):
    """Bidirectional attention through ops.flash_attention(causal=False)."""
    cfg, jcfg = configs("whisper_medium")
    p, jp = params(cfg)
    ep, jep = layer(p["encoder"], 1), layer(jp["encoder"], 1)
    x = rand(12, B, cfg.n_audio_frames, cfg.d_model)
    calls = []
    real = ops.flash_attention

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr("repro_torch.models.blocks.ops.flash_attention", spy)
    close(EncoderBlock.apply(ep, cfg, torch.tensor(x)),
          JaxEncoderBlock.apply(jep, jcfg, jnp.asarray(x)), MODULE_TOL)
    assert calls == [{"causal": False}]


# ------------------------------------------------------------ whole models
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_block_kind_and_model_equal_reference(arch):
    port, ref = get_arch(arch), jax_get_arch(arch)
    assert block_kind(port) == jax_block_kind(ref)
    assert model_for(port).__name__ == jax_model_for(ref).__name__
    assert n_shared_applications(port) == (
        len(range(ref.shared_attn_every, ref.n_layers + 1,
                  ref.shared_attn_every)) if ref.shared_attn_every else 0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_served_configs_fit_the_attention_kernels(arch):
    """Every config's GQA attention (Zamba2's shared block and Whisper's
    three attentions included) at full width: head_dim in both kernels'
    HEAD_DIMS and a query-head group of at most 8 (decode_attention's
    limit). MLA runs plain (sdpa, absorbed decode), RWKV-6 no attention."""
    cfg = get_arch(arch)
    if cfg.attn_kind != "gqa":
        assert cfg.attn_kind in ("mla", "none")
        return
    assert cfg.head_dim in flash_mod.HEAD_DIMS
    assert cfg.head_dim in decode_mod.HEAD_DIMS
    assert cfg.n_heads % cfg.n_kv_heads == 0
    assert cfg.n_heads // cfg.n_kv_heads <= 8


@pytest.mark.parametrize("arch", ZOO)
@pytest.mark.parametrize("reduced", [False, True])
def test_param_shapes_and_dtypes_equal_reference_init(arch, reduced):
    port, ref = configs(arch) if reduced else (get_arch(arch),
                                               jax_get_arch(arch))
    model = model_for(port)
    shapes = jax.eval_shape(lambda k: jax_model_for(ref).init(k, ref),
                            jax.random.PRNGKey(0))
    assert model.param_shapes(port) == jax.tree_util.tree_map(
        lambda s: tuple(s.shape), shapes)
    want = {k: str(v.dtype) for k, v in flatten_dict(
        jax.tree_util.tree_map(lambda s: s, shapes)).items()}
    got = {k: str(v).replace("torch.", "")
           for k, v in flatten_dict(model.param_dtypes(port)).items()}
    assert got == want


def test_init_draws_every_family_on_the_requested_device():
    for arch in ZOO:
        cfg = configs(arch)[0]
        model = model_for(cfg)
        p = model.init(torch.Generator().manual_seed(0), cfg, device="cpu")
        shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), p)
        assert shapes == model.param_shapes(cfg), arch
        dtypes = jax.tree_util.tree_map(lambda t: t.dtype, p)
        assert dtypes == model.param_dtypes(cfg), arch
    cfg = configs("zamba2_2_7b")[0]
    core = DecoderLM.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")["blocks"]["core"]
    assert not core["dt_bias"].any() and not core["conv_b"].any()
    assert 0.3 < float(core["conv_w"].std()) < 0.7


def prefill_ref(arch, cfg, jcfg, jp, toks):
    """JAX's prefill of ``toks`` -> (logits, cache or None, aux or None)."""
    if cfg.enc_layers:
        return golden_tool.zoo_prefill(jcfg, jp, toks, audio(cfg)), None, None
    logits, cache = jax.jit(jax_make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    _, _, aux = jax.jit(jax_model_for(jcfg).prefill, static_argnums=1)(
        jp, jcfg, jnp.asarray(toks))
    return np.asarray(logits), cache, aux


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_matches_reference(arch):
    """Prefill logits; the caches: Zamba2's Mamba states and shared-block
    K/V equal the reference's prefill cache, the MoE models' K/V or MLA
    latents the cache the reference's serve_step writes over the same
    tokens (see test_reference_prefill_cache_is_not_its_decode_cache,
    with the capacity raised); the MoE aux summed over the layers."""
    cfg, jcfg = configs(arch)
    p, jp = params(cfg)
    toks = golden_tool.tokens(cfg, B, P, seed=7)
    batch = {"tokens": torch.tensor(toks)}
    if cfg.enc_layers:
        batch["audio"] = torch.tensor(audio(cfg))
    ops.reset_launch_counts()
    out = make_prefill_step(cfg)(p, batch)
    assert sum(ops.launch_counts().values()) == 0      # plain versions
    want, jcache, jaux = prefill_ref(arch, cfg, jcfg, jp, toks)
    if cfg.enc_layers:
        close(out, want, MODEL_TOL)
        return
    logits, cache = out
    close(logits, want, MODEL_TOL)
    if arch == "zamba2_2_7b":
        close_tree(cache["layers"], jcache["layers"], MODEL_TOL)
        close_tree(cache["shared"], jcache["shared"], MODEL_TOL)
        assert cache["shared"].k.shape[0] == n_shared_applications(cfg) == 2
    else:
        _, _, aux = DecoderLM.prefill(p, cfg, torch.tensor(toks))
        close(aux.moe_aux, jaux.moe_aux, MODULE_TOL)
        close(aux.moe_dropped, jaux.moe_dropped, MODULE_TOL)
        assert float(aux.moe_aux) > 0
        # one token at a time routes all B tokens as one group: with the
        # capacity raised no slot drops either way, so decode's hidden
        # states, and the caches it writes, are prefill's
        cfg, jcfg = configs(arch, capacity_factor=8.0)
        _, cache = make_prefill_step(cfg)(p, batch)
        _, served = golden_tool.zoo_serve(jcfg, jp, toks, P)
        close_tree(cache["layers"], served["layers"], MODEL_TOL)


@pytest.mark.parametrize("arch", ZOO)
def test_serve_step_every_exit_matches_reference(arch):
    """T=12 teacher-forced steps into an 11-row cache (GQA wraps, MLA
    clamps): every exit's logits, the caches of the layers that ran (and
    the shared block's), the deeper layers' untouched."""
    cfg, jcfg = configs(arch)
    p, jp = params(cfg)
    toks = golden_tool.tokens(cfg, B, T, seed=8)
    model = model_for(cfg)
    au = audio(cfg) if cfg.enc_layers else None
    for e in cfg.exit_layers:
        want, jcache = golden_tool.zoo_serve(jcfg, jp, toks, T - 1, e, au)
        step = make_serve_step(cfg, exit_layer=e)
        cache = model.init_cache(cfg, B, T - 1, device="cpu")
        if cfg.enc_layers:
            cache["enc_out"] = EncDecLM.encode(p, cfg, torch.tensor(au))
        for t in range(T):
            logits, out = step(p, cache, torch.tensor(toks[:, t]),
                               torch.full((B,), t, dtype=torch.int64))
            assert out is cache
            close(logits, want[t], MODEL_TOL, f"exit {e} step {t}")
        ran = layer(cache["layers"], slice(0, e))
        close_tree(ran, layer(jcache["layers"], slice(0, e)), MODEL_TOL)
        for f in cache["layers"]:
            assert not f[e:].any()
        if "shared" in cache:
            close_tree(cache["shared"], jcache["shared"], MODEL_TOL)


@pytest.mark.parametrize("arch", ZOO)
def test_decode_matches_dense(arch):
    """tests/test_models.py's parity on the port: the full-sequence
    forward's logits against serve_step token by token, with the MoE's
    capacity factor raised so that batched and per-token routing drop
    alike (the reference's own setting)."""
    cfg = get_arch(arch, reduced=True)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    model = model_for(cfg)
    p = lm_params_from_numpy(lm_params_numpy(cfg, 0), cfg, "cpu")
    b, s = 2, 16
    toks = torch.tensor(golden_tool.tokens(cfg, b, s, seed=9))
    cache = model.init_cache(cfg, b, s, device="cpu")
    if cfg.enc_layers:
        au = torch.tensor(audio(cfg))
        hiddens, _ = EncDecLM.forward_train(p, cfg, au, toks)
        dense = DecoderLM.logits(p["decoder"], hiddens[cfg.n_layers])
        cache["enc_out"] = EncDecLM.encode(p, cfg, au)
    else:
        h, _, _ = DecoderLM.prefill(p, cfg, toks)
        dense = DecoderLM.logits(p, h)
    step = make_serve_step(cfg)
    steps = [step(p, cache, toks[:, t], torch.full((b,), t))[0]
             for t in range(s)]
    close(torch.stack(steps, 1), dense.detach().numpy(), PARITY_TOL)


def test_reference_mla_prefill_cache_is_not_its_decode_cache():
    """ROADMAP §3 item 1 for MLA: the latents that JAX's
    ``DecoderLM.prefill`` returns come from the ln2 output, not the ln1
    latents its ``serve_step`` writes over the same tokens; the port
    returns the latter (test_prefill_matches_reference). The capacity is
    raised so that decode and prefill route alike. If this fails, the
    reference changed: revisit ROADMAP §3."""
    cfg, jcfg = configs("deepseek_v2_236b", capacity_factor=8.0)
    _, jp = params(cfg)
    toks = golden_tool.tokens(cfg, B, P, seed=7)
    _, jcache, _ = prefill_ref("deepseek_v2_236b", cfg, jcfg, jp, toks)
    _, served = golden_tool.zoo_serve(jcfg, jp, toks, P)
    got = np.asarray(jcache["layers"].c_kv)
    want = np.asarray(served["layers"].c_kv)
    per_layer = np.abs(got - want).max(axis=(1, 2, 3))
    # every layer's latents are off by a sizeable share of their largest
    # entry (layer 0 by more than it, the later layers by 15-18% here)
    assert (per_layer > 0.1 * np.abs(want).max(axis=(1, 2, 3))).all()


def test_whisper_prefill_step_takes_audio_and_returns_logits_only():
    cfg, _ = configs("whisper_medium")
    p, _ = params(cfg)
    out = make_prefill_step(cfg)(p, {
        "tokens": torch.tensor(golden_tool.tokens(cfg, B, 8)),
        "audio": torch.tensor(audio(cfg))})
    assert isinstance(out, torch.Tensor) and out.shape == (B, cfg.vocab)


def test_lm_params_from_numpy_checks_the_new_trees():
    """Names, shapes and the float32 leaves of the new families' trees,
    EncDecLM's nesting included."""
    cfg, _ = configs("deepseek_moe_16b")
    bad = lm_params_numpy(cfg, 0)
    bad["blocks"]["ffn"]["router"]["w"] = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="blocks/ffn/router/w: shape"):
        lm_params_from_numpy(bad, cfg, "cpu")
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
        lm_params_numpy(bf, 0))
    with pytest.raises(TypeError, match="router/w: dtype bfloat16"):
        lm_params_from_numpy(tree, bf, "cpu")
    tree["blocks"]["ffn"]["router"]["w"] = lm_params_numpy(
        bf, 0)["blocks"]["ffn"]["router"]["w"]
    p = lm_params_from_numpy(tree, bf, "cpu")
    assert p["blocks"]["ffn"]["router"]["w"].dtype == torch.float32
    assert p["blocks"]["ffn"]["w1"].dtype == torch.bfloat16
    cfg, _ = configs("whisper_medium")
    bad = lm_params_numpy(cfg, 0)
    bad["decoder"]["blocks"]["cross"]["wq"]["b"] = np.zeros(
        (4, 256), np.float32)
    with pytest.raises(ValueError, match="decoder/blocks/cross/wq/b"):
        lm_params_from_numpy(bad, cfg, "cpu")
    bad = lm_params_numpy(cfg, 0)
    del bad["enc_norm"]
    with pytest.raises(ValueError, match="missing.*enc_norm/scale"):
        lm_params_from_numpy(bad, cfg, "cpu")
    cfg, _ = configs("zamba2_2_7b")
    tree = lm_params_numpy(cfg, 0)
    a = tree["blocks"]["core"]["a_log"]
    assert a.min() >= -6 and a.max() <= 0 and a.std() > 1
    tree["shared_block"]["attn"]["wq"]["w"] = tree["shared_block"]["attn"][
        "wq"]["w"][:, :8]
    with pytest.raises(ValueError, match="shared_block/attn/wq/w: shape"):
        lm_params_from_numpy(tree, cfg, "cpu")


# ---------------------------------------------------------------- serving
SERVE_SCHEDULE = (4, -1, 2, 3)


@pytest.mark.parametrize("arch", ["zamba2_2_7b", "deepseek_moe_16b",
                                  "whisper_medium"])
def test_edge_engine_serves_the_zoo_as_jax(arch):
    """EdgeServingEngine over the reduced arch, 4 slots with decoding,
    against the JAX engine on its injected draws (the LM weights
    lm_params_numpy(cfg, 0) on both sides; Whisper decodes against zero
    encoder output, as the reference's engine does): assignments and
    generated tokens equal, rewards within 1e-5."""
    data, extra = port_golden.serve_run("grle", arch=arch,
                                        schedule=SERVE_SCHEDULE)
    cfg = get_arch(arch, reduced=True)
    eng = EdgeServingEngine(
        cfg, [Replica(n, s) for n, s in port_golden.SERVE_REPLICAS],
        scheduler="grle", batch_slots=port_golden.SERVE_BATCH,
        seed=int(data["seed"]), workload="mmpp", scenario="dyn_bursty",
        agent_kw=port_golden.SERVE_AGENT_KW,
        profile_kw={k: float(data[f"profile/{k}"])
                    for k in ("peak_flops", "hbm_bw")}, device="cpu")
    eng.params = lm_params_from_numpy(lm_params_numpy(cfg, 0), cfg, "cpu")
    eng.set_agent_state(agent_state_from_numpy(extra["state0"], "cpu"))
    takes = dict(zip(data["train_steps"].tolist(), data["replay_take"]))
    eng.inject_draws(
        ServeDraws(SlotTasks(*(torch.tensor(data[f"tasks/{f}"][t])
                               for f in SlotTasks._fields)),
                   torch.tensor(data["rand_cands"][t].astype(np.int64)),
                   None if t not in takes else torch.tensor(takes[t]))
        for t in range(len(SERVE_SCHEDULE)))
    names = [n for n, _ in port_golden.SERVE_REPLICAS]
    served = 0
    for i, n in enumerate(SERVE_SCHEDULE):
        reqs = None if n < 0 else [eng.make_request() for _ in range(n)]
        assignments, info = eng.serve_slot(reqs, decode=True)
        want = [(names[r], int(e)) for r, e in zip(
            data["assign_replica"][i], data["assign_exit"][i]) if r >= 0]
        assert assignments == want, f"slot {i}"
        texts = [list(map(int, data["texts"][i, j]))
                 for j in range(len(want))]
        assert (info["texts"] or []) == texts, f"slot {i}"
        served += len(texts)
        np.testing.assert_allclose(info["reward"], data["reward"][i],
                                   rtol=1e-5, atol=1e-7)
    assert served > 0
    assert eng.tokens_served == int(data["tokens_served"])


# ------------------------------------------------------------------ golden
def test_zoo_golden_is_current():
    """Rebuilding the zoo golden file with the JAX package gives the
    stored tokens and outputs (floats to 1e-6: XLA's CPU code may round
    differently on another CPU model)."""
    gold = golden_tool.load(golden_tool.ZOO_PATH)
    fresh = golden_tool.build_zoo()
    assert sorted(gold) == sorted(fresh)
    for k, v in fresh.items():
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(gold[k], v, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(gold[k], v, err_msg=k)


def replay_zoo_golden(arch, gold):
    """What chip_smoke.py does on the card for ``arch``, here with the
    plain versions."""
    cfg = get_arch(arch).reduced(
        **{k.split("/")[1]: int(gold[k]) for k in gold
           if k.startswith("reduced/")})
    p = lm_params_from_numpy(lm_params_numpy(cfg, int(gold["seed"])), cfg,
                             "cpu")
    toks = torch.tensor(gold[f"{arch}/tokens"])
    batch = {"tokens": toks}
    au = None
    if cfg.enc_layers:
        au = torch.tensor(golden_tool.zoo_audio(cfg, toks.shape[0],
                                                int(gold["audio_seed"])))
        batch["audio"] = au
    out = make_prefill_step(cfg)(p, batch)
    close(out if cfg.enc_layers else out[0], gold[f"{arch}/prefill/logits"],
          MODEL_TOL)
    if cfg.is_moe:
        x = Embedding.apply(p["embed"], toks)
        _, idx, _, _, _, keep = MoEFFN.route(layer(p["blocks"]["ffn"]), cfg,
                                             x)
        np.testing.assert_array_equal(idx.numpy(), gold[f"{arch}/experts"])
        np.testing.assert_array_equal(keep.numpy(), gold[f"{arch}/keep"])
    n = int(gold["serve_len"])
    model = model_for(cfg)
    for e in gold[f"{arch}/exits"]:
        step = make_serve_step(cfg, exit_layer=int(e))
        c = model.init_cache(cfg, toks.shape[0], n, device="cpu")
        if cfg.enc_layers:
            c["enc_out"] = EncDecLM.encode(p, cfg, au)
        for t in range(n):
            lg, c = step(p, c, toks[:, t], torch.full((toks.shape[0],), t))
            close(lg, gold[f"{arch}/serve/logits_{int(e)}"][t], MODEL_TOL)


@pytest.mark.parametrize("arch", ZOO)
def test_port_replays_the_zoo_golden_file(arch):
    replay_zoo_golden(arch, golden_tool.load(golden_tool.ZOO_PATH))
