"""The port's RWKV-6 path against the JAX package: the plain ``ssm_scan``
against the Pallas kernel (interpret mode), the JAX refs and the model's
``chunked_linear_attn``; the RWKV-6 modules; prefill and early-exit decode
of reduced RWKV-6-7B (4 layers, d_model 256, heads of 32, chunk 32),
float32 on the CPU, on numpy-drawn inputs and params; and the full
config's param tree. The CUDA kernel is held against the plain version in
test_torch_cuda.py, on a GPU.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels import ref as jax_ref
from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan
from repro.models.blocks import RWKVBlockWrap as JaxRWKVWrap
from repro.models.lm import DecoderLM as JaxLM
from repro.models.ssm import RWKV6Block as JaxRWKV
from repro.models.ssm import RWKVState as JaxRWKVState
from repro.models.ssm import chunked_linear_attn as jax_chunked
from repro.models.ssm import naive_linear_attn as jax_naive
from repro_torch.configs import get_arch
from repro_torch.core.bridge import lm_params_from_numpy, lm_params_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models import DecoderLM, model_for
from repro_torch.models.blocks import RWKVBlockWrap, block_kind
from repro_torch.models.ssm import (RWKV6Block, RWKVState, chunked_linear_attn,
                                    naive_linear_attn)
from repro_torch.train import make_prefill_step, make_serve_step

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import make_torch_lm_golden as golden_tool  # noqa: E402

sys.path.pop(0)
torch.set_num_threads(1)

SSM_TOL = dict(rtol=1e-4, atol=1e-4)      # f32 scan (tests/test_kernels.py)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)   # f32, one module
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)    # f32, through the model
# tests/test_kernels.py's ssm grid: (B, T, H, dk, dv, chunk)
SSM_GRID = [(2, 64, 2, 8, 16, 16), (1, 128, 4, 16, 16, 32),
            (2, 32, 1, 64, 32, 32)]
# log-decay regimes: the JAX tests' own, and a slow one whose cross-chunk
# terms (carried-state read, state update) matter
DECAYS = {"fast": 0.0, "slow": 5.0}
B, P, T = 2, 64, 12


def ssm_inputs(seed, b, t, h, dk, dv, *, rwkv, decay, init=False,
               dtype="float32"):
    """numpy-drawn q, k, v, log_w = -exp(0.5 N - shift), u, initial state
    -> (JAX arrays, torch tensors); q/k/v rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    q, k = (rng.standard_normal((b, t, h, dk)).astype(f32) for _ in range(2))
    v = rng.standard_normal((b, t, h, dv)).astype(f32)
    logw = -np.exp(0.5 * rng.standard_normal((b, t, h, dk))
                   - DECAYS[decay]).astype(f32)
    u = (0.2 * rng.standard_normal((h, dk))).astype(f32) if rwkv else None
    s0 = rng.standard_normal((b, h, dk, dv)).astype(f32) if init else None
    jx = [jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)]
    tx = [torch.tensor(x).to(getattr(torch, dtype)) for x in (q, k, v)]
    jx += [jnp.asarray(x) if x is not None else None for x in (logw, u, s0)]
    tx += [torch.tensor(x) if x is not None else None for x in (logw, u, s0)]
    return jx, tx


def close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


# ------------------------------------------------------------------ ssm_scan
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("rwkv", [False, True])
@pytest.mark.parametrize("b,t,h,dk,dv,chunk", SSM_GRID)
def test_ssm_scan_plain_matches_pallas_and_jax_ref(b, t, h, dk, dv, chunk,
                                                   rwkv, decay, dtype):
    (jq, jk, jv, jw, ju, _), (q, k, v, w, u, _) = ssm_inputs(
        t + dk, b, t, h, dk, dv, rwkv=rwkv, decay=decay, dtype=dtype)
    y, s = ops.ssm_scan(q, k, v, w, u, chunk=chunk)
    assert y.dtype == q.dtype and s.dtype == torch.float32
    assert y.shape == (b, t, h, dv) and s.shape == (b, h, dk, dv)
    tol = SSM_TOL if dtype == "float32" else BF16_TOL
    close(y, jax_ssm_scan(jq, jk, jv, jw, ju, chunk=chunk), tol)
    want_y, want_s = jax_ref.ssm_scan_ref(jq, jk, jv, jw, bonus_u=ju)
    close(y, want_y, tol)
    close(s, want_s, tol)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("rwkv", [False, True])
@pytest.mark.parametrize("b,t,h,dk,dv,chunk", SSM_GRID)
def test_ssm_scan_final_state_matches_chunked_linear_attn(b, t, h, dk, dv,
                                                          chunk, rwkv, decay,
                                                          init):
    (jq, jk, jv, jw, ju, js0), (q, k, v, w, u, s0) = ssm_inputs(
        t + dk + 1, b, t, h, dk, dv, rwkv=rwkv, decay=decay, init=init)
    y, s = chunked_linear_attn(q, k, v, w, chunk=chunk, bonus_u=u,
                               initial_state=s0)
    want_y, want_s = jax_chunked(jq, jk, jv, jw, chunk=chunk, bonus_u=ju,
                                 initial_state=js0)
    close(y, want_y, SSM_TOL)
    close(s, want_s, SSM_TOL)
    if init:   # the initial state reaches y only through the carried read
        y0, _ = chunked_linear_attn(q, k, v, w, chunk=chunk, bonus_u=u)
        assert float((y - y0).abs().max()) > 1e-2


# ------------------------------------------------- the bf16 kernel's emulation
def scan_err(got, want, state=False):
    """Max |got - want| over 1 + the largest |want| of the same (sequence,
    head): the bf16 gate's measure (tests/test_torch_cuda.py)."""
    got, want = got.float(), want.float()
    scale = 1 + want.abs().amax(dim=(2, 3) if state else (1, 3), keepdim=True)
    return float(((got - want).abs() / scale).max())


@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("rwkv", [False, True])
@pytest.mark.parametrize("b,t,h,dk,dv,chunk", SSM_GRID)
def test_ssm_bf16_emulation_unrounded_matches_pallas_and_jax_ref(
        b, t, h, dk, dv, chunk, rwkv, decay):
    """With its roundings left out, the bf16 kernel's emulation is the
    exact chunked algorithm: the Pallas kernel (interpret) and the JAX
    sequential ref within the f32 1e-4."""
    (jq, jk, jv, jw, ju, _), (q, k, v, w, u, _) = ssm_inputs(
        t + dk + 2, b, t, h, dk, dv, rwkv=rwkv, decay=decay)
    y, s = ref.ssm_scan_bf16_emulation(q, k, v, w, bonus_u=u, chunk=chunk,
                                       rounding=False)
    assert y.dtype == torch.float32 and y.shape == (b, t, h, dv)
    close(y, jax_ssm_scan(jq, jk, jv, jw, ju, chunk=chunk), SSM_TOL)
    want_y, want_s = jax_ref.ssm_scan_ref(jq, jk, jv, jw, bonus_u=ju)
    close(y, want_y, SSM_TOL)
    close(s, want_s, SSM_TOL)


@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("rwkv", [False, True])
@pytest.mark.parametrize("b,t,h,dk,dv,chunk", SSM_GRID)
def test_ssm_bf16_emulation_within_the_bf16_gate(b, t, h, dk, dv, chunk,
                                                 rwkv, decay):
    """With the kernel's bf16 roundings, on bf16 inputs from an initial
    state: y within the bf16 gate (3e-2 of 1 + the largest |y| of the
    sequence and head) of the float32 recurrence, and the state, which the
    kernel keeps at float32 precision (k_out as hi + lo), within 1e-4."""
    _, (q, k, v, w, u, s0) = ssm_inputs(t + dk + 3, b, t, h, dk, dv,
                                        rwkv=rwkv, decay=decay, init=True,
                                        dtype="bfloat16")
    y, s = ref.ssm_scan_bf16_emulation(q, k, v, w, bonus_u=u, chunk=chunk,
                                       initial_state=s0)
    want_y, want_s = ref.ssm_scan_ref(q.float(), k.float(), v.float(), w,
                                      bonus_u=u, initial_state=s0)
    assert scan_err(y, want_y) <= BF16_TOL["rtol"]
    assert scan_err(s, want_s, state=True) <= SSM_TOL["rtol"]
    y0, s0_ = ref.ssm_scan_bf16_emulation(q, k, v, w, bonus_u=u, chunk=chunk,
                                          initial_state=s0, rounding=False)
    assert scan_err(y0, want_y) <= SSM_TOL["rtol"]   # the roundings move it
    assert scan_err(y, y0) > 1e-4


@pytest.mark.parametrize("decay", list(DECAYS))
def test_ssm_bf16_emulation_limits_reject_planted_faults(decay):
    """At RWKV-6-7B's head width and chunk (8 sub-blocks a chunk, 4
    chunks), each fault of SSM_EMU_FAULTS planted in the emulation reads
    above the limits that the kernel is held to against the emulation
    (ssm_emu_err, y or state)."""
    b, t, h, dk, dv, chunk = 1, 512, 2, 64, 64, 128
    _, (q, k, v, w, u, s0) = ssm_inputs(17, b, t, h, dk, dv, rwkv=True,
                                        decay=decay, init=decay == "slow",
                                        dtype="bfloat16")
    kw = dict(bonus_u=u, chunk=chunk, initial_state=s0)
    y, s = ref.ssm_scan_bf16_emulation(q, k, v, w, **kw)
    assert ref.ssm_emu_err(y.bfloat16(), y) == 0.0
    for fault in ref.SSM_EMU_FAULTS:
        fy, fs = ref.ssm_scan_bf16_emulation(q, k, v, w, fault=fault, **kw)
        err_y = ref.ssm_emu_err(fy.bfloat16(), y)
        err_s = ref.ssm_emu_err(fs, s, state=True)
        assert err_y > ref.SSM_EMU_TOL or err_s > ref.SSM_EMU_STATE_TOL, fault
    with pytest.raises(ValueError, match="unknown fault"):
        ref.ssm_scan_bf16_emulation(q, k, v, w, fault="none of them", **kw)


def test_slow_decay_carries_state_across_chunks():
    """With the slow decay, the second chunk's output depends on the first
    chunk's tokens (the carried state), by far more than the tolerance."""
    _, (q, k, v, w, u, _) = ssm_inputs(0, 1, 64, 2, 16, 16, rwkv=True,
                                       decay="slow")
    y, _ = ops.ssm_scan(q, k, v, w, u, chunk=32)
    k2 = k.clone()
    k2[:, :32] = 0.0
    y2, _ = ops.ssm_scan(q, k2, v, w, u, chunk=32)
    assert float((y[:, 32:] - y2[:, 32:]).abs().max()) > 0.5


def test_naive_linear_attn_matches_jax():
    (jq, jk, jv, jw, ju, js0), (q, k, v, w, u, s0) = ssm_inputs(
        3, 2, 16, 2, 8, 8, rwkv=True, decay="slow", init=True)
    y, s = naive_linear_attn(q, k, v, w, bonus_u=u, initial_state=s0)
    want_y, want_s = jax_naive(jq, jk, jv, jw, bonus_u=ju, initial_state=js0)
    close(y, want_y, MODULE_TOL)
    close(s, want_s, MODULE_TOL)


def test_ssm_scan_on_cpu_runs_plain_version_and_checks_shapes():
    _, (q, k, v, w, u, s0) = ssm_inputs(1, 1, 48, 2, 8, 16, rwkv=True,
                                        decay="fast", init=True)
    ops.reset_launch_counts()
    s0_before = s0.clone()
    y, s = ops.ssm_scan(q, k, v, w, u, chunk=16, initial_state=s0)
    want_y, want_s = ref.ssm_scan_ref(q, k, v, w, bonus_u=u,
                                      initial_state=s0)
    assert torch.equal(y, want_y) and torch.equal(s, want_s)
    assert sum(ops.launch_counts().values()) == 0
    assert torch.equal(s0, s0_before)      # the initial state is not mutated
    with pytest.raises(ValueError, match="c must divide T"):
        ops.ssm_scan(q, k, v, w, u, chunk=32)        # 48 % 32
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.ssm_scan(q, k, v, w, u, chunk=24)        # the reference's limit
    with pytest.raises(ValueError, match="bonus_u"):
        ops.ssm_scan(q, k, v, w, u[:1], chunk=16)
    with pytest.raises(ValueError, match="initial_state"):
        ops.ssm_scan(q, k, v, w, u, chunk=16, initial_state=s0[:, :1])
    with pytest.raises(ValueError, match=r"\[B,T,H,dk\]"):
        ops.ssm_scan(q, k[:, :, :1], v, w, u, chunk=16)
    meta = [x.to("meta") for x in (q, k, v, w)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.ssm_scan(*meta, chunk=16)
    with pytest.raises(ValueError, match="several devices"):
        ops.ssm_scan(q, k, v, meta[3], chunk=16)
    # an input that requires grad: the same forward, now with a graph
    # (tests/test_torch_train_ssm.py holds its gradients), shapes checked
    q.requires_grad_(True)
    yg, sg = ops.ssm_scan(q, k, v, w, u, chunk=16, initial_state=s0)
    assert yg.grad_fn is not None and sg.grad_fn is not None
    assert torch.equal(yg, want_y) and torch.equal(sg, want_s)
    with pytest.raises(ValueError, match="c must divide T"):
        ops.ssm_scan(q, k, v, w, u, chunk=32)


# ------------------------------------------------------------------ modules
def configs():
    """(port cfg, JAX cfg): reduced rwkv6_7b, 4 layers, d_model 256, 8
    heads of 32, chunk 32, exits (1, 2, 3, 4), float32."""
    kw = dict(n_layers=4)
    return get_arch("rwkv6_7b").reduced(**kw), \
        jax_get_arch("rwkv6_7b").reduced(**kw)


def params(cfg, seed=0):
    tree = lm_params_numpy(cfg, seed)
    return (lm_params_from_numpy(tree, cfg, "cpu"),
            jax.tree_util.tree_map(jnp.asarray, tree))


def layer(p, jp, i=1):
    """Layer ``i``'s block params, port and JAX."""
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[i]
    return pick(p["blocks"]), jax.tree_util.tree_map(lambda a: a[i],
                                                     jp["blocks"])


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def state(cfg, seed):
    """A nonzero RWKVState [B=2], as numpy (wkv, shift_tm, shift_cm)."""
    h = cfg.d_model // cfg.ssm_head_dim
    return (rand(seed, B, h, cfg.ssm_head_dim, cfg.ssm_head_dim),
            rand(seed + 1, B, cfg.d_model), rand(seed + 2, B, cfg.d_model))


def test_time_mix_and_channel_mix_match_reference():
    cfg, jcfg = configs()
    (bp, jbp) = layer(*params(cfg))
    core, jcore = bp["core"], jbp["core"]
    x = rand(4, B, P, cfg.d_model)
    st = state(cfg, 5)
    for s in (None, st):
        ts = None if s is None else RWKVState(*map(torch.tensor, s))
        js = None if s is None else JaxRWKVState(*map(jnp.asarray, s))
        y, wkv, last = RWKV6Block.time_mix(core, cfg, torch.tensor(x), ts)
        jy, jwkv, jlast = JaxRWKV.time_mix(jcore, jcfg, jnp.asarray(x), js)
        close(y, jy, MODULE_TOL)
        close(wkv, jwkv, SSM_TOL)
        close(last, jlast, dict(rtol=0, atol=0))
        prev = None if s is None else s[2]
        close(RWKV6Block.channel_mix(
                  core, torch.tensor(x),
                  None if prev is None else torch.tensor(prev)),
              JaxRWKV.channel_mix(
                  jcore, jnp.asarray(x),
                  None if prev is None else jnp.asarray(prev)), MODULE_TOL)


def test_rwkv6_block_decode_matches_reference():
    cfg, jcfg = configs()
    (bp, jbp) = layer(*params(cfg))
    st = state(cfg, 6)
    ts = RWKVState(*map(torch.tensor, st))
    js = JaxRWKVState(*map(jnp.asarray, st))
    for t in range(3):
        x = rand(7 + t, B, 1, cfg.d_model)
        y, ts = RWKV6Block.apply_decode(bp["core"], cfg, torch.tensor(x), ts)
        jy, js = JaxRWKV.apply_decode(jbp["core"], jcfg, jnp.asarray(x), js)
        close(y, jy, MODULE_TOL)
        for f in golden_tool.STATE_FIELDS:
            close(getattr(ts, f), getattr(js, f), MODULE_TOL)


def test_rwkv_block_wrap_dense_and_decode_match_reference():
    cfg, jcfg = configs()
    (bp, jbp) = layer(*params(cfg), i=2)
    x = rand(8, B, P, cfg.d_model)
    pos = jnp.broadcast_to(jnp.arange(P)[None], (B, P))
    y, cache, _ = RWKVBlockWrap.apply_dense(bp, cfg, torch.tensor(x),
                                            want_cache=True)
    jy, jcache, _ = JaxRWKVWrap.apply_dense(jbp, jcfg, jnp.asarray(x), pos,
                                            want_cache=True)
    close(y, jy, MODULE_TOL)
    close(cache.wkv, jcache.wkv, SSM_TOL)
    close(cache.shift_tm, jcache.shift_tm, MODULE_TOL)
    close(cache.shift_cm, jcache.shift_cm, MODULE_TOL)
    y2, none, _ = RWKVBlockWrap.apply_dense(bp, cfg, torch.tensor(x))
    assert none is None and torch.equal(y, y2)
    ts, js = cache, jcache
    for t in range(3):
        xt = rand(9 + t, B, 1, cfg.d_model)
        yt, ts, _ = RWKVBlockWrap.apply_decode(bp, cfg, torch.tensor(xt),
                                               ts, None)
        jyt, js, _ = JaxRWKVWrap.apply_decode(jbp, jcfg, jnp.asarray(xt), js,
                                              None)
        close(yt, jyt, MODULE_TOL)
        for f in golden_tool.STATE_FIELDS:
            close(getattr(ts, f), getattr(js, f), SSM_TOL)


# ------------------------------------------------------------- whole model
def test_prefill_logits_and_state_match_reference():
    cfg, jcfg = configs()
    p, jp = params(cfg)
    toks = golden_tool.tokens(cfg, B, P, seed=11)
    ops.reset_launch_counts()
    logits, cache = make_prefill_step(cfg)(p, {"tokens": torch.tensor(toks)})
    assert sum(ops.launch_counts().values()) == 0      # plain versions
    want, jstate = golden_tool.rwkv_prefill(jcfg, jp, toks)
    close(logits, want, MODEL_TOL)
    h = cfg.d_model // cfg.ssm_head_dim
    assert isinstance(cache["layers"], RWKVState)
    assert cache["layers"].wkv.shape == (cfg.n_layers, B, h, 32, 32)
    assert cache["layers"].wkv.dtype == torch.float32
    for f in golden_tool.STATE_FIELDS:
        close(getattr(cache["layers"], f), jstate[f], MODEL_TOL)


def test_prefill_state_is_the_state_decode_writes():
    """The port's prefill state equals the state its own serve_step writes
    teacher-forced over the same tokens, and the last logits agree."""
    cfg, _ = configs()
    p, _ = params(cfg)
    toks = torch.tensor(golden_tool.tokens(cfg, B, P, seed=12))
    logits_p, cache_p = make_prefill_step(cfg)(p, {"tokens": toks})
    step = make_serve_step(cfg)
    cache = DecoderLM.init_cache(cfg, B, P, device="cpu")
    for t in range(P):
        logits_d, cache = step(p, cache, toks[:, t], torch.full((B,), t))
    close(logits_d, logits_p.numpy(), MODEL_TOL)
    for f in golden_tool.STATE_FIELDS:
        close(getattr(cache["layers"], f),
              getattr(cache_p["layers"], f).numpy(), MODEL_TOL)


def test_serve_step_every_exit_matches_reference():
    cfg, jcfg = configs()
    p, jp = params(cfg)
    toks = golden_tool.tokens(cfg, B, T, seed=13)
    for e in cfg.exit_layers:
        want, jstate = golden_tool.rwkv_serve(jcfg, jp, toks, e)
        step = make_serve_step(cfg, exit_layer=e)
        cache = DecoderLM.init_cache(cfg, B, T, device="cpu")
        ops.reset_launch_counts()
        for t in range(T):
            logits, out = step(p, cache, torch.tensor(toks[:, t]),
                               torch.full((B,), t))
            assert out is cache
            close(logits, want[t], MODEL_TOL)
        assert sum(ops.launch_counts().values()) == 0
        for f in golden_tool.STATE_FIELDS:
            got = getattr(cache["layers"], f)
            close(got[:e], jstate[f][:e], MODEL_TOL)
            # the layers past the exit never ran: their state is untouched
            assert not got[e:].any()


# ------------------------------------------------------------------ params
def test_param_shapes_and_dtypes_equal_reference_init():
    """Full rwkv6_7b in bf16 (jax.eval_shape allocates nothing) and the
    reduced f32 variant: names, shapes and dtypes leaf by leaf."""
    for cfg, jcfg in ((get_arch("rwkv6_7b"), jax_get_arch("rwkv6_7b")),
                      configs()):
        shapes = jax.eval_shape(lambda k: JaxLM.init(k, jcfg),
                                jax.random.PRNGKey(0))
        want = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
        assert DecoderLM.param_shapes(cfg) == want
        want_dt = jax.tree_util.tree_map(lambda s: str(s.dtype), shapes)
        got_dt = jax.tree_util.tree_map(
            lambda d: str(d).replace("torch.", ""),
            DecoderLM.param_dtypes(cfg))
        assert got_dt == want_dt
    core = DecoderLM.param_dtypes(get_arch("rwkv6_7b"))["blocks"]["core"]
    assert core["w0"] == core["bonus_u"] == torch.float32
    assert core["wr"]["w"] == torch.bfloat16


def test_init_draws_the_reference_distributions():
    cfg, _ = configs()
    p = DecoderLM.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    core = p["blocks"]["core"]
    assert not core["w0"].any() and core["w0"].dtype == torch.float32
    assert core["bonus_u"].dtype == torch.float32
    for name in ("mix", "lora_a", "lora_b", "bonus_u", "cm_mix"):
        assert 0.015 < float(core[name].std()) < 0.025, name
    w = core["cm_k"]["w"]
    assert float(w.abs().max()) <= (6 / (cfg.d_model + cfg.d_ff)) ** 0.5
    assert bool((core["ln_x"]["scale"] == 1).all())
    bf = DecoderLM.init(torch.Generator().manual_seed(0),
                        get_arch("rwkv6_7b").reduced(dtype="bfloat16"),
                        device="cpu")
    assert bf["blocks"]["core"]["wr"]["w"].dtype == torch.bfloat16
    assert bf["blocks"]["core"]["w0"].dtype == torch.float32


def test_lm_params_from_numpy_takes_rwkv_leaf_dtypes():
    cfg = get_arch("rwkv6_7b").reduced(n_layers=2, dtype="bfloat16")
    f32 = ("w0", "bonus_u")
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key in f32
        else np.asarray(jnp.asarray(a, jnp.bfloat16)),
        lm_params_numpy(cfg, 0))
    p = lm_params_from_numpy(tree, cfg, "cpu")
    assert p["blocks"]["core"]["w0"].dtype == torch.float32
    assert p["blocks"]["core"]["wk"]["w"].dtype == torch.bfloat16
    tree["blocks"]["core"]["w0"] = np.asarray(
        jnp.asarray(tree["blocks"]["core"]["w0"], jnp.bfloat16))
    with pytest.raises(TypeError, match="blocks/core/w0: dtype bfloat16, "
                                        "expected float32"):
        lm_params_from_numpy(tree, cfg, "cpu")


def test_rwkv_is_ported_and_mamba_is_not():
    """RWKV-6 runs as a DecoderLM of rwkv6 blocks. (Mamba-2 is ported
    since: tests/test_torch_models_zoo.py holds it.)"""
    assert block_kind(get_arch("rwkv6_7b")) == "rwkv6"
    assert model_for(get_arch("rwkv6_7b")) is DecoderLM
