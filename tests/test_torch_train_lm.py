"""The port's LM training (``repro_torch.train.steps``, ``forward_train``,
the differentiable ``flash_attention`` route, ``launch/train.py``, LM
checkpoints) against the JAX package: reduced Llama (exits (1, 2),
``remat=True``), DeepSeek-MoE, DeepSeek-V2 (MLA) and Whisper in float32
on the same numpy params and batches.

The reference's steps come from ``tools/make_torch_train_golden.py::
lm_run`` (``jax.value_and_grad`` of the reference's loss, AdamW under
``linear_warmup_cosine``), held against the reference's jitted
``make_train_step`` itself; ``tests/data/torch_train_golden.npz`` carries
those runs to the GPU machine, where ``chip_smoke.py`` replays them, and
a test here keeps it current. Params after Adam steps are held by
``chip_smoke.adam_rule``: rtol 1e-4 / atol 2e-7, an entry off it only
where a step's reference gradient sat within 1e-4 of its leaf's max of 0
(a near-tie, counted)."""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models.attention import sdpa as jax_sdpa
from repro.nn.pytree import flatten_dict as jax_flatten
from repro.train import checkpoint as jax_ckpt
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.bridge import (lm_params_from_numpy, lm_params_numpy,
                                     train_state_from_numpy)
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import DecoderLM
from repro_torch.nn.pytree import flatten_dict, unflatten_dict
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.train import restore_lm_params, save_checkpoint
from repro_torch.train._msgpack import unpackb
from repro_torch.train.checkpoint import read_payload
from repro_torch.train.steps import (make_loss_fn, make_train_state,
                                     make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
import make_torch_train_golden as golden_tool  # noqa: E402

sys.path.pop(0)
sys.path.pop(0)
torch.set_num_threads(1)

ARCHS = ("llama3_2_1b", "deepseek_moe_16b", "deepseek_v2_236b",
         "whisper_medium", "rwkv6_7b", "zamba2_2_7b")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's max |g|
FLASH_GRAD_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def ref_run(arch):
    return golden_tool.lm_run(arch)


def port_optimizer():
    """The golden runs' optimizer (``golden_tool.lm_optimizer``)."""
    return adamw(linear_warmup_cosine(*golden_tool.LM_SCHEDULE),
                 weight_decay=golden_tool.LM_WEIGHT_DECAY)


def t_batch(batch):
    return {k: torch.tensor(v).long() if v.dtype == np.int32
            else torch.tensor(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def port_run(arch):
    """The port on the reference's params and batches: the loss, metrics
    and gradients at the initial params, and the two train steps' metrics
    and final state."""
    run = ref_run(arch)
    cfg = run["cfg"]
    cfg = get_arch(arch).reduced(exit_layers=cfg.exit_layers,
                                 remat=cfg.remat, ssm_chunk=cfg.ssm_chunk)
    params = lm_params_from_numpy(lm_params_numpy(cfg, golden_tool.LM_SEED),
                                  cfg, "cpu")
    flat = {k: v.detach().requires_grad_()
            for k, v in flatten_dict(params).items()}
    loss, metrics = make_loss_fn(cfg)(unflatten_dict(flat),
                                      t_batch(run["batches"][0]))
    grads = torch.autograd.grad(loss, list(flat.values()))
    loss = loss.detach()
    state, opt = make_train_state(cfg, None, port_optimizer(),
                                  params=params)
    step = make_train_step(cfg, opt)
    step_metrics = []
    for batch in run["batches"]:
        state, m = step(state, t_batch(batch))
        step_metrics.append({k: float(v) for k, v in m.items()})
    return {"cfg": cfg, "loss": float(loss),
            "metrics": {k: float(v.detach()) for k, v in metrics.items()},
            "grads": dict(zip(flat, (g.numpy() for g in grads))),
            "step_metrics": step_metrics, "state": state}


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30) if b else abs(a)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_metrics_match_reference(arch):
    """The multi-exit loss, each exit's CE and the MoE load-balance loss at
    the initial params, 1e-5 relative; the dropped fraction exactly."""
    want, got = ref_run(arch)["metrics"][0], port_run(arch)
    assert sorted(got["metrics"]) == sorted(k for k in want if k != "loss")
    assert rel(got["loss"], want["loss"]) <= LOSS_RTOL
    for k, w in want.items():
        if k == "loss":
            continue
        if k == "moe_dropped":
            assert got["metrics"][k] == w
        else:
            assert rel(got["metrics"][k], w) <= LOSS_RTOL, k
    exits = [int(k[3:]) for k in want if k.startswith("ce_")]
    assert exits == list(port_run(arch)["cfg"].exit_layers)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    """Every param's gradient against ``jax.value_and_grad`` of the
    reference's loss at the same params: 1e-4 of the leaf's max |g|."""
    want = jax_flatten(ref_run(arch)["grads"][0])
    got = port_run(arch)["grads"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        m = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max()) / m
        assert err <= GRAD_TOL, f"{k}: {err:.3e} of the leaf's max |g|"


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_reference(arch):
    """Two ``make_train_step`` steps under AdamW + ``linear_warmup_cosine``:
    each step's loss and metrics, then params and AdamW's moments by the
    Adam rule (moments: nu's atol 2e-9, as chip_smoke's TRAIN_NU_TOL)."""
    run, port = ref_run(arch), port_run(arch)
    for got, want in zip(port["step_metrics"], run["metrics"]):
        for k, w in want.items():
            if k == "moe_dropped":
                assert got[k] == w
            else:
                assert rel(got[k], w) <= LOSS_RTOL, k
    ref_state = run["states"][-1]
    state = port["state"]
    assert int(state.step) == int(ref_state.step) == 2
    assert int(state.opt_state["step"]) == int(ref_state.opt_state["step"])
    ties, n = state_by_adam_rule(
        {"params": state.params, **state.opt_state}, ref_state,
        run["grads"])
    print(f"{arch}: near-ties {ties} of {n}")
    assert ties <= 1e-3 * n


def state_by_adam_rule(got: dict, ref_state, grads):
    """``got`` ``{"params", "mu", "nu"}`` (tensor or numpy trees) against
    the reference's TrainState by ``chip_smoke.adam_rule`` (nu with
    TRAIN_NU_TOL's atol); asserts no entry off it outside near-ties.
    Returns (near-ties, entries)."""
    grads = [jax_flatten(g) for g in grads]
    ties = n = 0
    for name, ref_tree, tol in (
            ("params", ref_state.params, chip_smoke.TRAIN_PARAM_TOL),
            ("mu", ref_state.opt_state["mu"], chip_smoke.TRAIN_PARAM_TOL),
            ("nu", ref_state.opt_state["nu"], chip_smoke.TRAIN_NU_TOL)):
        want = jax_flatten(ref_tree)
        for k, x in jax_flatten(got[name]).items():
            x = np.asarray(x)
            g = [gs[k] for gs in grads]
            bad, tie = chip_smoke.adam_rule(
                x, want[k], g, [float(np.abs(a).max()) for a in g],
                rtol=tol[0], atol=tol[1])
            assert bad == 0, f"{name} {k}: {bad} entries off the reference"
            ties += tie
            n += x.size
    return ties, n


def test_lm_run_is_the_reference_train_step():
    """``lm_run`` (value_and_grad, then AdamW eagerly) equals the
    reference's jitted ``make_train_step`` after each step, by the rule
    the port is held to (two XLA compilations round differently)."""
    run = ref_run("llama3_2_1b")
    for t, (got, want) in enumerate(zip(
            run["states"], golden_tool.reference_train_steps("llama3_2_1b"))):
        assert int(got.step) == int(want.step) == t + 1
        state_by_adam_rule({"params": got.params, **got.opt_state}, want,
                           run["grads"][:t + 1])


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_2_7b"])
def test_ssm_configs_refuse_training(arch):
    """RWKV-6 and Zamba2, which once refused training, build a train step
    and take one: a finite loss, the step counted, every param moved
    through the differentiable ``ops.ssm_scan``."""
    cfg = get_arch(arch, reduced=True)
    params = lm_params_from_numpy(lm_params_numpy(cfg, 0), cfg, "cpu")
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 17))).long()
    state, opt = make_train_state(cfg, None, adamw(1e-3), params=params)
    new, metrics = make_train_step(cfg, opt)(
        state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(metrics["loss"])) and int(new.step) == 1
    for k, x in flatten_dict(new.params).items():
        assert not torch.equal(x, flatten_dict(params)[k]), k


def test_every_other_config_builds_a_train_step():
    """Every arch, the SSM ones included, builds a train step."""
    for arch in ARCH_IDS:
        assert callable(make_train_step(get_arch(arch, reduced=True),
                                        adamw(1e-3)))


def test_train_step_marks_its_parts():
    """``on_part`` is called as the forward, the backward and the update
    end, in that order, and changes no number of the step."""
    cfg = get_arch("llama3_2_1b", reduced=True)
    params = lm_params_from_numpy(lm_params_numpy(cfg, 0), cfg, "cpu")
    toks = torch.tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 9))).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    parts, out = [], []
    for hook in (None, parts.append):
        state, opt = make_train_state(cfg, None, adamw(1e-3), params=params)
        out.append(make_train_step(cfg, opt, on_part=hook)(state, batch))
    assert parts == ["forward", "backward", "optimizer"]
    assert float(out[0][1]["loss"]) == float(out[1][1]["loss"])
    for a, b in zip(flatten_dict(out[0][0].params).values(),
                    flatten_dict(out[1][0].params).values()):
        assert torch.equal(a, b)


def test_remat_changes_no_number():
    """The checkpointed route (``remat=True``) gives the same loss and
    gradients as the plain one."""
    base = get_arch("llama3_2_1b").reduced(exit_layers=(1, 2))
    rng = np.random.default_rng(3)
    toks = torch.tensor(rng.integers(0, base.vocab, (2, 9))).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = []
    for remat in (False, True):
        cfg = get_arch("llama3_2_1b").reduced(exit_layers=(1, 2),
                                              remat=remat)
        p = lm_params_from_numpy(lm_params_numpy(cfg, 0), cfg, "cpu")
        flat = {k: v.requires_grad_() for k, v in flatten_dict(p).items()}
        loss, _ = make_loss_fn(cfg)(unflatten_dict(flat), batch)
        out.append((loss, torch.autograd.grad(loss, list(flat.values()))))
    assert float(out[0][0].detach()) == float(out[1][0].detach())
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("causal,window,shape", [
    (True, None, (2, 12, 4, 2, 16)), (True, 5, (2, 12, 4, 2, 16)),
    (False, None, (2, 10, 4, 4, 32))])
def test_flash_route_grads_match_jax_sdpa(causal, window, shape):
    """``ops.flash_attention``'s gradients on the CPU (autograd through
    the plain version) against ``jax.grad`` of the reference's ``sdpa``,
    for q, k and v: causal, windowed, maskless (Whisper's encoder)."""
    b, s, h, kvh, d = shape
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((b, s, n, d)).astype(np.float32)
               for n in (h, kvh, kvh))
    w = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))

    def jloss(q, k, v):
        out = jax_sdpa(q, k, v, pos, pos, scale=1.0 / np.sqrt(d),
                       causal=causal, window=window)
        return jnp.sum(out * w)

    want = golden_tool.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = ops.flash_attention(*ts, causal=causal, window=window)
    (out * torch.tensor(w)).sum().backward()
    for name, tt, wg in zip("qkv", ts, want):
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(wg),
                                   rtol=FLASH_GRAD_TOL, atol=FLASH_GRAD_TOL,
                                   err_msg=name)


def test_decode_and_scan_stay_forward_only():
    q = torch.zeros(1, 2, 32, requires_grad=True)
    kv = torch.zeros(1, 4, 2, 32)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.decode_attention(q, kv, kv, torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_with_reference(tmp_path, dtype):
    """A JAX ``save_checkpoint`` of reduced Llama params restores into the
    port's tree (``restore_lm_params``), the port saves it again, and JAX
    restores that: the same msgpack payload, byte for byte."""
    cfg = get_arch("llama3_2_1b").reduced(dtype=dtype)
    jcfg = jax_get_arch("llama3_2_1b").reduced(dtype=dtype)
    # the float32 leaves (none in Llama) would keep float32
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jcfg.jnp_dtype),
                                lm_params_numpy(cfg, 0))
    a, b = str(tmp_path / "ref.ckpt"), str(tmp_path / "port.ckpt")
    jax_ckpt.save_checkpoint(a, jp)
    params = restore_lm_params(a, cfg, "cpu")
    assert all(x.dtype == getattr(torch, dtype)
               for x in flatten_dict(params).values())
    save_checkpoint(b, params)
    assert unpackb(read_payload(a)) == unpackb(read_payload(b))
    back = jax_ckpt.restore_checkpoint(b)
    for k, x in jax_flatten(jp).items():
        assert np.asarray(jax_flatten(back)[k]).tobytes() == \
            np.asarray(x).tobytes(), k


def test_restore_lm_params_checks_the_tree(tmp_path):
    cfg = get_arch("llama3_2_1b").reduced()
    other = get_arch("llama3_2_1b").reduced(d_ff=256)
    path = str(tmp_path / "p.ckpt")
    save_checkpoint(path, lm_params_from_numpy(lm_params_numpy(other, 0),
                                               other, "cpu"))
    with pytest.raises(ValueError, match="shape"):
        restore_lm_params(path, cfg, "cpu")


def test_train_state_from_numpy_continues_the_run():
    """The reference's state after its first step, carried over, takes the
    port's second step to the reference's second state (Adam rule)."""
    arch = "llama3_2_1b"
    run = ref_run(arch)
    cfg = port_run(arch)["cfg"]
    state = train_state_from_numpy(run["states"][0], cfg, "cpu")
    assert int(state.step) == 1 and int(state.opt_state["step"]) == 1
    state, _ = make_train_step(cfg, port_optimizer())(
        state, t_batch(run["batches"][1]))
    want = jax_flatten(run["states"][1].params)
    for k, x in flatten_dict(state.params).items():
        g = jax_flatten(run["grads"][1])[k]
        bad, _ = chip_smoke.adam_rule(x.numpy(), want[k], [g],
                                      [float(np.abs(g).max())])
        assert bad == 0, k
    with pytest.raises(ValueError):
        train_state_from_numpy(run["states"][0],
                               get_arch(arch).reduced(d_ff=256), "cpu")


def test_launch_train_runs_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "llama.ckpt")
    launch_train.main(["--device", "cpu", "--arch", "llama3_2_1b",
                       "--reduced", "--steps", "3", "--batch", "2",
                       "--seq", "16", "--log-every", "1", "--checkpoint",
                       path])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines[:3]] == [
        ["step", "0"], ["step", "1"], ["step", "2"]]
    assert lines[-1] == f"saved params -> {path}"
    cfg = get_arch("llama3_2_1b", reduced=True)
    assert set(flatten_dict(restore_lm_params(path, cfg, "cpu"))) == set(
        flatten_dict(DecoderLM.param_shapes(cfg)))


def test_launch_train_whisper_and_the_default_device():
    """Whisper trains with its random audio frames; without ``--device``
    the CLI asks for the card and raises where there is none."""
    out = launch_train.train(launch_train.parse_args(
        ["--device", "cpu", "--arch", "whisper_medium", "--reduced",
         "--steps", "2", "--batch", "1", "--seq", "8"]), log=lambda _: None)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch_train.train(launch_train.parse_args(
                ["--arch", "llama3_2_1b", "--reduced", "--steps", "1"]))


def test_train_golden_is_current():
    """The stored LM runs equal ``lm_run``'s (the same JAX runs the tests
    above use; floats to 1e-6: XLA's CPU code may round differently on
    another CPU model)."""
    gold = golden_tool.load()
    fresh = {}
    for arch in golden_tool.LM_ARCHS:
        fresh.update(golden_tool.build_lm(arch, ref_run(arch)))
    for k, v in fresh.items():
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(gold[k], v, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(gold[k], v, err_msg=k)
    assert set(k for k in gold if k.split("/")[0] in golden_tool.LM_ARCHS) \
        == set(fresh)


@pytest.mark.parametrize("arch", golden_tool.LM_ARCHS)
def test_port_replays_the_train_golden_file(arch):
    """What chip_smoke.py's phase 34 does on the card, here on the CPU."""
    out = chip_smoke.lm_train_replay(torch.device("cpu"),
                                     golden_tool.load(), arch)
    assert out["grad_err"] <= GRAD_TOL and out["loss_err"] <= LOSS_RTOL
