"""Write ``tests/data/torch_train_golden.npz``: JAX training runs that the
port's training paths are replayed against on the GPU, where JAX is not
installed.

    PYTHONPATH=src python tools/make_torch_train_golden.py

The LM part: for each arch of ``LM_ARCHS``, ``lm_config(arch)`` (the
reduced config; Llama with exits (1, 2) of 2 layers and ``remat=True``,
RWKV-6 and Zamba2 with ``remat=True`` and chunks of 8 rows),
float32 params from ``repro_torch.core.bridge.lm_params_numpy(cfg,
LM_SEED)`` (rebuilt from the seed on the card, so not stored), and
``LM_STEPS`` steps of the reference's ``make_train_step`` under
``adamw(linear_warmup_cosine(*LM_SCHEDULE), weight_decay=
LM_WEIGHT_DECAY)`` on numpy batches (``lm_batches``), taken apart so
that the gradients are kept (``lm_run``; ``reference_train_steps`` runs
the jitted step itself). Per arch ``a``: ``a/tokens``, ``a/labels`` [T,
B, S] (Whisper also ``a/audio`` [T, B, frames, d]); per step ``a/loss``,
``a/ce_<e>``, ``a/moe_aux``, ``a/moe_dropped`` [T]; the config's
``a/exit_layers``, ``a/remat`` (and an SSM arch's ``a/ssm_chunk``);
and, for a sample of ``SAMPLE`` entries of each param leaf (``a/idx/<path>``, flat indices), each step's
gradient ``a/grads/<t>/<path>`` (of the reference's loss, ``jax.grad``;
``a/grad_max/<t>/<path>`` the leaf's max |g|) and the final params
``a/params/<path>``.

The VGG part: ``VGG16EE`` at ``VGG_WIDTH`` with numpy He-normal params
(``repro_torch.core.bridge.vgg_params_numpy(VGG_WIDTH, VGG_SEED)``) and
numpy batches (``vgg_numpy_batches``, stored: ``vgg/images`` [2 S, B,
32, 32, 3], ``vgg/labels``), trained by the reference's two stages
(``vgg_run``: ``VGG_STEPS`` Adam steps on exit 17, then ``VGG_STEPS`` on
the exits with the trunk frozen, as ``repro/vgg/train.py::train_vgg_ee``
does them): ``vgg/main_loss``, ``vgg/exit_loss`` [S], and sampled as above
the grads of every step ``vgg/grads/<t>/<path>`` (the leaves the step
trains) and the final ``vgg/params/<path>``.

``tests/test_torch_train_lm.py`` holds ``lm_run`` against the reference's
jitted ``make_train_step`` and checks that the file is current;
``tests/test_torch_vgg.py`` does the VGG part.
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
from repro.data import SyntheticImages  # noqa: E402
from repro.models.lm import model_for  # noqa: E402
from repro.nn.pytree import flatten_dict  # noqa: E402
from repro.optim import adam, adamw, linear_warmup_cosine  # noqa: E402
from repro.optim.optimizers import apply_updates  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.vgg import VGG16EE  # noqa: E402
from repro.vgg.model import N_EXITS  # noqa: E402
from repro.vgg.train import _ce  # noqa: E402
from repro_torch.core.bridge import (lm_params_numpy,  # noqa: E402
                                     vgg_params_numpy)

PATH = os.path.join(ROOT, "tests", "data", "torch_train_golden.npz")
LM_ARCHS = ("llama3_2_1b", "deepseek_moe_16b", "whisper_medium",
            "rwkv6_7b", "zamba2_2_7b")
LM_SEED, LM_BATCH_SEED = 0, 1
LM_B, LM_S, LM_STEPS = 2, 16, 2
# lr, warm-up steps, decay steps. The lr is small on purpose: Adam's first
# step moves an entry by ~lr whatever its gradient's size, so an entry
# whose gradient sits within rounding of 0 (a near-tie) can step either
# way, and at lr 1e-3 those flips perturb the second step's gradients
# beyond the gates (between two JAX compilations of the same step too).
# The weight decay is large so that its term (lr * wd * p) shows above
# the params' rtol.
LM_SCHEDULE = (1e-5, 1, 4)
LM_WEIGHT_DECAY = 30.0
# each arch's reduced config beyond ``reduced()``'s defaults: Llama with
# exits and remat; the SSM archs remat'd with chunks of 8 rows, so that
# LM_S = 16 tokens run two chunks and the state carried between them
ARCH_KW = {"llama3_2_1b": {"exit_layers": (1, 2), "remat": True},
           "rwkv6_7b": {"remat": True, "ssm_chunk": 8},
           "zamba2_2_7b": {"remat": True, "ssm_chunk": 8}}
VGG_WIDTH, VGG_SEED, VGG_BATCH_SEED = 0.125, 0, 2
# the lr is small for the reason LM_SCHEDULE's is: at 1e-3 the card's
# cuDNN convolutions flip near-tied first steps that XLA's do not, and
# the second step's loss moves 3e-4 relative
VGG_B, VGG_STEPS, VGG_LR = 4, 3, 1e-5
SAMPLE = 128
# XLA's CPU backend without LLVM's optimization passes: the same HLO, so
# the same arithmetic, compiled in about two thirds of the time (the
# reference runs here and in the tests are compile-bound)
COMPILE = {"xla_backend_optimization_level": 0}


def jit(fn):
    return jax.jit(fn, compiler_options=COMPILE)


def lm_config(arch: str):
    return get_arch(arch).reduced(**ARCH_KW.get(arch, {}))


def lm_optimizer():
    return adamw(linear_warmup_cosine(*LM_SCHEDULE),
                 weight_decay=LM_WEIGHT_DECAY)


def lm_batches(cfg, steps: int = LM_STEPS, b: int = LM_B, s: int = LM_S):
    """``steps`` numpy batches: tokens/labels [b, s] int32 (a random walk,
    labels the next tokens), Whisper's audio [b, frames, d] float32."""
    rng = np.random.default_rng(LM_BATCH_SEED)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab, size=(b, s + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.enc_layers:
            batch["audio"] = rng.standard_normal(
                (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
        out.append(batch)
    return out


def lm_loss_fn(cfg):
    """The reference's train loss, ``make_train_step``'s ``loss_fn`` (which
    it does not return), from its public pieces: (loss, metrics)."""
    model = model_for(cfg)

    def loss_fn(params, batch):
        if cfg.enc_layers:
            hiddens, aux = model.forward_train(params, cfg, batch["audio"],
                                               batch["tokens"])
            head = params["decoder"]["lm_head"]
        else:
            hiddens, aux = model.forward_train(params, cfg, batch["tokens"])
            head = params["lm_head"]
        loss, per_exit = jsteps.multi_exit_loss(params, cfg, hiddens,
                                                batch["labels"],
                                                head_params=head)
        loss = loss + cfg.router_aux_coef * aux.moe_aux
        metrics = {"ce_" + str(e): v for e, v in per_exit.items()}
        metrics["moe_aux"] = aux.moe_aux
        metrics["moe_dropped"] = aux.moe_dropped
        return loss, metrics

    return loss_fn


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _update(opt):
    """``(grads, opt_state, params) -> (params, opt_state)``: the
    optimizer's update applied, as ``make_train_step`` ends."""

    def update(g, opt_state, params):
        updates, opt_state = opt.update(g, opt_state, params)
        return apply_updates(params, updates), opt_state

    return update


def lm_run(arch: str, params=None) -> dict:
    """``LM_STEPS`` train steps from ``params`` (numpy;
    ``lm_params_numpy(cfg, LM_SEED)`` by default), each the reference's
    ``make_train_step`` taken apart: ``jax.value_and_grad`` of its loss
    then the optimizer's update and ``apply_updates``, two jitted
    programs, so that each step's gradients are kept.
    Returns {"cfg", "batches", "metrics": [per step], "grads": [per step,
    numpy trees], "states": [TrainState after each step, numpy]}."""
    cfg = lm_config(arch)
    if params is None:
        params = lm_params_numpy(cfg, LM_SEED)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt = lm_optimizer()
    state = jsteps.TrainState(p, opt.init(p), jnp.zeros((), jnp.int32))
    vg = jit(jax.value_and_grad(lm_loss_fn(cfg), has_aux=True))
    update = jit(_update(opt))
    batches = lm_batches(cfg)
    metrics, grads, states = [], [], []
    for batch in batches:
        (loss, m), g = vg(state.params, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
        params, opt_state = update(g, state.opt_state, state.params)
        state = jsteps.TrainState(params, opt_state, state.step + 1)
        metrics.append({"loss": float(loss),
                        **{k: float(v) for k, v in m.items()}})
        grads.append(np_tree(g))
        states.append(np_tree(state))
    return {"cfg": cfg, "batches": batches, "metrics": metrics,
            "grads": grads, "states": states}


def reference_train_steps(arch: str, params=None) -> list:
    """The same steps through the reference's jitted ``make_train_step``
    itself: [TrainState after each step, numpy]."""
    cfg = lm_config(arch)
    if params is None:
        params = lm_params_numpy(cfg, LM_SEED)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt = lm_optimizer()
    state = jsteps.TrainState(p, opt.init(p), jnp.zeros((), jnp.int32))
    step = jit(jsteps.make_train_step(cfg, opt))
    out = []
    for batch in lm_batches(cfg):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append(np_tree(state))
    return out


def sample_idx(size: int, path: str) -> np.ndarray:
    """``SAMPLE`` flat indices of a leaf (all of a smaller one), sorted,
    from a generator seeded by the path."""
    if size <= SAMPLE:
        return np.arange(size, dtype=np.int64)
    seed = int.from_bytes(path.encode()[-8:].rjust(8, b"\0"), "little")
    rng = np.random.default_rng([seed, size])
    return np.sort(rng.choice(size, SAMPLE, replace=False)).astype(np.int64)


def _sampled(gold: dict, prefix: str, tree: dict, idx: dict) -> None:
    for path, x in flatten_dict(tree).items():
        gold[f"{prefix}/{path}"] = np.asarray(x).reshape(-1)[idx[path]]


def build_lm(arch: str, run=None) -> dict:
    run = run or lm_run(arch)
    cfg = run["cfg"]
    gold = {f"{arch}/{k}": np.stack([b[k] for b in run["batches"]])
            for k in run["batches"][0]}
    for k in run["metrics"][0]:
        gold[f"{arch}/{k}"] = np.array([m[k] for m in run["metrics"]],
                                       np.float32)
    params = run["states"][-1].params
    idx = {path: sample_idx(x.size, f"{arch}/{path}")
           for path, x in flatten_dict(params).items()}
    for path, i in idx.items():
        gold[f"{arch}/idx/{path}"] = i
    for t, g in enumerate(run["grads"]):
        _sampled(gold, f"{arch}/grads/{t}", g, idx)
        for path, x in flatten_dict(g).items():
            gold[f"{arch}/grad_max/{t}/{path}"] = np.float32(
                np.abs(x).max())
    _sampled(gold, f"{arch}/params", params, idx)
    gold[f"{arch}/exit_layers"] = np.array(cfg.exit_layers, np.int32)
    gold[f"{arch}/remat"] = np.array(cfg.remat)
    if cfg.ssm_kind != "none":
        gold[f"{arch}/ssm_chunk"] = np.array(cfg.ssm_chunk, np.int32)
    return gold


# ------------------------------------------------------------------- VGG
def vgg_numpy_batches(steps: int = 2 * VGG_STEPS, batch: int = VGG_B):
    """Numpy batches for the card's replay: N(0, 1) images plus a
    per-class offset, uniform labels."""
    rng = np.random.default_rng(VGG_BATCH_SEED)
    labels = rng.integers(0, 10, size=(steps, batch)).astype(np.int32)
    offset = rng.standard_normal((10, 1, 1, 3)).astype(np.float32)
    images = rng.standard_normal((steps, batch, 32, 32, 3)).astype(
        np.float32) + offset[labels]
    return images, labels


def reference_eval_batches(*, eval_batches: int, batch: int,
                           noise: float = 0.8, data_seed: int = 0,
                           eval_seed: int = 10_000):
    """The eval batches the reference's ``profile_exits`` draws."""
    data = SyntheticImages(noise=noise, seed=data_seed)
    key = jax.random.PRNGKey(eval_seed)
    out = []
    for _ in range(eval_batches):
        key, kb = jax.random.split(key)
        x, y = data.sample(kb, batch)
        out.append((np.asarray(x), np.asarray(y).astype(np.int32)))
    return out


def vgg_run(params, images, labels, *, steps: int = VGG_STEPS,
            lr: float = VGG_LR) -> dict:
    """The reference's two stages (``repro/vgg/train.py::train_vgg_ee``'s
    steps: its ``_ce`` on ``VGG16EE.apply``, Adam, the trunk frozen by
    ``stop_gradient`` in stage 2) from numpy ``params`` on the given
    batches, recording every step's gradients: {"main_loss",
    "exit_loss", "grads": [per step, numpy trees of the trained leaves],
    "stage1": params after stage 1, "params": final}. Both stages' losses
    and gradients come from one jitted program, the updates from
    another."""
    opt = adam(lr)
    p = jax.tree_util.tree_map(jnp.asarray, params)

    def loss_main(q, x, y):
        return _ce(VGG16EE.apply(q, x, up_to_exit=N_EXITS)[N_EXITS], y)

    def loss_exits(p_exits, frozen, x, y):
        q = {**frozen, "exits": p_exits,
             "stages": jax.tree_util.tree_map(jax.lax.stop_gradient,
                                              frozen["stages"])}
        outs = VGG16EE.apply(q, x, up_to_exit=N_EXITS)
        losses = [_ce(v, y) for k, v in outs.items() if k != N_EXITS]
        return sum(losses) / max(len(losses), 1)

    @jit
    def both(q, x, y):
        return (jax.value_and_grad(loss_main)(q, x, y),
                jax.value_and_grad(loss_exits)(q["exits"], q, x, y))

    update = jit(_update(opt))
    hist = {"main_loss": [], "exit_loss": [], "grads": []}
    state = opt.init(p)
    for i in range(steps):
        (loss, g), _ = both(p, jnp.asarray(images[i]),
                            jnp.asarray(labels[i]))
        p, state = update(g, state, p)
        hist["main_loss"].append(float(loss))
        hist["grads"].append(np_tree({k: v for k, v in g.items()
                                      if k != "exits"}))
    hist["stage1"] = np_tree(p)
    p_exits = p["exits"]
    state = opt.init(p_exits)
    for i in range(steps, 2 * steps):
        _, (loss, g) = both({**p, "exits": p_exits},
                            jnp.asarray(images[i]), jnp.asarray(labels[i]))
        p_exits, state = update(g, state, p_exits)
        hist["exit_loss"].append(float(loss))
        hist["grads"].append(np_tree({"exits": g}))
    hist["params"] = np_tree({**p, "exits": p_exits})
    return hist


def build_vgg(run=None) -> dict:
    images, labels = vgg_numpy_batches()
    run = run or vgg_run(vgg_params_numpy(VGG_WIDTH, VGG_SEED), images,
                         labels)
    gold = {"vgg/images": images, "vgg/labels": labels,
            "vgg/main_loss": np.array(run["main_loss"], np.float32),
            "vgg/exit_loss": np.array(run["exit_loss"], np.float32)}
    idx = {path: sample_idx(x.size, f"vgg/{path}")
           for path, x in flatten_dict(run["params"]).items()}
    for path, i in idx.items():
        gold[f"vgg/idx/{path}"] = i
    for t, g in enumerate(run["grads"]):
        _sampled(gold, f"vgg/grads/{t}", g, idx)
        for path, x in flatten_dict(g).items():
            gold[f"vgg/grad_max/{t}/{path}"] = np.float32(np.abs(x).max())
    _sampled(gold, "vgg/params", run["params"], idx)
    return gold


def build(lm_runs=None, vgg=None) -> dict:
    lm_runs = lm_runs or {}
    gold = {"lm_archs": np.array(LM_ARCHS), "lm_seed": np.array(LM_SEED),
            "lm_schedule": np.array(LM_SCHEDULE),
            "lm_weight_decay": np.array(LM_WEIGHT_DECAY),
            "vgg_width": np.array(VGG_WIDTH), "vgg_seed": np.array(VGG_SEED),
            "vgg_steps": np.array(VGG_STEPS), "vgg_lr": np.array(VGG_LR)}
    for arch in LM_ARCHS:
        gold.update(build_lm(arch, lm_runs.get(arch)))
    gold.update(build_vgg(vgg))
    return gold


def load(path: str = PATH) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def main() -> None:
    gold = build()
    np.savez_compressed(PATH, **gold)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes, {len(gold)} "
          f"entries)")


if __name__ == "__main__":
    main()
