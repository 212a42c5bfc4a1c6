"""The port's multi-exit VGG-16 (``repro_torch.vgg``) against the JAX
package: every exit's logits (numpy params carried into both; the
reference's own init tree, from ``jax.eval_shape``, through
``vgg_params_from_numpy``: drawing it runs a threefry compile per leaf
shape, ~28 s on one CPU core), ``exit_flops``, two-stage training
(``train_vgg_ee``, 3 + 3 Adam steps, against the reference's steps in
``tools/make_torch_train_golden.py::vgg_run`` on numpy params and
batches: the run ``tests/data/torch_train_golden.npz`` carries to the
GPU machine) and ``profile_exits`` (accuracies on the reference's own
eval draws, rebuilt from its key schedule and injected; GFLOPs; the
roofline column at the reference's TPU figures), plus
``mec.profiles.exit_profile_roofline``."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.mec.profiles import (TPU_V5E_HBM_BW, TPU_V5E_PEAK_FLOPS,
                                exit_profile_tpu_v5e)
from repro.vgg import VGG16EE as JaxVGG
from repro.vgg import profile_exits as jax_profile_exits
from repro_torch.core.bridge import vgg_params_from_numpy, vgg_params_numpy
from repro_torch.mec import exit_profile_roofline
from repro_torch.nn.pytree import flatten_dict
from repro_torch.vgg import N_EXITS, VGG16EE, profile_exits, train_vgg_ee

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
import make_torch_train_golden as golden_tool  # noqa: E402

sys.path.pop(0)
sys.path.pop(0)
torch.set_num_threads(1)

WIDTH = golden_tool.VGG_WIDTH
LOGIT_TOL = 1e-5
LOSS_RTOL = 1e-5


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref_params():
    return vgg_params_numpy(WIDTH, 7)


def scaled_err(got, want) -> float:
    """max |got - want| / (1 + max |want|)."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / (1.0 + np.abs(want).max()))


@pytest.mark.parametrize("up_to_exit", [1, 4, 17])
def test_exit_logits_match_reference(ref_params, up_to_exit):
    images = np.random.default_rng(0).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    want = JaxVGG.apply(jax.tree_util.tree_map(jnp.asarray, ref_params),
                        jnp.asarray(images), up_to_exit=up_to_exit)
    got = VGG16EE.apply(vgg_params_from_numpy(ref_params, "cpu",
                                              width_mult=WIDTH),
                        torch.tensor(images), up_to_exit=up_to_exit)
    assert sorted(got) == sorted(want)
    assert max(got) == min(up_to_exit, N_EXITS)
    for e in want:
        assert scaled_err(got[e].numpy(), want[e]) <= LOGIT_TOL, e


@pytest.mark.parametrize("width", [0.125, 0.25, 1.0])
def test_exit_flops_and_shapes_equal_reference(width):
    assert VGG16EE.exit_flops(width) == JaxVGG.exit_flops(width)
    shapes = jax.eval_shape(lambda k: JaxVGG.init(k, width_mult=width),
                            jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten_dict(shapes).items()}
    assert flatten_dict(VGG16EE.param_shapes(width_mult=width)) == want
    got = VGG16EE.init(torch.Generator().manual_seed(0), width_mult=width,
                       device="cpu") if width < 1.0 else None
    if got is not None:
        assert {k: tuple(v.shape) for k, v in flatten_dict(got).items()} \
            == want


def test_vgg_params_from_numpy_takes_the_reference_init_tree():
    """The reference's ``VGG16EE.init`` tree (names, shapes, float32), as
    numpy leaves, converts; its values here are zeros."""
    shapes = jax.eval_shape(lambda k: JaxVGG.init(k, width_mult=WIDTH),
                            jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                  shapes)
    params = vgg_params_from_numpy(tree, "cpu", width_mult=WIDTH)
    assert flatten_dict(params).keys() == flatten_dict(tree).keys()


def test_vgg_params_from_numpy_checks_the_tree(ref_params):
    bad = jax.tree_util.tree_map(lambda x: x, ref_params)
    bad["head"]["w"] = bad["head"]["w"][:, :5]
    with pytest.raises(ValueError, match="head/w"):
        vgg_params_from_numpy(bad, "cpu", width_mult=WIDTH)
    with pytest.raises(ValueError):
        vgg_params_from_numpy(ref_params, "cpu", width_mult=1.0)


@pytest.fixture(scope="module")
def two_stage_run():
    """The reference's 3 + 3 steps (``golden_tool.vgg_run``) and the
    port's ``train_vgg_ee`` on the same numpy params and batches, and the
    port's stage 1 alone."""
    params = vgg_params_numpy(WIDTH, golden_tool.VGG_SEED)
    images, labels = golden_tool.vgg_numpy_batches()
    ref = golden_tool.vgg_run(params, images, labels)
    batches = [(torch.tensor(x), torch.tensor(y).long())
               for x, y in zip(images, labels)]
    kw = dict(width_mult=WIDTH, steps_main=golden_tool.VGG_STEPS,
              lr=golden_tool.VGG_LR, device="cpu")
    got, hist = train_vgg_ee(
        steps_exits=golden_tool.VGG_STEPS, batches=batches,
        params=vgg_params_from_numpy(params, "cpu", width_mult=WIDTH), **kw)
    stage1, _ = train_vgg_ee(
        steps_exits=0, batches=batches,
        params=vgg_params_from_numpy(params, "cpu", width_mult=WIDTH), **kw)
    return ref, got, hist, stage1


def test_two_stage_training_matches_reference(two_stage_run):
    """Both stages' losses 1e-5 relative; every param after the six steps
    by the Adam rule (``chip_smoke.adam_rule``: near-ties counted)."""
    ref, params, hist, _ = two_stage_run
    np.testing.assert_allclose(hist["main_loss"], ref["main_loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(hist["exit_loss"], ref["exit_loss"],
                               rtol=LOSS_RTOL)
    want = flatten_dict(ref["params"])
    grads = [flatten_dict(g) for g in ref["grads"]]
    ties = n = 0
    for path, p in flatten_dict(params).items():
        g = [gs[path] for gs in grads if path in gs]
        assert len(g) == golden_tool.VGG_STEPS, path
        bad, tie = chip_smoke.adam_rule(p.numpy(), want[path], g,
                                        [float(np.abs(a).max()) for a in g])
        assert bad == 0, f"{path}: {bad} entries off the reference"
        ties += tie
        n += p.numel()
    print(f"near-ties {ties} of {n}")
    assert ties <= 1e-3 * n


def test_stage_two_trains_only_the_exits(two_stage_run):
    """Stage 2 leaves the trunk and head where stage 1 put them (the
    reference's stop_gradient) and moves every exit classifier."""
    _, params, _, stage1 = two_stage_run
    s1 = flatten_dict(stage1)
    for path, p in flatten_dict(params).items():
        if path.startswith("exits/"):
            assert float((p - s1[path]).abs().max()) > 0, path
        else:
            assert torch.equal(p, s1[path]), path


def test_vgg_golden_is_current(two_stage_run):
    """The stored VGG run equals ``vgg_run``'s (floats to 1e-6)."""
    gold = golden_tool.load()
    fresh = golden_tool.build_vgg(two_stage_run[0])
    assert set(k for k in gold if k.startswith("vgg/")) == set(fresh)
    for k, v in fresh.items():
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(gold[k], v, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(gold[k], v, err_msg=k)


def test_port_replays_the_vgg_golden():
    """What chip_smoke.py's phase 36 does on the card, here on the CPU."""
    out = chip_smoke.vgg_train_replay(torch.device("cpu"),
                                      golden_tool.load())
    assert out["loss_err"] <= LOSS_RTOL


def test_profile_exits_matches_reference(ref_params):
    """Accuracies on the reference's eval batches exactly, GFLOPs exactly,
    the roofline column at the reference's TPU figures to 1e-12; the
    measured ``ms`` column is there and positive."""
    batches = golden_tool.reference_eval_batches(eval_batches=1, batch=64)
    jp = jax.tree_util.tree_map(jnp.asarray, ref_params)
    want = jax_profile_exits(jp, width_mult=WIDTH, eval_batches=1, batch=64,
                             measure_ms=False)
    got = profile_exits(
        vgg_params_from_numpy(ref_params, "cpu", width_mult=WIDTH),
        width_mult=WIDTH, measure_ms=True,
        batches=[(torch.tensor(x), torch.tensor(y).long())
                 for x, y in batches],
        peak_flops=TPU_V5E_PEAK_FLOPS, hbm_bw=TPU_V5E_HBM_BW)
    assert [r["exit"] for r in got] == [r["exit"] for r in want]
    for g, w in zip(got, want):
        assert g["accuracy"] == w["accuracy"], g["exit"]
        assert g["gflops"] == w["gflops"]
        np.testing.assert_allclose(g["roofline_ms"], w["tpu_v5e_ms"],
                                   rtol=1e-12)
        assert g["ms"] > 0
    h100 = profile_exits(
        vgg_params_from_numpy(ref_params, "cpu", width_mult=WIDTH),
        width_mult=WIDTH, measure_ms=False, batches=[
            (torch.tensor(x), torch.tensor(y).long()) for x, y in batches])
    assert all(r["roofline_ms"] < g["roofline_ms"]
               for r, g in zip(h100, got))


def test_exit_profile_roofline_at_tpu_figures_equals_reference():
    want_t, want_a = exit_profile_tpu_v5e()
    got_t, got_a = exit_profile_roofline(peak_flops=TPU_V5E_PEAK_FLOPS,
                                         hbm_bw=TPU_V5E_HBM_BW)
    np.testing.assert_allclose(got_t, want_t, rtol=1e-12)
    np.testing.assert_array_equal(got_a, want_a)
    want_t, _ = exit_profile_tpu_v5e(0.3)
    got_t, _ = exit_profile_roofline(0.3, peak_flops=TPU_V5E_PEAK_FLOPS,
                                     hbm_bw=TPU_V5E_HBM_BW)
    np.testing.assert_allclose(got_t, want_t, rtol=1e-12)
    h100_t, _ = exit_profile_roofline()
    assert h100_t.shape == (1, 5) and (h100_t < want_t).all()


def test_train_vgg_ee_own_draws_learn():
    """On its own generator the port's two stages run and the main loss
    falls (a reduced width, a few steps)."""
    params, hist = train_vgg_ee(0, width_mult=0.125, steps_main=12,
                                steps_exits=2, batch=16, device="cpu")
    assert len(hist["main_loss"]) == 12 and len(hist["exit_loss"]) == 2
    assert all(np.isfinite(hist["main_loss"] + hist["exit_loss"]))
    assert np.mean(hist["main_loss"][-3:]) < np.mean(hist["main_loss"][:3])
    assert set(params) == {"stages", "exits", "head"}
