"""The port's ``nn`` additions (``Conv2D``, ``LayerNorm``, ``Dropout``,
the pytree helpers, ``he_normal``/``truncated_normal_init``), the
optimizers (``adamw``, ``sgd``, clipping) and schedules, and the
synthetic data (``TokenStream``, ``SyntheticImages``) against the JAX
package on the same inputs. Random draws are the reference's, injected
through the port's seams (its threefry streams cannot be reproduced)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro import optim as joptim
from repro.data import SyntheticImages as JaxImages
from repro.data import TokenStream as JaxTokens
from repro.optim.optimizers import apply_updates as jax_apply_updates
from repro_torch import nn as tnn
from repro_torch import optim as toptim
from repro_torch.data import (SyntheticImages, TokenStream,
                              synthetic_batch_iterator)
from repro_torch.nn.pytree import flatten_dict

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


def t(x):
    return torch.tensor(np.asarray(x))


def assert_close_scaled(got, want, tol=1e-6):
    """max |got - want| <= tol * (1 + max |want|) (float32 sums in another
    order)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), 1.0 + np.abs(want).max()
    assert err <= tol * scale, f"max error {err}, allowed {tol * scale}"


def np_flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree).items()}


def t_flat(tree):
    return {k: v.detach().numpy() for k, v in flatten_dict(tree).items()}


def assert_trees_close(got, want, **tol):
    got, want = t_flat(got), np_flat(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# ------------------------------------------------------------------ nn
@pytest.mark.parametrize("hw,k,stride,padding", [
    (8, 3, 1, "SAME"), (9, 3, 2, "SAME"), (8, 3, 2, "SAME"),
    (8, 2, 2, "SAME"), (9, 3, 1, "VALID"), (9, 3, 2, "VALID")])
def test_conv2d_matches_reference(hw, k, stride, padding):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    p = {"w": rng.standard_normal((k, k, 3, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    want = jnn.Conv2D.apply(jax.tree_util.tree_map(jnp.asarray, p),
                            jnp.asarray(x), stride=(stride, stride),
                            padding=padding)
    got = tnn.Conv2D.apply({n: t(v) for n, v in p.items()}, t(x),
                           stride=(stride, stride), padding=padding)
    assert tuple(got.shape) == want.shape
    assert_close_scaled(got.numpy(), want)


def test_conv2d_refuses_other_padding():
    p = {"w": torch.zeros(3, 3, 2, 4)}
    with pytest.raises(ValueError, match="padding"):
        tnn.Conv2D.apply(p, torch.zeros(1, 4, 4, 2), padding="FULL")


def test_conv2d_keeps_the_tf32_setting_it_found():
    before = torch.backends.cudnn.allow_tf32
    tnn.Conv2D.apply({"w": torch.ones(3, 3, 1, 1)}, torch.ones(1, 4, 4, 1))
    with tnn.f32_convolutions():
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 == before


@pytest.mark.parametrize("use_bias", [True, False])
def test_layernorm_matches_reference(use_bias):
    rng = np.random.default_rng(1)
    x = (3.0 + 2.0 * rng.standard_normal((4, 7, 32))).astype(np.float32)
    p = {"scale": rng.standard_normal(32).astype(np.float32)}
    if use_bias:
        p["bias"] = rng.standard_normal(32).astype(np.float32)
    want = jnn.LayerNorm.apply(jax.tree_util.tree_map(jnp.asarray, p),
                               jnp.asarray(x))
    got = tnn.LayerNorm.apply({n: t(v) for n, v in p.items()}, t(x))
    assert_close_scaled(got.numpy(), want)
    init = tnn.LayerNorm.init(None, 32, device="cpu", use_bias=use_bias)
    assert set(init) == set(jnn.LayerNorm.init(jax.random.PRNGKey(0), 32,
                                               use_bias=use_bias))


def test_dropout_with_an_injected_mask_is_exact():
    """The reference's bernoulli mask, injected: the same output bit for
    bit; deterministic or rate 0 is the identity; a drawn mask keeps
    about 1 - rate."""
    key = jax.random.PRNGKey(3)
    x = np.random.default_rng(2).standard_normal((64, 33)).astype(np.float32)
    want = jnn.Dropout.apply(key, jnp.asarray(x), 0.3, deterministic=False)
    mask = np.asarray(jax.random.bernoulli(key, 0.7, x.shape))
    got = tnn.Dropout.apply(None, t(x), 0.3, deterministic=False,
                            mask=t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tnn.Dropout.apply(None, t(x), 0.3, deterministic=True) is not None
    np.testing.assert_array_equal(
        tnn.Dropout.apply(None, t(x), 0.3, deterministic=True).numpy(), x)
    np.testing.assert_array_equal(
        tnn.Dropout.apply(None, t(x), 0.0, deterministic=False).numpy(), x)
    gen = torch.Generator().manual_seed(0)
    drawn = tnn.Dropout.apply(gen, torch.ones(200, 200), 0.3,
                              deterministic=False)
    assert abs(float((drawn > 0).float().mean()) - 0.7) < 0.01


def test_initializers_match_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    w = tnn.he_normal(gen, (3, 3, 64, 128), device="cpu")
    assert abs(float(w.std()) - np.sqrt(2.0 / (9 * 64))) < 0.01 * np.sqrt(
        2.0 / (9 * 64)) * 10
    jw = np.asarray(jnn.he_normal(jax.random.PRNGKey(0), (3, 3, 64, 128)))
    assert abs(float(w.std()) / float(jw.std()) - 1.0) < 0.02
    tr = tnn.truncated_normal_init(gen, (256, 256), device="cpu", scale=0.5)
    jt = np.asarray(jnn.truncated_normal_init(jax.random.PRNGKey(0),
                                              (256, 256), scale=0.5))
    bound = 2.0 * 0.5 / 0.87962566
    assert float(tr.abs().max()) <= bound + 1e-6
    assert float(np.abs(jt).max()) <= bound + 1e-6
    assert abs(float(tr.std()) / float(jt.std()) - 1.0) < 0.02
    assert tr.dtype == torch.float32 and tuple(tr.shape) == (256, 256)


def pytree_case():
    rng = np.random.default_rng(4)
    return {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                  "b": rng.standard_normal(4).astype(np.float32)},
            "c": rng.standard_normal((2, 2, 5)).astype(np.float32),
            "n": np.arange(6, dtype=np.int32)}


def test_pytree_helpers_match_reference():
    tree = pytree_case()
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = {"a": {k: t(v) for k, v in tree["a"].items()}, "c": t(tree["c"]),
          "n": t(tree["n"])}
    assert tnn.tree_size(tt) == jnn.tree_size(jt)
    assert tnn.tree_bytes(tt) == jnn.tree_bytes(jt)
    float_tree = {"a": tt["a"], "c": tt["c"]}
    np.testing.assert_allclose(
        float(tnn.tree_global_norm(float_tree)),
        float(jnn.tree_global_norm({"a": jt["a"], "c": jt["c"]})), **TOL)
    cast = tnn.tree_cast(tt, torch.bfloat16)
    assert cast["a"]["w"].dtype == torch.bfloat16
    assert cast["n"].dtype == torch.int32
    paths = []
    got = tnn.tree_map_with_path(lambda p, x: paths.append(p) or x * 2,
                                 {"x": [t(np.ones(2)), (t(np.ones(1)),)],
                                  "y": tt["c"]})
    want_paths = []
    jnn.tree_map_with_path(lambda p, x: want_paths.append(p) or x,
                           {"x": [jnp.ones(2), (jnp.ones(1),)],
                            "y": jt["c"]})
    assert paths == want_paths == ["x/0", "x/1/0", "y"]
    assert isinstance(got["x"], list) and isinstance(got["x"][1], tuple)
    np.testing.assert_allclose(got["y"].numpy(), 2 * tree["c"], **TOL)


# --------------------------------------------------------------- optim
def opt_case(seed=5):
    rng = np.random.default_rng(seed)
    params = {"l1": {"w": rng.standard_normal((6, 4)).astype(np.float32),
                     "b": rng.standard_normal(4).astype(np.float32)},
              "l2": {"w": rng.standard_normal((4, 3)).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        for _ in range(5)]
    return params, grads


OPTIMIZERS = {
    "adamw": (lambda m: m.adamw(1e-2), None),
    "adamw_sched": (lambda m: m.adamw(m.linear_warmup_cosine(1e-2, 2, 5),
                                      weight_decay=0.3), None),
    "adam_cosine": (lambda m: m.adam(m.cosine_decay(1e-2, 3, 0.2)), None),
    "sgd": (lambda m: m.sgd(0.1), None),
    "sgd_momentum": (lambda m: m.sgd(m.constant(0.1), momentum=0.9), None),
    "chain_clip": (lambda m: m.chain_clip(m.adamw(1e-2), 1.0), None),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_five_steps_match_reference(name):
    make, _ = OPTIMIZERS[name]
    params, grads = opt_case()
    jopt, topt = make(joptim), make(toptim)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = jax.tree_util.tree_map(t, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jax_apply_updates(jp, ju)
        tu, ts = topt.update(jax.tree_util.tree_map(t, g), ts, tp)
        tp = toptim.apply_updates(tp, tu)
        assert_trees_close(tp, jp, **TOL)
    assert int(ts["step"]) == int(js["step"]) == 5
    for k in set(js) - {"step"}:
        assert_trees_close(ts[k], js[k], **TOL)


def test_adamw_on_bfloat16_params_matches_reference():
    """bf16 params and moments (a bf16 model's): the moments' constants
    rounded to bf16 (the reference's weak typing), the update in float32
    and the sum cast back (its type promotion); five steps equal to the
    reference's bit for bit."""
    params, grads = opt_case(7)
    jb = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                params)
    tb = jax.tree_util.tree_map(lambda x: t(x).bfloat16(), params)
    jopt = joptim.adamw(joptim.linear_warmup_cosine(1e-2, 2, 5))
    topt = toptim.adamw(toptim.linear_warmup_cosine(1e-2, 2, 5))
    js, ts = jopt.init(jb), topt.init(tb)
    for g in grads:
        ju, js = jopt.update(jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.bfloat16), g), js, jb)
        jb = jax_apply_updates(jb, ju)
        tu, ts = topt.update(jax.tree_util.tree_map(
            lambda x: t(x).bfloat16(), g), ts, tb)
        tb = toptim.apply_updates(tb, tu)
        for k, u in flatten_dict(tu).items():
            assert u.dtype == torch.float32, k
    for tree, ref in ((tb, jb), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
        want = {k: np.asarray(v).astype(np.float32)
                for k, v in flatten_dict(ref).items()}
        for k, v in flatten_dict(tree).items():
            assert v.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(v.float().numpy(), want[k],
                                          err_msg=k)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, grads = opt_case(6)
    g = grads[0]
    jc, jn = joptim.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g), max_norm)
    tc, tn = toptim.clip_by_global_norm(jax.tree_util.tree_map(t, g),
                                        max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    assert_trees_close(tc, jc, **TOL)


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("cosine_decay", (1e-3, 4, 0.1)),
    ("cosine_decay", (1e-3, 4)), ("linear_warmup_cosine", (1e-3, 2, 5)),
    ("linear_warmup_cosine", (1e-3, 0, 3))])
def test_schedules_match_reference(name, args):
    jf, tf = getattr(joptim, name)(*args), getattr(toptim, name)(*args)
    for step in range(7):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, **TOL)


# ----------------------------------------------------------------- data
def test_token_stream_successors_equal_reference():
    for vocab, branching, seed in ((512, 64, 0), (1000, 8, 3)):
        got = TokenStream(vocab, branching=branching, seed=seed,
                          device="cpu").successors
        want = JaxTokens(vocab, branching=branching, seed=seed).successors
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def jax_token_draws(vocab, branching, key, batch, seq):
    """The reference sampler's draws (``TokenStream.sample``'s key use),
    in one jitted program (one compile, not one per draw)."""
    def draws(key):
        k0, k1 = jax.random.split(key)
        return (jax.random.randint(k0, (batch,), 0, vocab),
                jax.random.randint(k1, (batch, seq), 0, branching))

    return tuple(map(np.asarray, jax.jit(draws)(key)))


def test_token_stream_samples_from_injected_draws_equal_reference():
    js, ts = JaxTokens(512, seed=1), TokenStream(512, seed=1, device="cpu")
    key = jax.random.PRNGKey(7)
    want_tok, want_lab = js.sample(key, 3, 20)
    first, picks = jax_token_draws(512, 64, key, 3, 20)
    tok, lab = ts.sample(None, 3, 20, first=first, picks=picks)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    np.testing.assert_array_equal(tok[:, 1:].numpy(), lab[:, :-1].numpy())


def test_token_stream_own_draws_follow_the_table():
    ts = TokenStream(97, branching=4, seed=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batches = synthetic_batch_iterator(ts.sample, gen, 5, 12)
    for _ in range(2):
        tok, lab = next(batches)
        assert tok.shape == lab.shape == (5, 12)
        succ = ts.successors[tok.numpy()]
        assert (succ == lab.numpy()[..., None]).any(-1).all()


def test_synthetic_images_prototypes_from_injected_base():
    ji = JaxImages(noise=0.8, seed=4)
    base = np.asarray(jax.random.normal(jax.random.PRNGKey(4),
                                        (10, 8, 8, 3)))
    ti = SyntheticImages(noise=0.8, seed=4, device="cpu", base=base)
    np.testing.assert_allclose(ti.prototypes.numpy(),
                               np.asarray(ji.prototypes), **TOL)


def test_synthetic_images_samples_from_injected_draws():
    ji = JaxImages(noise=1.2)
    base = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                        (10, 8, 8, 3)))
    ti = SyntheticImages(noise=1.2, device="cpu", base=base)
    key = jax.random.PRNGKey(11)
    want_x, want_y = ji.sample(key, 6)

    def draws(key):
        # the reference sampler's draws, in one jitted program
        k1, k2, k3 = jax.random.split(key, 3)
        return (jax.random.randint(k1, (6,), 0, 10),
                jax.random.uniform(k2, (6, 1, 1, 1)),
                jax.random.normal(k3, (6, 32, 32, 3)))

    labels, gain_u, noise_z = map(np.asarray, jax.jit(draws)(key))
    x, y = ti.sample(None, 6, labels=labels, gain_u=gain_u, noise_z=noise_z)
    np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))
    np.testing.assert_allclose(x.numpy(), np.asarray(want_x), **TOL)
    gen = torch.Generator().manual_seed(0)
    x2, y2 = ti.sample(gen, 4)
    assert x2.shape == (4, 32, 32, 3) and y2.shape == (4,)
    assert bool(torch.isfinite(x2).all()) and int(y2.max()) < 10
