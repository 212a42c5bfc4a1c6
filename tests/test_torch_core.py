"""repro_torch graph, quantizers, GCN and MLP actors, decision pass, host
replay buffer, agent shim and weight bridge against the JAX reference,
on the same inputs."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gcn as jax_gcn
from repro.core.graph import build_graph as jax_build_graph
from repro.core.graph import pad_graph as jax_pad_graph
from repro.core.policy import MLPActor as JaxMLPActor
from repro.core.policy import agent_def as jax_agent_def
from repro.core.quantize import \
    binary_order_preserving as jax_binary_candidates
from repro.core.quantize import one_hot_candidates as jax_candidates
from repro.core.replay import ReplayBuffer as JaxReplayBuffer
from repro.mec import MECEnv as JaxEnv
from repro.mec import make_scenario as jax_scenario
from repro.nn import MLP as JaxMLP
from repro_torch.core import (MECGraph, MLPActor, ReplayBuffer,
                              agent_def, agent_state_from_params,
                              binary_order_preserving, build_graph,
                              one_hot_candidates, pad_graph,
                              params_from_numpy)
from repro_torch.core import gcn
from repro_torch.mec import MECEnv, MECState, SlotTasks, make_scenario
from repro_torch.nn import MLP

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from make_torch_port_golden import load as load_golden  # noqa: E402

sys.path.pop(0)
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)   # the actor kernels' f32 tolerance


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_obs(name="dyn_topology", seed=0, m=14):
    jenv = JaxEnv(jax_scenario(name, n_devices=m))
    tasks = jenv.sample_slot(jax.random.PRNGKey(seed))
    state = jenv.reset()._replace(slot=jnp.asarray(2, jnp.int32))
    return jenv, state, tasks, jenv.observe(state, tasks)


def port_graph(obs, n, l):
    return build_graph({k: torch.tensor(np.asarray(v)) for k, v in obs.items()},
                       n, l)


def test_build_graph_matches_reference():
    jenv, _, _, obs = jax_obs()
    want = jax_build_graph(obs, jenv.N, jenv.L)
    got = port_graph(obs, jenv.N, jenv.L)
    for f in MECGraph._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-7,
                                   err_msg=f)


@pytest.mark.parametrize("early_exit", [True, False])
def test_one_hot_candidates_match_reference(early_exit):
    """Exact integer equality, with masked options (-1e9 scores) from the
    exit mask and from dropped links; batched rows equal per-row calls."""
    rng = np.random.default_rng(int(early_exit))
    m, n, l = 6, 2, 5
    scores = rng.uniform(size=(5, m, n * l)).astype(np.float32)
    scores[rng.uniform(size=scores.shape) < 0.2] = -1e9     # dropped links
    if not early_exit:
        scores[..., [i for i in range(n * l) if i % l != l - 1]] = -1e9
    scores[..., 0, :] = np.where(scores[..., 0, :] > -1, 0.5, -1e9)  # ties
    s = m * (n * l - 1) + 1
    got = one_hot_candidates(torch.tensor(scores), s)
    assert got.dtype == torch.int32 and got.shape == (5, s, m)
    for b in range(5):
        want = np.asarray(jax_candidates(jnp.asarray(scores[b]), s))
        np.testing.assert_array_equal(got[b].numpy(), want)


@pytest.mark.parametrize("hidden,edge", [((16, 8), 8), ((128, 64), 64)])
def test_gcn_apply_matches_reference_on_carried_params(hidden, edge):
    jenv, _, _, obs = jax_obs(seed=3)
    params = jax_gcn.init(jax.random.PRNGKey(1), 7, 4, hidden=hidden,
                          edge_hidden=edge)
    g = jax_build_graph(obs, jenv.N, jenv.L)
    g = jax.tree_util.tree_map(lambda x: jnp.stack([x, x * 0.5]), g)  # B=2
    want_x, want_l = jax.jit(jax_gcn.apply)(params, g)
    p = params_from_numpy(np_tree(params), "cpu", hidden=hidden,
                          edge_hidden=edge)
    got_x, got_l = gcn.apply(p, MECGraph(*(torch.tensor(np.asarray(x))
                                           for x in g)))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)


@pytest.mark.parametrize("name", ["fig5_baseline", "dyn_topology"])
def test_decide_with_injected_candidates_matches_reference(name):
    """With JAX's exploration draws injected, the port picks JAX's
    decision and critic value (trained params, so scores are not flat)."""
    golden = load_golden()
    jenv = JaxEnv(jax_scenario(name))
    jdef = jax_agent_def("grle", jenv)
    mask = golden["exit_mask"]
    jparams = jax.tree_util.tree_map(jnp.asarray, golden["params"])
    env = MECEnv(make_scenario(name), device="cpu")
    pdef = agent_def("grle", env, device="cpu")
    st = agent_state_from_params(pdef, golden["params"], mask)
    decide = jax.jit(jdef.decide_with)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        k_task, k_dec = jax.random.split(key)
        tasks = jenv.sample_slot(k_task)
        state = jenv.reset()._replace(slot=jnp.asarray(seed, jnp.int32))
        dec, q, g = decide(jparams, jnp.asarray(mask), state, tasks, k_dec)
        # the reference's own exploration draw, as decide_with makes it
        allowed = (jnp.asarray(mask)[None, :] > 0.5) & (g.mask > 0.5)
        gumbel = jax.random.gumbel(k_dec, (jdef.n_random, *allowed.shape))
        rand = jnp.argmax(jnp.where(allowed[None], gumbel, -jnp.inf), -1)
        p_dec, p_q, _ = pdef.decide(
            st, MECState(*(torch.tensor(np.asarray(x)) for x in state)),
            SlotTasks(*(torch.tensor(np.asarray(x)) for x in tasks)),
            rand_cands=torch.tensor(np.asarray(rand)))
        assert p_dec.dtype == torch.int32
        np.testing.assert_array_equal(p_dec.numpy(), np.asarray(dec))
        np.testing.assert_allclose(float(p_q), float(q), rtol=1e-5)


def test_decide_needs_generator_or_candidates():
    env = MECEnv(make_scenario("fig5_baseline", n_devices=4), device="cpu")
    adef = agent_def("grle", env, device="cpu", hidden=(16, 8))
    gen = torch.Generator().manual_seed(0)
    st = adef.init(gen)
    tasks = env.sample_slot(gen, (3,))
    dec, q, _ = adef.decide(st, env.reset((3,)), tasks, generator=gen)
    assert dec.shape == (3, 4) and q.shape == (3,)
    with pytest.raises(ValueError, match="generator or rand_cands"):
        adef.decide(st, env.reset((3,)), tasks)
    with pytest.raises(ValueError, match="rand_cands shape"):
        adef.decide(st, env.reset((3,)), tasks,
                    rand_cands=torch.zeros((16, 4), dtype=torch.int32))


def test_grl_random_candidates_respect_exit_mask():
    env = MECEnv(make_scenario("dyn_topology", n_devices=5), device="cpu")
    adef = agent_def("grl", env, device="cpu", hidden=(16, 8))
    gen = torch.Generator().manual_seed(1)
    st = adef.init(gen)
    tasks = env.sample_slot(gen, (8,))
    g = build_graph(env.observe(env.reset((8,)), tasks), env.N, env.L)
    rand = adef._random_candidates(st.exit_mask, g, gen)      # [8, K, M]
    assert (rand % env.L == env.L - 1).all()
    assert torch.gather(g.mask, -1, rand.transpose(-1, -2).long()).min() == 1


# -------------------------------------------------------------- the bridge
def _golden_params():
    return {k: dict(v) for k, v in load_golden()["params"].items()}


def test_bridge_round_trip():
    params = _golden_params()
    adef = agent_def("grle", MECEnv(make_scenario("fig5_baseline"),
                                    device="cpu"), device="cpu")
    st = agent_state_from_params(adef, params, load_golden()["exit_mask"])
    for layer, leaves in params.items():
        for name, x in leaves.items():
            np.testing.assert_array_equal(st.params[layer][name].numpy(), x)


@pytest.mark.parametrize("break_it,error", [
    (lambda p: p.pop("edge_out"), "missing"),
    (lambda p: p["dev1"].pop("b"), "leaves"),
    (lambda p: p.update(extra={"w": np.zeros((1, 1), np.float32)}),
     "unexpected"),
    (lambda p: p["dev2"].update(w=p["dev2"]["w"][:, :8]), "shape"),
    (lambda p: p["opt1"].update(w=p["opt1"]["w"].astype(np.float64)),
     "dtype"),
])
def test_bridge_rejects_mismatch(break_it, error):
    params = _golden_params()
    break_it(params)
    with pytest.raises((ValueError, TypeError), match=error):
        params_from_numpy(params, "cpu")


# ------------------------------------------------- DROO's MLP actor
def test_mlp_layer_matches_reference():
    rng = np.random.default_rng(0)
    params = JaxMLP.init(jax.random.PRNGKey(2), 9, 17, 5)
    x = rng.normal(size=(3, 4, 9)).astype(np.float32)
    want = JaxMLP.apply(params, jnp.asarray(x))
    got = MLP.apply(jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a)), params), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["fig8_csi", "dyn_topology"])
def test_mlp_actor_apply_matches_reference(name):
    """DROO's actor at M=14 (trunk 56 -> 256 -> 256, head 256 -> 140) on
    the reference's graphs and its init's params carried over: x̂ and the
    masked logits within 1e-5, a fleet batch of two graphs."""
    jenv, _, _, obs = jax_obs(name, seed=4)
    params = JaxMLPActor.init(jax.random.PRNGKey(5), jenv.M, jenv.N,
                              jenv.N * jenv.L)
    g = jax_build_graph(obs, jenv.N, jenv.L)
    g = jax.tree_util.tree_map(lambda x: jnp.stack([x, x * 0.5]), g)
    want_x, want_l = jax.jit(JaxMLPActor.apply, static_argnums=2)(
        params, g, jenv.L)
    p = params_from_numpy(np_tree(params), "cpu",
                          dims=(jenv.M, jenv.N, jenv.L))
    assert tuple(p["trunk"]["fc1"]["w"].shape) == (56, 256)
    assert tuple(p["head"]["w"].shape) == (256, 140)
    pg = MECGraph(*(torch.tensor(np.asarray(x)) for x in g))
    np.testing.assert_allclose(
        MLPActor.features(pg, jenv.L).numpy(),
        np.asarray(JaxMLPActor.features(g, jenv.L)), rtol=0, atol=0)
    got_x, got_l = MLPActor.apply(p, pg, jenv.L)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)


@pytest.mark.parametrize("method", ["droo", "drooe"])
@pytest.mark.parametrize("name", ["fig5_baseline", "dyn_topology"])
def test_mlp_decide_matches_reference(method, name):
    """DROO/DROOE with the reference's init params and exploration draws
    injected: the reference's decision and critic value."""
    jenv = JaxEnv(jax_scenario(name))
    jdef = jax_agent_def(method, jenv)
    jst = jdef.init(jax.random.PRNGKey(11))
    env = MECEnv(make_scenario(name), device="cpu")
    pdef = agent_def(method, env, device="cpu")
    st = agent_state_from_params(pdef, np_tree(jst.params),
                                 np.asarray(jst.exit_mask))
    decide = jax.jit(jdef.decide_with)
    for seed in range(3):
        k_task, k_dec = jax.random.split(jax.random.PRNGKey(seed))
        tasks = jenv.sample_slot(k_task)
        state = jenv.reset()._replace(slot=jnp.asarray(seed, jnp.int32))
        dec, q, g = decide(jst.params, jst.exit_mask, state, tasks, k_dec)
        allowed = (jst.exit_mask[None, :] > 0.5) & (g.mask > 0.5)
        gumbel = jax.random.gumbel(k_dec, (jdef.n_random, *allowed.shape))
        rand = jnp.argmax(jnp.where(allowed[None], gumbel, -jnp.inf), -1)
        p_dec, p_q, _ = pdef.decide(
            st, MECState(*(torch.tensor(np.asarray(x)) for x in state)),
            SlotTasks(*(torch.tensor(np.asarray(x)) for x in tasks)),
            rand_cands=torch.tensor(np.asarray(rand)))
        np.testing.assert_array_equal(p_dec.numpy(), np.asarray(dec))
        np.testing.assert_allclose(float(p_q), float(q), rtol=1e-5)


def test_mlp_bridge_checks_shapes():
    params = np_tree(JaxMLPActor.init(jax.random.PRNGKey(0), 6, 2, 10))
    p = params_from_numpy(params, "cpu", dims=(6, 2, 5))
    assert p["trunk"]["fc2"]["w"].shape == (256, 256)
    with pytest.raises(ValueError, match="dims"):
        params_from_numpy(params, "cpu")
    with pytest.raises(ValueError, match="head/w: shape"):
        params_from_numpy(params, "cpu", dims=(6, 2, 4))
    params["trunk"].pop("fc2")
    with pytest.raises(ValueError, match="trunk: leaves"):
        params_from_numpy(params, "cpu", dims=(6, 2, 5))


@pytest.mark.parametrize("shape,n_cand", [((7,), 8), ((7,), 3), ((4, 5), 6),
                                          ((3, 1), 1)])
def test_binary_order_preserving_matches_reference(shape, n_cand):
    """Exact, with ties in |x̂−0.5| and batch rows equal to per-row
    calls."""
    rng = np.random.default_rng(sum(shape) + n_cand)
    x = rng.uniform(size=shape).astype(np.float32)
    x[..., 0] = 0.5
    if shape[-1] > 2:
        x[..., 1] = 0.75
        x[..., 2] = 0.25                       # a tie with x[..., 1]
    got = binary_order_preserving(torch.tensor(x), n_cand)
    assert got.dtype == torch.int32
    rows = x.reshape(-1, shape[-1])
    want = np.stack([np.asarray(jax_binary_candidates(jnp.asarray(r), n_cand))
                     for r in rows])
    np.testing.assert_array_equal(
        got.numpy().reshape(want.shape), want)


@pytest.mark.parametrize("batch,pad_to", [((), 14), ((3,), 20), ((2, 2), 9)])
def test_pad_graph_matches_reference(batch, pad_to):
    jenv, _, _, obs = jax_obs(m=9)
    g = jax_build_graph(obs, jenv.N, jenv.L)
    g = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, batch + x.shape) + 0.0, g)
    want = jax_pad_graph(g, pad_to)
    got = pad_graph(MECGraph(*(torch.tensor(np.asarray(x)) for x in g)),
                    pad_to)
    for f in MECGraph._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    with pytest.raises(ValueError, match="cannot pad"):
        pad_graph(got, 3)


def test_replay_buffer_matches_reference():
    """The host ring with the same seed: the same sampled entries, in
    order, before and after it wraps; the batch shrinks to the stored
    count."""
    jenv, _, _, obs = jax_obs(m=5)
    g0 = jax_build_graph(obs, jenv.N, jenv.L)
    jbuf, buf = JaxReplayBuffer(6, seed=3), ReplayBuffer(6, seed=3)
    rng = np.random.default_rng(0)
    for i in range(9):
        g = jax.tree_util.tree_map(lambda x: x + float(i), g0)
        dec = rng.integers(0, 10, size=5).astype(np.int32)
        jbuf.add(g, dec)
        buf.add(MECGraph(*(torch.tensor(np.asarray(x)) for x in g)),
                torch.tensor(dec))
        assert len(buf) == len(jbuf)
        for n in (4, 8):
            (jg, jd), (pg, pd) = jbuf.sample(n), buf.sample(n)
            np.testing.assert_array_equal(pd, jd)
            for f in MECGraph._fields:
                np.testing.assert_array_equal(getattr(pg, f),
                                              np.asarray(getattr(jg, f)))


@pytest.mark.parametrize("method", ["grle", "droo"])
def test_agent_def_n_exits_matches_reference(method):
    """``AgentDef.n_exits`` is the env's L in both packages (5 at the
    paper's defaults), and the deprecated agent shim reads it."""
    from repro.core.agent import make_agent as jax_make_agent
    from repro.mec import MECConfig as JaxMECConfig
    from repro_torch.core.agent import make_agent
    from repro_torch.mec import MECConfig

    want = jax_agent_def(method, JaxEnv(JaxMECConfig())).n_exits
    adef = agent_def(method, MECEnv(MECConfig(), device="cpu"), device="cpu")
    assert adef.n_exits == want == 5
    assert make_agent(method, adef.env, 0).n_exits == jax_make_agent(
        method, JaxEnv(JaxMECConfig()), jax.random.PRNGKey(0)).n_exits == 5
