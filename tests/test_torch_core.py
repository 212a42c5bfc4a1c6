"""repro_torch graph, quantizer, GCN actor, decision pass and weight
bridge against the JAX reference, on the same inputs."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gcn as jax_gcn
from repro.core.graph import build_graph as jax_build_graph
from repro.core.policy import agent_def as jax_agent_def
from repro.core.quantize import one_hot_candidates as jax_candidates
from repro.mec import MECEnv as JaxEnv
from repro.mec import make_scenario as jax_scenario
from repro_torch.core import (MECGraph, agent_def, agent_state_from_params,
                              build_graph, one_hot_candidates,
                              params_from_numpy)
from repro_torch.core import gcn
from repro_torch.mec import MECEnv, MECState, SlotTasks, make_scenario

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
