"""repro_torch MEC simulator against the JAX reference: the same
``SlotTasks`` and ``MECState`` go through both envs; the port's own draws
are held to the reference's distributions by statistics."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.mec import MECEnv as JaxEnv
from repro.mec import MECState as JaxState
from repro.mec import make_scenario as jax_scenario
from repro_torch.mec import MECEnv, MECState, SlotTasks, make_scenario

torch.set_num_threads(1)

RTOL = 1e-6      # float32 arithmetic kept op for op; sums differ in order
SCENARIOS = ["fig5_baseline", "fig8_csi", "dyn_topology"]


@functools.lru_cache(maxsize=None)
def _envs(name, n_devices):
    return (JaxEnv(jax_scenario(name, n_devices=n_devices)),
            MECEnv(make_scenario(name, n_devices=n_devices), device="cpu"))


def envs(name, n_devices=14):
    """(JAX env, port env) of one scenario; cached so the JAX env's jitted
    methods compile once per module."""
    return _envs(name, n_devices)


def jax_inputs(jenv, seed, *, inactive=()):
    """A JAX task draw and a mid-episode state with queued work."""
    key = jax.random.PRNGKey(seed)
    tasks = jenv.sample_slot(key)
    if inactive:
        tasks = tasks._replace(
            active=tasks.active.at[jnp.asarray(inactive)].set(0.0))
    rng = np.random.default_rng(seed)
    state = JaxState(
        dev_free=jnp.asarray(rng.uniform(0.0, 0.2, jenv.M), jnp.float32),
        es_free=jnp.asarray(rng.uniform(0.0, 0.2, jenv.N), jnp.float32),
        slot=jnp.asarray(3, jnp.int32))
    return state, tasks


def to_port(tree, cls):
    return cls(*(torch.tensor(np.asarray(x)) for x in tree))


def candidates(env, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, env.N * env.L, (s, env.M)).astype(np.int32)


@pytest.mark.parametrize("name", SCENARIOS)
def test_observe_matches_reference(name):
    jenv, env = envs(name)
    state, tasks = jax_inputs(jenv, 1, inactive=(2, 5))
    want = jenv.observe(state, tasks)
    got = env.observe(to_port(state, MECState), to_port(tasks, SlotTasks))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", SCENARIOS)
def test_evaluate_matches_reference_143_candidates(name):
    """S = 127 quantizer + 16 random candidates at M=14, with inactive
    devices, and with dropped links under dyn_topology."""
    jenv, env = envs(name)
    state, tasks = jax_inputs(jenv, 2, inactive=(0, 7, 13))
    if name == "dyn_topology":
        assert float(np.asarray(tasks.connect).min()) == 0.0
    cands = candidates(env, 143, 3)
    want = jenv.evaluate(state, tasks, jnp.asarray(cands))
    got = env.evaluate(to_port(state, MECState), to_port(tasks, SlotTasks),
                       torch.tensor(cands))
    assert got.shape == (143,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-7)


@pytest.mark.parametrize("name", SCENARIOS)
def test_step_matches_reference(name):
    jenv, env = envs(name)
    state, tasks = jax_inputs(jenv, 4, inactive=(3,))
    dec = candidates(env, 1, 5)[0]
    j_state, j_res = jenv.step(state, tasks, jnp.asarray(dec))
    p_state, p_res = env.step(to_port(state, MECState),
                              to_port(tasks, SlotTasks), torch.tensor(dec))
    for f in JaxState._fields:
        np.testing.assert_allclose(getattr(p_state, f).numpy(),
                                   np.asarray(getattr(j_state, f)),
                                   rtol=RTOL, err_msg=f)
    assert p_state.slot.dtype == torch.int32
    for f in j_res._fields:
        np.testing.assert_allclose(getattr(p_res, f).numpy(),
                                   np.asarray(getattr(j_res, f)),
                                   rtol=RTOL, atol=1e-7, err_msg=f)


def test_batched_evaluate_equals_per_fleet():
    """One [B, S, M] call scores what B separate [S, M] calls score."""
    jenv, env = envs("fig8_csi", n_devices=6)
    per = [jax_inputs(jenv, 10 + b) for b in range(3)]
    states = MECState(*(torch.stack(xs) for xs in
                        zip(*(to_port(s, MECState) for s, _ in per))))
    tasks = SlotTasks(*(torch.stack(xs) for xs in
                        zip(*(to_port(t, SlotTasks) for _, t in per))))
    cands = torch.tensor(np.stack([candidates(env, 9, b) for b in range(3)]))
    batched = env.evaluate(states, tasks, cands)
    for b, (s, t) in enumerate(per):
        one = env.evaluate(to_port(s, MECState), to_port(t, SlotTasks),
                           cands[b])
        torch.testing.assert_close(batched[b], one, rtol=0, atol=0)


# ------------------------------------------------- mirrors of test_mec.py
def test_fcfs_no_server_overlap():
    """Tasks on one ES must not overlap: sum of cmp <= makespan."""
    _, env = envs("fig5_baseline", n_devices=8)
    gen = torch.Generator().manual_seed(0)
    tasks = env.sample_slot(gen)
    dec = torch.tensor(candidates(env, 1, 0)[0])
    _, res = env.step(env.reset(), tasks, dec)
    n_idx = dec.numpy() // env.L
    start = (res.t_com + res.t_wait).numpy()
    dur = res.t_cmp.numpy()
    for srv in range(env.N):
        sel = n_idx == srv
        if sel.sum() < 2:
            continue
        s, d = start[sel], dur[sel]
        order = np.argsort(s)
        assert np.all(s[order][1:] >= (s + d)[order][:-1] - 1e-5)


def test_evaluate_matches_step_when_estimates_exact():
    """With no jitter/CSI error the critic's Q equals realized Q."""
    _, env = envs("fig5_baseline", n_devices=6)
    tasks = env.sample_slot(torch.Generator().manual_seed(1))
    dec = torch.tensor(candidates(env, 1, 1)[0])
    q = env.evaluate(env.reset(), tasks, dec[None])
    _, res = env.step(env.reset(), tasks, dec)
    np.testing.assert_allclose(float(q[0]), float(res.reward), rtol=1e-5)


# ------------------------------------------------------ draw statistics
@pytest.mark.parametrize("name", ["fig8_csi", "dyn_topology"])
def test_sample_slot_statistics_match_reference(name):
    """The port's generator draws the reference's distributions: the
    same observed ranges (to 1% of their width) and means within 5
    standard errors over 4096 draws."""
    jenv, env = envs(name)
    n = 4096
    want = jax.vmap(jenv.sample_slot)(
        jax.random.split(jax.random.PRNGKey(0), n))
    got = env.sample_slot(torch.Generator().manual_seed(0), (n,))
    for f in SlotTasks._fields:
        w = np.asarray(getattr(want, f), np.float64)
        g = getattr(got, f).numpy().astype(np.float64)
        assert g.shape == w.shape, f
        slack = 0.01 * (w.max() - w.min()) + 1e-6 * abs(w).max()
        assert abs(g.min() - w.min()) <= slack, (f, g.min(), w.min())
        assert abs(g.max() - w.max()) <= slack, (f, g.max(), w.max())
        se = w.std() / np.sqrt(w.size) + 1e-12
        assert abs(g.mean() - w.mean()) < 5 * se * np.sqrt(2), (
            f, g.mean(), w.mean())


def test_device_none_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MECEnv(make_scenario("fig5_baseline"))


def test_poisson_scenarios_not_ported_yet():
    """``make_scenario`` builds the poisson scenarios (the serving engines
    run them); the fleet driver still refuses them (ROADMAP item 5)."""
    from repro_torch.core import agent_def
    from repro_torch.rollout import RolloutDriver

    cfg = make_scenario("dyn_poisson")
    assert cfg.workload == "poisson" and cfg.arrival_rate == 0.7
    adef = agent_def("grle", MECEnv(cfg, device="cpu"), device="cpu")
    with pytest.raises(NotImplementedError, match="poisson.*item 5"):
        RolloutDriver(adef, 2, device="cpu")
