"""repro_torch MEC simulator against the JAX reference: the same
``SlotTasks`` and ``MECState`` go through both envs; the port's own draws
are held to the reference's distributions by statistics. Scenario spaces
get the reference's uniforms; per-fleet knobs equal one network at a
time; the greedy and exhaustive oracles pick the reference's decisions."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.mec import MECEnv as JaxEnv
from repro.mec import MECState as JaxState
from repro.mec import make_scenario as jax_scenario
from repro.mec import scenarios as jax_scenarios
from repro.mec.config import derive_params as jax_derive_params
from repro_torch.mec import (PRIMITIVE_FIELDS, MECEnv, MECState,
                             ScenarioParams, SlotTasks, derive_params,
                             make_scenario)
from repro_torch.mec import scenarios

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
    """(Named for the refusal it pinned until the fleet driver took
    poisson/mmpp workloads.) ``make_scenario`` builds the poisson
    scenarios, and the driver runs one: DROO on dyn_poisson, B=2, T=12,
    fed the JAX driver's raw draws, makes the JAX driver's decisions."""
    import os
    import sys
    from repro.core.policy import agent_def as jax_agent_def
    from repro.rollout import RolloutDriver as JaxDriver
    from repro_torch.core import agent_def, agent_state_from_params
    from repro_torch.rollout import (InitDraws, RolloutDriver, SlotDraws,
                                     WorkloadDraws)
    from repro_torch.mec import SlotUniforms
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import make_torch_port_golden as golden_tool
    sys.path.pop(0)

    cfg = make_scenario("dyn_poisson")
    assert cfg.workload == "poisson" and cfg.arrival_rate == 0.7
    jdef = jax_agent_def("droo", JaxEnv(jax_scenario("dyn_poisson")))
    jst = jdef.init(jax.random.PRNGKey(1))
    mask = np.asarray(jst.exit_mask)
    _, want = JaxDriver(jdef, n_fleets=2, train=False).run(
        jax.random.PRNGKey(7), 12, mode="loop", agent_state=jst)
    init, wl, _, rand = golden_tool.dyn_draws(jdef, mask, 7, 2, 12)
    t = torch.tensor
    draws = SlotDraws(
        None, t(rand.astype(np.int64)),
        init=InitDraws(t(init["init/rate"]), t(init["init/capacity"])),
        workload=WorkloadDraws(
            *(t(wl[f"wl/{f}"]) for f in WorkloadDraws._fields[:-1]),
            SlotUniforms(*(t(wl[f"wl/slot/{f}"])
                           for f in SlotUniforms._fields))))
    drv = RolloutDriver(agent_def("droo", MECEnv(cfg, device="cpu"),
                                  device="cpu"), 2, train=False,
                        device="cpu")
    st = agent_state_from_params(drv.adef, jax.tree_util.tree_map(
        np.asarray, jst.params), mask)
    _, trace = drv.run(0, 12, mode="loop", agent_state=st, draws=draws)
    np.testing.assert_array_equal(trace.decisions.numpy(),
                                  np.asarray(want.decisions))
    np.testing.assert_array_equal(trace.active.numpy(),
                                  np.asarray(want.active))


# ------------------------------------------ scenario spaces
def test_derive_params_matches_reference():
    """Primitive knobs -> the derived AR(1) moments and rate bounds in
    float32, batched and not: the reference's within 1e-6."""
    rng = np.random.default_rng(0)
    base = jax_scenarios.scenario_params("dyn_markov_channel")
    for batch in ((), (3,)):
        prim = {}
        for f in PRIMITIVE_FIELDS:
            x = np.asarray(getattr(base, f))
            prim[f] = (x * rng.uniform(0.5, 1.0, size=batch + x.shape)
                       ).astype(np.float32)
        prim["ar1_rho"] = rng.uniform(0, 0.99, size=batch).astype(np.float32)
        ex_t = np.broadcast_to(np.asarray(base.exit_times_s),
                               batch + base.exit_times_s.shape)
        ex_a = np.broadcast_to(np.asarray(base.exit_acc),
                               batch + base.exit_acc.shape)
        if batch:
            want = jax.vmap(jax_derive_params)(
                {k: jnp.asarray(v) for k, v in prim.items()},
                jnp.asarray(ex_t), jnp.asarray(ex_a))
        else:
            want = jax_derive_params(prim, ex_t, ex_a)
        got = derive_params({k: torch.tensor(v) for k, v in prim.items()},
                            torch.tensor(ex_t), torch.tensor(ex_a))
        for f, g, w in zip(ScenarioParams._fields, got, want):
            assert tuple(g.shape) == w.shape, f
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7, err_msg=f)


@pytest.mark.parametrize("t", [0.0, 0.35, 1.0])
def test_interpolate_params_matches_reference(t):
    a, b = "fig5_baseline", "dyn_markov_channel"
    want = jax_scenarios.interpolate_params(
        jax_scenarios.scenario_params(a), jax_scenarios.scenario_params(b), t)
    got = scenarios.interpolate_params(
        scenarios.scenario_params(a, device="cpu"),
        scenarios.scenario_params(b, device="cpu"), t)
    for f, g, w in zip(ScenarioParams._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7, err_msg=f)


def _space_uniforms(space, key):
    """The reference's uniforms of ``ScenarioSpace.sample(key)``: one key
    per primitive field, in ``PRIMITIVE_FIELDS`` order."""
    keys = jax.random.split(key, len(PRIMITIVE_FIELDS))
    return {f: np.asarray(jax.random.uniform(k, jnp.shape(getattr(space.lo,
                                                                  f))))
            for k, f in zip(keys, PRIMITIVE_FIELDS)}


@pytest.mark.parametrize("lo,hi", [("fig5_baseline", "fig8_csi"),
                                   ("dyn_churn", "dyn_markov_channel")])
def test_scenario_space_samples_match_reference(lo, hi):
    """``sample`` and ``sample_batch`` on the reference's own uniforms
    (``fold_in`` per fleet for the batch): every leaf within 1e-6, the
    interval knobs sorted, exit tables tiled per fleet."""
    jspace = jax_scenarios.scenario_space(lo, hi, n_devices=6)
    space = scenarios.scenario_space(lo, hi, n_devices=6, device="cpu")
    key = jax.random.PRNGKey(4)
    want = jspace.sample(key)
    got = space.sample(uniforms={k: torch.tensor(v) for k, v in
                                 _space_uniforms(jspace, key).items()})
    for f, g, w in zip(ScenarioParams._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    n = 5
    want = jspace.sample_batch(key, n)
    draws = [_space_uniforms(jspace, jax.random.fold_in(key, i))
             for i in range(n)]
    got = space.sample_batch(uniforms={
        f: torch.tensor(np.stack([d[f] for d in draws]))
        for f in PRIMITIVE_FIELDS})
    for f, g, w in zip(ScenarioParams._fields, got, want):
        assert tuple(g.shape) == w.shape, f
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    own = space.sample_batch(torch.Generator().manual_seed(0), n)
    assert (own.capacity_range[:, 0] <= own.capacity_range[:, 1]).all()
    for f in PRIMITIVE_FIELDS:
        lo_f, hi_f = getattr(space.lo, f), getattr(space.hi, f)
        x = getattr(own, f)
        assert ((x >= torch.minimum(lo_f, hi_f) - 1e-6)
                & (x <= torch.maximum(lo_f, hi_f) + 1e-6)).all(), f


def test_scenario_names_grids_and_resolution_match_reference():
    assert list(scenarios.scenario_grid()) == list(
        jax_scenarios.scenario_grid())
    assert list(scenarios.scenario_grid(["fig6_capacity"], (4,), (5.0,))) \
        == list(jax_scenarios.scenario_grid(["fig6_capacity"], (4,), (5.0,)))
    axes = dict(n_devices=(6, 14), slot_ms=(10.0, 30.0))
    assert list(scenarios.expand_grid(scenarios.PAPER_FIGURES, **axes)) \
        == list(jax_scenarios.expand_grid(jax_scenarios.PAPER_FIGURES,
                                          **axes))
    assert list(scenarios.expand_grid()) == list(jax_scenarios.expand_grid())
    name = scenarios.space_scenario_name("fig5_baseline", "fig8_csi", 3, 7)
    assert name == jax_scenarios.space_scenario_name("fig5_baseline",
                                                     "fig8_csi", 3, 7)
    assert scenarios.parse_space_scenario(name) == \
        jax_scenarios.parse_space_scenario(name) == \
        ("fig5_baseline", "fig8_csi", 3, 7)
    assert scenarios.is_space_scenario(name)
    assert not scenarios.is_space_scenario("fig8_csi")
    for bad in ("space:fig5_baseline:fig8_csi:x:0", "space:nope:fig8_csi:1:0",
                "space:fig5_baseline:fig8_csi:1"):
        with pytest.raises(ValueError):
            scenarios.parse_space_scenario(bad)
        with pytest.raises(ValueError):
            jax_scenarios.parse_space_scenario(bad)
    for n in ("fig8_csi", "dyn_bursty"):
        cfg, sp = scenarios.resolve_scenario(n, n_devices=6, device="cpu")
        jcfg, jsp = jax_scenarios.resolve_scenario(n, n_devices=6)
        assert cfg == make_scenario(n, n_devices=6) and sp is None is jsp
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    cfg, sp = scenarios.resolve_scenario(name, n_devices=6, device="cpu")
    assert cfg == make_scenario("fig5_baseline", n_devices=6)
    again = scenarios.resolve_scenario(name, n_devices=6, device="cpu")[1]
    other = scenarios.resolve_scenario(scenarios.space_scenario_name(
        "fig5_baseline", "fig8_csi", 4, 7), n_devices=6, device="cpu")[1]
    assert all(torch.equal(x, y) for x, y in zip(sp, again))
    assert not torch.equal(sp.csi_error, other.csi_error)
    with pytest.raises(ValueError, match="structurally"):
        scenarios.scenario_space("fig8_csi", "dyn_bursty", device="cpu")


# -------------------------------------------- per-fleet knobs
def test_per_fleet_knobs_equal_one_network_at_a_time():
    """``sample_slot``, ``observe``, ``evaluate`` and ``step`` with one
    scenario per fleet ([B]-leading knobs) give, fleet by fleet and bit
    for bit, what one network under its own scenario gives."""
    _, env = envs("fig5_baseline", n_devices=6)
    sp = scenarios.scenario_space("fig5_baseline", "dyn_topology",
                                  n_devices=6, device="cpu").sample_batch(
        torch.Generator().manual_seed(0), 3)
    gen = torch.Generator().manual_seed(1)
    tasks = env.sample_slot(gen, (3,), sp)
    state = MECState(torch.rand(3, 6, generator=gen) * 0.1,
                     torch.rand(3, env.N, generator=gen) * 0.1,
                     torch.full((3,), 2, dtype=torch.int32))
    dec = torch.randint(0, env.N * env.L, (3, 7, 6), generator=gen)
    q = env.evaluate(state, tasks, dec, sp)
    obs = env.observe(state, tasks, sp)
    nxt, res = env.step(state, tasks, dec[:, 0], sp)
    g1 = torch.Generator().manual_seed(1)
    for b in range(3):
        sp_b = ScenarioParams(*(x[b] for x in sp))
        st_b = MECState(*(x[b] for x in state))
        t_b = SlotTasks(*(x[b] for x in tasks))
        assert torch.equal(env.evaluate(st_b, t_b, dec[b], sp_b), q[b])
        for k, v in env.observe(st_b, t_b, sp_b).items():
            assert torch.equal(v, obs[k][b]), k
        n_b, r_b = env.step(st_b, t_b, dec[b, 0], sp_b)
        for x, y in zip(list(n_b) + list(r_b), list(nxt) + list(res)):
            assert torch.equal(x, y[b])
    # the draws' knobs too: each fleet's ranges and drop rate
    lo = sp.task_kb[:, 0, None] * 8e3
    assert (tasks.size_bits >= lo - 1).all()
    del g1


# ------------------------------------------------- oracles
def assert_same_oracle_pick(jenv, state, tasks, got, want):
    """Equal decisions, or two the reference's critic scores within float32
    rounding of each other (1e-6 relative): devices in symmetric positions
    can swap options at an exact tie that each framework's summation
    order breaks its own way."""
    got, want = np.asarray(got), np.asarray(want)
    if (got == want).all():
        return
    q = np.asarray(jenv.evaluate(state, tasks, jnp.asarray(
        np.stack([want, got]), jnp.int32)))
    np.testing.assert_allclose(q[1], q[0], rtol=1e-6,
                               err_msg=f"decisions {got} vs {want}")


@pytest.mark.parametrize("name,early_exit", [("fig5_baseline", True),
                                             ("fig8_csi", True),
                                             ("fig8_csi", False)])
def test_greedy_decision_matches_reference(name, early_exit):
    """The sequential-greedy oracle at M=14 on the reference's slots, with
    queued work: the reference's decisions (``assert_same_oracle_pick``);
    batched rows equal one network's."""
    jenv, env = envs(name)
    decisions = []
    states, tasks_ = [], []
    for seed in range(2):
        state, tasks = jax_inputs(jenv, 20 + seed)
        want = jenv.greedy_decision(state, tasks, early_exit=early_exit)
        got = env.greedy_decision(to_port(state, MECState),
                                  to_port(tasks, SlotTasks),
                                  early_exit=early_exit)
        assert got.dtype == torch.int32
        assert_same_oracle_pick(jenv, state, tasks, got, want)
        decisions.append(got)
        states.append(to_port(state, MECState))
        tasks_.append(to_port(tasks, SlotTasks))
    batched = env.greedy_decision(
        MECState(*(torch.stack(x) for x in zip(*states))),
        SlotTasks(*(torch.stack(x) for x in zip(*tasks_))),
        early_exit=early_exit)
    assert torch.equal(batched, torch.stack(decisions))


@pytest.mark.parametrize("early_exit", [True, False])
def test_exhaustive_decision_matches_reference(early_exit):
    jenv, env = envs("fig8_csi", n_devices=3)
    for seed in range(2):
        state, tasks = jax_inputs(jenv, 30 + seed)
        want = jenv.exhaustive_decision(state, tasks, early_exit=early_exit)
        got = env.exhaustive_decision(to_port(state, MECState),
                                      to_port(tasks, SlotTasks),
                                      early_exit=early_exit)
        assert_same_oracle_pick(jenv, state, tasks, got, want)
        # the oracle is at least as good as greedy
        q = env.evaluate(to_port(state, MECState), to_port(tasks, SlotTasks),
                         torch.stack([got, env.greedy_decision(
                             to_port(state, MECState),
                             to_port(tasks, SlotTasks),
                             early_exit=early_exit)]))
        assert float(q[0]) >= float(q[1])


# ---------------------------------------------- the batched env's sp
def test_vecenv_takes_one_shared_scenario():
    """``VecMECEnv``'s ``sample_slot``, ``observe``, ``evaluate`` and
    ``step`` take one ``ScenarioParams`` shared by the B fleets, as the
    reference's: on the reference's batched draws and states under a
    scenario other than the env's own, the port gives the reference's
    outputs (integers exactly, floats to 1e-6); ``sample_slot`` under it
    draws what ``MECEnv.sample_slot`` draws (its deadlines the
    reference's), and without it the env's own scenario."""
    from repro.rollout.vecenv import VecMECEnv as JaxVecEnv
    from repro_torch.rollout.vecenv import VecMECEnv

    jenv, env = envs("fig5_baseline", n_devices=6)
    jsp = JaxEnv(jax_scenario("dyn_topology", n_devices=6)).params
    jsp = jsp._replace(deadline_s=jsp.deadline_s * 0.5,
                       exit_times_s=jsp.exit_times_s * 1.5,
                       csi_error=jsp.csi_error + 0.2,
                       exit_acc=jsp.exit_acc * 0.9)
    sp = ScenarioParams(*(torch.tensor(np.asarray(x)) for x in jsp))
    b = 3
    jvec, vec = JaxVecEnv(jenv, b), VecMECEnv(env, b)
    jtasks = jvec.sample_slot(jvec.fleet_keys(jax.random.PRNGKey(5)), jsp)
    rng = np.random.default_rng(6)
    jstates = JaxState(
        dev_free=jnp.asarray(rng.uniform(0, 0.2, (b, 6)), jnp.float32),
        es_free=jnp.asarray(rng.uniform(0, 0.2, (b, env.N)), jnp.float32),
        slot=jnp.full((b,), 3, jnp.int32))
    states, tasks = to_port(jstates, MECState), to_port(jtasks, SlotTasks)
    cands = np.stack([candidates(env, 7, s) for s in range(b)])

    def same(got, want, name):
        want = np.asarray(want)
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-7, err_msg=name)

    obs = vec.observe(states, tasks, sp)
    for k, w in jvec.observe(jstates, jtasks, jsp).items():
        same(obs[k], w, k)
    same(vec.evaluate(states, tasks, torch.tensor(cands), sp),
         jvec.evaluate(jstates, jtasks, jnp.asarray(cands), jsp), "Q")
    new, res = vec.step(states, tasks, torch.tensor(cands[:, 0]), sp)
    j_new, j_res = jvec.step(jstates, jtasks, jnp.asarray(cands[:, 0]), jsp)
    for f in JaxState._fields:
        same(getattr(new, f), getattr(j_new, f), f)
    for f in j_res._fields:
        same(getattr(res, f), getattr(j_res, f), f)
    # without sp: the env's own scenario, which differs
    assert not torch.equal(vec.evaluate(states, tasks, torch.tensor(cands)),
                           vec.evaluate(states, tasks, torch.tensor(cands),
                                        sp))
    assert not torch.equal(vec.observe(states, tasks)["device"],
                           obs["device"])
    drawn = vec.sample_slot(torch.Generator().manual_seed(2), sp)
    direct = env.sample_slot(torch.Generator().manual_seed(2), (b,), sp)
    for x, y in zip(drawn, direct):
        assert torch.equal(x, y)
    same(drawn.deadline_s, jtasks.deadline_s, "deadline_s")
    plain = vec.sample_slot(torch.Generator().manual_seed(2))
    assert torch.equal(plain.deadline_s, env.params.deadline_s.expand(b, 6))
