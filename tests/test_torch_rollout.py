"""The port's driver as a whole, against the JAX driver.

The JAX ``RolloutDriver.run(mode="loop")`` draws its tasks and
exploration candidates from threefry keys; those draws are rebuilt from
the driver's key schedule (``tools/make_torch_port_golden.py``) and
injected into the port's driver, which must then make the same decisions.
``tests/data/torch_port_golden.npz`` carries one GRLE run (fig5_baseline)
and ``tests/data/torch_port_dyn_golden.npz`` three training runs (DROO,
DROOE on an mmpp workload, GRLE with one scenario per fleet) to the GPU
machine, where JAX is not installed; tests here keep them current. The
poisson/mmpp scenarios run against live JAX drivers on their raw
workload draws; per-fleet scenarios equal one-fleet runs bit for bit.
"""
import gc
import os
import sys
import weakref

import numpy as np
import pytest
import torch

from repro_torch.core import agent_def, agent_state_from_params, make_agent
from repro_torch.mec import (MECEnv, MECState, ScenarioParams, SlotTasks,
                             SlotUniforms, make_scenario, scenario_space)
from repro_torch.nn.pytree import flatten_dict, tree_refill, tree_tensors
from repro_torch.obs import telemetry_host
from repro_torch.rollout import (InitDraws, RolloutDriver, SlotDraws,
                                 WorkloadDraws, carry_metrics,
                                 carry_telemetry, make_workload,
                                 trace_metrics)
from repro_torch.rollout.driver import _at

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import make_torch_port_golden as golden_tool  # noqa: E402

sys.path.pop(0)
torch.set_num_threads(1)

TOL = 1e-5          # reward and q_est, relative (f32 sums in other orders)
METRIC_KEYS = ("ssp", "avg_accuracy", "deadline_miss", "throughput_tps",
               "avg_reward", "tasks", "train_steps")


@pytest.fixture(scope="module")
def golden():
    return golden_tool.load()


def jax_run(name, golden, seed):
    """JAX driver trace + metrics and its draws/states for ``name``."""
    adef = golden_tool.grle(name)
    st = golden_tool.agent_state(adef, golden["params"], golden["exit_mask"])
    trace, metrics = golden_tool.driver_trace(
        adef, st, seed, golden_tool.N_FLEETS, golden_tool.N_SLOTS)
    tasks, rand = golden_tool.driver_draws(
        adef, golden["exit_mask"], seed, golden_tool.N_FLEETS,
        golden_tool.N_SLOTS)
    ref = golden_tool.reference_episode(adef, golden["params"],
                                        golden["exit_mask"], tasks, rand)
    return adef, trace, metrics, tasks, rand, ref


def port_run(name, golden, tasks, rand, mode="loop"):
    env = MECEnv(make_scenario(name), device="cpu")
    drv = RolloutDriver(agent_def("grle", env, device="cpu"),
                        rand.shape[1], train=False, device="cpu")
    st = agent_state_from_params(drv.adef, golden["params"],
                                 golden["exit_mask"])
    draws = SlotDraws(
        SlotTasks(*(torch.tensor(tasks[f]) for f in SlotTasks._fields)),
        torch.tensor(rand.astype(np.int64)))
    carry, trace = drv.run(0, rand.shape[0], mode=mode, agent_state=st,
                           draws=draws)
    return drv, carry, trace


def assert_same_decisions(got, want, q_margin, xhat_margin):
    """Equal decisions; a flip is reported with its slot, fleet and the
    reference's near-tie margins."""
    bad = np.argwhere((got != want).any(-1))
    assert bad.size == 0, "decisions differ at " + "; ".join(
        f"slot {t} fleet {b}: q margin {q_margin[t, b]:.3g}, "
        f"x_hat margin {xhat_margin[t, b]:.3g}" for t, b in bad)


def test_golden_file_is_current(golden):
    """Rebuilding the golden run from its stored params and seed with the
    JAX package gives the stored trace, draws, states and metrics:
    integers and booleans exactly, floats to 1e-6 (XLA's CPU code may
    round differently on another CPU model)."""
    seed = int(golden["seed"])
    name = str(golden["scenario"])
    _, trace, metrics, tasks, rand, ref = jax_run(name, golden, seed)

    def same(got, want, msg):
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=msg)
        else:
            np.testing.assert_array_equal(got, want, err_msg=msg)

    for k, v in trace.items():
        same(v, golden[f"trace/{k}"], k)
    for k, v in metrics.items():
        same(v, golden[f"metrics/{k}"], k)
    for k, v in tasks.items():
        same(v, golden[f"tasks/{k}"], k)
    np.testing.assert_array_equal(rand, golden["rand_cands"])
    for k in ("state_dev_free", "state_es_free", "state_slot", "q_margin",
              "xhat_margin"):
        same(ref[k], golden[k], k)
    # the replay on injected draws is the driver's own run
    np.testing.assert_array_equal(ref["decisions"], trace["decisions"])
    np.testing.assert_allclose(ref["q_est"], trace["q_est"], rtol=1e-6)
    np.testing.assert_allclose(ref["reward"], trace["reward"], rtol=1e-6)


def check_against(drv, carry, trace, want, metrics, q_margin, xhat_margin):
    assert trace.decisions.dtype == torch.int32
    assert_same_decisions(trace.decisions.numpy(), want["decisions"],
                          q_margin, xhat_margin)
    np.testing.assert_allclose(trace.reward.numpy(), want["reward"], rtol=TOL)
    np.testing.assert_allclose(trace.q_est.numpy(), want["q_est"], rtol=TOL)
    for k in ("success", "accuracy", "active"):
        np.testing.assert_array_equal(trace._asdict()[k].numpy(), want[k],
                                      err_msg=k)
    got = drv.metrics(carry)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(got[k], float(metrics[k]), rtol=1e-6,
                                   err_msg=k)
    assert np.isnan(got["final_loss"]) and np.isnan(float(metrics["final_loss"]))


def test_port_reproduces_golden_fig5(golden):
    want = {k.split("/", 1)[1]: v for k, v in golden.items()
            if k.startswith("trace/")}
    metrics = {k.split("/", 1)[1]: v for k, v in golden.items()
               if k.startswith("metrics/")}
    tasks = {f: golden[f"tasks/{f}"] for f in SlotTasks._fields}
    drv, carry, trace = port_run(str(golden["scenario"]), golden, tasks,
                                 golden["rand_cands"])
    check_against(drv, carry, trace, want, metrics, golden["q_margin"],
                  golden["xhat_margin"])


def test_port_reproduces_jax_driver_fig8(golden):
    """fig8_csi (capacity, jitter and CSI error): live JAX run, B=4, T=32."""
    _, trace, metrics, tasks, rand, ref = jax_run("fig8_csi", golden, seed=5)
    drv, carry, p_trace = port_run("fig8_csi", golden, tasks, rand)
    check_against(drv, carry, p_trace, trace, metrics, ref["q_margin"],
                  ref["xhat_margin"])


def test_teacher_forced_slots_match(golden):
    """Every slot started from JAX's own ``MECState``: a flip cannot
    cascade, so each slot's decision and next state are held alone."""
    env = MECEnv(make_scenario(str(golden["scenario"])), device="cpu")
    adef = agent_def("grle", env, device="cpu")
    st = agent_state_from_params(adef, golden["params"], golden["exit_mask"])
    n_slots = golden["rand_cands"].shape[0]
    decisions = []
    for t in range(n_slots):
        state = MECState(*(torch.tensor(golden[f"state_{f}"][t])
                           for f in MECState._fields))
        tasks = SlotTasks(*(torch.tensor(golden[f"tasks/{f}"][t])
                            for f in SlotTasks._fields))
        dec, _, _ = adef.decide(
            st, state, tasks,
            rand_cands=torch.tensor(golden["rand_cands"][t].astype(np.int64)))
        decisions.append(dec.numpy())
        nxt, _ = env.step(state, tasks, torch.tensor(
            golden["trace/decisions"][t]))
        for f in MECState._fields:
            np.testing.assert_allclose(
                getattr(nxt, f).numpy(), golden[f"state_{f}"][t + 1],
                rtol=1e-6, err_msg=f"slot {t} {f}")
    assert_same_decisions(np.stack(decisions), golden["trace/decisions"],
                          golden["q_margin"], golden["xhat_margin"])


def test_own_generator_run_matches_reference_statistics(golden):
    """Without injected draws the port runs on its own generator: a fixed
    seed repeats, and the trained GRLE's §VI-D metrics over 16 fleets land
    within sampling spread of the JAX driver's golden run (4 fleets)."""
    env = MECEnv(make_scenario(str(golden["scenario"])), device="cpu")
    drv = RolloutDriver(agent_def("grle", env, device="cpu"), 16,
                        train=False, device="cpu")
    st = agent_state_from_params(drv.adef, golden["params"],
                                 golden["exit_mask"])
    c1, t1 = drv.run(3, golden_tool.N_SLOTS, mode="loop", agent_state=st)
    _, t2 = drv.run(3, golden_tool.N_SLOTS, mode="loop", agent_state=st)
    assert torch.equal(t1.decisions, t2.decisions)
    m = drv.metrics(c1)
    assert m["tasks"] == golden_tool.N_SLOTS * 16 * env.M
    assert abs(m["ssp"] - float(golden["metrics/ssp"])) < 0.02
    assert abs(m["avg_accuracy"] - float(golden["metrics/avg_accuracy"])) < 0.01
    assert abs(m["avg_reward"] / float(golden["metrics/avg_reward"]) - 1) < 0.03


def test_driver_refuses_training_and_cpu_fallback(monkeypatch):
    """Training that could never run is refused, as in the reference (a
    ring smaller than the minibatch, or than one slot's fleets); so is a
    silent move to the CPU."""
    env = MECEnv(make_scenario("fig5_baseline", n_devices=4), device="cpu")
    adef = agent_def("grle", env, device="cpu", hidden=(16, 8))
    with pytest.raises(ValueError, match="smaller than minibatch"):
        RolloutDriver(adef, 2, train=True, replay_capacity=32, device="cpu")
    with pytest.raises(ValueError, match="cannot hold one slot"):
        RolloutDriver(adef, 200, train=True, device="cpu")
    RolloutDriver(adef, 2, train=False, replay_capacity=32, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RolloutDriver(adef, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        agent_def("grle", env)


# ------------------------------------------------------- compiled episode
def test_scan_reproduces_golden_fig5(golden):
    """``mode="scan"`` (the static-buffer episode, uncaptured on the CPU)
    on the golden draws: the JAX run's decisions, rewards and metrics."""
    want = {k.split("/", 1)[1]: v for k, v in golden.items()
            if k.startswith("trace/")}
    metrics = {k.split("/", 1)[1]: v for k, v in golden.items()
               if k.startswith("metrics/")}
    tasks = {f: golden[f"tasks/{f}"] for f in SlotTasks._fields}
    drv, carry, trace = port_run(str(golden["scenario"]), golden, tasks,
                                 golden["rand_cands"], mode="scan")
    check_against(drv, carry, trace, want, metrics, golden["q_margin"],
                  golden["xhat_margin"])


def small_driver(train=True, telemetry=True, b=2):
    env = MECEnv(make_scenario("fig8_csi", n_devices=4), device="cpu")
    adef = agent_def("grle", env, device="cpu", hidden=(16, 8))
    return RolloutDriver(adef, b, train=train, replay_capacity=32,
                         batch_size=8, train_every=5, telemetry=telemetry,
                         device="cpu")


def assert_same_run(a, b):
    """Two (carry, trace) pairs equal bit for bit, NaN equal to NaN, and
    the host mirrors too."""
    xs, ys = tree_tensors(a), tree_tensors(b)
    assert len(xs) == len(ys)
    for i, (x, y) in enumerate(zip(xs, ys)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert torch.equal(x, y) or torch.equal(
            torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0)), i
    ca, cb = a[0].agent_state, b[0].agent_state
    assert ca.host_step == cb.host_step
    assert ca.replay.host_size == cb.replay.host_size


@pytest.mark.parametrize("train,telemetry", [(False, False), (False, True),
                                             (True, False), (True, True)])
def test_scan_equals_loop_bit_for_bit(train, telemetry):
    """On one seed of the driver's own generator: the trace, the
    ``CellMetrics``, the telemetry and the learner, bit for bit; a second
    scan run on the driver's cached buffers again; a caller's generator
    object the same as its seed."""
    drv = small_driver(train, telemetry)
    loop = drv.run(7, 30, mode="loop")
    scan = drv.run(7, 30, mode="scan")
    assert_same_run(loop, scan)
    assert_same_run(loop, drv.run(7, 30))               # scan is the default
    assert_same_run(loop, drv.run(torch.Generator().manual_seed(7), 30))
    assert (loop[0].telemetry is None) == (not telemetry)
    if train:
        assert int(scan[0].agent_state.loss_count) == 6
        assert scan[0].agent_state.host_step == 30
        assert scan[0].agent_state.replay.host_size == 32


def test_scan_results_do_not_alias_its_buffers():
    """A run's carry and trace stay as they were when the driver runs
    again: the scan hands out copies of its static buffers."""
    drv = small_driver()
    c1, t1 = drv.run(1, 12)
    kept = [x.clone() for x in tree_tensors((c1, t1))]
    drv.run(2, 12)
    for x, y in zip(kept, tree_tensors((c1, t1))):
        assert torch.equal(torch.nan_to_num(x, nan=7.0),
                           torch.nan_to_num(y, nan=7.0))


def test_telemetry_does_not_perturb_trajectories():
    """The registry only observes: decisions, rewards and the learned
    params are identical with it on and off."""
    c_on, t_on = small_driver(telemetry=True).run(3, 25)
    c_off, t_off = small_driver(telemetry=False).run(3, 25)
    assert torch.equal(t_on.decisions, t_off.decisions)
    assert torch.equal(t_on.reward, t_off.reward)
    for a, b in zip(tree_tensors(c_on.params), tree_tensors(c_off.params)):
        assert torch.equal(a, b)
    assert c_off.telemetry is None and carry_telemetry(c_off) is None


def test_counters_agree_with_trace():
    """As tests/test_obs.py holds the reference: task and success counts
    exactly, the Eq-9 reward to float32 summation order, the decision
    histograms partition the active tasks."""
    drv = small_driver()
    carry, trace = drv.run(4, 30)
    host = carry_telemetry(carry)
    c = host["counters"]
    active = trace.active.numpy() > 0.5
    assert c["slots"] == 30
    assert c["tasks"] == active.sum()
    assert c["success"] == (trace.success.numpy() & active).sum()
    assert c["train_steps"] == (~np.isnan(trace.loss.numpy())).sum() == 6
    np.testing.assert_allclose(c["reward"], trace.reward.numpy().sum(),
                               rtol=1e-5)
    for name in ("exit", "server", "latency"):
        assert sum(host["hists"][name]["counts"]) == pytest.approx(
            c["tasks"])
    assert host == {**telemetry_host(carry.telemetry),
                    "summary": host["summary"]}
    assert len(host["summary"]["exit_share"]) == drv.env.L


def test_carry_metrics_agrees_with_trace_metrics():
    drv = small_driver()
    carry, trace = drv.run(9, 25)
    m_acc = carry_metrics(carry, slot_s=drv.env.cfg.slot_s, n_fleets=2)
    m_tr = trace_metrics(trace, slot_s=drv.env.cfg.slot_s)
    for k in ("ssp", "avg_accuracy", "throughput_tps", "avg_reward"):
        np.testing.assert_allclose(m_acc[k], m_tr[k], rtol=1e-5, err_msg=k)
    assert isinstance(m_acc["tasks"], int) and m_acc["tasks"] == m_tr["tasks"]
    assert isinstance(m_acc["train_steps"], int)
    assert m_acc["train_steps"] == int(np.isfinite(trace.loss.numpy()).sum())
    np.testing.assert_allclose(m_acc["final_loss"], m_tr["final_loss"],
                               rtol=1e-6)
    c0, t0 = small_driver(train=False).run(9, 3)
    assert carry_metrics(c0, slot_s=0.03, n_fleets=2)["final_loss"] is None
    assert trace_metrics(t0, slot_s=0.03)["final_loss"] is None


def test_driver_surface():
    """The reference's public names: ``init_carry``, ``carry.params``,
    ``mode`` checked, the replay ring re-exported under ``rollout``."""
    import repro_torch.core.devreplay as core_replay
    import repro_torch.rollout as rollout
    drv = small_driver()
    carry = drv.init_carry(0)
    assert carry.params is carry.agent_state.params
    assert int(carry.agent_state.step) == 0 and carry.telemetry is not None
    with pytest.raises(ValueError, match="unknown mode"):
        drv.run(0, 2, mode="jit")
    for name in ("DeviceReplay", "replay_init", "replay_add",
                 "replay_sample"):
        assert getattr(rollout, name) is getattr(core_replay, name)


def test_build_counters_count_episodes_not_runs():
    """``episodes_built`` counts scan episodes, one per episode shape: a
    second run of the same shapes (another seed, another ``sp`` of the same
    shapes, a fresh agent state) builds nothing new; the loop builds none;
    another length builds one more. No graphs are captured on the CPU,
    and a ``CompileTracker`` files the builds under the driver's label."""
    from repro_torch.obs import CompileTracker
    drv = small_driver()
    assert (drv.episodes_built, drv.graphs_captured, drv.label) == (
        0, 0, None)
    drv.label = "small"
    sp = drv.env.params
    with CompileTracker() as ct:
        drv.run(0, 6, sp=sp)
        drv.run(1, 6, sp=ScenarioParams(*(x.clone() for x in sp)),
                agent_state=drv.adef.init(torch.Generator().manual_seed(3)))
        drv.run(2, 6, mode="loop")
        assert drv.episodes_built == 1
        drv.run(0, 7, sp=sp)
    assert (drv.episodes_built, drv.graphs_captured) == (2, 0)
    assert ct.by_label()["small"]["episodes"] == 2
    assert ct.n_graphs_captured == 0


def test_a_dropped_driver_is_freed_at_once():
    """The compiled episode holds no reference back to its driver: a driver
    its caller drops is freed by reference counting, never by a later pass
    of the cyclic collector (which on the card could fall inside another
    driver's capture and destroy graphs there)."""
    drv = small_driver(train=False, telemetry=False)
    drv.run(0, 3)
    ref = weakref.ref(drv)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del drv
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


# ---------------------------- dynamic workloads, per-fleet scenarios
@pytest.fixture(scope="module")
def dyn_golden():
    with np.load(golden_tool.DYN_GOLDEN) as z:
        return {k: z[k] for k in z.files}


def t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


# ``SlotDraws`` of one stored run: the tasks (iid), or the workload's init
# and per-slot raw uniforms (poisson/mmpp), and its replay rows if stored
dyn_slot_draws = golden_tool.port_slot_draws


def stored_sp(data):
    if "sp/task_kb" not in data:
        return None
    return ScenarioParams(*(t(data[f"sp/{f}"])
                            for f in ScenarioParams._fields))


def port_dyn_run(data, mode):
    """A stored run of ``torch_port_dyn_golden.npz`` through the port's
    driver: its initial params, draws, minibatch rows and scenarios."""
    env = MECEnv(make_scenario(str(data["scenario"])), device="cpu")
    sp = stored_sp(data)
    drv = RolloutDriver(agent_def(str(data["method"]), env, device="cpu"),
                        golden_tool.DYN_FLEETS, train=True,
                        per_fleet_scenarios=sp is not None, device="cpu",
                        **golden_tool.DYN_KW)
    st = agent_state_from_params(drv.adef, golden_tool.tree_of(
        data, "init_params"), data["exit_mask"])
    carry, trace = drv.run(0, golden_tool.DYN_SLOTS, mode=mode,
                           agent_state=st, sp=sp,
                           draws=dyn_slot_draws(data))
    return drv, carry, trace


@pytest.mark.parametrize("run", list(golden_tool.DYN_RUNS))
def test_dyn_golden_file_is_current(dyn_golden, run):
    """Rebuilding each stored run with the JAX package gives the stored
    arrays: integers exactly, floats to 1e-6."""
    data = golden_tool.build_dyn_run(run)
    stored = golden_tool.run_of(dyn_golden, run)
    assert set(data) == set(stored)
    for k, v in data.items():
        want = stored[k]
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(v, want, rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v, want, err_msg=k)
    assert os.path.getsize(golden_tool.DYN_GOLDEN) < 4 << 20


NEAR_TIE = 1e-5     # chip_smoke.py's: a flipped decision's recorded margin


def check_dyn_replay(drv, carry, trace, data):
    """``chip_smoke.py`` phase 17's gate on a stored run: decisions equal
    up to the first slot where one differs, which must be at a recorded
    near-tie (critic or actor margin <= 1e-5) after the first train step;
    before it, activity exactly, losses within 1e-5 relative, q_est and
    rewards within 1e-5; without a flip, also the final params and Adam
    moments (rtol 1e-4, atol 2e-7) and the §VI-D metrics. Returns the
    slots compared."""
    dec, want = trace.decisions.numpy(), data["trace/decisions"]
    n_slots = want.shape[0]
    flipped = np.flatnonzero((dec != want).any(-1).any(-1))
    stop = int(flipped[0]) if flipped.size else n_slots
    if stop < n_slots:
        for b in np.flatnonzero((dec[stop] != want[stop]).any(-1)):
            margin = min(data["q_margin"][stop, b],
                         data["xhat_margin"][stop, b])
            assert margin <= NEAR_TIE, (
                f"slot {stop} fleet {b}: decision differs at margin "
                f"{margin:.3g}")
    assert stop > int(data["train_slots"][0]) - 1, (
        f"a decision flipped at slot {stop}, before the first train step")
    cut = slice(0, stop)
    np.testing.assert_array_equal(trace.active.numpy()[cut],
                                  data["trace/active"][cut])
    loss, want_loss = trace.loss.numpy()[cut], data["trace/loss"][cut]
    np.testing.assert_array_equal(np.isnan(loss), np.isnan(want_loss))
    ok = ~np.isnan(want_loss)
    np.testing.assert_allclose(loss[ok], want_loss[ok], rtol=1e-5)
    np.testing.assert_allclose(trace.q_est.numpy()[cut],
                               data["trace/q_est"][cut], rtol=TOL)
    np.testing.assert_allclose(trace.reward.numpy()[cut],
                               data["trace/reward"][cut], rtol=TOL,
                               atol=1e-7)
    if stop < n_slots:
        return stop
    fin = carry.agent_state
    for name, tree in (("params", fin.params), ("mu", fin.opt_state["mu"]),
                       ("nu", fin.opt_state["nu"])):
        want_t = flatten_dict(golden_tool.tree_of(data, f"final/{name}"))
        got_t = flatten_dict(tree)
        assert set(got_t) == set(want_t)
        for k, w in want_t.items():
            np.testing.assert_allclose(
                got_t[k].numpy(), w, err_msg=f"{name}/{k}",
                **(dict(rtol=1e-4, atol=2e-7) if name != "nu"
                   else dict(rtol=1e-4, atol=1e-12)))
    assert int(fin.opt_state["step"]) == int(data["final/opt_step"]) == 12
    m = drv.metrics(carry)
    for k in ("ssp", "avg_accuracy", "tasks", "train_steps"):
        np.testing.assert_allclose(m[k], float(data[f"metrics/{k}"]),
                                   rtol=1e-6, err_msg=k)
    return stop


@pytest.mark.parametrize("mode", ["loop", "scan"])
@pytest.mark.parametrize("run", list(golden_tool.DYN_RUNS))
def test_port_replays_dyn_golden(dyn_golden, run, mode):
    """DROO on fig8_csi, DROOE on dyn_bursty (mmpp, the workload state fed
    its raw uniforms) and GRLE with one sampled scenario per fleet on
    dyn_markov_channel, each B=4, T=64 with 12 train steps, from the JAX
    run's initial params, through ``check_dyn_replay``. DROO's critic
    meets exact ties (symmetric assignments score the same up to the
    summation order, where the reference's own driver and a replay of it
    disagree on most seeds), so its run is held up to its first tie (and
    whole by ``test_port_teacher_forced_on_dyn_golden``); the other two
    run whole."""
    data = golden_tool.run_of(dyn_golden, run)
    stop = check_dyn_replay(*port_dyn_run(data, mode), data)
    if run != "droo_fig8":
        assert stop == golden_tool.DYN_SLOTS


@pytest.mark.parametrize("run", list(golden_tool.DYN_RUNS))
def test_port_teacher_forced_on_dyn_golden(dyn_golden, run):
    """Each stored run teacher-forced: every slot the port decides from its
    own learner on the run's draws (its decision the run's, or different
    only at a recorded near-tie), then the env and the learner take the
    run's decision, so DROO's critic ties cannot move the rest of the
    run: all 12 losses within 1e-5, the final params and Adam moments
    within rtol 1e-4 / atol 2e-7."""
    data = golden_tool.run_of(dyn_golden, run)
    env = MECEnv(make_scenario(str(data["scenario"])), device="cpu")
    sp = stored_sp(data)
    adef = RolloutDriver(agent_def(str(data["method"]), env, device="cpu"),
                         golden_tool.DYN_FLEETS, device="cpu",
                         **golden_tool.DYN_KW).adef
    draws = dyn_slot_draws(data)
    gen = make_workload(env)
    wl = (None if draws.init is None
          else gen.init(None, sp, draws=draws.init))
    agent = adef.episode_state(agent_state_from_params(
        adef, golden_tool.tree_of(data, "init_params"), data["exit_mask"]))
    env_state = env.reset((golden_tool.DYN_FLEETS,))
    want = t(data["trace/decisions"])
    losses, n_train = [], 0
    for k in range(golden_tool.DYN_SLOTS):
        if draws.tasks is not None:
            tasks = SlotTasks(*(x[k] for x in draws.tasks))
        else:
            wl, tasks = gen.sample(wl, None, sp, draws=_at(draws.workload, k))
        dec, _, graphs = adef.decide(agent, env_state, tasks, sp=sp,
                                     rand_cands=draws.rand_cands[k])
        for b in np.flatnonzero((dec != want[k]).any(-1).numpy()):
            assert min(data["q_margin"][k, b],
                       data["xhat_margin"][k, b]) <= NEAR_TIE, (k, b)
        take = None
        if adef.train_due(agent, golden_tool.DYN_FLEETS):
            take, n_train = draws.replay_take[n_train], n_train + 1
        env_state, _ = env.step(env_state, tasks, want[k], sp)
        agent, loss = adef.absorb(agent, graphs, want[k], take=take)
        losses.append(float(loss))
    loss, want_loss = np.asarray(losses), data["trace/loss"]
    np.testing.assert_array_equal(np.isnan(loss), np.isnan(want_loss))
    ok = ~np.isnan(want_loss)
    assert n_train == ok.sum() == 12
    np.testing.assert_allclose(loss[ok], want_loss[ok], rtol=1e-5)
    for name, tree in (("params", agent.params),
                       ("mu", agent.opt_state["mu"]),
                       ("nu", agent.opt_state["nu"])):
        want_t = flatten_dict(golden_tool.tree_of(data, f"final/{name}"))
        got_t = flatten_dict(tree)
        assert set(got_t) == set(want_t)
        for key, w in want_t.items():
            np.testing.assert_allclose(
                got_t[key].numpy(), w, err_msg=f"{name}/{key}",
                **(dict(rtol=1e-4, atol=2e-7) if name != "nu"
                   else dict(rtol=1e-4, atol=1e-12)))


def jax_dyn_run(scenario, golden, seed, n_fleets=4, n_slots=16):
    """A live JAX ``train=False`` run of GRLE with the golden's trained
    params on a poisson/mmpp scenario, its raw draws rebuilt, and the
    critic's and actor's margins of a replay on them."""
    import jax
    from repro.core.policy import agent_def as jax_agent_def
    from repro.mec import MECEnv as JaxEnv
    from repro.mec import make_scenario as jax_scenario
    from repro.rollout import RolloutDriver as JaxDriver
    jdef = jax_agent_def("grle", JaxEnv(jax_scenario(scenario)))
    st = golden_tool.agent_state(jdef, golden["params"], golden["exit_mask"])
    _, trace = JaxDriver(jdef, n_fleets=n_fleets, train=False).run(
        jax.random.PRNGKey(seed), n_slots, mode="loop", agent_state=st)
    init, wl, tasks, rand = golden_tool.dyn_draws(
        jdef, golden["exit_mask"], seed, n_fleets, n_slots)
    ref = golden_tool.reference_episode(jdef, golden["params"],
                                        golden["exit_mask"], tasks, rand)
    want = {k: np.asarray(v) for k, v in trace._asdict().items()}
    np.testing.assert_array_equal(ref["decisions"], want["decisions"])
    return want, {**init, **wl, "rand_cands": rand}, ref


def first_flip(got, want, q_margin, xhat_margin):
    """The first slot where a decision differs (T if none); every fleet
    that differs there must sit at a recorded near-tie."""
    flipped = np.flatnonzero((got != want).any(-1).any(-1))
    if not flipped.size:
        return got.shape[0]
    t = int(flipped[0])
    for b in np.flatnonzero((got[t] != want[t]).any(-1)):
        margin = min(q_margin[t, b], xhat_margin[t, b])
        assert margin <= NEAR_TIE, (f"slot {t} fleet {b}: decision differs "
                                    f"at margin {margin:.3g}")
    return t


@pytest.mark.parametrize("scenario", ["dyn_poisson", "dyn_bursty",
                                      "dyn_churn", "dyn_markov_channel"])
def test_driver_on_dynamic_scenarios_equals_jax(golden, scenario):
    """Every poisson/mmpp scenario, B=4 fleets, T=16, the trained GRLE:
    the port's driver fed the JAX driver's raw workload draws (its own
    workload state advancing on them) makes the JAX decisions, or differs
    first at a recorded near-tie (<= 1e-5), and up to there the same
    activity, rewards and q_est within 1e-5."""
    want, draws, ref = jax_dyn_run(scenario, golden, seed=12)
    env = MECEnv(make_scenario(scenario), device="cpu")
    drv = RolloutDriver(agent_def("grle", env, device="cpu"), 4,
                        train=False, device="cpu")
    st = agent_state_from_params(drv.adef, golden["params"],
                                 golden["exit_mask"])
    _, trace = drv.run(0, 16, mode="loop", agent_state=st,
                       draws=dyn_slot_draws(draws))
    stop = first_flip(trace.decisions.numpy(), want["decisions"],
                      ref["q_margin"], ref["xhat_margin"])
    assert stop >= 12
    cut = slice(0, stop)
    np.testing.assert_array_equal(trace.active.numpy()[cut],
                                  want["active"][cut])
    assert 0 < want["active"].mean() < 1
    np.testing.assert_allclose(trace.reward.numpy()[cut],
                               want["reward"][cut], rtol=TOL, atol=1e-7)
    np.testing.assert_allclose(trace.q_est.numpy()[cut], want["q_est"][cut],
                               rtol=TOL)


def dyn_driver(b, per_fleet, method="grle", scenario="dyn_churn"):
    env = MECEnv(make_scenario(scenario, n_devices=5), device="cpu")
    adef = agent_def(method, env, device="cpu", hidden=(16, 8))
    return RolloutDriver(adef, b, train=False, per_fleet_scenarios=per_fleet,
                         device="cpu")


def space_sp(b, seed=0):
    return scenario_space("dyn_churn", "dyn_markov_channel", n_devices=5,
                          device="cpu").sample_batch(
        torch.Generator().manual_seed(seed), b)


@pytest.mark.parametrize("method", ["grle", "droo"])
def test_per_fleet_run_equals_one_fleet_runs(method):
    """A B=3 run with one scenario per fleet equals, fleet by fleet, runs
    each under one fleet's scenario, on the same draws: bit for bit the
    B=3 runs with that scenario shared (one batch shape, so one summation
    order), and one-fleet runs with equal decisions and activity, the
    rest within 1e-6. This is the check that every knob is read per
    fleet, not as the first fleet's."""
    b, n_slots = 3, 12
    sp = space_sp(b)
    drv = dyn_driver(b, True, method)
    st = drv.adef.init(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    k, m, n, l = drv.adef.n_random, 5, drv.env.N, drv.env.L

    def u(*shape):
        return torch.rand(shape, generator=gen)

    slot = SlotUniforms(u(n_slots, b, m), u(n_slots, b, m, n),
                        u(n_slots, b, n, l), u(n_slots, b, m, n))
    wl = WorkloadDraws(u(n_slots, b), u(n_slots, b, m), u(n_slots, b, m),
                       u(n_slots, b, m, n), u(n_slots, b, n), slot)
    init = InitDraws(u(b, m, n), u(b, n))
    rand = torch.randint(0, n * l, (n_slots, b, k, m), generator=gen)
    draws = SlotDraws(None, rand, init=init, workload=wl)
    assert len({float(x) for x in sp.arrival_rate}) == b
    _, whole = drv.run(0, n_slots, mode="loop", agent_state=st, sp=sp,
                       draws=draws)
    shared, one = dyn_driver(b, False, method), dyn_driver(1, True, method)
    for i in range(b):
        sp_i = ScenarioParams(*(x[i] for x in sp))
        _, same_shape = shared.run(0, n_slots, mode="loop", agent_state=st,
                                   sp=sp_i, draws=draws)
        d_i = SlotDraws(
            None, rand[:, i:i + 1],
            init=InitDraws(*(x[i:i + 1] for x in init)),
            workload=tree_refill(wl, (x[:, i:i + 1]
                                      for x in tree_tensors(wl))))
        _, alone = one.run(0, n_slots, mode="loop", agent_state=st,
                           sp=ScenarioParams(*(x[i:i + 1] for x in sp)),
                           draws=d_i)
        for name, x, y, z in zip(whole._fields, whole, same_shape, alone):
            if x.dim() < 2:                   # the loss, NaN: no training
                continue
            assert torch.equal(x[:, i], y[:, i]), (i, name)
            if x.dtype in (torch.float32,):
                np.testing.assert_allclose(z[:, 0].numpy(), x[:, i].numpy(),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"{i} {name}")
            else:
                assert torch.equal(x[:, i], z[:, 0]), (i, name)


def test_scan_equals_loop_dynamic_per_fleet():
    """dyn_churn with one scenario per fleet, training on: scan and loop
    bit for bit on one seed of the driver's own generator; a swapped
    ``sp`` of the same shapes replays the same compiled episode."""
    env = MECEnv(make_scenario("dyn_churn", n_devices=4), device="cpu")
    adef = agent_def("drooe", env, device="cpu")
    drv = RolloutDriver(adef, 3, train=True, replay_capacity=32,
                        batch_size=8, train_every=5, telemetry=True,
                        per_fleet_scenarios=True, device="cpu")
    sp = scenario_space("dyn_churn", "dyn_markov_channel", n_devices=4,
                        device="cpu").sample_batch(
        torch.Generator().manual_seed(0), 3)
    loop = drv.run(5, 25, mode="loop", sp=sp)
    scan = drv.run(5, 25, mode="scan", sp=sp)
    assert_same_run(loop, scan)
    assert int(scan[0].agent_state.loss_count) == 5
    episode = drv._episode
    sp2 = ScenarioParams(*(x.flip(0) for x in sp))
    scan2 = drv.run(5, 25, sp=sp2)
    assert drv._episode is episode
    assert_same_run(drv.run(5, 25, mode="loop", sp=sp2), scan2)
    assert not torch.equal(scan2[1].reward, scan[1].reward)
    with pytest.raises(ValueError, match="leading"):
        drv.run(5, 25, sp=ScenarioParams(*(x[0] for x in sp)))


def test_driver_refuses_mismatched_draws_and_sp():
    drv = dyn_driver(2, False)
    with pytest.raises(ValueError, match="sp.task_kb"):
        drv.run(0, 3, sp=space_sp(2))
    iid = small_driver(train=False)
    init = InitDraws(torch.zeros(2, 4, 2), torch.zeros(2, 2))
    with pytest.raises(ValueError, match="iid"):
        iid.run(0, 3, draws=SlotDraws(None, torch.zeros(
            3, 2, 16, 4, dtype=torch.int64), init=init))


def test_agent_shim_through_the_driver_equals_agent_def():
    """``make_agent`` (the deprecated ``OffloadingAgent``) drives the
    driver as its ``AgentDef`` and state do; ``sync_agent`` writes the
    result back into it."""
    env = MECEnv(make_scenario("dyn_bursty", n_devices=4), device="cpu")
    with pytest.warns(DeprecationWarning):
        shim = make_agent("droo", env, 3, buffer_size=32, batch_size=8,
                          train_every=5)
    assert shim.adef.actor == "mlp" and not shim.early_exit
    drv = RolloutDriver(shim, 2, device="cpu")
    adef = agent_def("droo", env, device="cpu", buffer_size=32,
                     batch_size=8, train_every=5)
    st = adef.init(torch.Generator().manual_seed(3))
    for a, b in zip(tree_tensors(st.params), tree_tensors(shim.state.params)):
        assert torch.equal(a, b)
    via_shim = drv.run(4, 20)
    direct = RolloutDriver(adef, 2, device="cpu").run(4, 20, agent_state=st)
    assert_same_run(via_shim, direct)
    drv.sync_agent(via_shim[0])
    assert shim.state is via_shim[0].agent_state
    with pytest.raises(ValueError, match="AgentDef"):
        RolloutDriver(adef, 2, device="cpu").sync_agent(direct[0])
    dec, info = shim.act(env.reset(), env.sample_slot(shim.generator))
    assert dec.shape == (4,) and "q_est" in info


def test_chip_smoke_reads_the_profilers_raw_records_as_its_events():
    """``chip_smoke.profiler_records`` reads a window's raw results without
    building ``prof.events()``'s tree, and gives every record the tree
    gives, with the same name, host or device, duration and correlation
    id, here for a loop-mode episode on the CPU with the driver's phase
    spans in it; the records the tree drops are host ops nested in one of
    the same name (its duplicate removal), never a device record or a
    graph launch."""
    import collections
    import importlib.util

    from torch.profiler import ProfilerActivity, profile

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(root, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    env = MECEnv(make_scenario("fig5_baseline", n_devices=4), device="cpu")
    drv = RolloutDriver(agent_def("grle", env, device="cpu"), 2,
                        device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        drv.run(0, 3, mode="loop")
    cuda = torch.autograd.DeviceType.CUDA
    got = collections.Counter((r.name, r.on_device, r.corr, round(r.us, 3))
                              for r in chip_smoke.profiler_records(prof))
    want = collections.Counter(
        (e.name, e.device_type == cuda, e.id,
         round(e.time_range.elapsed_us(), 3)) for e in prof.events())
    assert sum(want.values()) > 100 and not want - got
    extra = got - want
    assert all(not on_device and name != "cudaGraphLaunch"
               and any(n == name for n, *_ in want)
               for name, on_device, *_ in extra)
