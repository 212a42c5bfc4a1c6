"""The port's GRLE decision path as a whole, against the JAX driver.

The JAX ``RolloutDriver(train=False).run(mode="loop")`` draws its tasks
and exploration candidates from threefry keys; those draws are rebuilt
from the driver's key schedule (``tools/make_torch_port_golden.py``) and
injected into the port's driver, which must then make the same decisions.
``tests/data/torch_port_golden.npz`` carries one such run (fig5_baseline)
to the GPU machine, where JAX is not installed; the first test here keeps
it current.
"""
import gc
import os
import sys
import weakref

import numpy as np
import pytest
import torch

from repro_torch.core import agent_def, agent_state_from_params
from repro_torch.mec import MECEnv, MECState, SlotTasks, make_scenario
from repro_torch.obs import telemetry_host
from repro_torch.rollout import (RolloutDriver, SlotDraws, carry_metrics,
                                 carry_telemetry, trace_metrics)
from repro_torch.rollout.driver import _tensors

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
    xs, ys = _tensors(a), _tensors(b)
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
    kept = [x.clone() for x in _tensors((c1, t1))]
    drv.run(2, 12)
    for x, y in zip(kept, _tensors((c1, t1))):
        assert torch.equal(torch.nan_to_num(x, nan=7.0),
                           torch.nan_to_num(y, nan=7.0))


def test_telemetry_does_not_perturb_trajectories():
    """The registry only observes: decisions, rewards and the learned
    params are identical with it on and off."""
    c_on, t_on = small_driver(telemetry=True).run(3, 25)
    c_off, t_off = small_driver(telemetry=False).run(3, 25)
    assert torch.equal(t_on.decisions, t_off.decisions)
    assert torch.equal(t_on.reward, t_off.reward)
    for a, b in zip(_tensors(c_on.params), _tensors(c_off.params)):
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
