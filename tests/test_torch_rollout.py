"""The port's GRLE decision path as a whole, against the JAX driver.

The JAX ``RolloutDriver(train=False).run(mode="loop")`` draws its tasks
and exploration candidates from threefry keys; those draws are rebuilt
from the driver's key schedule (``tools/make_torch_port_golden.py``) and
injected into the port's driver, which must then make the same decisions.
``tests/data/torch_port_golden.npz`` carries one such run (fig5_baseline)
to the GPU machine, where JAX is not installed; the first test here keeps
it current.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import agent_def, agent_state_from_params
from repro_torch.mec import MECEnv, MECState, SlotTasks, make_scenario
from repro_torch.rollout import RolloutDriver, SlotDraws

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


def port_run(name, golden, tasks, rand):
    env = MECEnv(make_scenario(name), device="cpu")
    drv = RolloutDriver(agent_def("grle", env, device="cpu"),
                        rand.shape[1], train=False, device="cpu")
    st = agent_state_from_params(drv.adef, golden["params"],
                                 golden["exit_mask"])
    draws = SlotDraws(
        SlotTasks(*(torch.tensor(tasks[f]) for f in SlotTasks._fields)),
        torch.tensor(rand.astype(np.int64)))
    carry, trace = drv.run(0, rand.shape[0], agent_state=st, draws=draws)
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
    c1, t1 = drv.run(3, golden_tool.N_SLOTS, agent_state=st)
    _, t2 = drv.run(3, golden_tool.N_SLOTS, agent_state=st)
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
