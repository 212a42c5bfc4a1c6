"""The port's ``PopulationDriver`` against the reference's, live on the
CPU: ``run_generation`` and ``evaluate`` of P=3 GRLE members with
distinct sampled hypers (lr, explore_gain, exit_tau) on one
fig5_baseline..fig8_csi draw each, at M=4, B=2, T=10 (2 train steps).

The reference's population (``jax.vmap(adef.init)``) comes across with
``core/bridge.py::population_from_numpy``; each member's draws (tasks,
Gumbel exploration noise, replay rows) are rebuilt from the reference's
key schedule (``tools/make_torch_port_golden.py::pop_member_episode``)
and injected. Decisions equal (or a flip only at a recorded near-tie,
where the comparison stops), per member metrics within 1e-5, trained
params within rtol 1e-4 / atol 2e-7.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro import pop as jpop
from repro.core.policy import agent_def as jax_agent_def
from repro.mec.env import MECEnv as JaxMECEnv
from repro.mec.scenarios import make_scenario as jax_make_scenario
from repro.mec.scenarios import scenario_space as jax_scenario_space
from repro.pop.population import exit_mask_from_tau as jax_exit_mask
from repro.rollout import RolloutDriver as JaxRolloutDriver
from repro_torch.core import agent_def
from repro_torch.core.bridge import population_from_numpy
from repro_torch.mec import MECEnv, SlotTasks, make_scenario
from repro_torch.mec.config import ScenarioParams
from repro_torch.nn.pytree import flatten_dict
from repro_torch.pop import PopulationDriver
from repro_torch.rollout import SlotDraws

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import make_torch_port_golden as golden_tool  # noqa: E402

sys.path.pop(0)
torch.set_num_threads(1)

NEAR_TIE = 1e-5
METRIC_TOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=2e-7)
P, M, B, T = 3, 4, 2, 10
KW = dict(replay_capacity=16, batch_size=4, train_every=5)


def t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


@pytest.fixture(scope="module")
def world():
    """The reference's population after one generation, its metrics,
    each member's draws and replay, and an evaluation's."""
    jdef = jax_agent_def("grle", JaxMECEnv(jax_make_scenario(
        "fig5_baseline", n_devices=M)))
    key = jax.random.PRNGKey(4)
    pop = jpop.init_population(jdef, key, P, jpop.sample_hypers(
        jax.random.fold_in(key, 1), P))
    space = jax_scenario_space("fig5_baseline", "fig8_csi", n_devices=M)
    sps = space.sample_batch(jax.random.fold_in(key, 2), P)
    pdrv = jpop.PopulationDriver(jdef, n_fleets=B, n_slots=T, mesh=None,
                                 **KW)
    run_key, eval_key = jax.random.fold_in(key, 3), jax.random.fold_in(key, 5)
    trained, mets = pdrv.run_generation(pop, run_key, sps)
    sp = jax.tree_util.tree_map(lambda x: x[0], sps)
    evals = pdrv.evaluate(trained, eval_key, sp)
    eval_drv = JaxRolloutDriver(pdrv.adef, n_fleets=B, train=False)

    def episodes(drv, pop_, key_, sp_of):
        programs = golden_tool._pop_programs(drv)
        out = []
        for i in range(P):
            pick = (lambda x: x[i])
            agent = jax.tree_util.tree_map(pick, pop_.agents)
            hyp = jax.tree_util.tree_map(pick, pop_.hypers)
            agent = agent._replace(exit_mask=jax_exit_mask(drv.adef,
                                                           hyp.exit_tau))
            ep = golden_tool.pop_member_episode(
                drv, programs, agent, jax.random.fold_in(key_, i),
                sp_of(i), hyp, T)
            ep.pop("final_state")
            out.append(ep)
        return out

    np_tree = (lambda tree: jax.tree_util.tree_map(np.asarray, tree))
    return {
        "pop": np_tree(pop._asdict()), "trained": np_tree(trained._asdict()),
        "mets": np_tree(mets), "evals": np_tree(evals),
        "sps": np_tree(sps._asdict()), "sp": np_tree(sp._asdict()),
        "train": episodes(pdrv.drv, pop, run_key, lambda i: jax.tree_util
                          .tree_map(lambda x: x[i], sps)),
        "eval": episodes(eval_drv, trained, eval_key, lambda i: sp),
    }


def port_driver():
    env = MECEnv(make_scenario("fig5_baseline", n_devices=M), device="cpu")
    return PopulationDriver(agent_def("grle", env, device="cpu"),
                            n_fleets=B, n_slots=T, **KW)


def member_draws(eps, train: bool):
    return [SlotDraws(SlotTasks(*(t(ep[f"tasks/{f}"])
                                  for f in SlotTasks._fields)), None,
                      t(ep["replay_take"], torch.int64) if train else None,
                      gumbel=t(ep["gumbel"])) for ep in eps]


def held_slots(eps, traces) -> list:
    """Per member the slots held: all, or those before a flip, which must
    sit at a recorded near-tie."""
    out = []
    for i, (ep, tr) in enumerate(zip(eps, traces)):
        diff = np.argwhere((tr.decisions.numpy() != ep["decisions"]).any(-1))
        if diff.size:
            s, b = diff[0]
            margin = min(float(ep[k][s, b]) for k in
                         ("q_margin", "xhat_margin", "cand_margin"))
            assert margin <= NEAR_TIE, (i, s, b, margin)
        out.append(int(diff[0][0]) if diff.size else T)
    return out


@pytest.mark.parametrize("mode", ["scan", "loop"])
def test_run_generation_matches_reference(world, mode):
    pop = population_from_numpy(world["pop"], "cpu")
    assert len(set(pop.hypers.explore_gain.tolist())) == P
    sps = ScenarioParams(**{k: t(v) for k, v in world["sps"].items()})
    drv = port_driver()
    trained, mets, traces = drv.run_generation(
        pop, 0, sps, draws=member_draws(world["train"], True), mode=mode,
        traces=True)
    held = held_slots(world["train"], traces)
    for i, ep in enumerate(world["train"]):
        np.testing.assert_allclose(traces[i].reward.numpy()[:held[i]],
                                   ep["reward"][:held[i]], rtol=METRIC_TOL,
                                   atol=1e-7)
    if held != [T] * P:
        return                  # a near-tie flip: the runs part there
    for k in ("avg_reward", "ssp", "avg_accuracy", "tasks", "train_steps",
              "final_loss"):
        np.testing.assert_allclose(mets[k].numpy(), world["mets"][k],
                                   rtol=METRIC_TOL, err_msg=k)
    want = population_from_numpy(world["trained"], "cpu")
    got, exp = flatten_dict(trained.agents.params), flatten_dict(
        want.agents.params)
    for k in exp:
        np.testing.assert_allclose(got[k].numpy(), exp[k].numpy(),
                                   err_msg=k, **PARAM_TOL)
    assert int(trained.agents.loss_count[0]) == 2


def test_evaluate_matches_reference(world):
    trained = population_from_numpy(world["trained"], "cpu")
    sp = ScenarioParams(**{k: t(v) for k, v in world["sp"].items()})
    drv = port_driver()
    got = drv.evaluate(trained, 0, sp,
                       draws=member_draws(world["eval"], False))
    assert drv.eval_driver.train is False
    for k in ("avg_reward", "ssp", "avg_accuracy", "tasks"):
        np.testing.assert_allclose(got[k].numpy(), world["evals"][k],
                                   rtol=METRIC_TOL, err_msg=k)
    replayed = np.asarray([ep["reward"].mean() for ep in world["eval"]])
    np.testing.assert_allclose(got["avg_reward"].numpy(), replayed,
                               rtol=METRIC_TOL)
