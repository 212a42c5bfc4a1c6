"""Two ``PopulationTrainer`` generations of the port against the
reference's, through ``tests/data/torch_pop_golden.npz``.

The file holds a JAX ``repro.pop.PopulationTrainer`` run (GRLE on
fig5_baseline..fig8_csi at M=5, P=4 members with sampled hypers, B=2,
T=15, 4 regions, PBT every generation; ``tools/make_torch_port_golden.py
::build_pop``) with every draw it made: the hyperparameter uniforms, the
curriculum's regions and offsets, each member's tasks, Gumbel exploration
noise (which, under a member's explore_gain, picks candidates that depend
on its actor) and replay rows, and PBT's coin and jitters. The port's
trainer replays it on the CPU from the stored initial params and hypers:
every decision equal, or a flip only at a recorded near-tie, after which
the comparison stops; per member metrics within 1e-5; PBT's sources,
copies and ranks exact; hypers and the curriculum state within 1e-6;
reports, telemetry counters and history records as the reference's; the
final params within rtol 1e-4 / atol 2e-7. ``test_pop_golden_is_current``
rebuilds the file's run with the JAX package.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import agent_def
from repro_torch.mec import MECEnv, SlotTasks, make_scenario
from repro_torch.mec.scenarios import scenario_space
from repro_torch.nn.pytree import flatten_dict
from repro_torch.obs.history import HistoryStore
from repro_torch.obs.telemetry import telemetry_host
from repro_torch.pop import Curriculum, MemberHypers, PopulationTrainer
from repro_torch.pop.pbt import PBTDraws
from repro_torch.pop.trainer import GenerationDraws
from repro_torch.rollout import SlotDraws

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import make_torch_port_golden as golden_tool  # noqa: E402

sys.path.pop(0)
torch.set_num_threads(1)

NEAR_TIE = 1e-5
METRIC_TOL = 1e-5      # per-member avg_reward / ssp / avg_accuracy
HYPER_TOL = 1e-6       # hypers and the curriculum state
PARAM_TOL = dict(rtol=1e-4, atol=2e-7)
MARGINS = ("q_margin", "xhat_margin", "cand_margin")


@pytest.fixture(scope="module")
def gold():
    with np.load(golden_tool.POP_GOLDEN) as z:
        return {k: z[k] for k in z.files}


def t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def port_trainer(history=None):
    c = golden_tool.POP
    env = MECEnv(make_scenario(c["space"][0], n_devices=c["n_devices"]),
                 device="cpu")
    adef = agent_def(c["method"], env, device="cpu")
    space = scenario_space(*c["space"], n_devices=c["n_devices"],
                           device="cpu")
    return PopulationTrainer(
        adef, Curriculum(space.lo, space.hi, n_regions=c["regions"]),
        n_members=c["members"], n_fleets=c["fleets"], n_slots=c["slots"],
        seed=c["seed"], replay_capacity=c["replay"], batch_size=c["batch"],
        train_every=c["train_every"], telemetry=True, history=history,
        history_name="pop")


def generation_draws(gold, g) -> GenerationDraws:
    pre = f"gen{g}"
    members = [SlotDraws(
        SlotTasks(*(t(gold[f"{pre}/m{i}/tasks/{f}"])
                    for f in SlotTasks._fields)), None,
        t(gold[f"{pre}/m{i}/replay_take"], torch.int64),
        gumbel=t(gold[f"{pre}/m{i}/gumbel"]))
        for i in range(golden_tool.POP["members"])]
    return GenerationDraws(
        region=t(gold[f"{pre}/region"]), offset=t(gold[f"{pre}/offset"]),
        members=members, pbt=PBTDraws(*(t(gold[f"{pre}/pbt/{k}"])
                                        for k in ("up", "gain", "tau"))))


def first_flip(gold, g, i, decisions):
    """The first slot at which ``decisions`` part from member i's of
    generation g (None: never); fails unless it sits at a recorded
    near-tie."""
    pre = f"gen{g}/m{i}"
    diff = np.argwhere((decisions != gold[f"{pre}/decisions"]).any(-1))
    if not diff.size:
        return None
    s, b = diff[0]
    margin = min(float(gold[f"{pre}/{k}"][s, b]) for k in MARGINS)
    assert margin <= NEAR_TIE, (f"gen {g} member {i}: decision differs at "
                                f"slot {s} fleet {b}, margin {margin:.3e}")
    return int(s)


def test_trainer_replays_reference_generations(gold, tmp_path):
    store = HistoryStore(str(tmp_path / "hist"))
    tr = port_trainer(history=store)
    ts = tr.init_state()
    init = golden_tool.tree_of(gold, "init/params")
    params = {layer: {leaf: t(init[layer][leaf]) for leaf in leaves}
              for layer, leaves in ts.pop.agents.params.items()}
    hyp = MemberHypers(*(t(gold[f"init/hypers/{f}"])
                         for f in MemberHypers._fields))
    ts = ts._replace(pop=ts.pop._replace(
        agents=ts.pop.agents._replace(params=params), hypers=hyp))
    for g in range(golden_tool.POP["generations"]):
        pre = f"gen{g}"
        ts, rep, det = tr.generation(ts, draws=generation_draws(gold, g),
                                     detail=True)
        flips = [first_flip(gold, g, i, tr_.decisions.numpy())
                 for i, tr_ in enumerate(det.traces)]
        if any(f is not None for f in flips):
            return              # the run left the golden one at a near-tie
        for i, trace in enumerate(det.traces):
            np.testing.assert_allclose(trace.reward.numpy(),
                                       gold[f"{pre}/m{i}/reward"],
                                       rtol=METRIC_TOL, atol=1e-7)
            np.testing.assert_array_equal(np.isnan(trace.loss.numpy()),
                                          np.isnan(gold[f"{pre}/m{i}/loss"]))
        for k in ("avg_reward", "ssp", "avg_accuracy", "tasks",
                  "train_steps", "final_loss"):
            np.testing.assert_allclose(det.metrics[k].numpy(),
                                       gold[f"{pre}/mets/{k}"],
                                       rtol=METRIC_TOL, err_msg=k)
        for k in ("src", "copied", "ranks"):
            got = getattr(det.stats, k).numpy()
            np.testing.assert_array_equal(got, gold[f"{pre}/stats/{k}"])
            assert got.dtype == gold[f"{pre}/stats/{k}"].dtype
        for f in MemberHypers._fields:
            np.testing.assert_allclose(getattr(ts.pop.hypers, f).numpy(),
                                       gold[f"{pre}/hypers/{f}"],
                                       rtol=HYPER_TOL, err_msg=f)
        np.testing.assert_allclose(ts.cur.score.numpy(),
                                   gold[f"{pre}/cur/score"], rtol=HYPER_TOL)
        np.testing.assert_array_equal(ts.cur.visits.numpy(),
                                      gold[f"{pre}/cur/visits"])
        assert rep["generation"] == g and rep["arm"] == "curriculum"
        assert rep["best_member"] == int(gold[f"{pre}/report/best_member"])
        assert rep["region_visits"] == \
            gold[f"{pre}/report/region_visits"].tolist()
        for k, v in rep["metrics"].items():
            np.testing.assert_allclose(v, gold[f"{pre}/report/{k}"],
                                       rtol=METRIC_TOL, err_msg=k)
    assert int(ts.pop.generation) == golden_tool.POP["generations"]
    want = flatten_dict(golden_tool.tree_of(gold, "final/params"))
    got = flatten_dict(ts.pop.agents.params)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=k,
                                   **PARAM_TOL)
    host = telemetry_host(tr.telemetry)
    for k, v in host["counters"].items():
        assert v == float(gold[f"telemetry/{k}"]), k
    for k, h in host["hists"].items():
        np.testing.assert_array_equal(h["counts"],
                                      gold[f"telemetry/hist/{k}"])
    recs = [r for r in store.records() if r["kind"] == "pop"]
    assert len(recs) == golden_tool.POP["generations"]
    for j, r in enumerate(recs):
        assert r["name"] == "pop"
        for k, v in r["metrics"].items():
            np.testing.assert_allclose(v, gold[f"history/{j}/{k}"],
                                       rtol=METRIC_TOL, err_msg=k)


def test_pop_golden_is_current(gold):
    """Rebuilding the golden run with the JAX package gives the stored
    arrays: integers and booleans exactly, floats to 1e-6 (XLA's CPU
    code may round differently on another CPU model)."""
    data = golden_tool.build_pop()
    assert set(data) == set(gold)
    for k, want in gold.items():
        got = np.asarray(data[k])
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
