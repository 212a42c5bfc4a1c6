"""The paper's §VI experiments through the port (``repro_torch.figures``)
against the JAX package, and the launch specs' struct functions called the
reference's way.

* The struct functions (``launch/specs.py``): ``params_struct(cfg, mesh)``
  and ``train_state_struct(cfg, mesh)`` return the reference's tuples, the
  structs one device's shards of the reference's, the specs leaf for leaf
  the reference's, on the production mesh and on a host mesh.
* ``rollout_method`` replayed on the reference's draws
  (``tests/data/torch_figures_golden.npz``, ``tools/
  make_torch_figures_golden.py``): all four methods at M=6, τ = 30 ms, 100
  slots (4 train steps); decisions equal up to a flip at a recorded
  near-tie, the losses within 1e-5 relative, the ``RunningMetrics``
  summary within 1e-6.
* Fig 4's rows: the moving windows against the reference's formulas, and
  a short run's layout.
* The learning check at the CPU cut against the reference's per-seed rows,
  with the learning rate 1e-12 control rejected.
* The runner ``python -m repro_torch.figures``.
"""
import json
import os
import sys
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_arch as jax_get_arch
from repro.core import make_agent as jax_make_agent
from repro.launch import mesh as jax_mesh
from repro.launch import specs as jax_specs
from repro.mec import MECEnv as JaxEnv
from repro.mec import make_scenario as jax_scenario
from repro_torch.configs import get_arch
from repro_torch.core.bridge import params_from_numpy
from repro_torch.figures import FIGURES, METHODS, RunDraws, common
from repro_torch.figures import convergence, learning
from repro_torch.figures.__main__ import main as figures_main
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.mec import SlotTasks
from repro_torch.sharding import PSpec

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import make_torch_port_golden as golden_tool  # noqa: E402

sys.path.pop(0)
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_figures_golden.npz")
NEAR_TIE = 1e-5       # a flipped decision must sit at such a margin
LOSS_RTOL = 1e-5
SUMMARY_TOL = 1e-6
# benchmarks/common.py::rollout_method's row keys
ROW_KEYS = {"ssp", "avg_accuracy", "throughput_tps", "avg_reward", "tasks",
            "method", "scenario", "n_devices", "slot_ms", "slots", "wall_s"}
STAMPS = {"backend", "git_rev", "torch_version"}


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


# ------------------------------------------------ the struct functions
def _key(entry) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(entry)


def jax_flat(tree, leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=None if leaf is None else
        (lambda x: isinstance(x, leaf)))
    return {"/".join(_key(e) for e in path): x for path, x in flat}


def port_flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(port_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def meshes(kind: str):
    """(port mesh, the reference's mesh of the same shape)."""
    if kind == "production":
        mesh = make_production_mesh()
        return mesh, AbstractMesh(mesh.shape, mesh.mesh_dim_names)
    return make_host_mesh(), jax_mesh.make_host_mesh()


def assert_struct_and_specs(got, want) -> None:
    """Port leaves are one device's shard of the reference's leaves (same
    paths, dtypes, and the reference sharding's ``shard_shape``); the specs
    are the reference's leaf for leaf."""
    (struct, pspecs), (jstruct, jspecs) = got, want
    mine = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in port_flat(struct).items()}
    ref = {p: (tuple(x.sharding.shard_shape(x.shape)), str(x.dtype))
           for p, x in jax_flat(jstruct).items()}
    assert mine == ref
    assert all(t.device.type == "meta" for t in port_flat(struct).values())
    mine, ref = port_flat(pspecs), jax_flat(jspecs, jax.sharding.
                                            PartitionSpec)
    assert sorted(mine) == sorted(ref)
    for path, spec in ref.items():
        assert isinstance(mine[path], PSpec), path
        assert tuple(mine[path]) == tuple(spec), (path, mine[path], spec)


@pytest.mark.parametrize("mesh_kind", ["production", "host"])
@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_moe_16b"])
def test_struct_functions_are_called_as_the_reference(arch, mesh_kind):
    """``params_struct(cfg, mesh)`` -> ``(struct, specs)`` and
    ``train_state_struct(cfg, mesh)`` -> ``(state, specs, optimizer)``,
    positionally in both packages, as ``repro/launch/dryrun.py`` calls
    them."""
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    mesh, jmesh = meshes(mesh_kind)
    got, want = specs.params_struct(cfg, mesh), jax_specs.params_struct(
        jcfg, jmesh)
    assert len(got) == len(want) == 2
    assert_struct_and_specs(got, want)
    got = specs.train_state_struct(cfg, mesh)
    want = jax_specs.train_state_struct(jcfg, jmesh)
    assert len(got) == len(want) == 3
    assert_struct_and_specs(got[:2], want[:2])
    assert callable(got[2].init) and callable(got[2].update)


# ------------------------------------------------------- the replay
def replay_draws(gold: dict, method: str) -> RunDraws:
    env = common.MECEnv(common.make_scenario(
        str(gold["replay/scenario"]), n_devices=int(gold["replay/n_devices"])),
        device="cpu")
    p = f"replay/{method}"
    return RunDraws(
        params_from_numpy(golden_tool.tree_of(gold, f"{p}/params"), "cpu",
                          dims=(env.M, env.N, env.L)),
        SlotTasks(*(torch.tensor(gold[f"replay/tasks/{f}"])
                    for f in SlotTasks._fields)),
        torch.tensor(gold[f"{p}/rand_cands"].astype(np.int64)),
        torch.tensor(gold[f"{p}/replay_take"]))


@pytest.mark.parametrize("method", METHODS)
def test_rollout_method_replays_the_reference(golden, method, monkeypatch):
    """The port's ``rollout_method`` on the reference's draws and initial
    params: its decisions are the reference's up to a flip at a recorded
    near-tie (after which the comparison stops), each loss before it
    within 1e-5 relative and, without a flip, the summary within 1e-6.
    The golden file's initial params and first tasks are the reference's
    own (``make_agent`` from ``PRNGKey(seed)``, ``sample_slot``)."""
    g = golden
    m, tau = int(g["replay/n_devices"]), float(g["replay/slot_ms"])
    slots, seed = int(g["replay/slots"]), int(g["replay/seed"])
    scenario = str(g["replay/scenario"])
    jenv = JaxEnv(jax_scenario(scenario, n_devices=m, slot_ms=tau))
    key = jax.random.PRNGKey(seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jagent = jax_make_agent(method, jenv, key, seed=seed)
    want = golden_tool.flat_tree(f"replay/{method}/params",
                                 jax.tree_util.tree_map(np.asarray,
                                                        jagent.state.params))
    assert sorted(want) == sorted(k for k in g if k.startswith(
        f"replay/{method}/params/"))
    for k, x in want.items():
        np.testing.assert_array_equal(g[k], x, err_msg=k)
    _, sk = jax.random.split(key)
    first = jenv.sample_slot(sk)
    for f in SlotTasks._fields:
        np.testing.assert_array_equal(g[f"replay/tasks/{f}"][0],
                                      np.asarray(getattr(first, f)))

    agents, decisions = [], []
    make_agent = common.make_agent

    def recording(*args, **kw):
        agent = make_agent(*args, **kw)
        act = agent.act

        def rec_act(*a, **k):
            out = act(*a, **k)
            decisions.append(out[0].numpy())
            return out

        agent.act = rec_act
        agents.append(agent)
        return agent

    monkeypatch.setattr(common, "make_agent", recording)
    row = common.rollout_method(method, scenario, n_devices=m, slot_ms=tau,
                                slots=slots, seed=seed, device="cpu",
                                draws=replay_draws(g, method))
    assert set(row) == ROW_KEYS
    dec = np.stack(decisions)
    ref = g[f"replay/{method}/decisions"]
    flips = np.flatnonzero((dec != ref).any(-1))
    stop = int(flips[0]) if flips.size else slots
    if flips.size:
        margin = min(g[f"replay/{method}/q_margin"][stop],
                     g[f"replay/{method}/xhat_margin"][stop])
        assert margin <= NEAR_TIE, (
            f"{method}: decision differs at slot {stop}, margin {margin:.3g}")
    want_loss = g[f"replay/{method}/loss"]
    n_loss = int(np.isfinite(want_loss[:stop]).sum())
    assert n_loss >= (3 if stop == slots else 0)
    np.testing.assert_allclose(agents[0].loss_history[:n_loss],
                               want_loss[np.isfinite(want_loss)][:n_loss],
                               rtol=LOSS_RTOL)
    if stop == slots:
        assert len(agents[0].loss_history) == n_loss
        for k in ("ssp", "avg_accuracy", "throughput_tps", "avg_reward",
                  "tasks"):
            np.testing.assert_allclose(
                row[k], g[f"replay/{method}/summary/{k}"], rtol=SUMMARY_TOL,
                atol=SUMMARY_TOL, err_msg=k)


# ------------------------------------------------------------ Fig 4
def test_convergence_rows_follow_the_reference_formulas():
    """``loop_row`` and ``scan_row`` against ``benchmarks/convergence.py``'s
    own expressions on the same arrays."""
    rng = np.random.default_rng(0)
    ratios, losses = rng.uniform(0.5, 1.0, 37), rng.uniform(0.2, 0.7, 12)
    row = convergence.loop_row("grle", ratios, list(range(0, 370, 10)),
                               list(losses))
    win = max(1, 50 // 10)
    moving = np.convolve(ratios, np.ones(win) / win, mode="valid")
    assert row["final_moving_Qhat"] == float(moving[-1])
    assert row["max_moving_Qhat"] == float(moving.max())
    assert row["final_loss"] == float(np.mean(losses[-5:]))
    assert row["Qhat_curve"] == [round(float(x), 4) for x in ratios]
    assert row["loss_curve"] == [round(float(v), 4) for v in losses]
    reward = rng.uniform(0.0, 3.0, (120, 3))
    trace_loss = np.full(120, np.nan)
    trace_loss[69::10] = rng.uniform(0.2, 0.7, 6)
    row = convergence.scan_row("drooe", 3, reward, trace_loss)
    mean = reward.mean(axis=1)
    moving = np.convolve(mean, np.ones(50) / 50, mode="valid")
    kept = trace_loss[~np.isnan(trace_loss)]
    assert row["method"] == "drooe_scan_B3"
    assert row["final_moving_reward"] == float(moving[-1])
    assert row["max_moving_reward"] == float(moving.max())
    assert row["final_loss"] == float(np.mean(kept[-5:]))
    assert row["reward_curve_slots"] == list(range(0, 120, 10))
    assert row["reward_curve"] == [round(float(x), 4) for x in mean[::10]]
    assert row["loss_curve"] == [round(float(v), 4) for v in kept]
    assert convergence.loop_row("grle", ratios, [], [])["final_loss"] is None


def test_convergence_runs_lay_out_the_reference_rows():
    """A short per-slot run (Q̂ against the oracle every 10 slots, two
    train steps) and a short two-fleet scan run: the reference's row keys
    (and ``wall_s``), a Q̂ check every 10 slots in (0, 1.5], finite
    losses."""
    row = convergence.loop_convergence("grle", slots=80, device="cpu")
    assert set(row) == {"method", "final_moving_Qhat", "max_moving_Qhat",
                        "final_loss", "Qhat_curve_slots", "Qhat_curve",
                        "loss_curve", "wall_s"}
    assert row["Qhat_curve_slots"] == list(range(0, 80, 10))
    assert all(0.0 < q <= 1.5 for q in row["Qhat_curve"])
    assert len(row["loss_curve"]) == 2 and np.isfinite(row["final_loss"])
    row = convergence.scan_convergence("drooe", slots=80, n_fleets=2,
                                       device="cpu")
    assert set(row) == {"method", "final_moving_reward",
                        "max_moving_reward", "final_loss",
                        "reward_curve_slots", "reward_curve", "loss_curve",
                        "wall_s"}
    assert row["method"] == "drooe_scan_B2"
    assert row["reward_curve_slots"] == list(range(0, 80, 10))
    # two fleets fill the 64-row minibatch at slot 32: steps at 40..80
    assert len(row["loss_curve"]) == 5 and np.isfinite(row["final_loss"])


# ------------------------------------------------- the learning check
def test_learning_check_matches_the_reference_and_rejects_the_control(
        golden, capsys):
    """At ``learning.CPU_SPEC`` (the golden file's spec): per method the
    port's mean ``final_loss``, ``ssp`` and ``avg_accuracy`` over 16 seeds
    within ``LEARN_SE`` standard errors of the reference's mean, and the
    first 4 seeds' cells at learning rate 1e-12 outside it on
    ``final_loss``."""
    spec = learning.CPU_SPEC
    assert str(golden["learn/cpu/spec"]) == learning.spec_json(spec)
    ref = {k[len("learn/cpu/"):]: v for k, v in golden.items()
           if k.startswith("learn/cpu/")}
    assert all((ref[f"{m}/train_steps"] == 5).all() for m in spec["methods"])
    res = learning.learning_check(spec, ref, device="cpu")
    report = capsys.readouterr().out
    assert res["ok"], report
    assert res["control_rejected"], report
    assert {g["n"] for g in res["trained"]} == {16}
    assert {g["n"] for g in res["control"]} == {learning.CONTROL_SEEDS}


def test_learning_check_specs_are_the_golden_files(golden):
    """Both cuts' specs are the golden file's, and the card's has the
    reference's 54 train steps in every cell."""
    assert str(golden["learn/card/spec"]) == learning.spec_json(
        learning.CARD_SPEC)
    for m in learning.CARD_SPEC["methods"]:
        assert (golden[f"learn/card/{m}/train_steps"] == 54).all()
        assert golden[f"learn/card/{m}/final_loss"].shape == (16,)


# ------------------------------------------------------------ the runner
def test_runner_writes_its_rows_and_rejects_unknown_names(
        tmp_path, monkeypatch, capsys):
    """``--quick --only imperfect_csi --device cpu``: the four methods at
    M ∈ {6, 10}, τ = 30 ms, 150 slots, in ``REPRO_RESULTS`` with the
    reference's row keys and the stamps, nothing in the history; an
    unknown name exits 2 naming the known ones; without a card the default
    device raises."""
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path))
    monkeypatch.setenv("REPRO_HISTORY", "")
    out = figures_main(["--quick", "--only", "imperfect_csi", "--device",
                        "cpu"])
    rows = json.loads((tmp_path / "torch_imperfect_csi.json").read_text())
    assert rows == json.loads(json.dumps(out["imperfect_csi"]))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "torch_imperfect_csi.json"]
    assert [(r["method"], r["n_devices"], r["slot_ms"]) for r in rows] == [
        (m, d, 30.0) for m in METHODS for d in (6, 10)]
    for r in rows:
        assert set(r) == ROW_KEYS | STAMPS and r["backend"] == "cpu"
        assert r["slots"] == 150 and r["scenario"] == "fig8_csi"
        assert 0.0 <= r["ssp"] <= 1.0 and 0.0 <= r["avg_accuracy"] <= 1.0
    assert "imperfect_csi/grle_over_drooe,,max=" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        figures_main(["--only", "vary_device"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "vary_device (did you mean vary_devices" in err
    assert all(name in err for name in FIGURES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        figures_main(["--quick", "--only", "imperfect_csi"])


# ---------------------------------------------- chip_smoke.py's phase 47
@pytest.fixture(scope="module")
def chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("method", ["grle", "drooe"])
def test_chip_phase_counts_the_train_steps_the_gate_makes_due(
        chip_smoke, method):
    """Phase 47's launch gate reads the agent's own train gate: 34 steps
    in Fig 4's 400 slots, 2 in an 80-slot column run, as many as a CPU
    run of ``rollout_method``'s agent takes."""
    from repro_torch.core import agent_def
    from repro_torch.mec import MECEnv, make_scenario
    env = MECEnv(make_scenario("fig5_baseline", n_devices=6), device="cpu")
    adef = agent_def(method, env, device="cpu")
    assert chip_smoke.due_steps(adef, chip_smoke.FIG4_SLOTS) == 34
    assert chip_smoke.due_steps(adef, chip_smoke.FIG_SLOTS) == 2
    agents = []
    make_agent = common.make_agent

    def recording(*args, **kw):
        agents.append(make_agent(*args, **kw))
        return agents[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "make_agent", recording)
        common.rollout_method(method, "fig5_baseline", n_devices=6,
                              slot_ms=30.0, slots=90, device="cpu")
    assert len(agents[0].loss_history) == chip_smoke.due_steps(adef, 90) == 3


def test_save_rows_writes_the_file_and_names_the_history_records(
        tmp_path, monkeypatch):
    """``obs.rows.save_rows``: the stamped rows in
    ``REPRO_RESULTS/torch_<name>.json``; one history record per row, named
    as the reference's CSV digest names a row without a ``name`` (the
    module/method-M-tau label), its metrics the numeric row entries but
    the stamps, with the rows' own ``n_devices`` (M) kept."""
    from repro_torch.obs import HistoryStore
    from repro_torch.obs.rows import NON_METRIC_KEYS, save_rows
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path / "res"))
    monkeypatch.setenv("REPRO_HISTORY", str(tmp_path / "hist"))
    rows = [dict(method=m, n_devices=6, slot_ms=30.0, ssp=0.5,
                 avg_accuracy=0.25, wall_s=1.0) for m in ("grle", "droo")]
    path = save_rows("vary_devices", rows, torch.device("cpu"))
    assert path == str(tmp_path / "res" / "torch_vary_devices.json")
    saved = json.loads(open(path).read())
    assert saved == rows and all(r["n_devices"] == 6 for r in saved)
    assert all(set(r) == {"method", "n_devices", "slot_ms", "ssp",
                          "avg_accuracy", "wall_s"} | STAMPS for r in saved)
    recs = HistoryStore(str(tmp_path / "hist")).records(kind="bench")
    assert [r["name"] for r in recs] == ["vary_devices/grle-M6-t30.0",
                                         "vary_devices/droo-M6-t30.0"]
    assert recs[0]["metrics"] == {"slot_ms": 30.0, "ssp": 0.5,
                                  "avg_accuracy": 0.25, "wall_s": 1.0}
    assert not set(recs[0]["metrics"]) & set(NON_METRIC_KEYS)
