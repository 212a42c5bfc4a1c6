"""The fleet, member and cell axes over several ranks (PyTorch port), on
gloo CPU process groups of 2 and 4 ranks.

``RolloutDriver.run_sharded`` splits the fleets over a ``fleet`` mesh; the
population splits its members and the sweep its cells. Each is held
against the unsharded run in this process (the reference's contract: the
same decisions, replay ring and params bit for bit, every rank the same)
and the sharded driver also against the JAX training golden, as the
unsharded one is (``tests/test_torch_train.py``). What the ranks run is in
``tests/torch_rank_tasks.py``; one process group per world size serves the
whole module (``RankPool``, a ``file://`` rendezvous under a temporary
directory).

Bit for bit: the fleets' half of a slot runs at B / world fleets a
rank, so its CPU arithmetic must not depend on a fleet's place in the
batch (``mec/env.py`` spells the critic's logistic with ``exp`` for
that: ``torch.sigmoid`` rounds differently in the CPU's vectorized loop
and its scalar tail).
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_rank_tasks as T
from repro_torch.sharding.ranks import RankPool

GOLDEN = Path(__file__).parent / "data" / "torch_port_train_golden.npz"
NEAR_TIE = 1e-5
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=2e-7)
NU_TOL = dict(rtol=1e-4, atol=2e-9)
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """A gloo group of 2 ranks and one of 4, for the whole module."""
    root = tmp_path_factory.mktemp("rdv")
    out = {w: RankPool(w, init_method=f"file://{root}/world{w}")
           for w in WORLDS}
    yield out
    for pool in out.values():
        pool.close()


def same(a, b) -> bool:
    """Equal bit for bit, NaN equal to NaN."""
    a, b = np.atleast_1d(a), np.atleast_1d(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def all_same(xs, ys) -> bool:
    return len(xs) == len(ys) and all(same(x, y) for x, y in zip(xs, ys))


# ------------------------------------------------------------ the driver
SPECS = {
    "iid_telemetry": dict(scenario="fig5_baseline", M=5, B=8, T=25, seed=3,
                          telemetry=True),
    "mmpp_per_fleet": dict(scenario="dyn_bursty", M=4, B=8, T=22, seed=11,
                           per_fleet=True),
    "loop": dict(scenario="fig8_csi", M=4, B=4, T=16, seed=5, mode="loop"),
}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(SPECS))
def test_sharded_episode_equals_unsharded(pools, world, name):
    """``run_sharded`` over ``world`` ranks against the unsharded scan
    episode: the final carry (env and workload state gathered back to
    all B, the ring, params, Adam state, metrics and telemetry) and the
    trace bit for bit on every rank; the host mirrors and the metrics
    summary equal."""
    spec = SPECS[name]
    want = T.driver_episode(dict(spec, mode="scan"), sharded=False)
    got = pools[world].run(T.driver_episode, spec)
    for r, g in enumerate(got):
        assert all_same(g["ring"], want["ring"]), f"rank {r}: ring"
        assert all_same(g["params"], want["params"]), f"rank {r}: params"
        assert all_same(g["carry"], want["carry"]), f"rank {r}: carry"
        assert all_same(g["trace"], want["trace"]), f"rank {r}: trace"
        assert g["metrics"] == want["metrics"]
        assert g["host"] == want["host"]


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _tree_close(got: dict, data: dict, prefix: str, tol: dict) -> None:
    for layer, leaves in got.items():
        for name, x in leaves.items():
            np.testing.assert_allclose(
                x, data[f"{prefix}/{layer}/{name}"], err_msg=f"{prefix} "
                f"{layer}/{name}", **tol)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_episode_trains_as_the_golden(pools, golden, world):
    """The JAX training golden (fig5_baseline at full width M=14, B=4,
    T=64, five train steps), its draws sliced per rank, through
    ``run_sharded`` over ``world`` ranks: held as the unsharded replay is
    (the decisions equal, a flip only at a recorded near-tie <= 1e-5,
    after which the comparison stops; losses 1e-5; final params and Adam
    moments rtol 1e-4, atol 2e-7 (nu 2e-9)); every rank the same."""
    got = pools[world].run(T.golden_episode, golden)
    for g in got[1:]:
        assert all(same(g["trace"][k], got[0]["trace"][k])
                   for k in g["trace"])
        assert g["params"].keys() == got[0]["params"].keys()
        for layer in g["params"]:
            assert all(same(g["params"][layer][n], got[0]["params"][layer][n])
                       for n in g["params"][layer])
    g = got[0]
    dec = g["trace"]["decisions"]
    agree = (dec == golden["trace/decisions"]).all(-1)
    flipped = np.flatnonzero(~agree.all(-1))
    stop = int(flipped[0]) if flipped.size else dec.shape[0]
    for t, b in np.argwhere(~agree[:stop + 1]):
        margin = min(golden["q_margin"][t, b], golden["xhat_margin"][t, b])
        assert margin <= NEAR_TIE, f"slot {t} fleet {b}: margin {margin}"
    assert stop > int(golden["train_slots"][0]) - 1, "flip before training"
    loss, want = g["trace"]["loss"][:stop], golden["trace/loss"][:stop]
    np.testing.assert_array_equal(np.isnan(loss), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(loss[ok], want[ok], rtol=LOSS_RTOL)
    np.testing.assert_allclose(g["trace"]["q_est"][:stop],
                               golden["trace/q_est"][:stop], rtol=1e-5)
    if stop == dec.shape[0]:
        _tree_close(g["params"], golden, "final/params", PARAM_TOL)
        _tree_close(g["mu"], golden, "final/mu", PARAM_TOL)
        _tree_close(g["nu"], golden, "final/nu", NU_TOL)
        assert g["opt_step"] == int(golden["final/opt_step"])
        assert g["metrics"]["train_steps"] == ok.sum()
        np.testing.assert_allclose(g["metrics"]["ssp"],
                                   float(golden["metrics/ssp"]), rtol=1e-6)


# ------------------------------------------------------- members and cells
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pop_generation_equals_unsharded(pools, world):
    """One PBT generation of P = 4 members split over ``world`` ranks
    (2 or 1 a rank) and a held-out evaluation, against the unsharded
    trainer: the report, the trained and exploited agents, hypers,
    curriculum, [P] metrics, member traces, telemetry and evaluation
    scores bit for bit on every rank."""
    spec = dict(P=4, M=4, slots=12, seed=2)
    want = T.pop_generation(spec, sharded=False)
    for r, g in enumerate(pools[world].run(T.pop_generation, spec)):
        assert g["report"] == want["report"], f"rank {r}"
        for key in ("agents", "hypers", "cur", "telemetry"):
            assert all_same(g[key], want[key]), f"rank {r}: {key}"
        for key in ("metrics", "evals"):
            assert g[key].keys() == want[key].keys()
            assert all(same(g[key][k], want[key][k]) for k in g[key])
        assert all(all_same(a, b)
                   for a, b in zip(g["traces"], want["traces"]))


POP_GOLDEN = Path(__file__).parent / "data" / "torch_pop_golden.npz"
METRIC_TOL = 1e-5      # tests/test_torch_pop_golden.py's gates
HYPER_TOL = 1e-6
MARGINS = ("q_margin", "xhat_margin", "cand_margin")


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pop_replays_the_golden(pools, world, tmp_path):
    """The JAX population golden (GRLE on fig5_baseline..fig8_csi at M=5,
    P=4 members, two generations, every draw injected) through
    ``PopulationTrainer`` with its members split over ``world`` ranks,
    held as ``tests/test_torch_pop_golden.py`` holds the unsharded
    trainer: every decision equal, or a flip only at a recorded near-tie
    (<= 1e-5), after which the comparison stops; per member rewards and
    metrics within 1e-5; PBT's sources, copies and ranks exact; hypers
    and the curriculum within 1e-6; the reports as the reference's; final
    params rtol 1e-4 / atol 2e-7; the telemetry counters and the history
    records (rank 0's alone) as the reference's. Every rank the same."""
    from repro_torch.obs.history import HistoryStore

    with np.load(POP_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    cfg = dict(ast.literal_eval(str(gold.pop("config"))))
    hist = str(tmp_path / "hist")
    got = pools[world].run(T.pop_golden, gold, cfg, hist)
    for g in got[1:]:
        assert all(same(a["traces"][i][k], b["traces"][i][k])
                   for a, b in zip(g["gens"], got[0]["gens"])
                   for i in range(cfg["members"]) for k in a["traces"][i])
        assert all(same(g["params"][k], got[0]["params"][k])
                   for k in got[0]["params"])
        assert [x["report"] for x in g["gens"]] == \
            [x["report"] for x in got[0]["gens"]]
    run = got[0]
    for g, gen in enumerate(run["gens"]):
        pre = f"gen{g}"
        flips = []
        for i, trace in enumerate(gen["traces"]):
            diff = np.argwhere((trace["decisions"] !=
                                gold[f"{pre}/m{i}/decisions"]).any(-1))
            if diff.size:
                s, b = diff[0]
                margin = min(float(gold[f"{pre}/m{i}/{k}"][s, b])
                             for k in MARGINS)
                assert margin <= NEAR_TIE, (f"gen {g} member {i}: slot {s} "
                                            f"fleet {b}, margin {margin}")
                flips.append(i)
        if flips:
            return              # the run left the golden one at a near-tie
        for i, trace in enumerate(gen["traces"]):
            np.testing.assert_allclose(trace["reward"],
                                       gold[f"{pre}/m{i}/reward"],
                                       rtol=METRIC_TOL, atol=1e-7)
            np.testing.assert_array_equal(np.isnan(trace["loss"]),
                                          np.isnan(gold[f"{pre}/m{i}/loss"]))
        for k in ("avg_reward", "ssp", "avg_accuracy", "tasks",
                  "train_steps", "final_loss"):
            np.testing.assert_allclose(gen["metrics"][k],
                                       gold[f"{pre}/mets/{k}"],
                                       rtol=METRIC_TOL, err_msg=k)
        for k, x in gen["stats"].items():
            np.testing.assert_array_equal(x, gold[f"{pre}/stats/{k}"])
            assert x.dtype == gold[f"{pre}/stats/{k}"].dtype
        for f, x in gen["hypers"].items():
            np.testing.assert_allclose(x, gold[f"{pre}/hypers/{f}"],
                                       rtol=HYPER_TOL, err_msg=f)
        np.testing.assert_allclose(gen["score"], gold[f"{pre}/cur/score"],
                                   rtol=HYPER_TOL)
        np.testing.assert_array_equal(gen["visits"],
                                      gold[f"{pre}/cur/visits"])
        rep = gen["report"]
        assert rep["generation"] == g and rep["arm"] == "curriculum"
        assert rep["best_member"] == int(gold[f"{pre}/report/best_member"])
        assert rep["region_visits"] == \
            gold[f"{pre}/report/region_visits"].tolist()
        for k, v in rep["metrics"].items():
            np.testing.assert_allclose(v, gold[f"{pre}/report/{k}"],
                                       rtol=METRIC_TOL, err_msg=k)
    assert run["generation"] == cfg["generations"]
    want = {k[len("final/params/"):]: v for k, v in gold.items()
            if k.startswith("final/params/")}
    assert set(run["params"]) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(run["params"][k], w, err_msg=k,
                                   **PARAM_TOL)
    host = run["telemetry"]
    for k, v in host["counters"].items():
        assert v == float(gold[f"telemetry/{k}"]), k
    for k, h in host["hists"].items():
        np.testing.assert_array_equal(h["counts"],
                                      gold[f"telemetry/hist/{k}"])
    recs = [r for r in HistoryStore(hist).records() if r["kind"] == "pop"]
    assert len(recs) == cfg["generations"]
    for j, r in enumerate(recs):
        assert r["name"] == "pop"
        for k, v in r["metrics"].items():
            np.testing.assert_allclose(v, gold[f"history/{j}/{k}"],
                                       rtol=METRIC_TOL, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_sweep_pack_pads_and_equals_unsharded(pools, world):
    """A pack of 3 cells (padded to 4 over 2 or 4 ranks: the padding
    runs nothing and gives no row) through ``run_pack`` on the mesh: every
    rank returns the unsharded pack's rows, which are ``run_cell``'s."""
    from repro_torch.sweep import run_cell

    want = T.sweep_pack(3, sharded=False)
    assert len(want) == 3
    cells = T.sweep_spec(3).expand()
    assert want == [run_cell(c, device="cpu") for c in cells]
    for rows in pools[world].run(T.sweep_pack, 3):
        assert rows == want


def test_sweep_launcher_over_ranks(pools, tmp_path):
    """``python -m repro_torch.launch sweep`` on 2 ranks (the group the
    launcher would join under torchrun): the unsharded report on each,
    the store and report written by rank 0, and a rerun all cached."""
    argv = ["--device", "cpu", "--scenarios", "fig5_baseline", "--methods",
            "grle,droo", "--seeds", "1", "--slots", "8", "--devices", "4",
            "--replay", "16", "--batch", "4", "--train-every", "4",
            "--fleets", "2"]
    from repro_torch.launch.sweep import main
    want = main(argv + ["--store", str(tmp_path / "one"), "--report",
                        str(tmp_path / "one.json")])
    out = argv + ["--store", str(tmp_path / "two"), "--report",
                  str(tmp_path / "two.json")]
    for _ in range(2):
        assert pools[2].run(T.sweep_launcher, out) == [want, want]
    assert (tmp_path / "two.json").read_bytes() == \
        (tmp_path / "one.json").read_bytes()
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) == \
        sorted(p.name for p in (tmp_path / "one").iterdir())


def test_sweep_launcher_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch sweep --device
    cpu``: the launcher itself joins the gloo group torchrun describes
    (``init_from_env``), runs the cell axis over 2 devices and leaves the
    group; rank 0 alone prints and writes, and its report and store are
    the one-process run's."""
    argv = ["--device", "cpu", "--scenarios", "fig5_baseline", "--methods",
            "grle,droo", "--seeds", "1", "--slots", "8", "--devices", "4",
            "--replay", "16", "--batch", "4", "--train-every", "4",
            "--fleets", "2"]
    from repro_torch.launch.sweep import main
    main(argv + ["--store", str(tmp_path / "one"), "--report",
                 str(tmp_path / "one.json")])
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    done = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch", "sweep",
         *argv, "--store", str(tmp_path / "two"), "--report",
         str(tmp_path / "two.json")],
        env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-4000:]
    assert done.stdout.count("cell axis over 2 devices") == 1, done.stdout
    assert done.stdout.count("[sweep] report -> ") == 1
    assert (tmp_path / "two.json").read_bytes() == \
        (tmp_path / "one.json").read_bytes()
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) == \
        sorted(p.name for p in (tmp_path / "one").iterdir())


# --------------------------------------------------------------- refusals
@pytest.mark.parametrize("world", WORLDS)
def test_the_references_refusals(pools, world):
    """Fleets or members that do not divide the ranks, and a mesh larger
    (or, here, smaller) than the group, raise with the reference's
    words; nothing falls back to fewer devices."""
    errs = pools[world].run(T.errors, world + 1)[0]
    assert errs["fleets"] == (f"n_fleets={world + 1} not divisible by "
                              f"{world} devices")
    assert errs[world + 1] == (f"a fleet mesh over {world + 1} devices, but "
                               f"the process group has {world} rank(s)")
    if world > 2:
        assert "spans every rank" in errs[world - 1]
    else:                       # one device: the single-device None
        assert errs[world - 1] is None
    msg = pools[world].run(T.population_of, {"M": 4}, world + 1)[0]
    assert msg == (f"population size {world + 1} not divisible by {world} "
                   f"devices (padding would distort PBT ranks)")


@pytest.mark.parametrize("world", WORLDS)
def test_shard_gather_and_replicate(pools, world):
    """``shard_leading_axis`` keeps each rank's contiguous block (as
    ``P("fleet")`` lays it out), ``gather_leading`` puts a mixed-dtype
    tree back bit for bit, ``replicate`` gives rank 0's tree to all."""
    for r, g in enumerate(pools[world].run(T.tree_round_trip, 7)):
        for k, full in g["tree"].items():
            n = full.shape[0] // world
            assert same(g["mine"][k], full[r * n:(r + 1) * n])
            assert same(g["back"][k], full)
        assert same(g["replicated"]["x"], np.zeros(3, np.float32))
        assert same(g["replicated"]["n"], np.array(0, np.int32))
