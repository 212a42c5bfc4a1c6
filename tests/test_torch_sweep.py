"""The port's sweep: spec expansion and hashing, packing, packed equal to
sequential bit for bit, episode builds per pack, the resumable store, the
report, the single-device fleet helpers, the CLI, regression verdicts and
the history trends — each held against the reference's where it has one
(``tests/test_sweep.py`` mirrored). Rows against the reference's
``run_cell`` on injected draws: ``tests/test_torch_sweep_ref.py``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.obs import CompileTracker, HistoryStore
from repro_torch.sweep import (Cell, ForeignRowError, PackProgram, SweepSpec,
                               SweepStore, build_report, cell_keys,
                               cell_seeds, format_markdown, format_telemetry,
                               pack_cells, run_cell, run_pack, run_sweep,
                               write_report)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
QUIET = dict(device="cpu", log=lambda *_: None)


def tiny_spec(**kw):
    base = dict(scenarios=("fig5_baseline",), methods=("grle", "grl"),
                seeds=(0, 1), n_devices=3, n_slots=20, replay_capacity=16,
                batch_size=4, train_every=5)
    base.update(kw)
    return SweepSpec(**base)


def reference_spec(spec):
    from repro.sweep import SweepSpec as RefSpec
    return RefSpec(**{f: getattr(spec, f)
                      for f in spec.__dataclass_fields__})


# ---------------------------------------------------------------- spec/cells
class TestSpec:
    def test_expand_order_and_count(self):
        spec = tiny_spec(scenarios=("fig5_baseline", "fig6_capacity"))
        cells = spec.expand()
        assert len(cells) == 2 * 2 * 2
        assert [c.scenario for c in cells[:4]] == ["fig5_baseline"] * 4
        assert [(c.method, c.seed) for c in cells[:4]] == [
            ("grle", 0), ("grle", 1), ("grl", 0), ("grl", 1)]

    def test_from_names_cli_form(self):
        spec = SweepSpec.from_names("fig5_baseline,fig6_capacity",
                                    "grle,droo", 3)
        assert spec.scenarios == ("fig5_baseline", "fig6_capacity")
        assert spec.methods == ("grle", "droo")
        assert spec.seeds == (0, 1, 2)

    @pytest.mark.parametrize("bad", [
        "not_a_scenario", "space:fig5_baseline:fig8_csi:0",
        "space:fig5_baseline:nope:0:0", "space:fig5_baseline:fig8_csi:x:0"])
    def test_unknown_or_malformed_scenario_rejected(self, bad):
        with pytest.raises(ValueError):
            tiny_spec(scenarios=(bad,))

    def test_hash_covers_run_shape(self):
        a, b = tiny_spec().expand()[0], tiny_spec(n_slots=21).expand()[0]
        assert a.cell_hash != b.cell_hash
        assert a.cell_hash == tiny_spec().expand()[0].cell_hash

    @pytest.mark.parametrize("kind", ["named", "space", "overrides"])
    def test_cell_hash_equals_reference(self, kind):
        """A port store and a reference store line up cell by cell."""
        if kind == "named":
            spec = tiny_spec(scenarios=("fig5_baseline", "dyn_bursty"),
                             methods=("grle", "grl", "drooe", "droo"))
        elif kind == "space":
            spec = SweepSpec.from_space("fig5_baseline", "fig8_csi", 3,
                                        space_seed=3, seeds=(0, 4))
        else:
            spec = tiny_spec(overrides=(("deadline_s", 0.05),
                                        ("capacity_range", (0.5, 1.0))))
        cells, ref = spec.expand(), reference_spec(spec).expand()
        assert [tuple(c) for c in cells] == [tuple(c) for c in ref]
        assert [c.cell_hash for c in cells] == [c.cell_hash for c in ref]
        assert [c.label() for c in cells] == [c.label() for c in ref]

    def test_cell_seeds_shared_across_methods(self):
        """Paired seeds: methods see identical streams per seed; seeds
        differ, and each is a 63-bit int."""
        grle0, grle1, grl0, grl1 = tiny_spec().expand()
        assert cell_seeds(grle0) == cell_seeds(grl0) == cell_keys(grl0)
        assert cell_seeds(grle1) == cell_seeds(grl1) != cell_seeds(grle0)
        p, r = cell_seeds(grle0)
        assert p != r and all(0 <= s < 2 ** 63 for s in (p, r))
        assert cell_seeds(grle0._replace(n_slots=99)) == (p, r)


# ------------------------------------------------------------------- packer
class TestPacker:
    def test_packs_by_family_across_scenarios(self):
        spec = tiny_spec(scenarios=("fig5_baseline", "fig6_capacity"),
                         methods=("grle", "grl", "drooe", "droo"))
        packs = pack_cells(spec.expand())
        assert len(packs) == 2        # {gcn, mlp}
        for pack in packs:
            assert len(pack.cells) == 8    # 2 scenarios x 2 methods x 2 seeds
            assert pack.scenarios == ("fig5_baseline", "fig6_capacity")
        assert len(pack_cells(spec.expand(), split_scenarios=True)) == 4

    def test_pack_composition_independent_of_completion(self):
        cells = tiny_spec().expand()
        full = pack_cells(cells)
        shuffled = pack_cells(list(reversed(cells)))
        assert [p.cells for p in full] == [p.cells for p in shuffled]

    @pytest.mark.parametrize("grid,split", [
        ("paper", False), ("dyn", False), ("paper", True), ("dyn", True)])
    def test_packs_equal_reference(self, grid, split):
        """Same labels, families, cells and order as the reference's
        packer: the paper grid (fig5..fig8, four space draws) and the dyn
        grid (poisson, churn, markov channel, bursty, topology)."""
        from repro.sweep import pack_cells as ref_pack_cells
        from repro_torch.mec.scenarios import DYNAMIC_SCENARIOS, PAPER_FIGURES
        names = (PAPER_FIGURES + SweepSpec.from_space(
            "fig5_baseline", "fig8_csi", 4).scenarios if grid == "paper"
            else DYNAMIC_SCENARIOS)
        spec = SweepSpec(scenarios=names, seeds=(0, 1))
        packs = pack_cells(spec.expand(), split_scenarios=split)
        ref = ref_pack_cells(reference_spec(spec).expand(),
                             split_scenarios=split)
        assert [(p.label(), p.family, [tuple(c) for c in p.cells])
                for p in packs] == [(p.label(), p.family,
                                     [tuple(c) for c in p.cells])
                                    for p in ref]
        if grid == "paper" and not split:
            assert [len(p.cells) for p in packs] == [32, 32]


# ------------------------------------------------------- packed equivalence
MIXED = {
    # one iid pack per family: two named scenarios and two space draws
    "iid": ("fig5_baseline", "fig8_csi", "space:fig5_baseline:fig8_csi:0:0",
            "space:fig5_baseline:fig8_csi:1:0"),
    "poisson": ("dyn_poisson", "dyn_churn", "dyn_markov_channel"),
}


class TestPackedEquivalence:
    @pytest.mark.parametrize("workload", list(MIXED))
    def test_packed_equals_sequential_bit_for_bit(self, workload):
        """Every cell of a mixed pack, run through the pack's one driver
        with its knobs as data, equals a fresh driver's run of that cell
        alone: every field, the telemetry snapshot and summary included.
        A knob read from the template's config instead of ``sp`` would
        give every cell cell 0's value."""
        spec = tiny_spec(scenarios=MIXED[workload],
                         methods=("grle", "grl", "drooe", "droo"),
                         seeds=(0,))
        packs = pack_cells(spec.expand())
        assert [len(p.scenarios) for p in packs] == [len(MIXED[workload])] * 2
        for pack in packs:
            rows = run_pack(pack, telemetry=True, device="cpu")
            for cell, row in zip(pack.cells, rows):
                assert row == run_cell(cell, telemetry=True, device="cpu"), \
                    cell.label()
            by = {r["scenario"]: r["avg_reward"] for r in rows
                  if r["method"] in ("grle", "drooe")}
            assert len(set(by.values())) == len(by)   # knobs differ

    def test_early_exit_mask_respected_per_cell(self):
        """GRL cells inside a GRLE pack never see early exits: their
        accuracy is exactly the final-exit accuracy on every success."""
        from repro_torch.mec import make_scenario
        (pack,) = pack_cells(tiny_spec(seeds=(0,)).expand())
        rows = {r["method"]: r for r in run_pack(pack, device="cpu")}
        final_acc = make_scenario("fig5_baseline",
                                  n_devices=3).exit_accuracy[-1]
        grl = rows["grl"]
        np.testing.assert_allclose(grl["avg_accuracy"],
                                   final_acc * grl["ssp"], rtol=1e-5)
        assert rows["grle"]["avg_accuracy"] < grl["avg_accuracy"]

    def test_one_episode_built_per_pack(self):
        """A 2-method x 2-seed x 3-scenario grid of one family, two runs of
        its program: one episode built, as the reference's guard pins one
        compiled program per pack; no graphs on the CPU."""
        spec = tiny_spec(scenarios=("fig5_baseline", "fig7_jitter",
                                    "space:fig5_baseline:fig8_csi:0:0"))
        (pack,) = pack_cells(spec.expand())
        with CompileTracker() as ct:
            prog = PackProgram(pack, device="cpu")
            first = prog.run()
            assert prog.run() == first
            ct.track(pack.label(), prog)
        assert ct.assert_counts({pack.label(): 1}) == {pack.label(): 1}
        assert prog.driver.graphs_captured == 0
        assert ct.by_label() == {pack.label(): {
            "episodes": 1, "graphs": 0, "seconds": pytest.approx(
                ct.total_compile_s)}}
        summary = ct.summary()
        assert (summary["n_backend_compiles"], summary["n_graphs_captured"],
                summary["tracked"]) == (1, 0, {pack.label(): 1})
        with pytest.raises(AssertionError, match="1 episodes built"):
            ct.assert_counts({pack.label(): 2})
        run_cell(pack.cells[0], device="cpu")    # after the context: unseen
        assert ct.n_backend_compiles == 1

    def test_sweep_builds_one_episode_per_pack(self):
        spec = tiny_spec(methods=("grle", "droo"),
                         scenarios=("fig5_baseline", "dyn_poisson"))
        with CompileTracker() as ct:
            run_sweep(spec, **QUIET)
        packs = pack_cells(spec.expand())
        assert ct.by_label() == {p.label(): {
            "episodes": 1, "graphs": 0,
            "seconds": pytest.approx(ct.by_label()[p.label()]["seconds"])}
            for p in packs}
        assert ct.n_backend_compiles == len(packs) == 4


# -------------------------------------------------------------------- store
class TestStore:
    def test_roundtrip_and_no_clobber(self, tmp_path):
        store = SweepStore(str(tmp_path))
        cell = tiny_spec().expand()[0]
        store.save(cell, {"x": 1.0})
        assert store.has(cell) and store.load(cell) == {"x": 1.0}
        store.save(cell, {"x": 2.0})          # refuses to overwrite
        assert store.load(cell) == {"x": 1.0}
        assert store.completed() == 1

    def test_killed_then_resumed_sweep_is_byte_identical(self, tmp_path):
        spec = tiny_spec(methods=("grle", "grl", "droo"))
        store_dir = tmp_path / "store"
        store = SweepStore(str(store_dir))
        rows_full = run_sweep(spec, store=store, **QUIET)
        assert {r["backend"] for r in rows_full} == {"torch-cpu"}
        report_a = json.dumps(build_report(rows_full), sort_keys=True)
        blobs = {p: (store_dir / p).read_bytes()
                 for p in os.listdir(store_dir)}
        assert len(blobs) == 6
        victim = sorted(blobs)[1]
        (store_dir / victim).unlink()
        msgs = []
        rows_resumed = run_sweep(spec, store=store, device="cpu",
                                 log=msgs.append)
        assert json.dumps(build_report(rows_resumed),
                          sort_keys=True) == report_a
        for p, blob in blobs.items():
            assert (store_dir / p).read_bytes() == blob, p
        ran = [m for m in msgs if ": running" in m]
        assert len(ran) == 1 and "cached)" in ran[0]

    def test_sequential_resume_runs_only_missing_cells(self, tmp_path,
                                                       monkeypatch):
        import repro_torch.sweep.runner as runner_mod
        cells = tiny_spec().expand()
        store = SweepStore(str(tmp_path))
        cached = {"cached": True, "backend": "torch-cpu"}
        for c in cells[1:]:
            store.save(c, cached)
        executed = []

        def fake_run_cell(cell, **kw):
            executed.append(cell)
            return {"cached": False, "backend": "torch-cpu"}

        monkeypatch.setattr(runner_mod, "run_cell", fake_run_cell)
        rows = runner_mod.run_sweep(tiny_spec(), store=store, packed=False,
                                    **QUIET)
        assert executed == [cells[0]]
        assert rows[0]["cached"] is False
        assert all(r == cached for r in rows[1:])

    def test_fully_cached_sweep_runs_nothing(self, tmp_path):
        spec = tiny_spec()
        store = SweepStore(str(tmp_path))
        run_sweep(spec, store=store, **QUIET)
        msgs = []
        with CompileTracker() as ct:
            run_sweep(spec, store=store, device="cpu", log=msgs.append)
        assert msgs and all("cached" in m for m in msgs)
        assert ct.n_backend_compiles == 0

    @pytest.mark.parametrize("backend", [None, "torch-cuda"])
    def test_another_backends_row_is_refused(self, tmp_path, backend):
        """A reference row (no backend) or a card's row in the store of a
        CPU sweep is an error naming the store, never a finished cell."""
        spec = tiny_spec(seeds=(0,))
        store = SweepStore(str(tmp_path))
        row = {"avg_accuracy": 0.5}
        if backend is not None:
            row["backend"] = backend
        store.save(spec.expand()[0], row)
        with pytest.raises(ForeignRowError, match=str(tmp_path)):
            run_sweep(spec, store=store, **QUIET)


# ------------------------------------------------------------------- report
def _row(scenario, method, seed, acc, tps=10.0, ssp=1.0):
    return dict(scenario=scenario, method=method, seed=seed,
                avg_accuracy=acc, ssp=ssp, deadline_miss=1.0 - ssp,
                throughput_tps=tps, avg_reward=0.5)


class TestReport:
    def test_ratios_vs_baselines(self):
        rows = [_row("fig5_baseline", "grle", s, 0.9) for s in (0, 1)]
        rows += [_row("fig5_baseline", "grl", s, 0.45) for s in (0, 1)]
        rows += [_row("fig5_baseline", "drooe", s, 0.6) for s in (0, 1)]
        ratios = build_report(rows)["scenarios"]["fig5_baseline"]["ratios"]
        assert ratios["grle_vs_grl"]["avg_accuracy"] == pytest.approx(2.0)
        assert ratios["grle_vs_drooe"]["avg_accuracy"] == pytest.approx(1.5)
        assert "grle_vs_droo" not in ratios

    def test_report_bytes_equal_reference(self, tmp_path):
        """The port's report module is the reference's: the same JSON
        bytes, markdown and telemetry table for the same rows — real rows
        of a port sweep (telemetry on, a NaN-free None loss among them)
        and synthetic ones with a NaN."""
        from repro.sweep import report as ref
        rows = run_sweep(tiny_spec(methods=("grle", "grl", "drooe", "droo"),
                                   scenarios=("fig5_baseline", "fig8_csi"),
                                   n_slots=4),
                         telemetry=True, **QUIET)
        assert any(r["final_loss"] is None for r in rows)
        rows += [_row("dyn_bursty", "grle", 0, float("nan")),
                 _row("dyn_bursty", "droo", 0, 0.25, tps=0.0)]
        rep, want = build_report(rows), ref.build_report(rows)
        assert rep == want
        a = write_report(rep, str(tmp_path / "port.json"))
        b = ref.write_report(want, str(tmp_path / "ref.json"))
        assert open(a, "rb").read() == open(b, "rb").read()
        assert format_markdown(rep) == ref.format_markdown(want)
        assert format_telemetry(rows) == ref.format_telemetry(rows)
        assert "| fig5_baseline/grle/s0 |" in format_telemetry(rows)


# ----------------------------------------------------------------- sharding
class TestSharding:
    def test_fleet_mesh_is_one_device(self):
        """Without a process group ``fleet_mesh()`` is the reference's
        single-device None; a mesh over more devices than the group has
        ranks raises and names how to start one rank per card (the
        multi-rank mesh itself: tests/test_torch_sharded_rollout.py)."""
        from repro_torch.sharding import (FLEET_AXIS, fleet_mesh,
                                          gather_leading, pad_to_devices,
                                          replicate, shard_leading_axis)
        assert FLEET_AXIS == "fleet"
        assert fleet_mesh() is None and fleet_mesh(1) is None
        with pytest.raises(ValueError, match="over 4 devices.*1 rank.*"
                                             "torchrun --nproc-per-node 4"):
            fleet_mesh(4)
        tree = {"x": torch.zeros(3)}
        assert shard_leading_axis(tree, None) is tree
        assert replicate(tree, None) is tree
        assert gather_leading(tree, None) is tree
        assert pad_to_devices(5, None) == 5

        class M:
            @staticmethod
            def size():
                return 4

        assert pad_to_devices(6, M) == 8 and pad_to_devices(8, M) == 8


# ---------------------------------------------------------------------- CLI
def test_launch_sweep_end_to_end_with_resume(tmp_path):
    """``python -m repro_torch.launch.sweep --device cpu``: the report and
    markdown; a second run loads every cell, rewrites nothing, and prints
    the same report."""
    args = [sys.executable, "-m", "repro_torch.launch.sweep", "--device",
            "cpu", "--scenarios", "fig5_baseline", "--methods", "grle,droo",
            "--seeds", "1", "--slots", "15", "--devices", "3", "--replay",
            "16", "--batch", "4", "--train-every", "5", "--store",
            str(tmp_path / "store"), "--report", str(tmp_path / "r.json"),
            "--telemetry", "--history", str(tmp_path / "hist")]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    outs, blobs = [], []
    for _ in range(2):
        p = subprocess.run(args, capture_output=True, text=True, timeout=300,
                           env=env, cwd=str(tmp_path))
        assert p.returncode == 0, p.stderr[-2000:]
        outs.append(p.stdout)
        blobs.append({f: (tmp_path / "store" / f).read_bytes()
                      for f in os.listdir(tmp_path / "store")})
    report = json.loads((tmp_path / "r.json").read_text())
    sc = report["scenarios"]["fig5_baseline"]
    assert set(sc["methods"]) == {"grle", "droo"}
    assert "grle_vs_droo" in sc["ratios"]
    assert "| grle |" in outs[0] and "= 2 cells on cpu" in outs[0]
    assert ": ran " in outs[0] and ": ran " not in outs[1]
    assert outs[1].count("cells cached") == 2
    assert blobs[0] == blobs[1] and len(blobs[0]) == 2
    recs = HistoryStore(str(tmp_path / "hist")).records(kind="sweep")
    assert [r["name"] for r in recs] == ["fig5_baseline/grle/s0",
                                        "fig5_baseline/droo/s0"]
    man = recs[0]["manifest"]
    assert (man["backend"], man["use_pallas"]) == ("cpu", False)
    assert "tel_deadline_hit_rate" in recs[0]["metrics"]
    assert "| fig5_baseline/droo/s0 |" in outs[0]


# ------------------------------------------------- regression and history
def synthetic_history(path):
    """Six names' series in one records.jsonl: steady, regressed,
    improved, too short, noisy, and one whose newest record has another
    backend (so its baseline is empty)."""
    rng = np.random.default_rng(0)
    recs = []
    man = {"git_rev": "abc", "backend": "cuda", "n_devices": 1,
           "use_pallas": True}

    def add(name, metrics, **m):
        recs.append({"schema": 1, "kind": "bench", "name": name,
                     "ts": float(len(recs)), "metrics": metrics,
                     "manifest": dict(man, git_rev=f"r{len(recs):07d}", **m)})

    for i in range(8):
        add("steady", {"cells_per_s": 10.0 + 0.01 * i, "wall_s": 2.0,
                       "label_only": 3})
        add("noisy", {"cells_per_s": 10.0 + rng.normal(0, 2.0)})
    for i in range(5):
        add("regressed", {"cells_per_s": 10.0, "us_per_call": 5.0})
        add("improved", {"steps_per_s": 100.0, "latency_p99_s": 1.0})
    add("regressed", {"cells_per_s": 6.0, "us_per_call": 9.0})
    add("improved", {"steps_per_s": 180.0, "latency_p99_s": 0.4})
    add("short", {"ssp": 0.9})
    add("short", {"ssp": 0.2})
    add("moved", {"ssp": 0.9})
    add("moved", {"ssp": 0.91}, backend="cpu")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "records.jsonl"), "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return path


def test_regress_verdicts_equal_reference(tmp_path):
    from repro.obs import history as ref_history
    from repro.obs import regress as ref_regress
    from repro_torch.obs import regress
    root = synthetic_history(str(tmp_path / "h"))
    got = regress.check_history(HistoryStore(root))
    want = ref_regress.check_history(ref_history.HistoryStore(root))
    assert got == want
    status = {(v["name"], v["metric"]): v["status"] for v in got}
    assert status[("regressed", "cells_per_s")] == regress.REGRESSION
    assert status[("regressed", "us_per_call")] == regress.REGRESSION
    assert status[("improved", "latency_p99_s")] == regress.IMPROVEMENT
    assert status[("steady", "cells_per_s")] == regress.OK
    assert status[("short", "ssp")] == regress.INSUFFICIENT
    assert status[("moved", "ssp")] == regress.INSUFFICIENT
    assert regress.summarize_verdicts(got) == \
        ref_regress.summarize_verdicts(want)
    for v in ([3.0, 3.1, 2.9], [1.0], []):
        for d in (1, -1, 0):
            assert regress.regression_verdict(v, 2.0, direction=d) == \
                ref_regress.regression_verdict(v, 2.0, direction=d)


def test_launch_history_markdown_equals_reference(tmp_path, capsys):
    """The trend report of the port's CLI is the reference's on the same
    store, but that the port names its manifest's device count
    ``devices`` (the reference: ``jax devices``); ``--check`` exits 1 on
    the regression."""
    from repro.launch import history as ref_launch
    from repro.obs import history as ref_history
    from repro_torch.launch import history
    from repro_torch.obs import regress
    root = synthetic_history(str(tmp_path / "h"))
    text, verdicts = history.trend_report(HistoryStore(root))
    want, want_v = ref_launch.trend_report(ref_history.HistoryStore(root))
    assert text == want.replace("jax devices=", "devices=")
    assert verdicts == want_v
    out = str(tmp_path / "report.md")
    counts = history.main(["--root", root, "--out", out, "--name", "st"])
    assert counts == regress.summarize_verdicts(verdicts)
    assert counts["regression"] == 2
    assert "## `steady`" in open(out).read()
    assert "## `regressed`" not in open(out).read()
    with pytest.raises(SystemExit) as e:
        history.main(["--root", root, "--out", "", "--check"])
    assert e.value.code == 1
    empty = history.trend_report(HistoryStore(str(tmp_path / "none")))
    assert empty[0] == ref_launch.trend_report(ref_history.HistoryStore(
        str(tmp_path / "none")))[0]
    capsys.readouterr()


def test_run_sweep_appends_history_per_executed_cell(tmp_path):
    spec = tiny_spec(seeds=(0,))
    hist = HistoryStore(str(tmp_path / "h"))
    store = SweepStore(str(tmp_path / "s"))
    rows = run_sweep(spec, store=store, history=hist, telemetry=True,
                     **QUIET)
    run_sweep(spec, store=store, history=hist, **QUIET)   # cached: none
    recs = hist.records(kind="sweep")
    # pack order: (scenario, method, seed)
    assert [r["name"] for r in recs] == ["fig5_baseline/grl/s0",
                                        "fig5_baseline/grle/s0"]
    for rec, row in zip(recs, rows[::-1]):
        assert rec["cell"] == row["cell"] and rec["n_slots"] == 20
        assert rec["metrics"]["ssp"] == row["ssp"]
        assert "seed" not in rec["metrics"]
        assert rec["metrics"]["tel_deadline_hit_rate"] == \
            row["telemetry"]["summary"]["deadline_hit_rate"]
        man = rec["manifest"]
        assert (man["backend"], man["use_pallas"], man["n_devices"]) == (
            "cpu", False, 1)
        assert man["config_signature"] == [
            "3", "2", "5", "iid", "True", "0.03"]


# ------------------------------------------------------ learning over seeds
LEARN = dict(scenarios=("fig5_baseline",), methods=("grle", "drooe"),
             seeds=tuple(range(48)), n_devices=3, n_slots=60,
             replay_capacity=16, batch_size=4, train_every=5)
LEARN_SE = 3.0      # |port mean - reference mean| within 3 standard errors


def test_learning_over_seeds_matches_reference():
    """The port's own-generator sweep against the reference's ``run_sweep``
    (threefry draws), fig5_baseline, GRLE and DROOE, M=3, T=60 (12 train
    steps), seeds 0-47: per method, the port's mean ``ssp`` and
    ``avg_accuracy`` lie within ``LEARN_SE`` standard errors of the
    reference's mean, the standard error being that of the reference's
    48-seed mean, s_ref / sqrt(48). The two draw from different RNGs, so
    only the statistics can agree. Observed (CPU): gaps of 0.00 (GRLE
    ssp), 0.49 (GRLE accuracy), 0.37 (DROOE ssp) and 0.81 (DROOE
    accuracy) standard errors. Over seeds 0-7 alone the reference's
    standard error is too unstable to test against: its DROOE ssp is 1.0
    in seven of eight seeds, and the port's DROOE ssp and accuracy lie
    5.0 and 3.8 of those standard errors from it."""
    from repro.sweep import SweepSpec as RefSpec
    from repro.sweep import run_sweep as ref_run_sweep
    rows = run_sweep(SweepSpec(**LEARN), **QUIET)
    ref = ref_run_sweep(RefSpec(**LEARN), log=lambda *_: None)
    assert all(r["train_steps"] == 12 for r in rows + ref)
    for method in LEARN["methods"]:
        for key in ("ssp", "avg_accuracy"):
            a = np.asarray([r[key] for r in rows if r["method"] == method])
            b = np.asarray([r[key] for r in ref if r["method"] == method])
            se = b.std(ddof=1) / np.sqrt(b.size)
            gap = abs(a.mean() - b.mean())
            assert gap <= LEARN_SE * se, (
                f"{method} {key}: port {a.mean():.6f} vs reference "
                f"{b.mean():.6f}, gap {gap:.3g} > {LEARN_SE} x {se:.3g}")
