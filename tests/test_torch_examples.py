"""The port's examples (``examples/torch_*.py``) in-process on the CPU at a
tiny size through their ``main(argv)``, held against what the reference's
examples of the same names fix: their configs, their summaries' keys,
the legacy quickstart's deprecation hygiene (as the reference's CI runs
it), the figure sweep's GRLE-vs-baseline ratios, the curriculum
assertion and the 100M trainer's config and parameter count. Each
example's GPU run is ``chip_smoke.py``'s."""
import dataclasses
import fnmatch
import importlib.util
import json
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)
CPU = ("--device", "cpu")


def example(name: str):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_summary_keys() -> set:
    from repro.mec import RunningMetrics
    return set(RunningMetrics(slot_s=0.03).summary())


def reference_carry_keys() -> set:
    """The keys of the reference's ``carry_metrics``: its
    ``metrics_finalize`` fields."""
    from repro.rollout.metrics import metrics_finalize, metrics_init
    return set(metrics_finalize(metrics_init(), slot_s=0.03, n_fleets=1))


def ignored(path: str) -> bool:
    """Whether a line of ``.gitignore`` covers ``path`` (relative to the
    root) or a directory above it."""
    patterns = [ln.strip() for ln in (ROOT / ".gitignore").read_text()
                .splitlines() if ln.strip() and not ln.startswith("#")]
    parts = Path(path).parts
    for i in range(1, len(parts) + 1):
        sub = "/".join(parts[:i])
        is_dir = i < len(parts)
        for pat in patterns:
            if pat.endswith("/") and not is_dir:
                continue
            if fnmatch.fnmatch(sub, pat.rstrip("/")):
                return True
    return False


# ------------------------------------------------------------- quickstart
@pytest.fixture(scope="module")
def quickstart():
    """40 slots: the GRLE agent's first train step falls on the last slot
    (minibatch 32, a step every 10 slots)."""
    return example("torch_quickstart").main([*CPU, "--slots", "40"])


def test_quickstart_summaries_have_the_reference_keys(quickstart):
    for method in ("grle", "droo"):
        m = quickstart[method]
        assert set(m) == reference_summary_keys()
        assert m["tasks"] > 0 and 0.0 < m["ssp"] <= 1.0
    assert quickstart["train_steps"] == {"grle": 1, "droo": 1}


def test_quickstart_legacy_is_deprecation_clean_and_equal(quickstart):
    """``--legacy`` through the deprecated shim: its own warning, once per
    method, and no other (the reference's CI promotes every other warning
    to an error); the same draws, so the same summaries as the pure
    path."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = example("torch_quickstart").main([*CPU, "--slots", "40",
                                                "--legacy"])
    msgs = [(w.category, str(w.message)) for w in seen]
    assert len(msgs) == 2, msgs
    assert all(cat is DeprecationWarning
               and msg.startswith("OffloadingAgent is deprecated")
               for cat, msg in msgs), msgs
    assert out == quickstart


# --------------------------------------------------------- scenario fleet
def test_scenario_fleet_trains_and_evaluates_three_points():
    out = example("torch_scenario_fleet").main(
        [*CPU, "--fleets", "2", "--slots", "20", "--devices", "4"])
    keys = reference_carry_keys()
    assert set(out["train"]) == keys
    assert out["train"]["train_steps"] > 0
    assert list(out["eval"]) == ["fig5_baseline", "fig8_csi", "midpoint"]
    for m in out["eval"].values():
        assert set(m) == keys and m["train_steps"] == 0
        assert 0.0 < m["ssp"] <= 1.0 and m["tasks"] > 0


# ------------------------------------------------------------------ sweep
def test_sweep_paper_figures_reports_grle_ratios(tmp_path):
    ex = example("torch_sweep_paper_figures")
    argv = [*CPU, "--slots", "6", "--seeds", "1", "--store",
            str(tmp_path / "store"), "--report", str(tmp_path / "r.json")]
    report = ex.main(argv)
    scenarios = ["fig5_baseline", "fig6_capacity", "fig7_jitter",
                 "fig8_csi", "dyn_bursty"]
    assert sorted(report["scenarios"]) == sorted(scenarios)
    for s in scenarios:
        entry = report["scenarios"][s]
        assert sorted(entry["methods"]) == ["droo", "drooe", "grl", "grle"]
        assert sorted(entry["ratios"]) == ["grle_vs_droo", "grle_vs_drooe",
                                           "grle_vs_grl"]
        for ratio in entry["ratios"].values():
            assert all(np.isfinite(v) for v in ratio.values())
    assert json.loads((tmp_path / "r.json").read_text()) == report
    assert ex.main(argv) == report                  # resumed from the store
    grid = ex.main([*CPU, "--slots", "4", "--seeds", "1", "--device-grid",
                    "3,4", "--store", str(tmp_path / "grid"), "--report",
                    str(tmp_path / "g.json")])
    assert sorted(grid) == ["M=3", "M=4"]
    for rep in grid.values():
        assert sorted(rep["scenarios"]["fig5_baseline"]["ratios"]) == [
            "grle_vs_droo", "grle_vs_drooe", "grle_vs_grl"]


def test_example_outputs_go_where_git_ignores_them():
    """The sweep's store and report and the trainer's checkpoint default to
    paths that ``.gitignore`` lists; the repo's own files are not."""
    sweep = example("torch_sweep_paper_figures").parse_args([])
    trainer = example("torch_train_100m").parse_args([])
    for path in (f"{sweep.store}/cell.json", sweep.report,
                 trainer.checkpoint):
        assert ignored(path), path
    assert not ignored("examples/torch_train_100m.py")
    assert not ignored("results/BENCH_kernels.json")


# ------------------------------------------------------------- population
TINY_POP = [*CPU, "--members", "2", "--slots", "4", "--devices", "3",
            "--regions", "3"]


@pytest.fixture(scope="module")
def pop_comparison():
    ex = example("torch_pop_curriculum")
    args = ex.parse_args([*TINY_POP, "--generations", "2"])
    return args, ex.compare(args)


def test_pop_curriculum_result_has_the_reference_layout(pop_comparison):
    """``compare_curriculum_dr``'s result, as the reference's example reads
    it: both arms' evaluations, region visits, the margin and the
    verdict."""
    _, result = pop_comparison
    assert set(result) == {"eval_points", "arms", "margin",
                           "curriculum_wins"}
    assert result["eval_points"] == [0.9, 1.0]
    for arm in ("curriculum", "dr"):
        row = result["arms"][arm]
        assert set(row) == {"eval_rewards", "eval_mean", "final_train",
                            "region_visits"}
        assert len(row["eval_rewards"]) == 2 and len(row["region_visits"]) == 3
        assert sum(row["region_visits"]) == 2 * 2     # members x generations
    assert result["margin"] == pytest.approx(
        result["arms"]["curriculum"]["eval_mean"]
        - result["arms"]["dr"]["eval_mean"])


def test_chip_phase_checks_the_pop_result_but_not_its_sign(pop_comparison):
    """The chip phase's check of the population example's result accepts a
    well-formed result whichever arm wins, and rejects a verdict that
    disagrees with the margin or a region count that does not add up."""
    import copy

    spec = importlib.util.spec_from_file_location("_chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    args, result = pop_comparison
    means = chip_smoke.check_pop_result(result, args)
    assert means == (result["arms"]["curriculum"]["eval_mean"],
                     result["arms"]["dr"]["eval_mean"])
    flipped = copy.deepcopy(result)
    cur, dr = flipped["arms"]["curriculum"], flipped["arms"]["dr"]
    cur["eval_mean"], dr["eval_mean"] = 1.0, 2.0
    flipped["margin"], flipped["curriculum_wins"] = -1.0, False
    chip_smoke.check_pop_result(flipped, args)          # DR wins: not gated
    flipped["curriculum_wins"] = True
    with pytest.raises(SystemExit, match="do not match"):
        chip_smoke.check_pop_result(flipped, args)
    short = copy.deepcopy(result)
    short["arms"]["dr"]["region_visits"][0] += 1
    with pytest.raises(SystemExit, match="malformed"):
        chip_smoke.check_pop_result(short, args)


def test_pop_curriculum_keeps_the_reference_assertion():
    """One generation: the curriculum has no scores yet and samples as DR
    does, so both arms train and score alike, the margin is 0, and the
    example's assertion that the curriculum wins fails, as the
    reference's would."""
    with pytest.raises(AssertionError, match=r"curriculum must beat DR.*"
                                             r"margin \+0\.0000"):
        example("torch_pop_curriculum").main([*TINY_POP, "--generations",
                                              "1"])


# ---------------------------------------------------------------- serving
def test_edge_serving_decodes_at_the_scheduled_exits():
    out = example("torch_edge_serving").main([*CPU, "--slots", "2",
                                              "--decode"])
    assert set(out["summary"]) == reference_summary_keys()
    assert out["summary"]["tasks"] == 2 * 4
    for slot in out["slots"]:
        assert len(slot["assignments"]) == 4
        assert {r for r, _ in slot["assignments"]} <= {"h100", "edge-box"}
        assert {e for _, e in slot["assignments"]} <= {1, 2}
        assert all(len(t) == 4 and all(0 <= x < 512 for x in t)
                   for t in slot["texts"])


# --------------------------------------------------------------- training
@pytest.fixture(scope="module")
def reference_train_100m():
    """The reference example's config, its params' size and its train
    step's metric names, by shape only (``jax.eval_shape``: nothing
    compiled, nothing drawn)."""
    from repro.nn import tree_size
    from repro.optim import adamw, linear_warmup_cosine
    from repro.train.steps import make_train_state, make_train_step
    ref = example("train_100m")
    cfg = ref.CONFIG_100M
    opt = adamw(linear_warmup_cosine(6e-4, 20, 300))
    state = jax.eval_shape(lambda k: make_train_state(cfg, k, opt)[0],
                           jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((1, 8), np.int32),
             "labels": jax.ShapeDtypeStruct((1, 8), np.int32)}
    _, metrics = jax.eval_shape(make_train_step(cfg, opt), state, batch)
    return cfg, tree_size(state.params), set(metrics)


def test_train_100m_config_and_params_equal_the_reference(
        reference_train_100m):
    cfg, n_params, metric_keys = reference_train_100m
    ex = example("torch_train_100m")
    assert dataclasses.asdict(ex.CONFIG_100M) == dataclasses.asdict(cfg)
    out = ex.main([*CPU, "--steps", "1", "--batch", "1", "--seq", "8",
                   "--checkpoint", ""])
    assert out["n_params"] == n_params == 125_851_392
    assert set(out["metrics"]) == metric_keys
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    assert out["losses"][0] == pytest.approx(np.log(cfg.vocab), abs=0.5)
    assert out["checkpoint"] == ""
