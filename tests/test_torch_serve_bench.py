"""The port's serving benchmark (``repro_torch.launch.serve_bench``, the
dispatcher's ``serve-bench``) against the JAX engines, on the CPU.

* The bench's ``--quick`` comparison: JAX's traces through both JAX
  engines (the 4-slot sync loop and the 32-slot continuous engine) with
  their draws recorded; the port's row function on the same traces with
  those draws injected and the JAX runs' initial agent states gives rows
  whose deterministic fields equal what the JAX engines' snapshots and
  counts give (read as ``benchmarks/serve_throughput.py::run`` reads them).
* ``tests/data/torch_serve_async_golden.npz`` (the JAX continuous engine
  at the bench's ``--quick`` shape over its warm-up and main traces and
  the main stream's next 512 requests, two train steps) replays on the
  port with byte-equal step reports, equal decisions, counts and tokens,
  and final params within rtol 1e-4 / atol 2e-7; the file equals a
  rebuild.
* ``main(["--quick", "--device", "cpu", "--out", ...])`` writes the two
  rows with the keys of the reference's rows in ``BENCH_serve.json`` and
  leaves that file as it was.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.bridge import (agent_state_from_numpy,
                                     agent_state_from_params)
from repro_torch.launch import serve_bench
from repro_torch.launch.__main__ import main as launch_main
from repro_torch.nn.pytree import flatten_dict
from repro_torch.obs import HistoryStore
from repro_torch.obs import rows as obs_rows
from repro_torch.serve import Replica, ServeRequest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import make_torch_port_golden as golden_tool  # noqa: E402

sys.path.pop(0)
torch.set_num_threads(1)

GOLDEN = golden_tool.SERVE_ASYNC_GOLDEN
PARAM_TOL = dict(rtol=1e-4, atol=2e-7)      # the training tests' tolerance
# the keys of the reference's rows (benchmarks/serve_throughput.py's, as
# BENCH_serve.json holds them) without its stamps
REF_ROWS = {r["name"]: r for r in json.loads(
    (ROOT / "BENCH_serve.json").read_text())}
REF_STAMPS = {"backend", "n_jax_devices", "git_rev"}
SYNC_KEYS = set(REF_ROWS["serve_sync_slots4"]) - REF_STAMPS
CONT_KEYS = set(REF_ROWS["serve_continuous_slots64"]) - REF_STAMPS
STAMPS = {"backend", "n_devices", "git_rev", "torch_version"}
# the rows' deterministic fields (the sync row has no queue)
FIELDS = ("n_requests", "n_tokens", "deadline_hit_rate", "latency_p50_s",
          "latency_p99_s", "queue_depth_p99")


def _profile_kw(data):
    return {k: float(data[f"profile/{k}"]) for k in ("peak_flops", "hbm_bw")}


def _engines(data):
    """The bench's two engines on the CPU with the JAX runs' exit table."""
    return serve_bench._engines(
        get_arch(serve_bench.ARCH, reduced=True),
        [Replica(n, s) for n, s in serve_bench.REPLICAS],
        slots_sync=serve_bench.SLOTS_SYNC, slots_cont=int(data["batch_slots"]),
        seed=int(data["seed"]), device="cpu", profile_kw=_profile_kw(data))


def _cont_state(eng, data):
    eng.set_agent_state(agent_state_from_params(
        eng.agent_def, golden_tool.tree_of(data, "init_params"),
        data["exit_mask"]))


def _port(trace):
    return [ServeRequest(**dataclasses.asdict(r)) for r in trace]


def _golden_row(data):
    return {k[4:]: data[k].item() for k in data if k.startswith("row/")}


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.pop(0)
    return cs


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX side, once per module: the golden run (the continuous
    engine) with the traces it was given, and the sync loop over the
    bench's warm-up and main traces."""
    data, traces = golden_tool.serve_async_run()
    sync = golden_tool.serve_bench_sync_run(traces["warm"], traces["main"])
    return {"async": data, "traces": traces, "sync": sync}


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


# -------------------------------------------------- the bench against JAX
def test_bench_rows_equal_jax_engines_on_their_draws(jax_runs, chip_smoke,
                                                     capsys):
    data, traces, sync_run = (jax_runs["async"], jax_runs["traces"],
                              jax_runs["sync"])
    sync, cont = _engines(data)
    sync.set_agent_state(agent_state_from_numpy(sync_run["state0"], "cpu"))
    draws = sync_run["draws"]
    chip_smoke.inject_serve_draws(sync, draws, len(draws["rand_cands"]))
    _cont_state(cont, data)
    chip_smoke.inject_serve_draws(cont, data, len(data["rand_cands"]))
    rows = serve_bench.bench_rows(sync, cont, _port(traces["main"]),
                                  _port(traces["warm"]))
    assert [r["name"] for r in rows] == ["serve_sync_slots4",
                                         "serve_continuous_slots32"]
    assert set(rows[0]) == SYNC_KEYS and set(rows[1]) == CONT_KEYS
    assert tuple(sync_run["row"]) == FIELDS[:-1]
    assert {k: rows[0][k] for k in FIELDS[:-1]} == sync_run["row"]
    assert tuple(_golden_row(data)) == FIELDS
    assert {k: rows[1][k] for k in FIELDS} == _golden_row(data)
    assert rows[0]["n_requests"] == rows[1]["n_requests"] == 192
    n_steps = sum(int(data[f"steps/{r}"]) for r in ("warm", "main"))
    assert cont._step_idx == n_steps
    jeng = sync_run["engine"]
    assert sync.tokens_served == jeng.tokens_served
    assert int(sync.agent_state.loss_count) == int(
        jeng.agent_state.loss_count) >= 1
    np.testing.assert_array_equal(np.asarray(sync._latency_ring),
                                  np.asarray(jeng._latency_ring))
    assert "continuous slots=32" in capsys.readouterr().out


# ------------------------------------------------------------ the golden
def test_async_golden_replays_byte_equal(golden, chip_smoke):
    eng, reports, decisions, row = chip_smoke.async_golden_replay(
        golden, torch.device("cpu"))
    for name, got in reports.items():
        assert json.dumps(got, sort_keys=True) == str(
            golden[f"reports/{name}"]), name
        assert len(got) == int(golden[f"steps/{name}"])
    np.testing.assert_array_equal(np.stack(decisions), golden["decisions"])
    assert eng.counts == {k: int(golden[f"counts/{k}"])
                          for k in eng.counts}
    assert eng.tokens_served == int(golden["tokens_served"])
    assert eng.in_flight == 0
    assert int(eng.agent_state.loss_count) == int(
        golden["train_steps_taken"]) == len(golden["train_steps"]) >= 1
    assert row == _golden_row(golden)
    want = flatten_dict(golden_tool.tree_of(golden, "final/params"))
    got = flatten_dict(eng.agent_state.params)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **PARAM_TOL)


def test_async_golden_file_is_current(jax_runs, golden):
    """Rebuilding the golden run with the JAX package gives the stored
    file: integers and strings exactly, floats to 1e-6; under 1 MiB."""
    data = jax_runs["async"]
    assert set(data) == set(golden)
    for k, v in data.items():
        want = golden[k]
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(v, want, rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v, want, err_msg=k)
    assert sum(int(data[f"steps/{r}"]) for r in data["runs"].tolist()) \
        == len(data["decisions"]) == len(data["rand_cands"])
    assert int(data["row/n_requests"]) == golden_tool.BENCH_TRACES["main"][2]
    assert json.loads(str(data["agent_kw"])) == serve_bench.AGENT_KW
    assert os.path.getsize(GOLDEN) < 1 << 20


# ---------------------------------------------------------------- the CLI
def test_main_quick_on_cpu_writes_rows_and_leaves_bench_serve(tmp_path,
                                                              monkeypatch):
    ref_file = ROOT / "BENCH_serve.json"
    before = ref_file.read_bytes()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("REPRO_HISTORY", str(tmp_path / "hist"))
    out = tmp_path / "bench.json"
    out.write_text(json.dumps([{"name": "other", "wall_s": 1.0}]))
    launch_main(["serve-bench", "--quick", "--device", "cpu", "--out",
                 str(out)])
    rows = json.loads(out.read_text())
    assert [r["name"] for r in rows] == ["other", "serve_sync_slots4",
                                         "serve_continuous_slots32"]
    sync, cont = rows[1:]
    assert set(sync) == SYNC_KEYS | STAMPS
    assert set(cont) == CONT_KEYS | STAMPS
    assert sync["backend"] == cont["backend"] == "cpu"
    assert sync["n_requests"] == cont["n_requests"] == 192
    assert cont["requests_per_s"] > sync["requests_per_s"]
    recs = HistoryStore(str(tmp_path / "hist")).records(kind="bench")
    assert [r["name"] for r in recs] == ["serve_sync_slots4",
                                         "serve_continuous_slots32"]
    assert recs[1]["metrics"]["queue_depth_p99"] == cont["queue_depth_p99"]
    assert not set(recs[0]["metrics"]) & set(obs_rows.NON_METRIC_KEYS)
    assert ref_file.read_bytes() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["bench.json",
                                                          "hist"]


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_bench.main(["--quick", "--out", str(tmp_path / "b.json")])
    assert not (tmp_path / "b.json").exists()


def test_card_stamp_reads_nvidia_smi_and_falls_back(monkeypatch):
    """Off the card no stamp; on it the name and limit from
    ``obs.log.card_line``'s query of the card's index; the torch name and
    no limit where ``nvidia-smi`` cannot be run."""
    assert obs_rows.card_stamp(torch.device("cpu")) == {}
    calls = []

    def smi(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(
            cmd, 0, "NVIDIA H100 80GB HBM3, 700.00 W\nCard B, 350.00 W\n")

    monkeypatch.setattr(subprocess, "run", smi)
    assert obs_rows.card_stamp(torch.device("cuda", 1)) == {
        "device_name": "Card B", "power_limit": "350.00 W"}
    assert obs_rows.card_stamp(torch.device("cuda")) == {
        "device_name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    assert calls[0] == ["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]

    def missing(cmd, **kw):
        raise FileNotFoundError(cmd[0])

    monkeypatch.setattr(subprocess, "run", missing)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "a card")
    assert obs_rows.card_stamp(torch.device("cuda")) == {
        "device_name": "a card", "power_limit": None}


# ------------------------------------------------- chip_smoke.py's phases
def test_chip_report_diff_holds_latencies_to_1e_6(chip_smoke, golden):
    cs = chip_smoke
    step = json.loads(str(golden["reports/main"]))[-1]
    assert step["served"] and cs.report_diff(step, step) == ([], 0.0)

    def moved(rel=0.0, **change):
        got = json.loads(json.dumps(step))
        got["served"][0]["latency_s"] *= 1 + rel
        got["served"][0].update(change)
        return cs.report_diff(got, step)

    bad, worst = moved(5e-7)
    assert bad == [] and 4e-7 < worst < 6e-7
    assert moved(2e-6)[0] and moved(exit=-1)[0] and moved(hit=False)[0]
    assert cs.report_diff(dict(step, admitted=[]), step)[0] == ["admitted"]


def test_chip_async_golden_phase_on_the_cpu(chip_smoke, golden,
                                            monkeypatch, capsys):
    """Phase 44 rehearsed on the CPU: the wrappers' plain calls counted as
    the kernels' launches."""
    from repro_torch.kernels import edge_score as edge_mod
    from repro_torch.kernels import gcn_agg as gcn_mod
    for mod, name in ((gcn_mod, "gcn_agg"), (edge_mod, "edge_score")):
        fn = getattr(mod, name)

        def counted(*args, _fn=fn, _mod=mod):
            _mod.launches += 1
            return _fn(*args)

        monkeypatch.setattr(mod, name, counted)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    counts = chip_smoke.serve_async_golden_phase(torch.device("cpu"))
    steps = len(golden["decisions"])
    n = steps + len(golden["train_steps"])
    assert counts["gcn_agg"] == 4 * n and counts["edge_score"] == n
    out = capsys.readouterr().out
    assert f"decisions equal {steps}/{steps} steps" in out
    assert "within 0.000e+00 relative" in out
