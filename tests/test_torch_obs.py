"""The port's telemetry registry (``repro_torch.obs.telemetry``) against the
JAX package's (``repro.obs.telemetry``): the same numpy-seeded inputs
through both, histogram counts exactly, counters that are counts exactly
and float32 sums within 1e-6 relative (the two sum in other orders)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.mec.env import SlotResult as JaxSlotResult
from repro.obs import telemetry as jt
from repro_torch.mec.env import SlotResult
from repro_torch.obs import telemetry as pt

torch.set_num_threads(1)

SUM_RTOL = 1e-6
COUNT_KEYS = ("slots", "tasks", "success", "train_steps", "admitted",
              "served", "expired", "generations", "pbt_rounds", "exploits",
              "resamples")


def assert_same_registry(got: pt.Telemetry, want: jt.Telemetry):
    assert list(got.counters) == list(want.counters)
    assert list(got.hists) == list(want.hists)
    for k, v in want.counters.items():
        g, w = float(got.counters[k]), float(v)
        if k in COUNT_KEYS:
            assert g == w, k
        else:
            np.testing.assert_allclose(g, w, rtol=SUM_RTOL, err_msg=k)
    for k, h in want.hists.items():
        assert got.hists[k].edges.dtype == torch.float32
        assert got.hists[k].counts.dtype == torch.float32
        np.testing.assert_array_equal(got.hists[k].edges.numpy(),
                                      np.asarray(h.edges), err_msg=k)
        np.testing.assert_array_equal(got.hists[k].counts.numpy(),
                                      np.asarray(h.counts), err_msg=k)
    g, w = float(got.loss_ema), float(want.loss_ema)
    assert np.isnan(g) == np.isnan(w)
    if not np.isnan(w):
        np.testing.assert_allclose(g, w, rtol=SUM_RTOL)


# ------------------------------------------------------------- histograms
EDGES = [0.0, 1.0, 2.0, 3.0]
HIST_CASES = {
    # below range, on the bottom edge, interior, on an interior edge,
    # inside the last bin, on the top edge, above range
    "edges": [-0.5, 0.0, 0.5, 1.0, 2.999, 3.0, 7.0],
    "top_edge": [3.0, 3.0, np.nextafter(np.float32(3.0), np.float32(0.0))],
    "nan": [np.nan, 0.5, np.nan],
    "inf": [np.inf, -np.inf, 1.5, np.inf],
}


@pytest.mark.parametrize("case", sorted(HIST_CASES))
@pytest.mark.parametrize("weighted", [False, True])
def test_hist_add_matches_reference(case, weighted):
    v = np.asarray(HIST_CASES[case], np.float32)
    w = None
    if weighted:
        w = (np.random.default_rng(len(v)).uniform(size=v.shape) > 0.4
             ).astype(np.float32)
    j = jt.hist_add(jt.hist_init(EDGES), jnp.asarray(v),
                    None if w is None else jnp.asarray(w))
    p = pt.hist_add(pt.hist_init(EDGES, device="cpu"), torch.tensor(v),
                    None if w is None else torch.tensor(w))
    np.testing.assert_array_equal(p.counts.numpy(), np.asarray(j.counts))
    assert p.counts.dtype == torch.float32


def test_hist_add_bins_nan_and_inf_as_documented():
    """NaN and +inf overflow, -inf underflows, values on an interior edge
    open its bin; many values over a batch axis, 0/1 weights exact."""
    rng = np.random.default_rng(0)
    v = rng.uniform(-1.0, 4.0, size=(64, 14)).astype(np.float32)
    v[0, :3] = [np.nan, np.inf, -np.inf]
    w = (rng.uniform(size=v.shape) > 0.3).astype(np.float32)
    w[0, :3] = 1.0
    p = pt.hist_add(pt.hist_init(EDGES, device="cpu"), torch.tensor(v),
                    torch.tensor(w))
    j = jt.hist_add(jt.hist_init(EDGES), jnp.asarray(v), jnp.asarray(w))
    np.testing.assert_array_equal(p.counts.numpy(), np.asarray(j.counts))
    one = pt.hist_add(pt.hist_init(EDGES, device="cpu"), torch.tensor(
        [np.nan, np.inf, -np.inf, 1.0], dtype=torch.float32))
    assert one.counts.tolist() == [1.0, 0.0, 1.0, 0.0, 2.0]
    assert float(p.counts.sum()) == float(w.sum())


@pytest.mark.parametrize("q", [0.0, 0.01, 0.3, 0.5, 0.99, 1.0])
@pytest.mark.parametrize("counts", [[0, 0, 0, 0, 0], [0, 0, 10, 0, 0],
                                    [5, 0, 0, 0, 0], [0, 0, 0, 0, 5],
                                    [1, 3, 2, 7, 4]])
def test_hist_quantile_matches_reference(q, counts):
    got = pt.hist_quantile(EDGES, counts, q)
    want = jt.hist_quantile(EDGES, counts, q)
    assert (np.isnan(got) and np.isnan(want)) or got == want


def test_hist_to_host_matches_reference():
    v = np.random.default_rng(1).uniform(-1, 4, size=50).astype(np.float32)
    p = pt.hist_add(pt.hist_init(EDGES, device="cpu"), torch.tensor(v))
    j = jt.hist_add(jt.hist_init(EDGES), jnp.asarray(v))
    assert pt.hist_to_host(p) == jt.hist_to_host(j)


# ------------------------------------------------------- rollout registry
def slot_results(seed, b=3, m=5, n_servers=2, n_exits=5):
    """A batched SlotResult with dead links (t_total = inf), inactive
    devices and misses, its decisions and active mask (numpy)."""
    rng = np.random.default_rng(seed)
    t_total = rng.uniform(0.0, 0.08, size=(b, m)).astype(np.float32)
    t_total[rng.uniform(size=(b, m)) < 0.15] = np.inf
    deadline = np.float32(0.03)
    active = (rng.uniform(size=(b, m)) > 0.2).astype(np.float32)
    res = dict(
        reward=rng.uniform(size=(b,)).astype(np.float32),
        t_total=t_total,
        success=(t_total <= deadline) & (active > 0.5),
        accuracy=rng.uniform(0.5, 1.0, size=(b, m)).astype(np.float32),
        t_com=rng.uniform(0.0, 0.02, size=(b, m)).astype(np.float32),
        t_wait=rng.uniform(0.0, 0.01, size=(b, m)).astype(np.float32),
        t_cmp=rng.uniform(0.0, 0.02, size=(b, m)).astype(np.float32))
    decisions = rng.integers(0, n_servers * n_exits, size=(b, m),
                             dtype=np.int32)
    return res, decisions, active, deadline


def fold_both(n_slots, losses, *, deadline_per_fleet=False):
    j = jt.rollout_telemetry(2, 5)
    p = pt.rollout_telemetry(2, 5, device="cpu")
    for t in range(n_slots):
        res, dec, act, dl = slot_results(t)
        if deadline_per_fleet:
            dl = np.asarray([0.02, 0.03, 0.05], np.float32)
        frac = np.float32(min(t + 1, 4) / 4)
        loss = np.float32(losses[t])
        j = jt.telemetry_update(
            j, decisions=jnp.asarray(dec),
            result=JaxSlotResult(**{k: jnp.asarray(v)
                                    for k, v in res.items()}),
            active=jnp.asarray(act), deadline_s=jnp.asarray(dl),
            replay_frac=jnp.asarray(frac), loss=jnp.asarray(loss),
            n_exits=5)
        p = pt.telemetry_update(
            p, decisions=torch.tensor(dec),
            result=SlotResult(**{k: torch.tensor(v)
                                 for k, v in res.items()}),
            active=torch.tensor(act), deadline_s=torch.tensor(dl),
            replay_frac=torch.tensor(frac), loss=torch.tensor(loss),
            n_exits=5)
    return p, j


def test_rollout_registry_matches_reference():
    p = pt.rollout_telemetry(2, 5, device="cpu")
    j = jt.rollout_telemetry(2, 5)
    assert pt.ROLLOUT_COUNTERS == jt.ROLLOUT_COUNTERS
    assert_same_registry(p, j)


@pytest.mark.parametrize("per_fleet", [False, True])
def test_telemetry_update_matches_reference(per_fleet):
    """Six slots of dead links, inactive devices and misses; train losses
    at slots 2, 4 and 5 (the EMA's first value, then its blend)."""
    nan = np.nan
    p, j = fold_both(6, [nan, nan, 0.7, nan, 0.5, 0.45],
                     deadline_per_fleet=per_fleet)
    assert_same_registry(p, j)
    assert float(p.counters["slots"]) == 6
    assert float(p.counters["train_steps"]) == 3
    # dead links never reach the seconds counters
    assert np.isfinite(float(p.counters["t_com_s"]))


def test_serve_registry_matches_reference():
    p = pt.serve_telemetry(2, 5, device="cpu")
    j = jt.serve_telemetry(2, 5)
    for admitted, served, expired, depth in ((3, 0, 0, 3), (2, 4, 1, 0),
                                             (0, 0, 0, 5000), (7, 2, 0, 9)):
        p = pt.serve_telemetry_update(p, admitted, served, expired, depth)
        j = jt.serve_telemetry_update(j, admitted, served, expired, depth)
    assert_same_registry(p, j)
    assert pt.QUEUE_DEPTH_EDGES == jt.QUEUE_DEPTH_EDGES


def test_pop_registry_matches_reference():
    p = pt.pop_telemetry(4, 3, device="cpu")
    j = jt.pop_telemetry(4, 3)
    rng = np.random.default_rng(2)
    for gen in range(3):
        region = rng.integers(0, 3, size=4)
        kw_j, kw_p = {}, {}
        if gen:
            ranks = rng.integers(0, 4, size=4)
            copied = (rng.uniform(size=4) > 0.5).astype(np.float32)
            kw_j = dict(src_ranks=jnp.asarray(ranks),
                        copied=jnp.asarray(copied))
            kw_p = dict(src_ranks=torch.tensor(ranks),
                        copied=torch.tensor(copied))
        j = jt.pop_telemetry_update(j, region=jnp.asarray(region), **kw_j)
        p = pt.pop_telemetry_update(p, region=torch.tensor(region), **kw_p)
    assert_same_registry(p, j)


@pytest.mark.parametrize("n_slots", [0, 6])
def test_host_view_and_summary_match_reference(n_slots):
    """``telemetry_host`` (one copy) and ``telemetry_summary`` on the same
    registry; the empty one reports None quantiles and stays strict JSON."""
    nan = np.nan
    p, j = fold_both(n_slots, [nan, 0.3, nan, 0.2, nan, 0.1][:n_slots])
    hp, hj = pt.telemetry_host(p), jt.telemetry_host(j)
    assert hp["hists"] == hj["hists"]
    for k, v in hj["counters"].items():
        np.testing.assert_allclose(hp["counters"][k], v, rtol=SUM_RTOL,
                                   err_msg=k)
    sp, sj = pt.telemetry_summary(hp), jt.telemetry_summary(hj)
    assert set(sp) == set(sj)
    for k, v in sj.items():
        if v is None or isinstance(v, list):
            assert sp[k] == v, k
        else:
            np.testing.assert_allclose(sp[k], v, rtol=1e-5, err_msg=k)
    json.dumps(hp | {"summary": sp} if n_slots else sp, allow_nan=False)
