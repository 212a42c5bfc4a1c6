"""The serving layer (``repro_torch.serve``) against the JAX reference
(``repro.serve``), on the CPU.

* The pure host pieces (clocks, queue, scheduler core) run the
  reference's cases, and the reference's and the port's scheduler cores
  run the same fixed-seed random schedules: equal outputs.
* Workloads: ``WorkloadGen.sample`` on the four dynamic scenarios gets
  JAX's own raw uniforms, rebuilt with the reference's key splits;
  ``active`` and ``member`` equal, the other leaves within 1e-6 relative.
* ``llm_exit_profile`` with the reference's roofline constants and
  ``RunningMetrics`` on the same results: equal to JAX at 1e-6 relative.
* ``EdgeServingEngine`` against a JAX engine (reduced ``qwen1_5_0_5b``,
  f32, 12 slots with decoding and one train step; GRLE, GRL, DROOE and
  DROO) with the JAX run's LM params, initial ``AgentState`` and draws
  injected (``tools/make_torch_port_golden.py``): assignments, texts,
  telemetry counts, tokens served and the latency ring equal; rewards,
  the §VI-D summary and losses within 1e-5 relative; final params within
  rtol 1e-4 / atol 2e-7. ``tests/data/torch_serve_golden.npz`` is that
  GRLE run.
* A request longer than the engine's 256-row cache decodes over the
  wrapped cache to the JAX engine's tokens.
* ``ContinuousServingEngine`` against JAX on a JAX trace, both hold
  policies: every step report equal; the counter law exact.
* Port-only, on the port's own generator: the reference's
  ``tests/test_serve.py`` engine cases (replay, counter balance, hold
  policies, sync-vs-async equivalence, hot swaps, the A/B pool, token
  accounting, the load generator).
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.mec import MECEnv as JaxEnv
from repro.mec import RunningMetrics as JaxMetrics
from repro.mec import llm_exit_profile as jax_llm_exit_profile
from repro.mec import make_scenario as jax_scenario
from repro.rollout import make_workload as jax_make_workload
from repro.serve import engine as jax_engine
from repro.serve import make_trace as jax_make_trace
from repro.serve import queue as jax_queue
from repro_torch.configs import get_arch
from repro_torch.core.bridge import (agent_state_from_numpy,
                                     agent_state_from_params,
                                     lm_params_from_numpy, lm_params_numpy)
from repro_torch.mec import (MECEnv, RunningMetrics, SlotTasks, SlotUniforms,
                             llm_exit_profile, make_scenario)
from repro_torch.mec.profiles import H100_HBM_BW, H100_PEAK_BF16_FLOPS
from repro_torch.nn.pytree import flatten_dict
from repro_torch.obs import HistoryStore
from repro_torch.rollout import (InitDraws, WorkloadDraws, WorkloadState,
                                 make_workload)
from repro_torch.serve import (AgentPool, ContinuousServingEngine,
                               EdgeServingEngine, Replica, Request,
                               ServeDraws, ServeRequest, VirtualClock,
                               WallClock, batch_init, batch_occupancy,
                               batch_release, make_trace, queue_depth,
                               queue_expire, queue_init, queue_pop,
                               queue_push, queue_requeue, sched_evict,
                               sched_tick)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import make_torch_port_golden as golden_tool  # noqa: E402

sys.path.pop(0)
torch.set_num_threads(1)

AGENT_KW = golden_tool.SERVE_AGENT_KW      # tests/test_serve.py's AGENT_KW
GOLDEN = golden_tool.SERVE_GOLDEN
RTOL = 1e-5                 # rewards, summaries, losses
PARAM_TOL = dict(rtol=1e-4, atol=2e-7)      # PR 18's final-param tolerance
WL_RTOL = 1e-6              # workload leaves
DYN = ("dyn_poisson", "dyn_bursty", "dyn_churn", "dyn_markov_channel")


def _arch():
    return get_arch("qwen1_5_0_5b", reduced=True)


def _replicas():
    return [Replica(n, s) for n, s in golden_tool.SERVE_REPLICAS]


def _engine(method="grle", batch_slots=4, seed=0, **kw):
    kw.setdefault("workload", "mmpp")
    kw.setdefault("scenario", "dyn_bursty")
    kw.setdefault("agent_kw", AGENT_KW)
    return ContinuousServingEngine(_arch(), _replicas(), scheduler=method,
                                   batch_slots=batch_slots, seed=seed,
                                   device="cpu", **kw)


def _req(rid, arrival=0.0, deadline=10.0, priority=0):
    return ServeRequest(rid=rid, arrival_s=arrival, deadline_s=deadline,
                        priority=priority)


def _ref_profile_kw():
    from repro.mec.profiles import TPU_V5E_HBM_BW, TPU_V5E_PEAK_FLOPS
    return dict(peak_flops=TPU_V5E_PEAK_FLOPS, hbm_bw=TPU_V5E_HBM_BW)


# ------------------------------------------------------------------- clocks
class TestClocks:
    def test_virtual_clock_advances_only_on_demand(self):
        c = VirtualClock()
        assert c.now() == 0.0
        assert c.advance(1.5) == 1.5
        assert c.now() == 1.5
        assert c.now() == 1.5          # reading does not advance

    def test_virtual_clock_rejects_negative(self):
        with pytest.raises(ValueError):
            VirtualClock().advance(-1e-9)

    def test_wall_clock_monotone_and_advance_noop(self):
        c = WallClock()
        a = c.now()
        b = c.advance(100.0)           # must NOT jump forward by 100 s
        assert b < 1.0
        assert a <= b <= c.now()


# -------------------------------------------------------------------- queue
class TestQueue:
    def test_push_stamps_monotone_seq(self):
        q = queue_push(queue_init(), [_req(i) for i in range(3)])
        q = queue_push(q, [_req(3)])
        assert [e.seq for e in q.pending] == [0, 1, 2, 3]
        assert q.next_seq == 4
        assert queue_depth(q) == 4

    def test_fifo_within_priority(self):
        reqs = [_req(0, priority=1), _req(1, priority=0),
                _req(2, priority=1), _req(3, priority=0)]
        q = queue_push(queue_init(), reqs)
        q, admitted = queue_pop(q, 3, now=0.0)
        assert [e.req.rid for e in admitted] == [1, 3, 0]
        assert [e.req.rid for e in q.pending] == [2]

    def test_expire_drops_past_deadline(self):
        reqs = [_req(0, deadline=1.0), _req(1, deadline=3.0),
                _req(2, deadline=2.0)]
        q = queue_push(queue_init(), reqs)
        q, expired = queue_expire(q, now=2.0)
        assert [e.req.rid for e in expired] == [0, 2]
        assert [e.req.rid for e in q.pending] == [1]

    def test_pop_never_admits_dead_requests(self):
        q = queue_push(queue_init(), [_req(0, deadline=1.0),
                                      _req(1, deadline=9.0)])
        q, admitted = queue_pop(q, 2, now=5.0)
        assert [e.req.rid for e in admitted] == [1]
        assert [e.req.rid for e in q.pending] == [0]

    def test_requeue_restores_original_order(self):
        q = queue_push(queue_init(), [_req(i) for i in range(4)])
        q, first = queue_pop(q, 2, now=0.0)
        q = queue_push(q, [_req(4)])
        q = queue_requeue(q, first)
        q, admitted = queue_pop(q, 5, now=0.0)
        assert [e.req.rid for e in admitted] == [0, 1, 2, 3, 4]


# ----------------------------------------------------- scheduler-core props
class TestSchedulerInvariants:
    """The reference's property cases: a fixed-seed RNG drives random
    push/tick/evict/release schedules through the pure core."""

    N_OPS = 400

    def _random_walk(self, seed, capacity=6):
        rng = np.random.default_rng(seed)
        clock = VirtualClock()
        q, batch = queue_init(), batch_init(capacity)
        submitted, expired_ids, served_ids = [], [], []
        running_rid = 0
        for _ in range(self.N_OPS):
            op = rng.integers(0, 4)
            now = clock.now()
            if op == 0:
                k = int(rng.integers(1, 4))
                reqs = [_req(running_rid + i, arrival=now,
                             deadline=now + float(rng.uniform(0.05, 2.0)),
                             priority=int(rng.integers(0, 3)))
                        for i in range(k)]
                running_rid += k
                submitted += [r.rid for r in reqs]
                q = queue_push(q, reqs)
            elif op == 1:
                q, batch, ev = sched_tick(q, batch, now)
                expired_ids += [e.req.rid for e in ev.expired]
                for _, e in ev.admitted:
                    assert e.req.deadline_s > now
            elif op == 2:
                ids = [i for i in range(capacity) if rng.random() < 0.3]
                q, batch, _ = sched_evict(q, batch, ids)
            else:
                slots = list(batch.slots)
                for i, r in enumerate(slots):
                    if r is not None and r.hold == 0:
                        slots[i] = r._replace(hold=int(rng.integers(1, 4)))
                batch = batch._replace(slots=tuple(slots))
                batch, released = batch_release(batch)
                served_ids += [r.entry.req.rid for _, r in released]
            assert 0 <= batch_occupancy(batch) <= capacity
            in_batch = [r.entry.req.rid for r in batch.slots
                        if r is not None]
            assert len(in_batch) == len(set(in_batch))
            clock.advance(float(rng.uniform(0.0, 0.2)))
        return submitted, expired_ids, served_ids, q, batch, clock

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_invariants_hold_under_random_schedules(self, seed):
        submitted, expired, served, q, batch, clock = self._random_walk(seed)
        accounted = set(expired) | set(served)
        assert len(expired) == len(set(expired))
        assert len(served) == len(set(served))
        assert set(expired) & set(served) == set()
        pending = {e.req.rid for e in q.pending}
        in_batch = {r.entry.req.rid for r in batch.slots if r is not None}
        assert accounted | pending | in_batch == set(submitted)

    def test_no_request_outlives_deadline_unmarked(self):
        clock = VirtualClock()
        reqs = [_req(i, deadline=0.25 + 0.05 * i) for i in range(10)]
        q, batch = queue_push(queue_init(), reqs), batch_init(1)
        seen_expired, seen_served = set(), set()
        while queue_depth(q) or batch_occupancy(batch):
            now = clock.now()
            q, batch, ev = sched_tick(q, batch, now)
            seen_expired |= {e.req.rid for e in ev.expired}
            for _, e in ev.admitted:
                assert e.req.deadline_s > now
            slots = tuple(r._replace(hold=1) if r and r.hold == 0 else r
                          for r in batch.slots)
            batch, released = batch_release(batch._replace(slots=slots))
            seen_served |= {r.entry.req.rid for _, r in released}
            clock.advance(0.2)
        assert seen_expired | seen_served == set(range(10))
        assert seen_expired
        assert seen_expired & seen_served == set()

    def test_evict_then_readmit_is_idempotent(self):
        q = queue_push(queue_init(),
                       [_req(i, priority=i % 2) for i in range(6)])
        q, batch, ev = sched_tick(q, batch_init(4), now=0.0)
        before = {slot: e.req.rid for slot, e in ev.admitted}
        q, batch, evicted = sched_evict(q, batch, range(4))
        assert batch_occupancy(batch) == 0
        q, batch, ev2 = sched_tick(q, batch, now=0.0)
        after = {slot: e.req.rid for slot, e in ev2.admitted}
        assert after == before


def _view(x):
    """A framework-neutral view of queue/scheduler values: requests by
    their fields, NamedTuples and tuples element by element."""
    if dataclasses.is_dataclass(x):
        return ("req",) + tuple(dataclasses.astuple(x))
    if isinstance(x, tuple):
        return tuple(_view(v) for v in x)
    if isinstance(x, float) and np.isnan(x):
        return "nan"
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_core_equals_reference_on_random_schedules(seed):
    """The reference's queue_* / sched_tick / sched_evict / batch_release
    and the port's, side by side on one fixed-seed random schedule:
    every output equal."""
    rng = np.random.default_rng(100 + seed)
    mods = {"ref": (jax_queue, jax_engine), "port": None}
    from repro_torch.serve import engine as port_engine
    from repro_torch.serve import queue as port_queue
    mods["port"] = (port_queue, port_engine)
    state = {k: (q.queue_init(), e.batch_init(5)) for k, (q, e) in
             mods.items()}
    now, rid = 0.0, 0
    for _ in range(300):
        op = int(rng.integers(0, 5))
        spec = [(rid + i, now, now + float(rng.uniform(0.05, 2.0)),
                 int(rng.integers(0, 3))) for i in range(
                     int(rng.integers(1, 4)))]
        evict = [i for i in range(5) if rng.random() < 0.3]
        holds = [int(rng.integers(1, 4)) for _ in range(5)]
        k = int(rng.integers(0, 4))
        outs = {}
        for name, (qm, em) in mods.items():
            q, batch = state[name]
            if op == 0:
                q = qm.queue_push(q, [qm.ServeRequest(*s) for s in spec])
                out = qm.queue_depth(q)
            elif op == 1:
                q, batch, out = em.sched_tick(q, batch, now)
            elif op == 2:
                q, batch, out = em.sched_evict(q, batch, evict)
            elif op == 3:
                slots = tuple(r._replace(hold=holds[i])
                              if r is not None and r.hold == 0 else r
                              for i, r in enumerate(batch.slots))
                batch, out = em.batch_release(batch._replace(slots=slots))
            else:
                q, out = qm.queue_expire(q, now)
                q, popped = qm.queue_pop(q, k, now)
                out = (out, popped)
            state[name] = (q, batch)
            outs[name] = _view((out, q, batch, em.batch_occupancy(batch)))
        assert outs["ref"] == outs["port"]
        if op == 0:
            rid += len(spec)
        now += float(rng.uniform(0.0, 0.2))


# ----------------------------------------------------------------- workloads
def _u(key, shape):
    return np.asarray(jax.random.uniform(key, shape))


def _jax_init_draws(key, m, n):
    """The uniforms of the reference's ``WorkloadGen.init``."""
    kr, kc = jax.random.split(key)
    return InitDraws(torch.tensor(_u(kr, (m, n))), torch.tensor(_u(kc, (n,))))


def _jax_sample_draws(key, m, n, l):
    """The uniforms of the reference's ``WorkloadGen.sample``
    (``workloads.py:100-139``): one key split nine ways."""
    ks = jax.random.split(key, 9)
    t = torch.tensor
    return WorkloadDraws(
        burst=t(_u(ks[0], ())), arrive=t(_u(ks[1], (m,))),
        churn=t(_u(ks[2], (m,))), rate=t(_u(ks[3], (m, n))),
        capacity=t(_u(ks[5], (n,))),
        slot=SlotUniforms(t(_u(ks[7], (m,))), t(_u(ks[4], (m, n))),
                          t(_u(ks[6], (n, l))), t(_u(ks[8], (m, n)))))


def _close(got, want, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if name in ("active", "member", "burst", "connect"):
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=WL_RTOL, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("scenario", DYN)
def test_workload_sample_equals_reference_on_its_draws(scenario):
    """16 slots of each dynamic scenario at M=8: the port's ``init`` and
    ``sample`` on the reference's raw uniforms give the reference's state
    and tasks (``active``/``member``/links exact, the rest 1e-6)."""
    m, t = 8, 16
    jenv = JaxEnv(jax_scenario(scenario, n_devices=m))
    env = MECEnv(make_scenario(scenario, n_devices=m), device="cpu")
    jgen, gen = jax_make_workload(jenv), make_workload(env)
    key = jax.random.PRNGKey(7)
    k_init, k_run = jax.random.split(key)
    jst = jgen.init(k_init)
    st = gen.init(draws=_jax_init_draws(k_init, m, env.N))
    for f in WorkloadState._fields:
        _close(getattr(st, f), getattr(jst, f), f)
    fired = 0
    for k in jax.random.split(k_run, t):
        jst, jtasks = jgen.sample(jst, k)
        st, tasks = gen.sample(st, draws=_jax_sample_draws(
            k, m, env.N, env.L))
        for f in WorkloadState._fields:
            _close(getattr(st, f), getattr(jst, f), f)
        for f in SlotTasks._fields:
            _close(getattr(tasks, f), getattr(jtasks, f), f)
        fired += int(tasks.active.sum())
    assert 0 < fired < m * t           # the arrival process did thin


@pytest.mark.parametrize("scenario", ["dyn_bursty", "dyn_markov_channel"])
def test_arrival_trace_equals_sequential_sample(scenario):
    env = MECEnv(make_scenario(scenario, n_devices=8), device="cpu")
    gen = make_workload(env)
    st0 = gen.init(torch.Generator().manual_seed(5))
    _, active = gen.arrival_trace(st0, torch.Generator().manual_seed(6), 12)
    g, st, rows = torch.Generator().manual_seed(6), st0, []
    for _ in range(12):
        st, tasks = gen.sample(st, g)
        rows.append(tasks.active)
    assert torch.equal(active, torch.stack(rows))


def test_workload_batch_axes_and_iid_path():
    """Leading batch axes: B networks in one call; the iid path is
    ``sample_slot`` on the same generator state."""
    env = MECEnv(make_scenario("dyn_churn", n_devices=6), device="cpu")
    gen = make_workload(env)
    st = gen.init(torch.Generator().manual_seed(0), batch=(3,))
    st, tasks = gen.sample(st, torch.Generator().manual_seed(1))
    assert tuple(tasks.rate_est.shape) == (3, 6, 2)
    assert tuple(st.burst.shape) == (3,)
    iid = MECEnv(make_scenario("fig5_baseline"), device="cpu")
    _, a = make_workload(iid).sample(None, torch.Generator().manual_seed(2),
                                     batch=(4,))
    b = iid.sample_slot(torch.Generator().manual_seed(2), (4,))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_env_scenario_params_override():
    """``sp`` threads through observe/evaluate/step/sample_slot: an env
    handed another config's params acts as that config's env."""
    a = MECEnv(make_scenario("fig5_baseline"), device="cpu")
    b = MECEnv(make_scenario("fig8_csi"), device="cpu")
    tasks = b.sample_slot(torch.Generator().manual_seed(0), (2,))
    got = a.sample_slot(torch.Generator().manual_seed(0), (2,), b.params)
    for x, y in zip(got, tasks):
        assert torch.equal(x, y)
    st = a.reset((2,))
    dec = torch.randint(0, a.N * a.L, (2, 5, a.M),
                        generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.evaluate(st, tasks, dec, b.params),
                       b.evaluate(st, tasks, dec))
    for k, v in a.observe(st, tasks, b.params).items():
        assert torch.equal(v, b.observe(st, tasks)[k])
    (s1, r1), (s2, r2) = (a.step(st, tasks, dec[:, 0], b.params),
                          b.step(st, tasks, dec[:, 0]))
    for x, y in zip(list(s1) + list(r1), list(s2) + list(r2)):
        assert torch.equal(x, y)


# ------------------------------------------------ exit profile and metrics
@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen1_5_0_5b",
                                  "rwkv6_7b"])
def test_llm_exit_profile_equals_reference(arch):
    cfg = get_arch(arch)
    args = (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab, cfg.exit_layers)
    for kw in ({}, {"kv_len": 256, "seq_len": 4, "n_chips": 2}):
        t, q = llm_exit_profile(*args, **kw, **_ref_profile_kw())
        jt, jq = jax_llm_exit_profile(*args, **kw)
        np.testing.assert_allclose(t, jt, rtol=1e-12)
        np.testing.assert_allclose(q, jq, rtol=1e-12)
    # default arguments model the card: the H100's published figures
    assert (H100_PEAK_BF16_FLOPS, H100_HBM_BW) == (989e12, 3.35e12)
    t, _ = llm_exit_profile(*args)
    want, _ = llm_exit_profile(*args, peak_flops=989e12, hbm_bw=3.35e12)
    np.testing.assert_array_equal(t, want)
    assert (t < jax_llm_exit_profile(*args)[0]).all()


def test_running_metrics_equal_reference():
    jenv = JaxEnv(jax_scenario("fig8_csi"))
    env = MECEnv(make_scenario("fig8_csi"), device="cpu")
    jm, m = JaxMetrics(slot_s=0.03), RunningMetrics(slot_s=0.03)
    rng = np.random.default_rng(0)
    st, jst = env.reset(), jenv.reset()
    for i in range(6):
        tasks = env.sample_slot(torch.Generator().manual_seed(i))
        tasks = tasks._replace(active=torch.tensor(
            (rng.random(env.M) < 0.7).astype(np.float32)))
        dec = torch.tensor(rng.integers(0, env.N * env.L, env.M))
        st, res = env.step(st, tasks, dec)
        jtasks = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()),
                                        tuple(tasks))
        from repro.mec.env import SlotTasks as JaxTasks
        jst, jres = jenv.step(jst, JaxTasks(*jtasks),
                              jnp.asarray(dec.numpy(), jnp.int32))
        m.update(res, tasks.active)
        jm.update(jres, jtasks[-1])
    got, want = m.summary(), jm.summary()
    assert got["tasks"] == want["tasks"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


# ------------------------------------------------- sync engine against JAX
@pytest.fixture(scope="module")
def jax_sync():
    """The JAX sync engine's run for GRLE and GRL, once per module."""
    return {m: golden_tool.serve_run(m) for m in ("grle", "grl")}


def port_sync(data, *, state=None, device="cpu"):
    """The port's sync engine replaying a serve run: the JAX run's LM
    params (``lm_params_numpy``), initial agent state (``state``, a numpy
    reference ``AgentState``; else the stored params and exit mask) and
    draws injected. Returns (engine, per-slot [(assignments, info)])."""
    cfg = _arch()
    eng = EdgeServingEngine(
        cfg, _replicas(), scheduler=str(data["scheduler"]),
        batch_slots=golden_tool.SERVE_BATCH, seed=int(data["seed"]),
        workload="mmpp", scenario="dyn_bursty", agent_kw=AGENT_KW,
        profile_kw={k: float(data[f"profile/{k}"])
                    for k in ("peak_flops", "hbm_bw")}, device=device)
    eng.params = lm_params_from_numpy(
        lm_params_numpy(cfg, int(data["lm_seed"])), cfg, device)
    if state is not None:
        eng.set_agent_state(agent_state_from_numpy(state, device))
    else:
        eng.set_agent_state(agent_state_from_params(
            eng.agent_def, golden_tool.tree_of(data, "init_params"),
            data["exit_mask"]))
    takes = dict(zip(data["train_steps"].tolist(), data["replay_take"]))
    eng.inject_draws(
        ServeDraws(SlotTasks(*(torch.tensor(data[f"tasks/{f}"][t])
                               for f in SlotTasks._fields)),
                   torch.tensor(data["rand_cands"][t].astype(np.int64)),
                   None if t not in takes else torch.tensor(takes[t]))
        for t in range(len(data["schedule"])))
    out = []
    for n in data["schedule"].tolist():
        reqs = None if n < 0 else [eng.make_request() for _ in range(n)]
        count = int(eng.agent_state.loss_count)
        assignments, info = eng.serve_slot(reqs, decode=True)
        info["loss"] = (float(eng.agent_state.last_loss)
                        if int(eng.agent_state.loss_count) > count
                        else float("nan"))
        out.append((assignments, info))
    return eng, out


def check_sync(data, eng, out):
    names = [n for n, _ in golden_tool.SERVE_REPLICAS]
    for i, (assignments, info) in enumerate(out):
        want = [(names[r], int(e)) for r, e in zip(
            data["assign_replica"][i], data["assign_exit"][i]) if r >= 0]
        assert assignments == want, f"slot {i}"
        texts = [list(map(int, data["texts"][i, j]))
                 for j in range(len(want))]
        assert (info["texts"] or []) == texts, f"slot {i}"
        np.testing.assert_allclose(info["reward"], data["reward"][i],
                                   rtol=RTOL, atol=1e-7)
        np.testing.assert_allclose(info["loss"], data["loss"][i], rtol=RTOL)
    assert np.isfinite(data["loss"]).sum() >= 1        # a train step ran
    summary = eng.metrics.summary()
    for k in golden_tool.SUMMARY_KEYS:
        np.testing.assert_allclose(summary[k], data[f"summary/{k}"],
                                   rtol=RTOL, err_msg=k)
    assert eng.tokens_served == int(data["tokens_served"])
    final = flatten_dict(golden_tool.tree_of(data, "final/params"))
    got = flatten_dict(eng.agent_state.params)
    assert set(got) == set(final)
    for path, want in final.items():
        np.testing.assert_allclose(got[path].numpy(), want, err_msg=path,
                                   **PARAM_TOL)


@pytest.mark.parametrize("method", ["grle", "grl"])
def test_edge_engine_equals_jax(jax_sync, method):
    """12 slots (explicit and arrival-driven, decoding, one train step)
    from the JAX run's full initial ``AgentState`` and draws."""
    data, extra = jax_sync[method]
    eng, out = port_sync(data, state=extra["state0"])
    check_sync(data, eng, out)
    # the latency ring exactly; telemetry counts exactly, sums at 1e-5
    np.testing.assert_array_equal(np.asarray(eng._latency_ring),
                                  extra["latency_ring"])
    snap, want = eng.telemetry_snapshot(), extra["telemetry"]
    for k, v in want["counters"].items():
        if k in ("slots", "tasks", "success", "train_steps"):
            assert snap["counters"][k] == v, k
        else:
            np.testing.assert_allclose(snap["counters"][k], v, rtol=RTOL,
                                       err_msg=k)
    for k, h in want["hists"].items():
        assert snap["hists"][k]["counts"] == list(h["counts"]), k
    assert snap["summary"]["tokens_served"] == \
        want["summary"]["tokens_served"]
    assert snap["transfers"]["decode_h2d"] == \
        want["transfers"]["decode_h2d"]


@pytest.fixture(scope="module")
def serve_golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_serve_golden_replays_equal(serve_golden):
    """The stored GRLE run (what ``chip_smoke.py`` replays on the card),
    from its params and exit mask."""
    eng, out = port_sync(serve_golden)
    check_sync(serve_golden, eng, out)


def test_serve_golden_file_is_current(jax_sync, serve_golden):
    """Rebuilding the serve golden run with the JAX package gives the
    stored file: integers exactly, floats to 1e-6."""
    data = jax_sync["grle"][0]
    assert set(data) == set(serve_golden)
    for k, v in data.items():
        want = serve_golden[k]
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(v, want, rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v, want, err_msg=k)
    assert os.path.getsize(GOLDEN) < 1 << 20


# ------------------------------------------------ async engine against JAX
@pytest.mark.parametrize("hold", ["slot", "latency"])
def test_continuous_engine_equals_jax(hold):
    """A JAX trace through both async engines with the JAX run's initial
    agent state and draws: every step report equal, the counter law
    exact."""
    jeng = golden_tool.serve_engine("grle", "async", hold=hold)
    slot = float(jeng.env.cfg.slot_s)
    trace = jax_make_trace(n_users=8, n_slots=20, slot_s=slot,
                           deadline_slack_s=3 * slot, seed=1)
    state0 = jax.tree_util.tree_map(np.asarray, jeng.agent_state)
    rec = golden_tool.record_draws(jeng)
    want = jeng.run(trace)
    draws = golden_tool.serve_draws(jeng, rec)

    eng = _engine(hold=hold, profile_kw=_ref_profile_kw())
    eng.set_agent_state(agent_state_from_numpy(state0, "cpu"))
    takes = dict(zip(draws["train_steps"].tolist(), draws["replay_take"]))
    eng.inject_draws(
        ServeDraws(SlotTasks(*(torch.tensor(draws[f"tasks/{f}"][t])
                               for f in SlotTasks._fields)),
                   torch.tensor(draws["rand_cands"][t].astype(np.int64)),
                   None if t not in takes else torch.tensor(takes[t]))
        for t in range(len(rec)))
    got = eng.run([ServeRequest(**dataclasses.asdict(r)) for r in trace])
    assert len(draws["train_steps"]) >= 1
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    c = eng.counts
    assert c == jeng.counts
    assert c["admitted"] == c["served"] + c["expired"] + eng.in_flight
    assert eng.in_flight == 0 and c["admitted"] == len(trace)


# ---------------------------------------------- port-only engine behaviour
class TestEngineReplay:
    def test_fixed_seed_trace_replays_byte_identical(self):
        def one_run():
            eng = _engine(batch_slots=8, seed=3)
            trace = make_trace(n_users=12, n_slots=30,
                               slot_s=float(eng.env.cfg.slot_s),
                               deadline_slack_s=0.4, seed=3)
            return json.dumps(eng.run(trace), sort_keys=True), eng
        blob_a, eng_a = one_run()
        blob_b, eng_b = one_run()
        assert blob_a == blob_b
        assert eng_a.counts == eng_b.counts

    def test_counter_balance_exact_mid_trace_and_drained(self, tmp_path):
        eng = _engine(batch_slots=4, seed=1, hold="latency")
        slot = float(eng.env.cfg.slot_s)
        trace = make_trace(n_users=32, n_slots=40, slot_s=slot,
                           deadline_slack_s=3 * slot, seed=1)
        eng.run(trace, max_steps=10)
        c = eng.counts
        assert c["admitted"] == c["served"] + c["expired"] + eng.in_flight
        eng.run([])
        c = eng.counts
        assert eng.in_flight == 0
        assert c["admitted"] == c["served"] + c["expired"]
        assert c["expired"] > 0
        store = HistoryStore(str(tmp_path))
        snap = eng.telemetry_snapshot(history=store, name="async")
        assert snap["counters"]["admitted"] == c["admitted"]
        assert snap["counters"]["served"] == c["served"]
        assert snap["counters"]["expired"] == c["expired"]
        assert snap["summary"]["requests_in_flight"] == 0
        assert snap["summary"]["queue_depth_p99"] is not None
        json.dumps(snap["summary"], allow_nan=False)
        rec, = store.records(kind="serve", name="async")
        assert rec["manifest"]["backend"] == "cpu"
        assert "torch_version" in rec["manifest"]
        assert rec["metrics"]["requests_served"] == c["served"]

    def test_latency_hold_policy(self):
        eng = _engine(batch_slots=2, seed=0, hold="latency")
        slot = float(eng.env.cfg.slot_s)
        assert eng._hold_steps(0.0) == 1
        assert eng._hold_steps(slot * 0.5) == 1
        assert eng._hold_steps(slot * 3.5) == 4
        assert eng._hold_steps(float("inf")) == 1
        assert _engine(batch_slots=2, seed=0)._hold_steps(slot * 3.5) == 1
        eng.submit([_req(i, deadline=50.0) for i in range(6)])
        while eng.in_flight:
            assert eng.step()["occupancy"] <= 2
        assert eng.counts["served"] == 6

    def test_unknown_hold_policy_rejected(self):
        with pytest.raises(ValueError, match="hold"):
            _engine(hold="forever")


class TestSyncAsyncEquivalence:
    """Replaying the async engine's per-step admission groups through the
    synchronous ``serve_slot`` reproduces every assignment and the final
    agent params, on the port's own generator."""

    @pytest.mark.parametrize("method", ["grle", "grl"])
    def test_decisions_match_serve_slot(self, method):
        asy = _engine(method=method, batch_slots=4, seed=0)
        trace = make_trace(n_users=6, n_slots=20,
                           slot_s=float(asy.env.cfg.slot_s),
                           deadline_slack_s=5.0, seed=1)
        reports = asy.run(trace)
        syn = EdgeServingEngine(_arch(), _replicas(), scheduler=method,
                                batch_slots=4, seed=0, workload="mmpp",
                                scenario="dyn_bursty", agent_kw=AGENT_KW,
                                init_model=False, device="cpu")
        for rep in reports:
            reqs = [syn.make_request() for _ in rep["assignments"]]
            assignments, _ = syn.serve_slot(reqs)
            got = [(a["replica"], a["exit"]) for a in rep["assignments"]]
            assert got == assignments, f"step {rep['step']} diverged"
        assert int(asy.agent_state.loss_count) >= 1
        a, b = asy.get_agent_state(), syn.get_agent_state()
        for layer, leaves in a.params.items():
            for name, x in leaves.items():
                assert torch.equal(x, b.params[layer][name])

    @pytest.mark.parametrize("method", ["droo", "drooe"])
    def test_mlp_schedulers_raise(self, method):
        """(Named for the refusal it pinned until DROO's MLP actor was
        ported.) The sync engine behind DROO/DROOE equals the JAX engine's
        12-slot run with decoding and a train step, from its initial
        ``AgentState`` with its draws injected, as GRLE's does
        (``check_sync``)."""
        data, extra = golden_tool.serve_run(method)
        eng, out = port_sync(data, state=extra["state0"])
        assert eng.agent_def.actor == "mlp"
        check_sync(data, eng, out)


class TestHotSwapUnderLoad:
    def test_agent_and_scenario_swap_drop_nothing(self):
        eng = _engine(batch_slots=4, seed=2, hold="latency")
        trace = make_trace(n_users=10, n_slots=30,
                           slot_s=float(eng.env.cfg.slot_s),
                           deadline_slack_s=0.3, seed=2)
        fresh = eng.agent_def.init(torch.Generator().manual_seed(99))
        sp_calm = eng.env.cfg.scenario_params("cpu")
        swaps = []

        def on_step(engine, rep):
            if rep["step"] == 5:
                engine.set_agent_state(fresh)
                swaps.append("agent")
            if rep["step"] == 9:
                engine.set_scenario_params(sp_calm)
                swaps.append("scenario")
            if rep["step"] == 13:
                engine.set_scenario_params(None)
                swaps.append("reset")

        reports = eng.run(trace, on_step=on_step)
        assert swaps == ["agent", "scenario", "reset"]
        outcomes = []
        for rep in reports:
            outcomes += [s["rid"] for s in rep["served"]]
            outcomes += rep["expired"]
        assert len(outcomes) == len(set(outcomes))
        assert sorted(outcomes) == [r.rid for r in trace]
        c = eng.counts
        assert c["admitted"] == len(trace)
        assert c["admitted"] == c["served"] + c["expired"]

    def test_swaps_check_structure_and_shapes(self):
        eng = _engine(batch_slots=4)
        other = _engine(batch_slots=6)
        with pytest.raises(ValueError, match="shape"):
            eng.set_agent_state(other.agent_state)
        with pytest.raises(ValueError, match="exit table"):
            eng.set_scenario_params(other.env.cfg.scenario_params("cpu")
                                    ._replace(exit_times_s=torch.zeros(3, 2)))
        st = eng.agent_state
        with pytest.raises(ValueError, match="structure"):
            eng.set_agent_state(st._replace(params={"gcn": st.params}))

    def test_ab_pool_round_robin_attribution(self):
        eng = _engine(batch_slots=4, seed=0)
        pool = AgentPool({
            "champion": eng.agent_def.init(torch.Generator().manual_seed(0)),
            "challenger": eng.agent_def.init(
                torch.Generator().manual_seed(1)),
        })
        eng.set_agent_pool(pool)
        trace = make_trace(n_users=8, n_slots=24,
                           slot_s=float(eng.env.cfg.slot_s),
                           deadline_slack_s=1.0, seed=4)
        reports = eng.run(trace)
        steps = len(reports)
        st = pool.stats
        assert st["champion"]["steps"] + st["challenger"]["steps"] == steps
        assert abs(st["champion"]["steps"] - st["challenger"]["steps"]) <= 1
        served = st["champion"]["served"] + st["challenger"]["served"]
        assert served == eng.counts["served"] > 0
        hits = st["champion"]["hits"] + st["challenger"]["hits"]
        assert hits == eng.counts["hits"]
        for name in ("champion", "challenger"):
            assert int(pool.variants[name].step) > 0


class TestLoadgen:
    def test_trace_deterministic_and_ordered(self):
        kw = dict(n_users=16, n_slots=25, slot_s=0.02,
                  deadline_slack_s=0.5, seed=7, priorities=(0, 1))
        a, b = make_trace(**kw), make_trace(**kw)
        assert a == b and len(a) > 0
        assert [r.rid for r in a] == list(range(len(a)))
        arrivals = [r.arrival_s for r in a]
        assert arrivals == sorted(arrivals)
        assert {r.priority for r in a} <= {0, 1}
        for r in a:
            assert r.deadline_s == r.arrival_s + 0.5
        assert make_trace(**dict(kw, seed=8)) != a

    def test_trace_rejects_iid_and_truncates(self):
        with pytest.raises(ValueError, match="iid"):
            make_trace(scenario="fig5_baseline")
        few = make_trace(n_users=16, n_slots=25, slot_s=0.02, seed=7,
                         max_requests=5)
        assert len(few) == 5


class TestTokenAccounting:
    def test_serve_slot_adds_max_new_per_request(self):
        syn = EdgeServingEngine(_arch(), _replicas(), scheduler="grle",
                                batch_slots=4, seed=0, workload="mmpp",
                                scenario="dyn_bursty", agent_kw=AGENT_KW,
                                init_model=False, device="cpu")
        assert syn.tokens_served == 0
        reqs = [syn.make_request(max_new=m) for m in (8, 16, 4)]
        syn.serve_slot(reqs)
        assert syn.tokens_served == 28
        syn.serve_slot([syn.make_request()])
        assert syn.tokens_served == 36
        snap = syn.telemetry_snapshot()
        assert snap["summary"]["tokens_served"] == 36

    def test_continuous_tokens_match_served_budgets(self):
        eng = _engine(batch_slots=4, seed=0)
        trace = make_trace(n_users=8, n_slots=30,
                           slot_s=float(eng.env.cfg.slot_s),
                           deadline_slack_s=5.0, seed=2)
        eng.run(trace)
        served = eng.counts["served"]
        assert served > 0
        assert eng.tokens_served == sum(r.max_new for r in trace[:served])
        snap = eng.telemetry_snapshot()
        assert snap["summary"]["tokens_served"] == eng.tokens_served


def test_static_scheduler_and_decode_transfers():
    """``scheduler=None``: final exit, replicas round-robin; decoding
    makes one upload and one download per exit group. A request longer
    than the 256-row cache (a 250-token prompt with 8 and with 40 new
    tokens) decodes over the wrapped cache as the JAX engine does: the
    same tokens, from ``lm_params_numpy`` weights on both sides."""
    eng = EdgeServingEngine(_arch(), _replicas(), scheduler=None,
                            batch_slots=4, seed=0, device="cpu")
    reqs = [eng.make_request(prompt_len=p, max_new=3) for p in (3, 5, 4)]
    assignments, info = eng.serve_slot(reqs, decode=True)
    assert assignments == [("a", 2), ("b", 2), ("a", 2)]
    assert [len(t) for t in info["texts"]] == [3, 3, 3]
    assert eng.transfers["decode_h2d"] == eng.transfers["decode_d2h"] == 1
    cfg = _arch()
    eng.params = lm_params_from_numpy(lm_params_numpy(cfg, 0), cfg, "cpu")
    jeng = golden_tool.serve_engine(None)
    assert jeng.cache_len == eng.cache_len == 256
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, 250).astype(
        np.int32)
    for max_new in (8, 40):
        want = jeng.serve_slot([jax_engine.Request(
            tokens=tokens, deadline_s=1.0, max_new=max_new)],
            decode=True)[1]["texts"]
        got = eng.serve_slot([Request(tokens=tokens, deadline_s=1.0,
                                      max_new=max_new)], decode=True)[1]
        assert len(got["texts"][0]) == max_new
        assert got["texts"] == [list(map(int, t)) for t in want]


def test_device_none_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EdgeServingEngine(_arch(), _replicas(), init_model=False)
