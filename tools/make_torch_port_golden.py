"""Write ``tests/data/torch_port_golden.npz``,
``tests/data/torch_port_train_golden.npz``,
``tests/data/torch_serve_golden.npz``,
``tests/data/torch_port_dyn_golden.npz``,
``tests/data/torch_pop_golden.npz`` and
``tests/data/torch_serve_async_golden.npz``: JAX traces with the random draws
that produced them, for holding the PyTorch port (``repro_torch``)
against the JAX package where JAX is not installed.

    PYTHONPATH=src python tools/make_torch_port_golden.py [--out PATH]
        [--train-out PATH] [--serve-out PATH] [--dyn-out PATH]
        [--pop-out PATH] [--serve-async-out PATH]
        [--only decision|train|serve|dyn|pop|serve_async]

Runs on the CPU with JAX only. The decision file:

1. train GRLE on ``fig5_baseline`` with ``RolloutDriver(train=True)``
   (seed 0, 4 fleets, 200 slots) so its decisions are not near-uniform;
2. run ``RolloutDriver(train=False).run(mode="loop")`` with the trained
   params for B=4 fleets and T=32 slots;
3. rebuild that run's draws from the driver's own key schedule (task
   keys per fleet for ``sample_slot``, decision keys for the Gumbel
   exploration candidates) and replay the decision path on them
   (``reference_episode``), which also records every slot's ``MECState``
   and the critic's top-two margin.

It holds the params, exit mask, the driver's trace, the draws
(``SlotTasks`` leaves, exploration candidates as int8), the states and
margins, and the ``metrics_finalize`` values.

The training file (``build_train``): a ``RolloutDriver(train=True).run(
mode="loop")`` episode from the driver's own fresh params on
fig5_baseline, B=4, T=64 (replay 128, minibatch 64, a train step every
10 slots: 5 steps, at slots 20..60), with the same draws, each train
step's replay rows (``train_takes``: ``replay_sample`` itself, called with
the step's sample key on a ring whose entries hold their own index), per
slot the decisions, q_est and margins of a replay that trains as the
driver does, each step's loss, and the params and Adam moments after the
last step. ``tests/test_torch_rollout.py`` and ``tests/test_torch_train.py``
check that a rebuild equals the stored files.

The serving file (``build_serve``): a JAX ``EdgeServingEngine`` (reduced
``qwen1_5_0_5b`` in float32 with ``repro_torch.core.bridge.
lm_params_numpy`` weights from ``SERVE_LM_SEED``, replicas a/1.0 and
b/0.7, ``batch_slots=4``, ``dyn_bursty`` MMPP arrivals, GRLE with
``SERVE_AGENT_KW``) serving the 12 slots of ``SERVE_SCHEDULE`` (explicit
requests or arrival-driven ones) with ``decode=True``. ``record_draws``
records each scheduling step's tasks and the agent's key, from which
``serve_draws`` rebuilds the exploration candidates and each train
step's replay rows. It holds the agent's initial params and exit mask,
the draws, the exit table's roofline figures, and per slot the
assignments, reward, loss and generated tokens, with the final params
and the §VI-D summary. ``tests/test_torch_serve.py`` checks that a
rebuild equals it.

The dynamic and baseline file (``build_dyn``): the three runs of
``DYN_RUNS``, each a ``RolloutDriver(train=True).run(mode="loop")``
episode (B=4, T=64, ring 32, minibatch 8, a train step every 5 slots:
12 steps) from the driver's own fresh params: DROO on fig8_csi (iid: the
tasks injected), DROOE on dyn_bursty (mmpp) and GRLE with
``per_fleet_scenarios=True`` on dyn_markov_channel under one
``scenario_space("fig5_baseline", "fig8_csi").sample_batch`` draw per
fleet (the poisson runs inject the workload's raw uniforms,
``dyn_draws``, so the port advances its own workload state; the
per-fleet ``sp`` is stored). Each run keeps what the training file keeps,
under ``<run>/``.

The population file (``build_pop``): a reference ``PopulationTrainer``
run (``POP``: GRLE, P=4 members with sampled hypers, B=2, T=15, M=5, 4
curriculum regions over fig5_baseline..fig8_csi, 2 generations, PBT
every generation) with every draw it made: the hyperparameter uniforms
(``init/hyper_u``), the initial params and hypers, per generation the
curriculum's regions and offsets (and the scenarios they give), per
member the tasks, the Gumbel exploration noise [T, B, K, M, O], the
replay rows and, from a replay of its episode (``pop_member_episode``,
held against the trainer's own run), its decisions, rewards, losses and
margins; the members' metrics, PBT's coin and jitters and its stats, the
hypers, curriculum state and report after it; the final params, the
telemetry counters and the history records.

The continuous-serving file (``build_serve_async``): a JAX
``ContinuousServingEngine`` at the serve-bench's ``--quick`` shape
(``benchmarks/serve_throughput.py``: 32 slots, ``BENCH_AGENT_KW``, trace
users 64 on a grid 8x denser than the engine's slot, slack 600 s) running,
each shifted onto its clock, the bench's warm-up trace, its main trace
(192 requests) and the next 512 requests of the main trace's stream
(``BENCH_TRACES``, ``BENCH_TAIL``), so that the run takes train steps. It
holds the agent's knobs (``agent_kw``, JSON), the traces as the engine
received them, the draws
(``record_draws``/``serve_draws``), the initial and final params, each
step's decision with the critic's and the actor's margins
(``serve_margins``), the step reports as JSON, the counts, the tokens
served and the continuous row's deterministic fields after the main trace
(``BENCH_ROW_KEYS``). ``serve_bench_sync_run`` is the sync side of the
bench's ``--quick`` comparison on the same traces, for the tests.

For the sweep (no file): ``sweep_cell_reference`` rebuilds the initial
params and draws the reference's ``sweep.run_cell`` uses for a cell, and
``port_slot_draws`` turns them into the port's ``SlotDraws``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.devreplay import replay_sample
from repro.core.graph import build_graph
from repro.core.policy import agent_def
from repro.core.quantize import one_hot_candidates
from repro.mec import MECEnv, make_scenario, scenario_space
from repro.mec.env import SlotTasks
from repro.rollout import RolloutDriver, make_workload
from repro.rollout.metrics import metrics_finalize
from repro.rollout.vecenv import VecMECEnv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden.npz")
TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data",
                            "torch_port_train_golden.npz")
SCENARIO, TRAIN_SEED, TRAIN_FLEETS, TRAIN_SLOTS = "fig5_baseline", 0, 4, 200
EVAL_SEED, N_FLEETS, N_SLOTS = 1, 4, 32
TRAIN_EP_SEED, TRAIN_EP_SLOTS = 2, 64
SERVE_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_serve_golden.npz")
SERVE_AGENT_KW = dict(buffer_size=32, batch_size=8, train_every=5,
                      n_candidates=8)
SERVE_ARCH, SERVE_SEED, SERVE_LM_SEED, SERVE_BATCH = "qwen1_5_0_5b", 0, 0, 4
SERVE_REPLICAS = (("a", 1.0), ("b", 0.7))
# per slot: the number of explicit requests, or -1 for arrival-driven
SERVE_SCHEDULE = (4, -1, 2, 3, -1, 4, 1, -1, 4, 3, -1, 2)
SERVE_NEW = 8          # make_request's max_new
SUMMARY_KEYS = ("ssp", "avg_accuracy", "throughput_tps", "avg_reward",
                "tasks")
TASK_FIELDS = ("size_bits", "deadline_s", "rate_true", "rate_est", "capacity",
               "cmp_true", "cmp_est", "connect", "active")
DYN_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_dyn_golden.npz")
DYN_FLEETS, DYN_SLOTS = 4, 64
DYN_KW = dict(replay_capacity=32, batch_size=8, train_every=5)
# run -> (method, scenario, seed, scenario space of per-fleet draws or None).
# DROO's seed is the first from 0 on which the reference's own driver and
# its jitted replay (``reference_episode``) make the same decisions: DROO
# meets exact critic ties, which the two programs break differently on
# seeds 0-8.
DYN_RUNS = {
    "droo_fig8": ("droo", "fig8_csi", 9, None),
    "drooe_bursty": ("drooe", "dyn_bursty", 4, None),
    "grle_space": ("grle", "dyn_markov_channel", 5,
                   ("fig5_baseline", "fig8_csi")),
}
DYN_SPACE_SEED = 6
POP_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_pop_golden.npz")
SERVE_ASYNC_GOLDEN = os.path.join(ROOT, "tests", "data",
                                  "torch_serve_async_golden.npz")
# the serve-bench's knobs and --quick shape (benchmarks/serve_throughput.py)
BENCH_AGENT_KW = dict(n_candidates=16, buffer_size=64, batch_size=16,
                      train_every=5)
BENCH_SLOTS_SYNC, BENCH_SLOTS_CONT, BENCH_USERS = 4, 32, 64
BENCH_GRID, BENCH_SLACK_S = 8, 600.0
# trace -> (n_slots, seed, max_requests): the bench's warm-up and main
# traces; the tail is the main trace's stream past its 192nd request,
# which takes the continuous run past its 20th step, where the ring first
# holds a minibatch on a train slot
BENCH_TRACES = {"warm": (4, 99, 32), "main": (4000, 7, 192)}
BENCH_TAIL = 512
BENCH_ROW_KEYS = ("n_requests", "n_tokens", "deadline_hit_rate",
                  "latency_p50_s", "latency_p99_s", "queue_depth_p99")
TRACE_FIELDS = ("rid", "arrival_s", "deadline_s", "priority", "prompt_len",
                "max_new")
# The population golden run: GRLE on fig5_baseline..fig8_csi at M=5, P=4
# members with sampled hypers, 2 fleets, 15 slots (3 train steps), 4
# curriculum regions, PBT every generation. Its margins (critic, actor,
# exploration noise) are recorded: a replay may part from it only at one
# at most NEAR_TIE, and then stops comparing.
POP = dict(method="grle", space=("fig5_baseline", "fig8_csi"), n_devices=5,
           members=4, fleets=2, slots=15, regions=4, generations=2, seed=0,
           replay=16, batch=4, train_every=5)


def grle(scenario: str):
    return agent_def("grle", MECEnv(make_scenario(scenario)))


def train_params(adef):
    """GRLE params after a short training run (numpy tree)."""
    drv = RolloutDriver(adef, n_fleets=TRAIN_FLEETS, train=True)
    carry, _ = drv.run(jax.random.PRNGKey(TRAIN_SEED), TRAIN_SLOTS,
                       mode="scan")
    return jax.tree_util.tree_map(np.asarray, carry.agent_state.params)


def agent_state(adef, params, exit_mask):
    """A JAX ``AgentState`` holding the given numpy params and mask."""
    st = adef.init(jax.random.PRNGKey(0))
    return st._replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                       exit_mask=jnp.asarray(exit_mask))


def driver_trace(adef, state, seed: int, n_fleets: int, n_slots: int):
    """The JAX driver's own ``train=False`` loop run (numpy leaves)."""
    drv = RolloutDriver(adef, n_fleets=n_fleets, train=False)
    carry, trace = drv.run(jax.random.PRNGKey(seed), n_slots, mode="loop",
                           agent_state=state)
    metrics = {k: np.asarray(v) for k, v in metrics_finalize(
        carry.metrics, slot_s=adef.env.cfg.slot_s, n_fleets=n_fleets).items()}
    return {k: np.asarray(v) for k, v in trace._asdict().items()}, metrics


def as_key(seed_or_key):
    """``PRNGKey(seed)`` for an int seed; a key as it is."""
    if isinstance(seed_or_key, (int, np.integer)):
        return jax.random.PRNGKey(int(seed_or_key))
    return seed_or_key


def driver_draws(adef, exit_mask, seed, n_fleets: int, n_slots: int):
    """The draws ``RolloutDriver.run(key)`` makes (``seed``: a key, or an
    int for ``PRNGKey(seed)``), rebuilt from its key schedule
    (``driver.py`` init_carry/_slot, ``policy.py`` decide_with):
    ``SlotTasks`` leaves [T, B, ...] and the exploration candidates
    [T, B, K, M]. The candidates are an argmax over Gumbel noise
    restricted to allowed options, which depends on the tasks' links but
    not on the actor."""
    env = adef.env
    vec = VecMECEnv(env, n_fleets)
    k_task, k_dec, _, _ = jax.random.split(as_key(seed), 4)
    task_keys, dec_keys = vec.fleet_keys(k_task), vec.fleet_keys(k_dec)
    mask = jnp.asarray(exit_mask)

    @jax.jit
    def slot(task_keys, dec_keys):
        task_keys, task_subs = VecMECEnv.split_keys(task_keys)
        dec_keys, dec_subs = VecMECEnv.split_keys(dec_keys)
        tasks = jax.vmap(env.sample_slot)(task_subs)

        def rand(dk, connect):
            g_mask = jnp.repeat(connect, env.L, axis=-1)
            allowed = (mask[None, :] > 0.5) & (g_mask > 0.5)
            gumbel = jax.random.gumbel(dk, (adef.n_random, *allowed.shape))
            return jnp.argmax(jnp.where(allowed[None], gumbel, -jnp.inf),
                              axis=-1).astype(jnp.int32)

        return task_keys, dec_keys, tasks, jax.vmap(rand)(dec_subs,
                                                          tasks.connect)

    tasks, rands = [], []
    for _ in range(n_slots):
        task_keys, dec_keys, t, r = slot(task_keys, dec_keys)
        tasks.append(t)
        rands.append(r)
    tasks = {f: np.stack([np.asarray(getattr(t, f)) for t in tasks])
             for f in TASK_FIELDS}
    return tasks, np.stack([np.asarray(r) for r in rands])


def reference_episode(adef, params, exit_mask, tasks, rand_cands,
                      state=None, sp=None, sp_axis=None):
    """Replay the JAX decision path on injected draws, fleet-batched.

    Returns decisions, q_est, reward, the ``MECState`` before every slot
    and after the last ([T+1, B, ...]), and per slot and fleet the
    critic's margin between the best candidate and the best one with a
    different decision (``q_margin``) and the smallest per-device gap
    between the actor's top two allowed scores (``xhat_margin``).

    With ``state`` (a JAX ``AgentState`` keyed as the driver keys it) the
    actor's params are the state's, and after every slot the learner
    absorbs the B fleets' (graph, decision) pairs as
    ``RolloutDriver(train=True)`` does; then the per-slot ``loss`` [T]
    and the final ``agent_state`` are returned too. ``sp`` is the run's
    scenario, shared (``sp_axis=None``) or per fleet (``sp_axis=0``).
    """
    env = adef.env
    mask = jnp.asarray(exit_mask)

    def fleet(state, t, rand, params, s):
        g = build_graph(env.observe(state, t, s), env.N, env.L)
        x_hat, _ = adef.scores(params, g, mask)
        cands = jnp.concatenate(
            [one_hot_candidates(x_hat, adef.n_candidates), rand], axis=0)
        q = env.evaluate(state, t, cands, s)
        best = jnp.argmax(q)
        new_state, res = env.step(state, t, cands[best], s)
        return new_state, res.reward, cands, q, best, x_hat, g

    step = jax.jit(jax.vmap(fleet, in_axes=(0, 0, 0, None, sp_axis)))
    absorb = jax.jit(adef.absorb)
    n_slots, n_fleets = rand_cands.shape[:2]
    env_state = VecMECEnv(env, n_fleets).reset()
    states, out = [env_state], {k: [] for k in
                                ("decisions", "q_est", "reward", "q_margin",
                                 "xhat_margin", "loss")}
    params = (jax.tree_util.tree_map(jnp.asarray, params) if state is None
              else state.params)
    for t in range(n_slots):
        t_tasks = SlotTasks(**{f: jnp.asarray(tasks[f][t])
                               for f in TASK_FIELDS})
        env_state, reward, cands, q, best, x_hat, g = step(
            env_state, t_tasks, jnp.asarray(rand_cands[t], jnp.int32),
            params, sp)
        states.append(env_state)
        cands, q, best = map(np.asarray, (cands, q, best))
        x_hat = np.sort(np.asarray(x_hat), axis=-1)
        dec = cands[np.arange(n_fleets), best]
        other = (cands != dec[:, None, :]).any(-1)
        q_other = np.where(other, q, -np.inf).max(-1)
        out["decisions"].append(dec)
        out["q_est"].append(q[np.arange(n_fleets), best])
        out["reward"].append(np.asarray(reward))
        out["q_margin"].append(q[np.arange(n_fleets), best] - q_other)
        out["xhat_margin"].append((x_hat[..., -1] - x_hat[..., -2]).min(-1))
        if state is not None:
            state, loss = absorb(state, g, jnp.asarray(dec))
            params = state.params
            out["loss"].append(np.asarray(loss))
    out = {k: np.stack(v) for k, v in out.items() if v}
    for name in ("dev_free", "es_free", "slot"):
        out[f"state_{name}"] = np.stack(
            [np.asarray(getattr(s, name)) for s in states])
    if state is not None:
        out["agent_state"] = state
    return out


def episode_keys(seed):
    """(k_init, k_episode) of ``RolloutDriver.init_carry(key)`` (``seed``:
    a key, or an int for ``PRNGKey(seed)``): the key a fresh ``adef.init``
    gets and the episode's agent key."""
    _, _, k_agent, _ = jax.random.split(as_key(seed), 4)
    return jax.random.split(k_agent)


def train_slots(adef, n_fleets: int, n_slots: int):
    """The 1-based slots whose ``absorb`` trains: every ``train_every``
    slots once the ring holds a full minibatch."""
    return [s for s in range(1, n_slots + 1)
            if s % adef.train_every == 0
            and min(s * n_fleets, adef.buffer_size) >= adef.batch_size]


def train_takes(adef, k_episode, sizes):
    """The replay rows each train step samples, one row of [batch_size]
    per ring size in ``sizes``: ``replay_sample`` with the step's sample
    key (the chain ``AgentDef.train_step`` splits from the episode key) on
    a ring whose decisions hold their own index."""
    ring = adef.empty_replay()
    index = jnp.broadcast_to(
        jnp.arange(ring.capacity, dtype=jnp.int32)[:, None],
        ring.decisions.shape)
    key, takes = k_episode, []
    for size in sizes:
        key, k_samp = jax.random.split(key)
        r = ring._replace(decisions=index,
                          size=jnp.asarray(size, jnp.int32))
        _, rows = replay_sample(r, k_samp, adef.batch_size)
        takes.append(np.asarray(rows[:, 0]))
    return np.stack(takes)


def build_train(seed: int = TRAIN_EP_SEED):
    """Everything the training golden file holds, as a flat dict."""
    adef = grle(SCENARIO)
    exit_mask = np.asarray(adef.exit_mask())
    drv = RolloutDriver(adef, n_fleets=N_FLEETS, train=True)
    key = jax.random.PRNGKey(seed)
    carry, trace = drv.run(key, TRAIN_EP_SLOTS, mode="loop")
    trace = {k: np.asarray(v) for k, v in trace._asdict().items()}
    metrics = {k: np.asarray(v) for k, v in metrics_finalize(
        carry.metrics, slot_s=adef.env.cfg.slot_s,
        n_fleets=N_FLEETS).items()}
    k_init, k_episode = episode_keys(seed)
    state0 = adef.episode_state(adef.init(k_init), k_episode)
    tasks, rand = driver_draws(adef, exit_mask, seed, N_FLEETS,
                               TRAIN_EP_SLOTS)
    ref = reference_episode(adef, None, exit_mask, tasks, rand, state0)
    # the replay is the driver's own run, training included
    np.testing.assert_array_equal(ref["decisions"], trace["decisions"])
    np.testing.assert_array_equal(np.isnan(ref["loss"]),
                                  np.isnan(trace["loss"]))
    np.testing.assert_allclose(ref["loss"], trace["loss"], rtol=1e-6)
    slots = train_slots(adef, N_FLEETS, TRAIN_EP_SLOTS)
    np.testing.assert_array_equal(
        np.flatnonzero(~np.isnan(trace["loss"])) + 1, slots)
    sizes = [min(s * N_FLEETS, adef.buffer_size) for s in slots]
    takes = train_takes(adef, k_episode, sizes)
    final = carry.agent_state
    data = {"scenario": np.asarray(SCENARIO), "seed": np.asarray(seed),
            "exit_mask": exit_mask, "rand_cands": rand.astype(np.int8),
            "train_slots": np.asarray(slots, np.int32),
            "replay_take": takes.astype(np.int32),
            "final/opt_step": np.asarray(final.opt_state["step"])}
    trees = {"init_params": state0.params, "final/params": final.params,
             "final/mu": final.opt_state["mu"],
             "final/nu": final.opt_state["nu"]}
    for prefix, tree in trees.items():
        for layer, leaves in tree.items():
            for name, x in leaves.items():
                data[f"{prefix}/{layer}/{name}"] = np.asarray(x)
    data.update({f"tasks/{k}": v for k, v in tasks.items()})
    data.update({f"trace/{k}": v for k, v in trace.items()})
    data.update({f"metrics/{k}": v for k, v in metrics.items()})
    for k in ("q_margin", "xhat_margin"):
        data[k] = ref[k]
    return data


def tree_of(data: dict, prefix: str) -> dict:
    """The nested ``{layer: ... {name: array}}`` tree stored under
    ``prefix/``."""
    tree = {}
    for k in data:
        if k.startswith(prefix + "/"):
            *heads, name = k[len(prefix) + 1:].split("/")
            node = tree
            for h in heads:
                node = node.setdefault(h, {})
            node[name] = data[k]
    return tree


def flat_tree(prefix: str, tree) -> dict:
    """``{prefix/path: array}`` of a nested tree of arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(f"{prefix}/{k}", v))
        return out
    return {prefix: np.asarray(tree)}


def build(seed: int = EVAL_SEED, params=None):
    """Everything the golden file holds, as a flat dict of arrays."""
    adef = grle(SCENARIO)
    if params is None:
        params = train_params(adef)
    exit_mask = np.asarray(adef.exit_mask())
    trace, metrics = driver_trace(adef, agent_state(adef, params, exit_mask),
                                  seed, N_FLEETS, N_SLOTS)
    tasks, rand = driver_draws(adef, exit_mask, seed, N_FLEETS, N_SLOTS)
    ref = reference_episode(adef, params, exit_mask, tasks, rand)
    data = {"scenario": np.asarray(SCENARIO), "seed": np.asarray(seed),
            "exit_mask": exit_mask, "rand_cands": rand.astype(np.int8)}
    for layer, leaves in params.items():
        for name, x in leaves.items():
            data[f"params/{layer}/{name}"] = x
    data.update({f"tasks/{k}": v for k, v in tasks.items()})
    data.update({f"trace/{k}": v for k, v in trace.items()})
    data.update({f"metrics/{k}": v for k, v in metrics.items()})
    for k in ("state_dev_free", "state_es_free", "state_slot", "q_margin",
              "xhat_margin"):
        data[k] = ref[k]
    return data


def load(path: str = GOLDEN) -> dict:
    """The golden file as a flat dict, params regrouped into a tree."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    params = tree_of(data, "params")
    data = {k: v for k, v in data.items() if not k.startswith("params/")}
    data["params"] = params
    return data


# ------------------------------------------------- dynamic and baselines
def wl_uniforms(key, m: int, n: int, l: int) -> dict:
    """The raw uniforms of one poisson/mmpp ``WorkloadGen.sample`` (one key
    split nine ways), by ``WorkloadDraws`` field; the slot's four under
    ``slot/``."""
    ks = jax.random.split(key, 9)
    u = jax.random.uniform
    return {"burst": u(ks[0], ()), "arrive": u(ks[1], (m,)),
            "churn": u(ks[2], (m,)), "rate": u(ks[3], (m, n)),
            "capacity": u(ks[5], (n,)), "slot/size": u(ks[7], (m,)),
            "slot/csi": u(ks[4], (m, n)), "slot/jitter": u(ks[6], (n, l)),
            "slot/connect": u(ks[8], (m, n))}


def dyn_draws(adef, exit_mask, seed, n_fleets: int, n_slots: int,
              sp=None, sp_axis=None):
    """The draws ``RolloutDriver.run(key, sp=sp)`` makes on a poisson/mmpp
    workload (``seed``: a key, or an int for ``PRNGKey(seed)``), rebuilt
    from its key schedule (``driver.py``
    init_carry/_slot, ``workloads.py`` init/sample): the workload init's
    uniforms [B, ...] (``init/rate``, ``init/capacity``), each slot's raw
    workload uniforms [T, B, ...] (``wl/...``), the tasks they give
    [T, B, ...] and the exploration candidates [T, B, K, M] (which depend
    on the tasks' links)."""
    env = adef.env
    m, n, l = env.M, env.N, env.L
    gen = make_workload(env)
    vec = VecMECEnv(env, n_fleets)
    k_task, k_dec, _, k_wl = jax.random.split(as_key(seed), 4)
    wl_keys = vec.fleet_keys(k_wl)

    def init_u(k):
        kr, kc = jax.random.split(k)
        return {"init/rate": jax.random.uniform(kr, (m, n)),
                "init/capacity": jax.random.uniform(kc, (n,))}

    init = {k: np.asarray(v) for k, v in jax.vmap(init_u)(wl_keys).items()}
    wl_state = jax.vmap(gen.init, in_axes=(0, sp_axis))(wl_keys, sp)
    task_keys, dec_keys = vec.fleet_keys(k_task), vec.fleet_keys(k_dec)
    mask = jnp.asarray(exit_mask)

    @jax.jit
    def slot(wl_state, task_keys, dec_keys, sp):
        task_keys, task_subs = VecMECEnv.split_keys(task_keys)
        dec_keys, dec_subs = VecMECEnv.split_keys(dec_keys)
        wl_state, tasks = jax.vmap(gen.sample, in_axes=(0, 0, sp_axis))(
            wl_state, task_subs, sp)
        u = jax.vmap(lambda k: wl_uniforms(k, m, n, l))(task_subs)

        def rand(dk, connect):
            g_mask = jnp.repeat(connect, l, axis=-1)
            allowed = (mask[None, :] > 0.5) & (g_mask > 0.5)
            gumbel = jax.random.gumbel(dk, (adef.n_random, *allowed.shape))
            return jnp.argmax(jnp.where(allowed[None], gumbel, -jnp.inf),
                              axis=-1).astype(jnp.int32)

        return (wl_state, task_keys, dec_keys, tasks, u,
                jax.vmap(rand)(dec_subs, tasks.connect))

    tasks, us, rands = [], [], []
    for _ in range(n_slots):
        wl_state, task_keys, dec_keys, t, u, r = slot(wl_state, task_keys,
                                                      dec_keys, sp)
        tasks.append(t)
        us.append(u)
        rands.append(r)
    tasks = {f: np.stack([np.asarray(getattr(t, f)) for t in tasks])
             for f in TASK_FIELDS}
    wl = {f"wl/{k}": np.stack([np.asarray(u[k]) for u in us])
          for k in us[0]}
    return init, wl, tasks, np.stack([np.asarray(r) for r in rands])


def dyn_space_sp(space, n_fleets: int):
    """The per-fleet scenarios of a run with a space: one
    ``sample_batch`` draw per fleet from ``PRNGKey(DYN_SPACE_SEED)``."""
    lo, hi = space
    return scenario_space(lo, hi).sample_batch(
        jax.random.PRNGKey(DYN_SPACE_SEED), n_fleets)


def build_dyn_run(run: str) -> dict:
    """One run of ``DYN_RUNS`` as a flat dict (keys without the run
    prefix)."""
    method, scenario, seed, space = DYN_RUNS[run]
    jdef = agent_def(method, MECEnv(make_scenario(scenario)))
    exit_mask = np.asarray(jdef.exit_mask())
    sp = None if space is None else dyn_space_sp(space, DYN_FLEETS)
    sp_axis = None if space is None else 0
    drv = RolloutDriver(jdef, n_fleets=DYN_FLEETS, train=True,
                        per_fleet_scenarios=space is not None, **DYN_KW)
    carry, trace = drv.run(jax.random.PRNGKey(seed), DYN_SLOTS, mode="loop",
                           sp=sp)
    trace = {k: np.asarray(v) for k, v in trace._asdict().items()}
    metrics = {k: np.asarray(v) for k, v in metrics_finalize(
        carry.metrics, slot_s=jdef.env.cfg.slot_s,
        n_fleets=DYN_FLEETS).items()}
    k_init, k_episode = episode_keys(seed)
    adef = drv.adef
    state0 = adef.episode_state(adef.init(k_init), k_episode)
    data = {"method": np.asarray(method), "scenario": np.asarray(scenario),
            "seed": np.asarray(seed), "exit_mask": exit_mask}
    if jdef.env.cfg.workload == "iid":
        tasks, rand = driver_draws(adef, exit_mask, seed, DYN_FLEETS,
                                   DYN_SLOTS)
        data.update({f"tasks/{k}": v for k, v in tasks.items()})
    else:
        init, wl, tasks, rand = dyn_draws(adef, exit_mask, seed, DYN_FLEETS,
                                          DYN_SLOTS, sp, sp_axis)
        data.update(init)
        data.update(wl)
    if sp is not None:
        data.update({f"sp/{k}": np.asarray(v)
                     for k, v in sp._asdict().items()})
    ref = reference_episode(adef, None, exit_mask, tasks, rand, state0,
                            sp=sp, sp_axis=sp_axis)
    # the replay on injected draws is the driver's own run
    np.testing.assert_array_equal(ref["decisions"], trace["decisions"])
    np.testing.assert_array_equal(np.isnan(ref["loss"]),
                                  np.isnan(trace["loss"]))
    np.testing.assert_allclose(ref["loss"], trace["loss"], rtol=1e-6)
    slots = train_slots(adef, DYN_FLEETS, DYN_SLOTS)
    np.testing.assert_array_equal(
        np.flatnonzero(~np.isnan(trace["loss"])) + 1, slots)
    takes = train_takes(adef, k_episode,
                        [min(s * DYN_FLEETS, adef.buffer_size)
                         for s in slots])
    final = carry.agent_state
    data.update({"rand_cands": rand.astype(np.int8),
                 "train_slots": np.asarray(slots, np.int32),
                 "replay_take": takes.astype(np.int32),
                 "final/opt_step": np.asarray(final.opt_state["step"])})
    for prefix, tree in (("init_params", state0.params),
                         ("final/params", final.params),
                         ("final/mu", final.opt_state["mu"]),
                         ("final/nu", final.opt_state["nu"])):
        data.update(flat_tree(prefix, jax.tree_util.tree_map(np.asarray,
                                                             tree)))
    data.update({f"trace/{k}": v for k, v in trace.items()})
    data.update({f"metrics/{k}": v for k, v in metrics.items()})
    for k in ("q_margin", "xhat_margin"):
        data[k] = ref[k]
    return data


def build_dyn() -> dict:
    """Everything the dynamic and baseline golden file holds, as a flat
    dict, each run under ``<run>/``."""
    return {f"{run}/{k}": v for run in DYN_RUNS
            for k, v in build_dyn_run(run).items()}


def run_of(data: dict, run: str) -> dict:
    """One run's entries of the dynamic golden file, prefix stripped."""
    return {k[len(run) + 1:]: v for k, v in data.items()
            if k.startswith(run + "/")}


# ------------------------------------------------------------- sweep cells
def sweep_cell_reference(cell, *, replay: bool = False) -> dict:
    """What the reference's ``sweep.run_cell`` runs for a sweep ``Cell``
    (the port's, or any tuple of its fields), as a flat dict of numpy
    arrays in the dynamic golden file's layout: the initial params
    ``adef.init(cell_keys(cell)[0])`` (``init_params/...``), the exit mask,
    and the draws of ``RolloutDriver.run(cell_keys(cell)[1])``: the tasks
    (iid: ``tasks/...``) or the workload's raw uniforms (poisson/mmpp:
    ``init/...``, ``wl/...``), the exploration candidates and each train
    step's replay rows. Named scenarios only (``sp`` None). With
    ``replay``, also a replay of the reference's decision path and learner
    on the draws (``reference_episode``: ``replay/decisions``,
    ``replay/reward``, ``replay/q_est``, equal to the reference driver's
    run up to its first exact critic tie, where the two may part) and its
    critic's and actor's margins (``q_margin``, ``xhat_margin``)."""
    from repro.sweep import Cell, cell_keys
    from repro.sweep.runner import _cell_def, _resolve_cell

    jcell = Cell(*cell)
    pkey, rkey = cell_keys(jcell)
    env, sp = _resolve_cell(jcell)
    if sp is not None:
        raise ValueError(f"{jcell.scenario}: named scenarios only")
    adef = _cell_def(jcell, env)
    mask = np.asarray(adef.exit_mask())
    n_fleets, n_slots = jcell.n_fleets, jcell.n_slots
    state0 = adef.init(pkey)
    _, k_episode = episode_keys(rkey)
    data = {"exit_mask": mask}
    data.update(flat_tree("init_params", jax.tree_util.tree_map(
        np.asarray, state0.params)))
    if env.cfg.workload == "iid":
        tasks, rand = driver_draws(adef, mask, rkey, n_fleets, n_slots)
        data.update({f"tasks/{k}": v for k, v in tasks.items()})
    else:
        init, wl, tasks, rand = dyn_draws(adef, mask, rkey, n_fleets,
                                          n_slots)
        data.update(init)
        data.update(wl)
    sizes = [min(s * n_fleets, adef.buffer_size)
             for s in train_slots(adef, n_fleets, n_slots)]
    data["rand_cands"] = rand.astype(np.int8)
    data["replay_take"] = (
        train_takes(adef, k_episode, sizes).astype(np.int32) if sizes
        else np.zeros((0, adef.batch_size), np.int32))
    if replay:
        ref = reference_episode(adef, None, mask, tasks, rand,
                                adef.episode_state(state0, k_episode))
        for k in ("decisions", "reward", "q_est"):
            data[f"replay/{k}"] = ref[k]
        data["q_margin"], data["xhat_margin"] = (ref["q_margin"],
                                                 ref["xhat_margin"])
    return data


def port_slot_draws(data: dict):
    """The port's ``SlotDraws`` (CPU tensors) of a run stored in the
    dynamic golden layout (``build_dyn_run``, ``sweep_cell_reference``):
    its tasks (iid), or its workload's init and per-slot raw uniforms
    (poisson/mmpp), its exploration candidates and replay rows (None
    without ``replay_take``)."""
    import torch
    from repro_torch.mec import SlotTasks, SlotUniforms
    from repro_torch.rollout import (InitDraws, SlotDraws, WorkloadDraws)

    def t(x):
        return torch.tensor(np.asarray(x))

    rand = t(data["rand_cands"].astype(np.int64))
    take = (t(data["replay_take"].astype(np.int64))
            if "replay_take" in data else None)
    if "init/rate" not in data:
        return SlotDraws(SlotTasks(*(t(data[f"tasks/{f}"])
                                     for f in SlotTasks._fields)), rand, take)
    slot = SlotUniforms(*(t(data[f"wl/slot/{f}"])
                          for f in SlotUniforms._fields))
    wl = WorkloadDraws(*(t(data[f"wl/{f}"])
                         for f in WorkloadDraws._fields[:-1]), slot)
    return SlotDraws(None, rand, take,
                     init=InitDraws(t(data["init/rate"]),
                                    t(data["init/capacity"])),
                     workload=wl)


# --------------------------------------------------------------- population
def pop_trainer(**kw):
    """The reference ``PopulationTrainer`` of the population golden file
    (``POP``), with ``kw`` passed on (``history=``, ``telemetry=``)."""
    from repro.pop import Curriculum, PopulationTrainer

    c = POP
    jdef = agent_def(c["method"], MECEnv(make_scenario(
        c["space"][0], n_devices=c["n_devices"])))
    space = scenario_space(*c["space"], n_devices=c["n_devices"])
    cur = Curriculum(space.lo, space.hi, n_regions=c["regions"])
    return PopulationTrainer(
        jdef, cur, n_members=c["members"], n_fleets=c["fleets"],
        n_slots=c["slots"], pbt_every=1, seed=c["seed"], mesh=None,
        replay_capacity=c["replay"], batch_size=c["batch"],
        train_every=c["train_every"], **kw)


def _pop_programs(drv):
    """The jitted slot replay and absorb of ``pop_member_episode`` for one
    reference driver (built once: scenario and hypers are arguments)."""
    adef, env = drv.adef, drv.env
    n_cand, k = adef.n_candidates, adef.n_random

    @jax.jit
    def slot(state, env_state, wl_state, task_keys, dec_keys, sp, gain):
        task_keys, task_subs = VecMECEnv.split_keys(task_keys)
        dec_keys, dec_subs = VecMECEnv.split_keys(dec_keys)

        def fleet(es, wl, tk, dk):
            wl, tasks = drv.workload.sample(wl, tk, sp)
            g = build_graph(env.observe(es, tasks, sp), env.N, env.L)
            x_hat, _ = adef.scores(state.params, g, state.exit_mask)
            allowed = (state.exit_mask[None, :] > 0.5) & (g.mask > 0.5)
            gum = jax.random.gumbel(dk, (k, *allowed.shape))
            noise = jnp.where(allowed[None], x_hat[None] * gain + gum,
                              -jnp.inf)
            rand = jnp.argmax(noise, axis=-1).astype(jnp.int32)
            top = jax.lax.top_k(noise, 2)[0]
            cand_margin = (top[..., 0] - top[..., 1]).min()
            cands = jnp.concatenate(
                [one_hot_candidates(x_hat, n_cand), rand], axis=0)
            q = env.evaluate(es, tasks, cands, sp)
            best = jnp.argmax(q)
            new_es, res = env.step(es, tasks, cands[best], sp)
            return (wl, new_es, g, cands[best], res.reward, q, best, cands,
                    x_hat, tasks, gum, cand_margin)

        out = jax.vmap(fleet)(env_state, wl_state, task_subs, dec_subs)
        return (task_keys, dec_keys) + out

    absorb = jax.jit(lambda st, g, d, lr: adef.absorb(st, g, d, lr=lr))
    return slot, absorb


def pop_member_episode(drv, programs, agent, key, sp, hypers,
                       n_slots: int) -> dict:
    """One population member's training episode as the reference's
    ``PopulationDriver`` runs it (``drv.init_carry(key, agent_state=agent,
    sp=sp)``, then ``drv._slot(carry, sp, hypers)`` per slot), replayed
    from its key schedule by ``programs`` (``_pop_programs(drv)``): the
    tasks, each fleet's Gumbel noise [T, B, K, M, O] (``decide_with``'s
    ``jax.random.gumbel(dk, ...)``), the replay rows of each train step,
    and per slot and fleet the decision, reward, q_est and three margins:
    the critic's (``q_margin``), the actor's (``xhat_margin``) and the
    smallest gap between the top two of the noise an exploration
    candidate's argmax picks from (``cand_margin``: x_hat * gain +
    gumbel). With ``drv.train`` also the per-slot loss; and the final
    ``AgentState``."""
    slot, absorb = programs
    adef = drv.adef
    carry = drv.init_carry(key, agent_state=agent, sp=sp)
    k_episode = carry.agent_state.key
    state, env_state, wl = carry.agent_state, carry.env_state, carry.wl_state
    task_keys, dec_keys = carry.task_keys, carry.dec_keys
    rec = {k_: [] for k_ in ("decisions", "reward", "q_est", "q_margin",
                             "xhat_margin", "cand_margin", "loss", "gumbel")}
    tasks_all, sizes = [], []
    for _ in range(n_slots):
        (task_keys, dec_keys, wl, env_state, g, dec, reward, q, best, cands,
         x_hat, tasks, gum, cand_margin) = slot(
            state, env_state, wl, task_keys, dec_keys, sp,
            hypers.explore_gain)
        cands, q, best = map(np.asarray, (cands, q, best))
        b = np.arange(q.shape[0])
        dec = np.asarray(dec)
        other = (cands != dec[:, None, :]).any(-1)
        x_sorted = np.sort(np.asarray(x_hat), axis=-1)
        rec["decisions"].append(dec)
        rec["reward"].append(np.asarray(reward))
        rec["q_est"].append(q[b, best])
        rec["q_margin"].append(q[b, best] - np.where(other, q, -np.inf)
                               .max(-1))
        rec["xhat_margin"].append((x_sorted[..., -1] - x_sorted[..., -2])
                                  .min(-1))
        rec["cand_margin"].append(np.asarray(cand_margin))
        rec["gumbel"].append(np.asarray(gum, np.float32))
        tasks_all.append(tasks)
        if not drv.train:
            continue
        size_before = int(state.replay.size)
        state, loss = absorb(state, g, jnp.asarray(dec), hypers.lr)
        rec["loss"].append(np.asarray(loss))
        if not np.isnan(np.asarray(loss)):
            sizes.append(min(size_before + dec.shape[0], adef.buffer_size))
    out = {k_: np.stack(v) for k_, v in rec.items() if v}
    out.update({f"tasks/{f}": np.stack([np.asarray(getattr(t, f))
                                        for t in tasks_all])
                for f in TASK_FIELDS})
    out["replay_take"] = (train_takes(adef, k_episode, sizes).astype(
        np.int32) if sizes else np.zeros((0, adef.batch_size), np.int32))
    out["final_state"] = state
    return out


def build_pop() -> dict:
    """Everything the population golden file holds, as a flat dict (see
    the module docstring)."""
    import tempfile

    from repro.obs.history import HistoryStore
    from repro.obs.telemetry import telemetry_host
    from repro.pop import pbt_update
    from repro.pop.population import exit_mask_from_tau

    c = POP
    with tempfile.TemporaryDirectory() as tmp:
        hist = HistoryStore(tmp)
        tr = pop_trainer(telemetry=True, history=hist, history_name="pop")
        drv = tr.driver.drv
        programs = _pop_programs(drv)
        p = c["members"]
        ts = tr.init_state()
        _, k_hyp = jax.random.split(jax.random.fold_in(tr.root, 0))
        data = {"config": np.asarray(repr(sorted(c.items()))),
                "init/hyper_u": np.stack([
                    np.asarray(jax.random.uniform(k_, (p,)))
                    for k_ in jax.random.split(k_hyp, 3)])}
        data.update(flat_tree("init/hypers", ts.pop.hypers._asdict()))
        data.update(flat_tree("init/params", jax.tree_util.tree_map(
            np.asarray, ts.pop.agents.params)))
        for g in range(c["generations"]):
            pre = f"gen{g}"
            key1 = tr._gen_key(1, g)
            _, k_offset = jax.random.split(key1)
            region, sps = tr._resample_fn(ts.cur, key1)
            data[f"{pre}/region"] = np.asarray(region)
            data[f"{pre}/offset"] = np.asarray(
                jax.random.uniform(k_offset, (p,), jnp.float32))
            data.update(flat_tree(f"{pre}/sps", sps._asdict()))
            key2 = tr._gen_key(2, g)
            run, mets = tr.driver.run_generation(ts.pop, key2, sps)
            for i in range(p):
                pick = (lambda x: x[i])
                agent = jax.tree_util.tree_map(pick, ts.pop.agents)
                hyp = jax.tree_util.tree_map(pick, ts.pop.hypers)
                agent = agent._replace(exit_mask=exit_mask_from_tau(
                    drv.adef, hyp.exit_tau))
                ep = pop_member_episode(
                    drv, programs, agent, jax.random.fold_in(key2, i),
                    jax.tree_util.tree_map(pick, sps), hyp, c["slots"])
                # the replay is the population driver's own run
                want = jax.tree_util.tree_map(pick, run.agents.params)
                for a, b in zip(jax.tree_util.tree_leaves(
                        ep.pop("final_state").params),
                        jax.tree_util.tree_leaves(want)):
                    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                               rtol=1e-4, atol=1e-6)
                np.testing.assert_allclose(ep["reward"].mean(),
                                           float(mets["avg_reward"][i]),
                                           rtol=1e-5)
                data.update({f"{pre}/m{i}/{k}": v for k, v in ep.items()})
            data.update({f"{pre}/mets/{k}": np.asarray(v)
                         for k, v in mets.items()})
            key3 = tr._gen_key(3, g)
            k_coin, k_gain, k_tau = jax.random.split(key3, 3)
            cfg = tr.pbt_cfg
            data[f"{pre}/pbt/up"] = np.asarray(
                jax.random.bernoulli(k_coin, 0.5, (p,)))
            data[f"{pre}/pbt/gain"] = np.asarray(jax.random.uniform(
                k_gain, (p,), jnp.float32, -cfg.gain_jitter,
                cfg.gain_jitter))
            data[f"{pre}/pbt/tau"] = np.asarray(jax.random.uniform(
                k_tau, (p,), jnp.float32, -cfg.tau_jitter, cfg.tau_jitter))
            _, stats = pbt_update(run, mets["avg_reward"], key3, cfg)
            data.update({f"{pre}/stats/{k}": np.asarray(v)
                         for k, v in stats._asdict().items()})
            ts, rep = tr.generation(ts)
            data.update({f"{pre}/report/{k}": np.asarray(v, np.float64)
                         for k, v in rep["metrics"].items()})
            data[f"{pre}/report/best_member"] = np.asarray(rep["best_member"])
            data[f"{pre}/report/region_visits"] = np.asarray(
                rep["region_visits"])
            data.update(flat_tree(f"{pre}/hypers", ts.pop.hypers._asdict()))
            data.update(flat_tree(f"{pre}/cur", ts.cur._asdict()))
        data.update(flat_tree("final/params", jax.tree_util.tree_map(
            np.asarray, ts.pop.agents.params)))
        host = telemetry_host(tr.telemetry)
        data.update({f"telemetry/{k}": np.asarray(v)
                     for k, v in host["counters"].items()})
        data.update({f"telemetry/hist/{k}": np.asarray(h["counts"])
                     for k, h in host["hists"].items()})
        recs = [r for r in hist.records() if r["kind"] == "pop"]
        for j, r in enumerate(recs):
            data.update({f"history/{j}/{k}": np.asarray(v, np.float64)
                         for k, v in r["metrics"].items()})
    return data


def pop_margin(data: dict) -> float:
    """The smallest recorded margin (critic, actor, exploration noise) of
    every member-episode of a population golden run."""
    return min(float(data[k].min()) for k in data
               if k.rsplit("/", 1)[-1] in ("q_margin", "xhat_margin",
                                           "cand_margin"))


# ------------------------------------------------------------------ serving
def serve_engine(scheduler: str = "grle", kind: str = "sync", *,
                 arch: str = SERVE_ARCH, **kw):
    """A JAX serving engine as the serve golden and tests build it, over
    the reduced ``arch``; the sync one with ``lm_params_numpy`` weights."""
    from repro.configs import get_arch
    from repro.serve import ContinuousServingEngine, EdgeServingEngine, Replica
    from repro_torch.core.bridge import lm_params_numpy

    cfg = get_arch(arch, reduced=True)
    kw = dict(dict(scheduler=scheduler, batch_slots=SERVE_BATCH,
                   seed=SERVE_SEED, workload="mmpp", scenario="dyn_bursty",
                   agent_kw=SERVE_AGENT_KW), **kw)
    replicas = [Replica(n, s) for n, s in SERVE_REPLICAS]
    if kind != "sync":
        return ContinuousServingEngine(cfg, replicas, **kw)
    eng = EdgeServingEngine(cfg, replicas, **kw)
    eng.params = jax.tree_util.tree_map(
        jnp.asarray, lm_params_numpy(cfg, SERVE_LM_SEED))
    return eng


def record_draws(eng) -> list:
    """Wrap a JAX engine's workload sample and agent step so that every
    scheduling step appends {"tasks" (before the occupancy overlay),
    "key", "size", "step"}: the agent's RNG key, replay size and slot
    count as the step finds them."""
    rec = []
    sample, step = eng._workload.sample, eng._agent_step

    def rec_sample(state, key, sp=None):
        state, tasks = sample(state, key, sp)
        rec.append({"tasks": tasks})
        return state, tasks

    def rec_step(state, mec_state, tasks, key=None, sp=None):
        rec[-1].update(key=state.key, size=int(state.replay.size),
                       step=int(state.step))
        return step(state, mec_state, tasks, key, sp)

    eng._workload.sample = rec_sample
    eng._agent_step = rec_step
    return rec


def serve_draws(eng, rec) -> dict:
    """The recorded steps' draws as the port injects them: tasks leaves
    [T, ...], the exploration candidates [T, K, M] (``AgentDef.step``
    splits the state's key and draws Gumbel noise over the allowed
    options, ``decide_with``) and each train step's replay rows
    [n_train, batch_size] at the steps ``train_steps``."""
    adef = eng.agent_def
    env = adef.env
    mask = jnp.asarray(eng.agent_state.exit_mask)
    rand, takes, train_steps = [], [], []
    for t, r in enumerate(rec):
        new_key, key = jax.random.split(r["key"])
        g_mask = jnp.repeat(r["tasks"].connect, env.L, axis=-1)
        allowed = (mask[None, :] > 0.5) & (g_mask > 0.5)
        gumbel = jax.random.gumbel(key, (adef.n_random, *allowed.shape))
        rand.append(np.asarray(jnp.argmax(
            jnp.where(allowed[None], gumbel, -jnp.inf), axis=-1)))
        size = min(r["size"] + 1, adef.buffer_size)
        if (r["step"] + 1) % adef.train_every == 0 \
                and size >= adef.batch_size:
            takes.append(train_takes(adef, new_key, [size])[0])
            train_steps.append(t)
    out = {f"tasks/{f}": np.stack([np.asarray(getattr(r["tasks"], f))
                                   for r in rec]) for f in TASK_FIELDS}
    out["rand_cands"] = np.stack(rand).astype(np.int8)
    out["replay_take"] = (np.stack(takes).astype(np.int32) if takes else
                          np.zeros((0, adef.batch_size), np.int32))
    out["train_steps"] = np.asarray(train_steps, np.int32)
    return out


def serve_run(scheduler: str = "grle", *, arch: str = SERVE_ARCH,
              schedule=SERVE_SCHEDULE) -> dict:
    """The JAX sync engine over ``schedule`` with decoding, serving the
    reduced ``arch``: the golden file's arrays plus "state0" (the initial
    ``AgentState``, numpy), "telemetry" (the snapshot), "latency_ring" and
    "tokens_served"."""
    from repro.mec.profiles import TPU_V5E_HBM_BW, TPU_V5E_PEAK_FLOPS

    eng = serve_engine(scheduler, arch=arch)
    state0 = jax.tree_util.tree_map(np.asarray, eng.agent_state)
    rec = record_draws(eng)
    names = [n for n, _ in SERVE_REPLICAS]
    t, m = len(schedule), SERVE_BATCH
    out = {"assign_replica": np.full((t, m), -1, np.int32),
           "assign_exit": np.full((t, m), -1, np.int32),
           "texts": np.full((t, m, SERVE_NEW), -1, np.int32),
           "reward": np.zeros((t,), np.float32),
           "loss": np.full((t,), np.nan, np.float32)}
    for i, n in enumerate(schedule):
        reqs = None if n < 0 else [eng.make_request() for _ in range(n)]
        count = int(eng.agent_state.loss_count)
        assignments, info = eng.serve_slot(reqs, decode=True)
        for j, (name, e) in enumerate(assignments):
            out["assign_replica"][i, j] = names.index(name)
            out["assign_exit"][i, j] = e
            out["texts"][i, j] = info["texts"][j]
        out["reward"][i] = info["reward"]
        if int(eng.agent_state.loss_count) > count:
            out["loss"][i] = float(eng.agent_state.last_loss)
    out.update(serve_draws(eng, rec))
    summary = eng.metrics.summary()
    data = {"seed": np.asarray(SERVE_SEED),
            "lm_seed": np.asarray(SERVE_LM_SEED),
            "scheduler": np.asarray(scheduler),
            "schedule": np.asarray(schedule, np.int32),
            "profile/peak_flops": np.asarray(TPU_V5E_PEAK_FLOPS),
            "profile/hbm_bw": np.asarray(TPU_V5E_HBM_BW),
            "exit_mask": np.asarray(state0.exit_mask),
            "tokens_served": np.asarray(eng.tokens_served),
            **{f"summary/{k}": np.asarray(summary[k]) for k in SUMMARY_KEYS},
            **out}
    final = jax.tree_util.tree_map(np.asarray, eng.agent_state.params)
    for prefix, tree in (("init_params", state0.params),
                         ("final/params", final)):
        data.update(flat_tree(prefix, tree))
    extra = {"state0": state0, "telemetry": eng.telemetry_snapshot(),
             "latency_ring": np.asarray(eng._latency_ring, np.float64)}
    return data, extra


def build_serve() -> dict:
    """Everything the serving golden file holds, as a flat dict."""
    return serve_run("grle")[0]


# ------------------------------------------------------- continuous serving
def bench_traces(slot_s: float) -> dict:
    """The serve-bench's ``--quick`` traces (``BENCH_TRACES``) for an
    engine whose slot is ``slot_s``, and the tail: the next ``BENCH_TAIL``
    requests of the main trace's stream, their instants moved back so
    that the first arrives at 0."""
    from repro.serve import make_trace
    kw = dict(n_users=BENCH_USERS, slot_s=slot_s / BENCH_GRID,
              deadline_slack_s=BENCH_SLACK_S, scenario="dyn_bursty")
    (n_w, seed_w, r_w), (n_m, seed_m, r_m) = BENCH_TRACES.values()
    warm = make_trace(n_slots=n_w, seed=seed_w, max_requests=r_w, **kw)
    stream = make_trace(n_slots=n_m, seed=seed_m,
                        max_requests=r_m + BENCH_TAIL, **kw)
    tail = stream[r_m:]
    return {"warm": warm, "main": stream[:r_m],
            "tail": shifted(tail, -tail[0].arrival_s)}


def shifted(trace, t0: float) -> list:
    """A trace's absolute instants shifted onto a clock already at t0
    (the bench's ``_shifted``)."""
    return [dataclasses.replace(r, arrival_s=r.arrival_s + t0,
                                deadline_s=r.deadline_s + t0)
            for r in trace]


def trace_arrays(prefix: str, trace) -> dict:
    return {f"{prefix}/{f}": np.asarray([getattr(r, f) for r in trace])
            for f in TRACE_FIELDS}


def record_inputs(eng) -> list:
    """Wrap a JAX engine's agent step so that every call appends the
    inputs its decision reads (params, exit mask, key, MEC state and the
    overlaid tasks) and the decision it made."""
    rec, step = [], eng._agent_step

    def rec_step(state, mec_state, tasks, key=None, sp=None):
        out = step(state, mec_state, tasks, key, sp)
        rec.append((state.params, state.exit_mask, state.key, mec_state,
                    tasks, out[1]))
        return out

    eng._agent_step = rec_step
    return rec


def serve_margins(adef, inputs) -> dict:
    """Each recorded step's decision [T, M] replayed from its inputs (held
    against the engine's own), the critic's margin between the best
    candidate and the best one with another decision (``q_margin``) and
    the smallest per-device gap between the actor's top two scores
    (``xhat_margin``), [T] each."""
    env = adef.env

    @jax.jit
    def margins(params, exit_mask, key, mec_state, tasks):
        _, key = jax.random.split(key)
        g = build_graph(env.observe(mec_state, tasks), env.N, env.L)
        x_hat, _ = adef.scores(params, g, exit_mask)
        cands = one_hot_candidates(x_hat, adef.n_candidates)
        allowed = (exit_mask[None, :] > 0.5) & (g.mask > 0.5)
        gumbel = jax.random.gumbel(key, (adef.n_random, *allowed.shape))
        rand = jnp.argmax(jnp.where(allowed[None], gumbel, -jnp.inf),
                          axis=-1).astype(jnp.int32)
        cands = jnp.concatenate([cands, rand], axis=0)
        q = env.evaluate(mec_state, tasks, cands)
        best = jnp.argmax(q)
        dec = cands[best]
        other = (cands != dec[None]).any(-1)
        q_other = jnp.where(other, q, -jnp.inf).max()
        xs = jnp.sort(x_hat, axis=-1)
        return dec, q[best] - q_other, (xs[..., -1] - xs[..., -2]).min()

    out = {"decisions": [], "q_margin": [], "xhat_margin": []}
    for params, mask, key, mec_state, tasks, decision in inputs:
        dec, qm, xm = margins(params, mask, key, mec_state, tasks)
        assert (np.asarray(dec) == np.asarray(decision)).all(), \
            "the margins' replay does not make the engine's decision"
        out["decisions"].append(np.asarray(decision, np.int32))
        out["q_margin"].append(np.asarray(qm, np.float32))
        out["xhat_margin"].append(np.asarray(xm, np.float32))
    return {k: np.stack(v) for k, v in out.items()}


def serve_async_run() -> tuple:
    """The JAX continuous engine at the serve-bench's ``--quick`` shape
    over the warm-up, main and tail traces: (the golden file's arrays,
    the traces before they were shifted onto the engine's clock)."""
    from repro.mec.profiles import TPU_V5E_HBM_BW, TPU_V5E_PEAK_FLOPS

    eng = serve_engine("grle", "async", batch_slots=BENCH_SLOTS_CONT,
                       agent_kw=BENCH_AGENT_KW)
    state0 = jax.tree_util.tree_map(np.asarray, eng.agent_state)
    rec = record_draws(eng)
    inputs = record_inputs(eng)
    data = {"seed": np.asarray(SERVE_SEED),
            "scheduler": np.asarray("grle"),
            "batch_slots": np.asarray(BENCH_SLOTS_CONT),
            "agent_kw": np.asarray(json.dumps(BENCH_AGENT_KW,
                                              sort_keys=True)),
            "profile/peak_flops": np.asarray(TPU_V5E_PEAK_FLOPS),
            "profile/hbm_bw": np.asarray(TPU_V5E_HBM_BW),
            "exit_mask": np.asarray(state0.exit_mask),
            "runs": np.asarray(["warm", "main", "tail"])}
    traces = bench_traces(float(eng.env.cfg.slot_s))
    for name, trace in traces.items():
        trace = shifted(trace, eng.clock.now())
        served, tokens = eng.counts["served"], eng.tokens_served
        reports = eng.run(trace)
        data.update(trace_arrays(f"trace/{name}", trace))
        data[f"reports/{name}"] = np.asarray(json.dumps(reports,
                                                        sort_keys=True))
        data[f"steps/{name}"] = np.asarray(len(reports))
        if name == "main":
            snap = eng.telemetry_snapshot()["summary"]
            row = dict(n_requests=eng.counts["served"] - served,
                       n_tokens=eng.tokens_served - tokens,
                       deadline_hit_rate=snap["deadline_hit_rate_exact"],
                       latency_p50_s=snap["latency_p50_s_exact"],
                       latency_p99_s=snap["latency_p99_s_exact"],
                       queue_depth_p99=snap["queue_depth_p99"])
            data.update({f"row/{k}": np.asarray(row[k])
                         for k in BENCH_ROW_KEYS})
    data.update({f"counts/{k}": np.asarray(v) for k, v in eng.counts.items()})
    data["tokens_served"] = np.asarray(eng.tokens_served)
    data["train_steps_taken"] = np.asarray(int(eng.agent_state.loss_count))
    data.update(serve_draws(eng, rec))
    data.update(serve_margins(eng.agent_def, inputs))
    final = jax.tree_util.tree_map(np.asarray, eng.agent_state.params)
    for prefix, tree in (("init_params", state0.params),
                         ("final/params", final)):
        data.update(flat_tree(prefix, tree))
    assert len(data["train_steps"]) >= 1
    return data, traces


def build_serve_async() -> dict:
    """Everything the continuous-serving golden file holds, flat."""
    return serve_async_run()[0]


def serve_bench_sync_run(warm, main) -> dict:
    """The sync side of the serve-bench's ``--quick`` comparison in JAX:
    a 4-slot ``EdgeServingEngine`` fed ``warm`` then ``main`` in 4-request
    chunks (the bench's ``_run_sync``). Returns its initial ``AgentState``
    (numpy), draws, the sync row's deterministic fields and the engine."""
    eng = serve_engine("grle", "sync", batch_slots=BENCH_SLOTS_SYNC,
                       agent_kw=BENCH_AGENT_KW, init_model=False)
    state0 = jax.tree_util.tree_map(np.asarray, eng.agent_state)
    rec = record_draws(eng)
    for trace in (warm, main):
        tokens = eng.tokens_served
        for i in range(0, len(trace), BENCH_SLOTS_SYNC):
            eng.serve_slot([eng.make_request(prompt_len=r.prompt_len,
                                             max_new=r.max_new)
                            for r in trace[i: i + BENCH_SLOTS_SYNC]])
    snap = eng.telemetry_snapshot()["summary"]
    row = dict(n_requests=len(main), n_tokens=eng.tokens_served - tokens,
               deadline_hit_rate=snap["deadline_hit_rate"],
               latency_p50_s=snap["latency_p50_s_exact"],
               latency_p99_s=snap["latency_p99_s_exact"])
    return {"state0": state0, "draws": serve_draws(eng, rec), "row": row,
            "engine": eng}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=GOLDEN)
    ap.add_argument("--train-out", default=TRAIN_GOLDEN)
    ap.add_argument("--serve-out", default=SERVE_GOLDEN)
    ap.add_argument("--dyn-out", default=DYN_GOLDEN)
    ap.add_argument("--pop-out", default=POP_GOLDEN)
    ap.add_argument("--serve-async-out", default=SERVE_ASYNC_GOLDEN)
    ap.add_argument("--only", choices=("decision", "train", "serve", "dyn",
                                       "pop", "serve_async"))
    args = ap.parse_args(argv)
    jobs = {"decision": (build, args.out),
            "train": (build_train, args.train_out),
            "serve": (build_serve, args.serve_out),
            "dyn": (build_dyn, args.dyn_out),
            "pop": (build_pop, args.pop_out),
            "serve_async": (build_serve_async, args.serve_async_out)}
    for name, (fn, out) in jobs.items():
        if args.only not in (None, name):
            continue
        data = fn()
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez_compressed(out, **data)
        print(f"wrote {out}: {os.path.getsize(out)} bytes, "
              f"{len(data)} arrays")
    return 0


if __name__ == "__main__":
    sys.exit(main())
