"""Write ``tests/data/torch_figures_golden.npz``: the JAX reference's side of
the port's paper-figure checks (``repro_torch.figures``), for the CPU
tests and for ``chip_smoke.py`` on the card, where JAX is not installed.

    PYTHONPATH=src python tools/make_torch_figures_golden.py [--out PATH]
        [--only replay|learn]

Runs on the CPU with JAX only; about two minutes on 8 cores (the M=14
learning sweep takes most of it).

The replay part (``build_replay``): for each of the four methods,
``benchmarks/common.py::rollout_method`` itself on fig5_baseline at M=6,
τ = 30 ms, ``REPLAY_SLOTS`` = 100 slots (the ring first holds a minibatch
of 64 at slot 64, so the agent trains at slots 70, 80, 90 and 100), seed
0, with its agent's slot step wrapped (``record``) to keep what each slot
reads and makes: the tasks, the agent's RNG key, ring size and step
count, the decision and the loss. From the keys it rebuilds the draws as
the port injects them (the exploration candidates: ``AgentDef.step``
splits the state's key and ``decide_with`` takes a Gumbel argmax over the
allowed options; each train step's replay rows: ``replay_sample`` on a
ring whose entries hold their own index), and per slot the critic's margin
between the best candidate and the best other decision (``q_margin``) and
the smallest per-device gap between the actor's top two scores
(``xhat_margin``). The tasks, the same for every method (one key chain
from the seed), are ``replay/tasks/<field>`` [T, ...]; per method ``m``:
``replay/m/params/<path>`` (the initial params), ``replay/m/exit_mask``,
``replay/m/rand_cands`` [T, K, M] int8, ``replay/m/replay_take``
[n_train, 64], ``replay/m/decisions`` [T, M], ``replay/m/q_margin``,
``replay/m/xhat_margin``, ``replay/m/loss`` [T] (NaN where no train step
ran) and the row's ``replay/m/summary/<key>``.

The learning part (``build_learn``): the reference's ``run_sweep`` at
``repro_torch.figures.learning``'s ``CPU_SPEC`` (fig5_baseline, GRLE and
DROOE, seeds 0-15, M=6, 8 fleets, 50 slots, ring 128, minibatch 64, a
train step every 10 slots: 5 steps) and ``CARD_SPEC`` (the same at M=14,
one fleet, 600 slots: 54 steps): ``learn/<cut>/spec`` (the spec's JSON)
and per method and key of ``LEARN_KEYS`` the per-seed values
``learn/<cut>/<method>/<key>`` [16], with ``train_steps``.
``tests/test_torch_figures.py`` checks that the specs are the port's.
"""
from __future__ import annotations

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import benchmarks.common as bench  # noqa: E402
from make_torch_port_golden import (TASK_FIELDS, flat_tree,  # noqa: E402
                                    train_takes)
from repro.core.graph import build_graph  # noqa: E402
from repro.core.quantize import one_hot_candidates  # noqa: E402
from repro.sweep import SweepSpec, run_sweep  # noqa: E402
from repro_torch.figures.learning import (CARD_SPEC, CPU_SPEC,  # noqa: E402
                                          LEARN_KEYS, spec_json)

PATH = os.path.join(ROOT, "tests", "data", "torch_figures_golden.npz")
METHODS = ("grle", "grl", "drooe", "droo")
REPLAY = dict(scenario="fig5_baseline", n_devices=6, slot_ms=30.0, seed=0)
REPLAY_SLOTS = 100
SUMMARY_KEYS = ("ssp", "avg_accuracy", "throughput_tps", "avg_reward",
                "tasks")
CUTS = {"cpu": CPU_SPEC, "card": CARD_SPEC}


def record(agent) -> list:
    """Wrap the shim's jitted slot step so that every slot appends what it
    reads (params, exit mask, key, ring size, step count, MEC state,
    tasks) and makes (decision, loss)."""
    rec, step = [], agent._step_fn

    def rec_step(state, mec_state, tasks, key=None, sp=None):
        out = step(state, mec_state, tasks, key, sp)
        rec.append(dict(params=state.params, exit_mask=state.exit_mask,
                        key=state.key, size=int(state.replay.size),
                        step=int(state.step), mec_state=mec_state,
                        tasks=tasks, decision=np.asarray(out[1]),
                        loss=float(out[2].loss)))
        return out

    agent._step_fn = rec_step
    return rec


def margins_fn(adef):
    """(decision, q_margin, xhat_margin, rand_cands) of one recorded slot,
    replayed from its inputs as ``AgentDef.step`` with ``key=None`` makes
    it."""
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
        return (dec, q[best] - q_other, (xs[..., -1] - xs[..., -2]).min(),
                rand)

    return margins


def replay_run(method: str) -> dict:
    """One method's replay arrays (see the module docstring), from the
    reference's own ``rollout_method``."""
    made = []
    make_agent = bench.make_agent

    def recording_make_agent(*args, **kw):
        agent = make_agent(*args, **kw)
        made.append((agent, jax.tree_util.tree_map(
            np.asarray, agent.state.params), record(agent)))
        return agent

    bench.make_agent = recording_make_agent
    try:
        row = bench.rollout_method(method, REPLAY["scenario"],
                                   n_devices=REPLAY["n_devices"],
                                   slot_ms=REPLAY["slot_ms"],
                                   slots=REPLAY_SLOTS, seed=REPLAY["seed"])
    finally:
        bench.make_agent = make_agent
    (agent, params0, rec), = made
    adef = agent.adef
    margins = margins_fn(adef)
    p = f"replay/{method}"
    out = {f"{p}/exit_mask": np.asarray(rec[0]["exit_mask"])}
    out.update(flat_tree(f"{p}/params", params0))
    cols = {k: [] for k in ("decisions", "q_margin", "xhat_margin",
                            "rand_cands", "loss")}
    takes = []
    for r in rec:
        dec, qm, xm, rand = margins(r["params"], r["exit_mask"], r["key"],
                                    r["mec_state"], r["tasks"])
        assert (np.asarray(dec) == r["decision"]).all(), \
            "the margins' replay does not make the agent's decision"
        cols["decisions"].append(r["decision"].astype(np.int32))
        cols["q_margin"].append(np.float32(qm))
        cols["xhat_margin"].append(np.float32(xm))
        cols["rand_cands"].append(np.asarray(rand, np.int8))
        cols["loss"].append(np.float32(r["loss"]))
        size = min(r["size"] + 1, adef.buffer_size)
        if (r["step"] + 1) % adef.train_every == 0 \
                and size >= adef.batch_size:
            new_key, _ = jax.random.split(r["key"])
            takes.append(train_takes(adef, new_key, [size])[0])
    out.update({f"{p}/{k}": np.stack(v) for k, v in cols.items()})
    out[f"{p}/replay_take"] = np.stack(takes).astype(np.int32)
    out.update({f"{p}/tasks/{f}": np.stack(
        [np.asarray(getattr(r["tasks"], f)) for r in rec])
        for f in TASK_FIELDS})
    out.update({f"{p}/summary/{k}": np.asarray(row[k])
                for k in SUMMARY_KEYS})
    assert len(takes) == int(np.isfinite(out[f"{p}/loss"]).sum()) >= 3
    return out


def build_replay() -> dict:
    data = {f"replay/{k}": np.asarray(v) for k, v in REPLAY.items()}
    data["replay/slots"] = np.asarray(REPLAY_SLOTS)
    for method in METHODS:
        run = replay_run(method)
        # every method draws the same tasks (one key chain from the seed):
        # they are stored once
        for f in TASK_FIELDS:
            tasks = run.pop(f"replay/{method}/tasks/{f}")
            np.testing.assert_array_equal(
                data.setdefault(f"replay/tasks/{f}", tasks), tasks)
        data.update(run)
    return data


def build_learn() -> dict:
    data = {}
    for cut, spec in CUTS.items():
        rows = run_sweep(SweepSpec(**spec), log=lambda *_: None)
        data[f"learn/{cut}/spec"] = np.asarray(spec_json(spec))
        for method in spec["methods"]:
            mine = sorted((r for r in rows if r["method"] == method),
                          key=lambda r: r["seed"])
            assert [r["seed"] for r in mine] == list(spec["seeds"])
            for key in LEARN_KEYS + ("train_steps",):
                data[f"learn/{cut}/{method}/{key}"] = np.asarray(
                    [r[key] for r in mine])
    return data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=PATH)
    ap.add_argument("--only", choices=("replay", "learn"))
    args = ap.parse_args(argv)
    data = {}
    if os.path.exists(args.out) and args.only:
        with np.load(args.out) as z:
            data = {k: z[k] for k in z.files
                    if not k.startswith(args.only + "/")}
    if args.only in (None, "replay"):
        data.update(build_replay())
    if args.only in (None, "learn"):
        data.update(build_learn())
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **data)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes, "
          f"{len(data)} arrays")
    return 0


if __name__ == "__main__":
    sys.exit(main())
