"""Serving throughput: the synchronous slot loop against continuous batching.

    PYTHONPATH=src python -m repro_torch.launch serve-bench [--quick]
        [--device cpu] [--out BENCH_torch_serve.json]

Counterpart of ``repro/launch/serve_bench.py`` and the benchmark it fronts
(``benchmarks/serve_throughput.py``), carried inside the package. Both
paths schedule the *same* MMPP request trace (``dyn_bursty``: two-state
bursty arrivals, churn, AR(1) channels) on the scheduling plane
(``init_model=False``: no LM decode, so the comparison isolates the
serving loop):

* ``serve_sync_slots4``: ``EdgeServingEngine`` with ``batch_slots=4``,
  the host feeding ``serve_slot`` one 4-request chunk at a time;
* ``serve_continuous_slots64`` (32 under ``--quick``):
  ``ContinuousServingEngine``: deadline-aware queue, pure scheduler tick
  per decode step, one batched GRLE actor pass pricing the whole batch.

The trace's arrival grid is 8x denser than the engine's slot grid, so a
backlog forms (``queue_depth_p99``). Rows merge into ``--out`` (rows of
other names are kept) and append to the port's run-history store
(``REPRO_HISTORY``). The command asserts what the reference asserts: the
continuous engine served every request and beat the sync loop on
requests/s. Runs on the card unless ``--device cpu``; on the card the
agent's actor runs the hand-written ``gcn_agg`` and ``edge_score``
kernels, and the clock stops only after ``torch.cuda.synchronize``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Sequence

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.obs.rows import record_rows, stamp_rows, timed
from repro_torch.serve import (ContinuousServingEngine, EdgeServingEngine,
                               Replica, make_trace)

# identical scheduler knobs for both engines (candidate subsampling keeps
# the wide-batch critic cost bounded; training cadence matches defaults)
AGENT_KW = dict(n_candidates=16, buffer_size=64, batch_size=16,
                train_every=5)
ARCH = "qwen1_5_0_5b"
REPLICAS = (("a", 1.0), ("b", 0.7))
SLOTS_SYNC = 4
GRID = 8                    # trace slots per engine slot
DEADLINE_SLACK_S = 600.0
WARM_SEED, MAIN_SEED = 99, 7
WARM_SLOTS, MAIN_SLOTS = 4, 4000
DEFAULT_OUT = "BENCH_torch_serve.json"


def quick_shape(quick: bool) -> dict:
    """The bench's size: continuous batch slots, users and requests."""
    return (dict(slots_cont=32, n_users=64, n_requests=192) if quick
            else dict(slots_cont=64, n_users=128, n_requests=1200))


def _engines(cfg, replicas, *, slots_sync, slots_cont, seed, device=None,
             **kw):
    common = dict(seed=seed, workload="mmpp", scenario="dyn_bursty",
                  agent_kw=AGENT_KW, init_model=False, device=device, **kw)
    sync = EdgeServingEngine(cfg, replicas, batch_slots=slots_sync, **common)
    cont = ContinuousServingEngine(cfg, replicas, batch_slots=slots_cont,
                                   **common)
    return sync, cont


def traces(slot_s: float, *, n_users: int, n_requests: int):
    """(warm-up, main) traces on a grid ``GRID`` x denser than ``slot_s``,
    with generous slack, so throughput compares served work, not drops."""
    kw = dict(n_users=n_users, slot_s=slot_s / GRID,
              deadline_slack_s=DEADLINE_SLACK_S, scenario="dyn_bursty")
    warm = make_trace(n_slots=WARM_SLOTS, seed=WARM_SEED,
                      max_requests=GRID * WARM_SLOTS, **kw)
    main = make_trace(n_slots=MAIN_SLOTS, seed=MAIN_SEED,
                      max_requests=n_requests, **kw)
    return warm, main


def _shifted(trace, t0):
    """Shift a trace's absolute instants onto a clock already at t0."""
    return [dataclasses.replace(r, arrival_s=r.arrival_s + t0,
                                deadline_s=r.deadline_s + t0)
            for r in trace]


def _run_sync(eng, trace):
    """Feed the trace through ``serve_slot`` in batch-sized chunks."""
    k = eng.batch_slots

    def loop():
        for i in range(0, len(trace), k):
            chunk = trace[i: i + k]
            reqs = [eng.make_request(prompt_len=r.prompt_len,
                                     max_new=r.max_new) for r in chunk]
            eng.serve_slot(reqs)
        return eng.get_agent_state().params

    _, wall = timed(loop, eng.device)
    return wall


def _run_continuous(eng, trace):
    def loop():
        eng.run(_shifted(trace, eng.clock.now()))
        return eng.get_agent_state().params

    _, wall = timed(loop, eng.device)
    return wall


def continuous_fields(eng, served0: int, tokens0: int) -> dict:
    """The continuous row's deterministic fields, read from ``eng`` after
    a run that began at ``served0`` served requests and ``tokens0``
    tokens: what it served, its deadline hit rate, the exact latency
    quantiles of its ring and its queue's p99 depth."""
    snap = eng.telemetry_snapshot()["summary"]
    return {"n_requests": eng.counts["served"] - served0,
            "n_tokens": eng.tokens_served - tokens0,
            "deadline_hit_rate": snap["deadline_hit_rate_exact"],
            "latency_p50_s": snap["latency_p50_s_exact"],
            "latency_p99_s": snap["latency_p99_s_exact"],
            "queue_depth_p99": snap["queue_depth_p99"]}


def bench_rows(sync, cont, main, warm) -> list:
    """Warm both engines on ``warm``, then time each on ``main``: the
    bench's two rows (unstamped). The engines and traces are the
    caller's, so a test can inject draws."""
    # warm both engines, so the timed windows hold no kernel build, no
    # first-call set-up
    _run_sync(sync, warm)
    _run_continuous(cont, warm)

    base_tokens_sync = sync.tokens_served
    wall_sync = _run_sync(sync, main)
    served_sync = len(main)
    tokens_sync = sync.tokens_served - base_tokens_sync
    rps_sync = served_sync / wall_sync
    tps_sync = tokens_sync / wall_sync
    print(f"  sync       slots={sync.batch_slots}   {served_sync} reqs  "
          f"{wall_sync:6.2f}s  {rps_sync:8.1f} req/s  "
          f"{tps_sync:8.1f} tok/s", flush=True)

    slots_cont = cont.batch_slots
    served0, tokens0 = cont.counts["served"], cont.tokens_served
    wall_cont = _run_continuous(cont, main)
    fields = continuous_fields(cont, served0, tokens0)
    rps_cont = fields["n_requests"] / wall_cont
    tps_cont = fields["n_tokens"] / wall_cont
    print(f"  continuous slots={slots_cont:<3d} {fields['n_requests']} reqs  "
          f"{wall_cont:6.2f}s  {rps_cont:8.1f} req/s  "
          f"{tps_cont:8.1f} tok/s  "
          f"(x{rps_cont / rps_sync:.2f}, queue_p99="
          f"{fields['queue_depth_p99']})", flush=True)

    sync_snap = sync.telemetry_snapshot()["summary"]
    return [
        {
            "name": f"serve_sync_slots{sync.batch_slots}",
            "derived": (f"EdgeServingEngine.serve_slot host loop, "
                        f"{sync.batch_slots}-request chunks of one MMPP "
                        f"dyn_bursty trace ({served_sync} requests), "
                        "scheduling plane only"),
            "wall_s": round(wall_sync, 3),
            "requests_per_s": round(rps_sync, 1),
            "tokens_per_s": round(tps_sync, 1),
            "n_requests": served_sync,
            "n_tokens": tokens_sync,
            "deadline_hit_rate": sync_snap["deadline_hit_rate"],
            "latency_p50_s": sync_snap["latency_p50_s_exact"],
            "latency_p99_s": sync_snap["latency_p99_s_exact"],
        },
        {
            "name": f"serve_continuous_slots{slots_cont}",
            "derived": ("ContinuousServingEngine.run on the same trace: "
                        "deadline queue + pure sched_tick + one batched "
                        f"actor program over {slots_cont} slots, arrivals "
                        f"{GRID}x the decode grid (>=1k backlog in full "
                        "mode)"),
            "wall_s": round(wall_cont, 3),
            "requests_per_s": round(rps_cont, 1),
            "tokens_per_s": round(tps_cont, 1),
            **fields,
            "vs_sync_speedup": round(rps_cont / rps_sync, 2),
        },
    ]


# ------------------------------------------------------------- rows out
def merge_bench_rows(path: str, new_rows) -> None:
    """Refresh only the rows whose names ``new_rows`` re-measured, keeping
    every other row of the file; the re-measured rows also append to run
    history."""
    names = {r["name"] for r in new_rows}
    kept = []
    if os.path.exists(path):
        with open(path) as f:
            kept = [r for r in json.load(f) if r.get("name") not in names]
    with open(path, "w") as f:
        json.dump(kept + list(new_rows), f, indent=1)
    record_rows(new_rows)


# ------------------------------------------------------------------ run
def run(quick: bool = False, *, device=None, out: str = DEFAULT_OUT):
    """Build both engines and the traces, run the comparison, merge the
    rows into ``out`` and assert the reference's two claims."""
    dev = resolve_device(device)
    cfg = get_arch(ARCH, reduced=True)
    replicas = [Replica(n, s) for n, s in REPLICAS]
    shape = quick_shape(quick)
    sync, cont = _engines(cfg, replicas, slots_sync=SLOTS_SYNC,
                          slots_cont=shape["slots_cont"], seed=0,
                          device=dev)
    warm, main = traces(float(cont.env.cfg.slot_s), n_users=shape["n_users"],
                        n_requests=shape["n_requests"])
    assert len(main) == shape["n_requests"], \
        f"trace too short: {len(main)}"
    rows = stamp_rows(bench_rows(sync, cont, main, warm), dev)
    merge_bench_rows(out, rows)
    served_cont = rows[1]["n_requests"]
    rps_sync, rps_cont = rows[0]["requests_per_s"], rows[1]["requests_per_s"]
    assert served_cont == len(main), (
        f"continuous engine dropped requests: {served_cont}/{len(main)}")
    assert rps_cont > rps_sync, (
        f"continuous batching must beat the sync loop: "
        f"{rps_cont:.1f} <= {rps_sync:.1f} req/s")
    return rows


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch serve-bench",
        description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="rows merge into this JSON file")
    args = ap.parse_args(list(argv) if argv is not None else None)
    return run(args.quick, device=args.device, out=args.out)


if __name__ == "__main__":
    main()
