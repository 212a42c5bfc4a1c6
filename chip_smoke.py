"""Drive repro_torch's GRLE decision path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA; it needs no JAX and no network. Phases, in
order, each fatal on failure:

1. the card's name and power limit (nvidia-smi); TF32 off for matmuls
   and convolutions, so the plain versions run in full float32;
2. build every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together) and print the build time;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and inputs for B in {1, 64}: max abs error <= 1e-5;
   time both (CUDA-graph replay, so host launch overhead is excluded);
4. golden replay: ``tests/data/torch_port_golden.npz`` (a JAX run with
   its draws) through the port's driver on the card — every decision
   matches, or differs only at a recorded near-tie (margin <= 1e-5);
5. the main path: GRLE on fig5_baseline at full width (M=14, N=2, L=5,
   hidden (128, 64), edge 64, 143 candidates), 64 fleets, 200 slots on
   the port's own generator, random weights from seed 0; the launch
   counts must read exactly 4 per slot for gcn_agg and 1 for edge_score;
6. one ``{"kernels": [...]}`` line, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no GPU is available.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden.npz")
TOL = 1e-5            # max abs error, kernel vs plain, float32
NEAR_TIE = 1e-5       # golden: a flipped decision must sit at such a margin
N_FLEETS, N_SLOTS, SEED = 64, 200, 0
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor-core
# float32 FLOP/s — the kernels are plain float32 FMA code
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
TASK_FIELDS = ("size_bits", "deadline_s", "rate_true", "rate_est", "capacity",
               "cmp_true", "cmp_est", "connect", "active")


def phase(n, title):
    print(f"\n== phase {n}: {title}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


# ----------------------------------------------------------------- timing
def graph_ms(fn, *, inner=20, reps=10) -> float:
    """Device time of one ``fn()`` call: ``inner`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * inner)


def eager_ms(fn, *, n=200) -> float:
    """Wall time of one eager ``fn()`` call, host launch path included."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def numel(*ts) -> int:
    return sum(t.numel() for t in ts)


def gcn_agg_cost(adj, hs, hn, ws, wn, b):
    """(bytes, flops) the function needs: each input read once, the output
    written once; adj@hn, deg, the divide, both products, bias, relu."""
    bsz, m, o = adj.shape
    fs, fn, h = hs.shape[-1], hn.shape[-1], ws.shape[-1]
    out = bsz * m * h
    nbytes = 4 * (numel(adj, hs, hn, ws, wn, b) + out)
    flops = bsz * m * (2 * o * fn + o + fn) + out * (2 * fs + 2 * fn + 3)
    return nbytes, flops


def edge_score_cost(hs, hd, ef, ws, bs, wd, wf, wo, bo):
    bsz, m, o = ef.shape
    h, e = ws.shape
    nbytes = 4 * (numel(hs, hd, ef, ws, bs, wd, wf, wo, bo) + bsz * m * o)
    flops = (bsz * m * e * (2 * h + 1) + bsz * o * e * 2 * h
             + bsz * m * o * (6 * e + 1))
    return nbytes, flops


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phases
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from repro_torch.core import agent_def, agent_state_from_numpy, gcn
    from repro_torch.core.graph import build_graph
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import edge_score as edge_mod
    from repro_torch.kernels import gcn_agg as gcn_mod
    from repro_torch.mec import MECEnv, SlotTasks, make_scenario
    from repro_torch.rollout import RolloutDriver, SlotDraws

    dev = torch.device("cuda")

    phase(1, "card")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    phase(2, "build")
    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"built {sorted(report)} in {time.perf_counter() - t0:.2f} s "
          f"(already present: {sorted(set(_build.KERNELS) - set(report))})")
    for name, log in report.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    phase(3, "kernels vs plain versions on the card")
    env = MECEnv(make_scenario("fig5_baseline"), device=dev)
    adef = agent_def("grle", env, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = adef.init(gen).params
    stats = {"gcn_agg": {}, "edge_score": {}}
    for b in (1, N_FLEETS):
        tasks = env.sample_slot(gen, (b,))
        g = build_graph(env.observe(env.reset((b,)), tasks), env.N, env.L)
        adj, adj_t = g.adj, g.adj.transpose(-1, -2)
        split = gcn._split
        l1d = (adj, g.device_feat, g.option_feat, *split(params["dev1"], 7))
        l1o = (adj_t, g.option_feat, g.device_feat, *split(params["opt1"], 4))
        h_dev, h_opt = ref.gcn_agg_ref(*l1d), ref.gcn_agg_ref(*l1o)
        l2d = (adj, h_dev, h_opt, *split(params["dev2"], 128))
        l2o = (adj_t, h_opt, h_dev, *split(params["opt2"], 128))
        h_dev2, h_opt2 = ref.gcn_agg_ref(*l2d), ref.gcn_agg_ref(*l2o)
        e_args = (h_dev2, h_opt2, adj, params["edge_src"]["w"],
                  params["edge_src"]["b"], params["edge_dst"]["w"],
                  params["edge_feat"]["w"][0], params["edge_out"]["w"][:, 0],
                  params["edge_out"]["b"])
        cases = [("gcn_agg", name, args, gcn_mod.gcn_agg, ref.gcn_agg_ref,
                  gcn_agg_cost(*args))
                 for name, args in (("layer1/device", l1d),
                                    ("layer1/option", l1o),
                                    ("layer2/device", l2d),
                                    ("layer2/option", l2o))]
        cases.append(("edge_score", "edge", e_args, edge_mod.edge_score,
                      ref.edge_score_ref, edge_score_cost(*e_args)))
        for kernel, name, args, fn, plain, cost in cases:
            got = fn(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ms = graph_ms(lambda: fn(*args))
            plain_ms = graph_ms(lambda: plain(*args))
            call_ms = eager_ms(lambda: fn(*args))
            b_ms, b_by = bound(*cost)
            print(f"  {kernel:10s} {name:14s} B={b:3d} shape "
                  f"{tuple(args[0].shape)}x{tuple(args[1].shape[-1:])}"
                  f"->{tuple(got.shape)}  max_abs_err {err:.3e}  kernel "
                  f"{ms * 1e3:8.2f} us  plain {plain_ms * 1e3:8.2f} us  "
                  f"eager call {call_ms * 1e3:8.2f} us  bound "
                  f"{b_ms * 1e3:6.3f} us ({b_by})", flush=True)
            if not err <= TOL:
                raise SystemExit(f"{kernel} {name} B={b}: max abs error "
                                 f"{err} above {TOL}")
            s = stats[kernel].setdefault(b, dict(err=0.0, ms=0.0, plain=0.0,
                                                 bytes=0, flops=0))
            s["err"] = max(s["err"], err)
            s["ms"] += ms
            s["plain"] += plain_ms
            s["bytes"] += cost[0]
            s["flops"] += cost[1]

    phase(4, "golden replay of a JAX run")
    with np.load(GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    tree = {}
    for k in [k for k in gold if k.startswith("params/")]:
        _, layer, leaf = k.split("/")
        tree.setdefault(layer, {})[leaf] = gold[k]
    g_env = MECEnv(make_scenario(str(gold["scenario"])), device=dev)
    g_def = agent_def("grle", g_env, device=dev)
    st = agent_state_from_numpy(tree, gold["exit_mask"], dev)
    t_gold, b_gold = gold["rand_cands"].shape[:2]
    draws = SlotDraws(
        SlotTasks(*(torch.tensor(gold[f"tasks/{f}"], device=dev)
                    for f in TASK_FIELDS)),
        torch.tensor(gold["rand_cands"].astype(np.int64), device=dev))
    _, trace = RolloutDriver(g_def, b_gold, device=dev).run(
        SEED, t_gold, agent_state=st, draws=draws)
    dec = trace.decisions.cpu().numpy()
    same = (dec == gold["trace/decisions"]).all(-1)
    dq = np.abs(trace.q_est.cpu().numpy() - gold["trace/q_est"])
    print(f"decisions matching: {int(same.sum())}/{same.size} slot-fleets; "
          f"max |dq| {float(dq.max()):.3e}; "
          f"max |dreward| {float(np.abs(trace.reward.cpu().numpy() - gold['trace/reward']).max()):.3e}")
    for t, b in np.argwhere(~same):
        margin = min(gold["q_margin"][t, b], gold["xhat_margin"][t, b])
        print(f"  slot {t} fleet {b}: q margin {gold['q_margin'][t, b]:.3e}, "
              f"x_hat margin {gold['xhat_margin'][t, b]:.3e}")
        if margin > NEAR_TIE:
            raise SystemExit(f"golden: decision differs at slot {t} fleet {b}"
                             f", not at a near-tie")
    if not (dq[same] <= 1e-5 * np.abs(gold["trace/q_est"][same])).all():
        raise SystemExit("golden: q_est differs by more than 1e-5 relative")

    phase(5, "main path: GRLE fig5_baseline, full width")
    drv = RolloutDriver(adef, N_FLEETS, device=dev)
    drv.run(SEED + 1, 5)                        # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    carry, trace = drv.run(SEED, N_SLOTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    m = drv.metrics(carry)
    print(f"M={env.M} N={env.N} L={env.L} hidden={adef.hidden} "
          f"candidates={adef.n_candidates}+{adef.n_random} B={N_FLEETS} "
          f"T={N_SLOTS}")
    print(f"ssp {m['ssp']:.6f}  avg_accuracy {m['avg_accuracy']:.6f}  "
          f"avg_reward {m['avg_reward']:.6f}  tasks {int(m['tasks'])}")
    print(f"wall {wall:.4f} s  fleet-slots/s {N_FLEETS * N_SLOTS / wall:.1f}  "
          f"slot {wall / N_SLOTS * 1e3:.3f} ms")
    print(f"launches {counts}")
    if counts != {"gcn_agg": 4 * N_SLOTS, "edge_score": N_SLOTS}:
        raise SystemExit(f"launch counts {counts}, expected gcn_agg "
                         f"{4 * N_SLOTS} and edge_score {N_SLOTS}")
    dec = trace.decisions
    if (tuple(dec.shape) != (N_SLOTS, N_FLEETS, env.M)
            or dec.dtype != torch.int32 or int(dec.min()) < 0
            or int(dec.max()) >= env.N * env.L
            or not bool(torch.isfinite(trace.reward).all())
            or not 0.0 < m["ssp"] <= 1.0
            or not 0.0 < m["avg_accuracy"] <= float(env.exit_acc.max())):
        raise SystemExit("main path output malformed")

    phase(6, "summary")
    sources = {"gcn_agg": ("src/repro_torch/csrc/gcn_agg.cu",
                           "src/repro/kernels/gcn_agg.py:40"),
               "edge_score": ("src/repro_torch/csrc/edge_score.cu",
                              "src/repro/kernels/edge_score.py:45")}
    kernels = []
    for name, (source, replaces) in sources.items():
        s = stats[name][N_FLEETS]
        b_ms, b_by = bound(s["bytes"], s["flops"])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(v["err"] for v in stats[name].values()),
            "ms": s["ms"], "plain_ms": s["plain"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None})
    print("times are per slot at B=64: the sum over one actor forward's "
          "launches (gcn_agg: 4, edge_score: 1)")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
