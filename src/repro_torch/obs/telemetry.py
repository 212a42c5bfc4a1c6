"""Device-resident telemetry: named counters + fixed-bucket histograms.

Counterpart of ``repro/obs/telemetry.py``, the whole module. ``Telemetry``
is a registry of named float32 scalar counters and fixed-bucket
histograms, carried by ``RolloutDriver(telemetry=True)`` beside its
``CellMetrics``, folded every slot by device ops that never wait on the
host (``torch.searchsorted`` and ``index_add``, never ``bincount``, which
reads its size on the host), and copied to the host once per episode
(``telemetry_host``).

The rules the reference pins hold here too:

* Static shape: every leaf's shape and dtype is fixed by the registry at
  init, so a carry with telemetry keeps one layout for the whole episode.
* Dtype-stable: counts and edges are float32; the weights are 0/1 masks,
  so histogram counts are exact whatever the order of the adds.
* Additive: counters are running sums, histogram updates weighted
  scatter-adds over any leading batch axes.

Units: histograms over task latency are in deadline units (t/deadline);
time counters are seconds summed over active tasks; ``replay_occ`` is a
fraction in [0, 1] summed per slot (divide by ``slots`` for the mean).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


# ---------------------------------------------------------------- histogram
class Histogram(NamedTuple):
    """Fixed-bucket histogram: K bins + explicit under/overflow.

    ``edges`` is [K+1] float32; ``counts`` is [K+2] float32 —
    ``counts[0]`` the underflow bin (value < edges[0]), ``counts[K+1]``
    the overflow bin (value >= edges[K], and NaN), ``counts[1 + i]`` the
    left-closed bin [edges[i], edges[i+1]).
    """
    edges: torch.Tensor   # [K+1] float32
    counts: torch.Tensor  # [K+2] float32 (underflow, K bins, overflow)


def hist_init(edges, *, device) -> Histogram:
    """An empty histogram over ``edges`` [K+1] on ``device``."""
    if not isinstance(edges, torch.Tensor):
        edges = np.asarray(edges, np.float32)
    edges = torch.as_tensor(edges, dtype=torch.float32, device=device)
    return Histogram(edges=edges,
                     counts=torch.zeros((edges.shape[0] + 1,),
                                        dtype=torch.float32,
                                        device=edges.device))


def hist_add(h: Histogram, values: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> Histogram:
    """Fold ``values`` (any shape) into the histogram, on the device.

    ``weights`` (same shape, default 1.0) scale each value's contribution;
    pass the ``active`` mask to drop inactive tasks. NaN values index the
    overflow bin, as in the reference; give them weight 0 if they should
    not count.
    """
    v = values.reshape(-1).to(torch.float32)
    w = (torch.ones_like(v) if weights is None
         else weights.reshape(-1).to(torch.float32))
    # right=True: v == edges[i] -> index i+1 -> the bin [edges[i], ...);
    # NaN is never below an edge, so the search passes every edge and
    # returns K+1, the overflow bin (tests hold it on the CPU and the card)
    idx = torch.searchsorted(h.edges, v, right=True)
    return h._replace(counts=h.counts.index_add(0, idx, w))


def hist_to_host(h: Histogram) -> dict:
    """One histogram (or a [C]-stacked one) as JSON-ready lists."""
    return {"edges": h.edges.detach().cpu().numpy().tolist(),
            "counts": h.counts.detach().cpu().numpy().tolist()}


def hist_quantile(edges, counts, q: float) -> float:
    """Quantile estimate from bucket counts (host-side, numpy).

    Linear interpolation inside the winning bucket; underflow mass sits at
    ``edges[0]`` and overflow at ``edges[-1]`` (q inside those bins
    returns the boundary edge). NaN on an empty histogram.
    """
    edges = np.asarray(edges, np.float64)
    counts = np.asarray(counts, np.float64)
    total = counts.sum()
    if total <= 0:
        return float("nan")
    cum = np.cumsum(counts)
    target = q * total
    b = int(np.searchsorted(cum, target, side="left"))
    b = min(b, len(counts) - 1)
    if b == 0:                       # inside the underflow bin
        return float(edges[0])
    if b == len(counts) - 1:         # inside the overflow bin
        return float(edges[-1])
    lo, hi = edges[b - 1], edges[b]
    prev = cum[b - 1] if b > 0 else 0.0
    frac = (target - prev) / max(counts[b], 1e-12)
    return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))


# ----------------------------------------------------------------- registry
class Telemetry(NamedTuple):
    """The registry: ``counters`` maps name -> float32 scalar running sum,
    ``hists`` name -> ``Histogram``; both key sets are fixed at init.
    ``loss_ema`` is an exponential moving average of the train loss (NaN
    until the first train step)."""
    counters: dict
    hists: dict
    loss_ema: torch.Tensor   # float32 scalar


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def telemetry_init(counter_names, hist_edges, *, device) -> Telemetry:
    """Fresh registry on ``device``: zero counters + empty histograms.
    ``hist_edges`` maps name -> bucket edge array."""
    return Telemetry(
        counters={n: _zero(device) for n in counter_names},
        hists={n: hist_init(e, device=device) for n, e in hist_edges.items()},
        loss_ema=torch.full((), torch.nan, dtype=torch.float32,
                            device=device),
    )


# How many latency/margin buckets the standard rollout registry uses.
LATENCY_BINS = 16
# EMA smoothing for the per-train-step loss (≈ 20-step horizon).
LOSS_EMA_BETA = 0.9

ROLLOUT_COUNTERS = (
    "slots",            # slots accumulated
    "tasks",            # active tasks seen
    "success",          # tasks finished within deadline (Eq 11)
    "t_com_s",          # Σ communication time over active tasks (Eq 1)
    "t_wait_s",         # Σ FCFS queueing wait over active tasks (Eq 7)
    "t_cmp_s",          # Σ inference compute time over active tasks (Eq 4)
    "acc_potential",    # Σ φ(exit) over active tasks (accuracy term, Eq 5)
    "psi_sum",          # Σ ψ(t/deadline) over active tasks (timeliness)
    "reward",           # Σ φ·ψ over active tasks (realized Eq-9 utility)
    "replay_occ",       # Σ per-slot replay-ring occupancy fraction
    "train_steps",      # train steps taken
)


def rollout_telemetry(n_servers: int, n_exits: int, *,
                      device) -> Telemetry:
    """The standard registry ``RolloutDriver(telemetry=True)`` carries.

    Histograms (fixed buckets, dimensionless):
      exit       — decision counts per exit depth l ∈ [0, L)
      server     — decision counts per edge server n ∈ [0, N)
      latency    — t_total/deadline over active tasks, 16 bins on [0, 2]
                   (overflow = misses by >2x or an unreachable link)
      margin     — (deadline - t_total)/deadline, 16 bins on [-1, 1]
                   (underflow = missed by >2x or an unreachable link)
      replay_occ — ring occupancy fraction, 8 bins on [0, 1]
    """
    edges = {
        "exit": np.arange(n_exits + 1, dtype=np.float32) - 0.5,
        "server": np.arange(n_servers + 1, dtype=np.float32) - 0.5,
        "latency": np.linspace(0.0, 2.0, LATENCY_BINS + 1),
        "margin": np.linspace(-1.0, 1.0, LATENCY_BINS + 1),
        "replay_occ": np.linspace(0.0, 1.0, 9),
    }
    return telemetry_init(ROLLOUT_COUNTERS, edges, device=device)


def telemetry_update(tel: Telemetry, *, decisions: torch.Tensor, result,
                     active: torch.Tensor, deadline_s,
                     replay_frac: torch.Tensor, loss: torch.Tensor,
                     n_exits: int) -> Telemetry:
    """Fold one slot's batched outputs into the registry.

    ``decisions``, ``result``'s leaves and ``active`` carry any leading
    batch axes over the device axis [M]; everything is pooled.
    ``deadline_s`` is a scalar or [B] and broadcasts; ``replay_frac`` is
    the learner's ring occupancy in [0, 1]; ``loss`` this slot's train
    loss (NaN when no train step ran).
    """
    f32 = torch.float32
    act = active.to(f32)
    actb = act > 0.5
    t_total = result.t_total.to(f32)
    dl = torch.as_tensor(deadline_s, dtype=f32, device=t_total.device)
    dl = dl.reshape(dl.shape + (1,) * (t_total.dim() - dl.dim()))
    lat = t_total * (1.0 / dl)                       # deadline units
    # ψ(t) = 1 - sigmoid(5 t/deadline): the Eq-9 soft-deadline term,
    # recomputed here so reward = Σ φ·ψ decomposes visibly
    psi = 1.0 - torch.sigmoid(5.0 * lat)
    psi = torch.where(torch.isinf(t_total), 0.0, psi)
    phi = result.accuracy.to(f32)
    suc = (result.success & actb).to(f32)
    exit_idx = (decisions % n_exits).to(f32)
    srv_idx = (decisions // n_exits).to(f32)
    # inf latencies (dead links) are misses, not time: the seconds
    # counters fold only reachable tasks
    reach = actb & torch.isfinite(t_total)

    def seconds(x):
        return torch.where(reach, x.to(f32), 0.0).sum()

    c = dict(tel.counters)
    c["slots"] = c["slots"] + 1.0
    c["tasks"] = c["tasks"] + act.sum()
    c["success"] = c["success"] + suc.sum()
    c["t_com_s"] = c["t_com_s"] + seconds(result.t_com)
    c["t_wait_s"] = c["t_wait_s"] + seconds(result.t_wait)
    c["t_cmp_s"] = c["t_cmp_s"] + seconds(result.t_cmp)
    c["acc_potential"] = c["acc_potential"] + (phi * act).sum()
    c["psi_sum"] = c["psi_sum"] + (psi * act).sum()
    c["reward"] = c["reward"] + (phi * psi * act).sum()
    c["replay_occ"] = c["replay_occ"] + replay_frac.to(f32)
    trained = ~torch.isnan(loss)
    c["train_steps"] = c["train_steps"] + trained.to(f32)

    h = dict(tel.hists)
    h["exit"] = hist_add(h["exit"], exit_idx, act)
    h["server"] = hist_add(h["server"], srv_idx, act)
    h["latency"] = hist_add(h["latency"], lat, act)
    h["margin"] = hist_add(h["margin"], 1.0 - lat, act)
    h["replay_occ"] = hist_add(h["replay_occ"], replay_frac.to(f32))

    loss32 = loss.to(f32)
    ema = torch.where(torch.isnan(tel.loss_ema), loss32,
                      LOSS_EMA_BETA * tel.loss_ema
                      + (1.0 - LOSS_EMA_BETA) * loss32)
    ema = torch.where(trained, ema, tel.loss_ema)
    return Telemetry(counters=c, hists=h, loss_ema=ema)


def _f32_like(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


# ------------------------------------------------------- serving registry
# Request-lifecycle counters the continuous-batching serve engine adds on
# top of the rollout registry: admitted == served + expired + in-flight.
SERVE_COUNTERS = (
    "admitted",        # requests accepted into the serving queue
    "served",          # requests that completed service
    "expired",         # requests dropped past-deadline before service
)

# Geometric queue-depth bucket edges: depth 0, 1, 2, 4, ... 4096.
QUEUE_DEPTH_EDGES = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                     256.0, 512.0, 1024.0, 2048.0, 4096.0)


def serve_telemetry(n_servers: int, n_exits: int, *,
                    device) -> Telemetry:
    """The rollout registry plus the ``SERVE_COUNTERS`` and a
    ``queue_depth`` histogram (pending-queue depth once per decode step,
    geometric buckets); ``serve_telemetry_update`` folds the extra keys."""
    base = rollout_telemetry(n_servers, n_exits, device=device)
    counters = dict(base.counters)
    counters.update({n: _zero(device) for n in SERVE_COUNTERS})
    hists = dict(base.hists)
    hists["queue_depth"] = hist_init(QUEUE_DEPTH_EDGES, device=device)
    return Telemetry(counters=counters, hists=hists,
                     loss_ema=base.loss_ema)


def serve_telemetry_update(tel: Telemetry, admitted, served, expired,
                           queue_depth) -> Telemetry:
    """Fold one decode step's request-lifecycle events: this step's event
    counts (ints or scalars) and the pending-queue depth after admission."""
    c = dict(tel.counters)
    ref = c["admitted"]
    c["admitted"] = c["admitted"] + _f32_like(admitted, ref)
    c["served"] = c["served"] + _f32_like(served, ref)
    c["expired"] = c["expired"] + _f32_like(expired, ref)
    h = dict(tel.hists)
    h["queue_depth"] = hist_add(h["queue_depth"],
                                _f32_like(queue_depth, ref).reshape(1))
    return Telemetry(counters=c, hists=h, loss_ema=tel.loss_ema)


# ---------------------------------------------------- population registry
POP_COUNTERS = (
    "generations",     # training generations completed
    "pbt_rounds",      # exploit/explore steps taken
    "exploits",        # members replaced by truncation selection
    "resamples",       # curriculum scenario draws taken (member-episodes)
)


def pop_telemetry(n_members: int, n_regions: int, *,
                  device) -> Telemetry:
    """A standalone registry for the population trainer; histograms with
    one bucket per integer value: ``member_rank`` (pre-surgery rank of each
    PBT copy's source, 0 = best) and ``region`` (curriculum-region
    visits)."""
    edges = {
        "member_rank": np.arange(n_members + 1, dtype=np.float32) - 0.5,
        "region": np.arange(n_regions + 1, dtype=np.float32) - 0.5,
    }
    return telemetry_init(POP_COUNTERS, edges, device=device)


def pop_telemetry_update(tel: Telemetry, *, region, src_ranks=None,
                         copied=None) -> Telemetry:
    """Fold one generation: ``region`` the [P] curriculum draws;
    ``src_ranks``/``copied`` the PBT round's source ranks and
    replaced-member mask, None on generations without one."""
    c = dict(tel.counters)
    ref = c["generations"]
    region = _f32_like(region, ref)
    c["generations"] = c["generations"] + 1.0
    c["resamples"] = c["resamples"] + float(region.shape[0])
    h = dict(tel.hists)
    h["region"] = hist_add(h["region"], region)
    if copied is not None:
        copied = _f32_like(copied, ref)
        c["pbt_rounds"] = c["pbt_rounds"] + 1.0
        c["exploits"] = c["exploits"] + copied.sum()
        h["member_rank"] = hist_add(
            h["member_rank"], _f32_like(src_ranks, ref), copied)
    return Telemetry(counters=c, hists=h, loss_ema=tel.loss_ema)


# ------------------------------------------------------------- host views
def telemetry_host(tel: Telemetry, index: Optional[int] = None) -> dict:
    """One device->host copy of the whole registry, JSON-ready.

    ``index`` slices a [C]-stacked registry down to one cell.
    """
    leaves = [*tel.counters.values(),
              *(x for h in tel.hists.values() for x in (h.edges, h.counts)),
              tel.loss_ema]
    if index is not None:
        leaves = [x[index] for x in leaves]
    sizes = [x.numel() for x in leaves]
    flat = torch.cat([x.detach().reshape(-1).to(torch.float32)
                      for x in leaves]).cpu().numpy()
    parts = iter(np.split(flat, np.cumsum(sizes)[:-1]))
    counters = {k: float(next(parts)[0]) for k in tel.counters}
    hists = {}
    for k in tel.hists:
        edges, counts = next(parts), next(parts)
        hists[k] = {"edges": edges.tolist(), "counts": counts.tolist()}
    return {"counters": counters, "hists": hists,
            "loss_ema": float(next(parts)[0])}


def telemetry_summary(host: dict) -> dict:
    """Derived headline numbers from a host-side registry dict.

    Fractions are in [0, 1]; latency quantiles in deadline units;
    ``*_share`` entries decompose Σ(t_com + t_wait + t_cmp);
    ``exit_share``/``server_share`` are decision distributions. Empty
    histograms report ``None`` quantiles (never NaN) and every ratio's
    denominator is floored, so an idle snapshot is strict-JSON safe.
    """
    c, hists = host["counters"], host["hists"]
    tasks = max(c["tasks"], 1.0)
    slots = max(c["slots"], 1.0)
    t_sum = max(c["t_com_s"] + c["t_wait_s"] + c["t_cmp_s"], 1e-12)

    def q(name, p):
        h = hists[name]
        v = hist_quantile(h["edges"], h["counts"], p)
        return v if np.isfinite(v) else None

    def share(name):
        counts = np.asarray(hists[name]["counts"][1:-1], np.float64)
        return (counts / max(counts.sum(), 1.0)).round(6).tolist()

    return {
        "tasks": c["tasks"],
        "deadline_hit_rate": c["success"] / tasks,
        "avg_reward_per_task": c["reward"] / tasks,
        "accuracy_potential_per_task": c["acc_potential"] / tasks,
        "timeliness_per_task": c["psi_sum"] / tasks,
        "comm_share": c["t_com_s"] / t_sum,
        "wait_share": c["t_wait_s"] / t_sum,
        "compute_share": c["t_cmp_s"] / t_sum,
        "latency_p50": q("latency", 0.5),
        "latency_p99": q("latency", 0.99),
        "margin_p50": q("margin", 0.5),
        "exit_share": share("exit"),
        "server_share": share("server"),
        "replay_occ_mean": c["replay_occ"] / slots,
        "train_steps": c["train_steps"],
        "loss_ema": (None if not np.isfinite(host["loss_ema"])
                     else host["loss_ema"]),
    }
