"""Edge-serving engines: GRLE scheduling multi-exit LM inference.

Counterpart of ``repro/serve/engine.py``. "Edge servers" are model
replicas with heterogeneous speed; tasks are generation requests with
deadlines; the GRLE agent picks (replica, exit depth) per request batch
and trains online as it serves; decoding runs the per-exit
``serve_step`` variants (the exit choice truncates the layer schedule).

Two engines share one world model (``_ServingCore``: the MEC simulator
with an analytic per-exit latency table in place of Table I, the
workload generator, the scheduler agent, telemetry):

* ``EdgeServingEngine`` — the synchronous slot loop: the caller hands
  ``serve_slot`` up to ``batch_slots`` requests (or lets the arrival
  process draw them) and everything completes within the call.
* ``ContinuousServingEngine`` — the async, continuously-batched path:
  requests enter a deadline-aware queue (``serve.queue``), a **pure**
  scheduler core (``sched_tick``/``sched_evict``/``batch_release``, a
  function of queue state, batch state and an explicit clock) admits
  and evicts per decode step, and one batched GRLE actor pass prices the
  whole batch. Driven by a ``serve.clock`` clock: a ``VirtualClock``
  makes the loop deterministic under test; a ``WallClock`` serves live.

Both engines run on the card unless ``device="cpu"``. On the card the
agent's actor runs the hand-written ``gcn_agg``/``edge_score`` kernels
(4 + 1 launches a decision, 4 + 1 more a train step) and decoding runs
``decode_attention`` once per layer and position. Every random draw
comes from the engine's one ``torch.Generator`` (seeded with ``seed``):
the workload's, the agent's initial params, its exploration candidates
and its replay minibatches, so two engines built from one seed consume
it identically. ``inject_draws`` replaces the slot's tasks, the
exploration candidates and a train step's replay rows with given values
(the tests feed the reference's). The LM's random params come from a
generator of their own, so ``init_model`` does not move that stream.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.policy import AgentState, agent_def
from repro_torch.device import resolve_device
from repro_torch.mec.config import MECConfig, ScenarioParams
from repro_torch.mec.env import MECEnv, SlotTasks
from repro_torch.mec.metrics import RunningMetrics
from repro_torch.mec.profiles import llm_exit_profile
from repro_torch.mec.scenarios import SCENARIOS
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import model_for
from repro_torch.obs.telemetry import (hist_quantile, rollout_telemetry,
                                       serve_telemetry,
                                       serve_telemetry_update,
                                       telemetry_host, telemetry_summary,
                                       telemetry_update)
from repro_torch.rollout.workloads import make_workload
from repro_torch.serve.clock import VirtualClock
from repro_torch.serve.queue import (QueueEntry, QueueState, ServeRequest,
                                     queue_depth, queue_expire, queue_init,
                                     queue_pop, queue_push, queue_requeue)
from repro_torch.train.steps import make_serve_step


@dataclasses.dataclass
class Request:
    tokens: np.ndarray          # prompt token ids
    deadline_s: float
    max_new: int = 8


@dataclasses.dataclass
class Replica:
    """One model replica ('edge server'). speed < 1 models a slower card."""
    name: str
    speed: float = 1.0


class ServeDraws(NamedTuple):
    """One scheduling step's injected draws; a None field is drawn from
    the engine's generator."""
    tasks: Optional[SlotTasks] = None       # the slot's world, leaves [M, ...]
    rand_cands: Optional[torch.Tensor] = None  # [K, M] exploration candidates
    take: Optional[torch.Tensor] = None     # [batch_size] replay rows, read
    #                                         only on a train step


def _tree_items(tree, path=""):
    """(path, leaf) over a state's NamedTuples and dicts, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_items(v, f"{path}/{k}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _tree_items(v, f"{path}/{k}")
    else:
        yield path, tree


# ===================================================================== core
class _ServingCore:
    """World model + scheduler agent shared by both serving engines.

    Owns everything except the serving *loop*: the MEC simulator with
    the LM exit-profile latency table, the arrival-process generator,
    the GRLE agent (hot-swappable via ``get/set_agent_state``), scenario
    hot-swap (``set_scenario_params``), telemetry and the exact latency
    ring. Both engines consume the generator identically, so a sync and
    an async engine built from the same seed share agent parameters and
    workload streams: the decision-equivalence tests rely on this.
    """

    def __init__(self, cfg: ArchConfig, replicas: list[Replica], *,
                 cache_len: int = 256, scheduler: Optional[str] = "grle",
                 batch_slots: int = 4, seed: int = 0,
                 workload: Optional[str] = None,
                 arrival_rate: Optional[float] = None,
                 scenario: Optional[str] = None,
                 latency_ring: int = 512,
                 agent_kw: Optional[dict] = None,
                 profile_kw: Optional[dict] = None,
                 init_model: bool = True,
                 device=None):
        """``scenario`` names a ``SCENARIOS`` entry whose dynamic knobs
        (capacity range, jitter, CSI error, workload process, ...) overlay
        the engine's MEC world model; exit tables and shape stay the
        engine's own, and explicitly passed ``workload=``/``arrival_rate=``
        win over the scenario's. Numeric knobs can be hot-swapped later
        via ``set_scenario_params``. Defaults without a scenario:
        ``workload="iid"``, ``arrival_rate=0.7``. ``latency_ring`` bounds
        the exact last-K request latency window. ``agent_kw`` forwards
        extra ``AgentDef`` knobs; ``profile_kw`` forwards to
        ``llm_exit_profile`` (e.g. another replica's ``peak_flops`` and
        ``hbm_bw``; default: the H100's). ``init_model=False`` skips the
        LM params for scheduling-plane-only use (the exit table needs
        only the architecture shape).
        """
        self.device = resolve_device(device)
        dev = self.device
        self.generator = torch.Generator(device=dev).manual_seed(int(seed))
        self.cfg = cfg
        self.model = model_for(cfg) if init_model else None
        self.params = (self.model.init(
            torch.Generator(device=dev).manual_seed(int(seed)), cfg,
            device=dev) if init_model else None)
        self.replicas = replicas
        self.cache_len = cache_len
        self.batch_slots = batch_slots

        # per-exit latency/quality profile (the Table-I analogue)
        times, quality = llm_exit_profile(
            cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab, cfg.exit_layers,
            kv_len=cache_len, **(profile_kw or {}))
        times = np.concatenate(
            [times / r.speed for r in replicas], axis=0)       # [N, L]
        self.exit_times = times
        self.exit_quality = quality

        # deadline must cover uplink time (≈ 0.3–6.4 ms at 4–16 KB prompts
        # over 20–100 Mbps) plus a few compute slots — same regime as the
        # paper's 30 ms budget.
        deadline = max(20e-3, float(times.max()) * 6)
        mec_kwargs = dict(
            task_kbytes=(4.0, 16.0), rate_mbps=(20.0, 100.0),
            capacity_range=(0.5, 1.0),
        )
        if scenario is not None:
            # scenario dynamics overlay the defaults; structural fields
            # stay the engine's (its exit tables ARE the Table-I analogue)
            overlay = dict(SCENARIOS[scenario])
            for k in ("n_devices", "n_servers", "exit_times_s",
                      "exit_accuracy", "slot_s", "deadline_s"):
                overlay.pop(k, None)
            mec_kwargs.update(overlay)
        # explicit constructor args beat the scenario's arrival process
        if workload is not None:
            mec_kwargs["workload"] = workload
        if arrival_rate is not None:
            mec_kwargs["arrival_rate"] = arrival_rate
        mec_kwargs.setdefault("workload", "iid")
        mec_kwargs.setdefault("arrival_rate", 0.7)
        mec_cfg = MECConfig(
            n_devices=batch_slots, n_servers=len(replicas),
            exit_times_s=tuple(map(tuple, times.tolist())),
            exit_accuracy=tuple(quality.tolist()),
            slot_s=deadline / 2, deadline_s=deadline,
            **mec_kwargs,
        )
        self.env = MECEnv(mec_cfg, device=dev)
        # live scenario knobs: None -> the config's own
        self._sp: Optional[ScenarioParams] = None
        self.mec_state = self.env.reset()
        # arrival process: with workload != "iid" the generator's ``active``
        # mask decides which batch slots carry a request each slot
        self._workload = make_workload(self.env)
        self._wl_state = self._workload.init(self.generator)
        self._req_rng = np.random.default_rng(seed)
        self.agent_def = (agent_def(scheduler, self.env, device=dev,
                                    **(agent_kw or {}))
                          if scheduler else None)
        self.agent_state = (self.agent_def.init(self.generator)
                            if self.agent_def is not None else None)
        self._draws = None
        self.metrics = RunningMetrics(slot_s=mec_cfg.slot_s)
        # device-resident request telemetry, pulled to the host only by
        # telemetry_snapshot, + host transfer counters
        self.telemetry = self._make_telemetry()
        # exact last-K request latencies (seconds, finished requests
        # only) next to the bucketed histogram
        self._latency_ring: collections.deque = collections.deque(
            maxlen=latency_ring)
        # generated-token accounting: each served request contributes its
        # ``max_new`` budget
        self.tokens_served = 0
        self.transfers = {"decode_h2d": 0, "decode_d2h": 0,
                          "telemetry_pulls": 0}
        self._no_loss = torch.full((), torch.nan, device=dev)
        L = self.env.L
        self._static_decision = torch.tensor(
            [(i % self.env.N) * L + (L - 1) for i in range(batch_slots)],
            dtype=torch.int32, device=dev)

    def _make_telemetry(self):
        return rollout_telemetry(self.env.N, self.env.L, device=self.device)

    # --------------------------------------------------------- draw seam
    def inject_draws(self, draws: Optional[Iterable[ServeDraws]]) -> None:
        """Take each coming scheduling step's draws from ``draws`` (one
        ``ServeDraws`` a step, in order); None returns to the engine's
        generator. Running past the end raises."""
        self._draws = None if draws is None else iter(draws)

    def _next_draws(self) -> ServeDraws:
        if self._draws is None:
            return ServeDraws()
        try:
            return next(self._draws)
        except StopIteration:
            raise RuntimeError("the injected draws are exhausted") from None

    # ---------------------------------------------------------- shared step
    def _price_slot(self, active: Optional[np.ndarray]):
        """One scheduling step over the current batch occupancy mask.

        Draws the slot's world from the arrival generator, overlays
        ``active`` (the real request occupancy), and runs the agent (or
        the static fallback). Returns (tasks, decision [M] np, result)
        after stepping the env and telemetry. The sync and async engines
        differ only in who computes ``active``.
        """
        dev = self.device
        draws = self._next_draws()
        tasks = draws.tasks
        if tasks is None:
            self._wl_state, tasks = self._workload.sample(
                self._wl_state, self.generator, self._sp)
        else:
            tasks = SlotTasks(*(torch.as_tensor(x, device=dev)
                                for x in tasks))
        if active is not None:
            tasks = tasks._replace(active=torch.as_tensor(
                active, dtype=torch.float32, device=dev))
        if self.agent_def is not None:
            self.agent_state, decision, aux = self.agent_def.step(
                self.agent_state, self.mec_state, tasks,
                generator=self.generator,
                rand_cands=(None if draws.rand_cands is None
                            else draws.rand_cands.to(dev)),
                take=draws.take, sp=self._sp)
            loss = aux.loss
            replay_frac = (self.agent_state.replay.size.to(torch.float32)
                           / float(self.agent_def.buffer_size))
        else:  # static: final exit, round-robin replica
            decision = self._static_decision
            loss = self._no_loss
            replay_frac = torch.zeros((), device=dev)
        self.mec_state, result = self.env.step(self.mec_state, tasks,
                                               decision, self._sp)
        self.metrics.update(result, tasks.active)
        deadline = self.env._sp(self._sp).deadline_s
        self.telemetry = telemetry_update(
            self.telemetry, decisions=decision, result=result,
            active=tasks.active, deadline_s=deadline,
            replay_frac=replay_frac, loss=loss, n_exits=self.env.L)
        return tasks, decision.cpu().numpy(), result

    def _assignment(self, decision: np.ndarray, slot: int):
        """Decode one slot's decision into (replica name, exit layer)."""
        n, l = divmod(int(decision[slot]), self.env.L)
        return self.replicas[n].name, self.cfg.exit_layers[l]

    # ------------------------------------------------------------ hot-swap
    def set_scenario_params(self, sp: Optional[ScenarioParams]) -> None:
        """Hot-swap the MEC world model's numeric dynamics (tensors on the
        engine's device). ``None`` restores the engine config's own knobs.
        Exit tables inside ``sp`` must keep the engine's [N, L] shape."""
        if sp is not None:
            want = tuple(self.env.params.exit_times_s.shape)
            got = tuple(sp.exit_times_s.shape)
            if got != want:
                raise ValueError(f"exit table shape {got} != engine {want}")
        self._sp = sp

    def get_agent_state(self) -> Optional[AgentState]:
        """The scheduler's live ``AgentState`` (params, opt state, replay
        ring, counters); ``None`` without a scheduler."""
        return self.agent_state

    def set_agent_state(self, state: AgentState) -> None:
        """Hot-swap the scheduler's entire mutable state (same structure,
        shapes and device). Raises without a scheduler or on a
        mismatch."""
        if self.agent_def is None:
            raise ValueError("engine has no scheduler agent")
        want = list(_tree_items(self.agent_state))
        got = list(_tree_items(state))
        if [p for p, _ in want] != [p for p, _ in got]:
            raise ValueError(f"AgentState structure {[p for p, _ in got]} "
                             f"!= engine {[p for p, _ in want]}")
        for (path, a), (_, b) in zip(want, got):
            if isinstance(a, torch.Tensor) != isinstance(b, torch.Tensor):
                raise ValueError(f"AgentState leaf {path}: "
                                 f"{type(b).__name__} != engine "
                                 f"{type(a).__name__}")
            if not isinstance(a, torch.Tensor):
                continue
            if tuple(a.shape) != tuple(b.shape):
                raise ValueError(f"AgentState leaf {path} shape "
                                 f"{tuple(b.shape)} != engine "
                                 f"{tuple(a.shape)}")
            if b.device != a.device:
                raise ValueError(f"AgentState leaf {path} on {b.device}, "
                                 f"engine on {a.device}")
        self.agent_state = state

    # ----------------------------------------------------------- telemetry
    def _extra_summary(self, summary: dict) -> None:
        """Hook: subclasses fold engine-specific summary keys in place."""

    def telemetry_snapshot(self, *, history=None,
                           name: str = "serve") -> dict:
        """Host view of the request telemetry (one device->host pull).

        ``summary`` carries the derived headline numbers
        (``deadline_hit_rate``, ``latency_p50``/``latency_p99`` in
        deadline units plus ``latency_p50_s``/``latency_p99_s`` in
        seconds) and ``latency_p50_s_exact``/``latency_p99_s_exact``,
        true order statistics over the exact last-K latency ring. Before
        any request is served every quantile is ``None`` and every rate
        0 (strict JSON as is). ``transfers`` counts the engine's
        host<->device round-trips. ``history`` (a ``HistoryStore``)
        appends the summary as one manifest-stamped ``serve`` record
        under ``name``.
        """
        host = telemetry_host(self.telemetry)
        summary = telemetry_summary(host)
        dl = float(self.env.cfg.deadline_s)
        lat = host["hists"]["latency"]
        for q, key in ((0.5, "latency_p50_s"), (0.99, "latency_p99_s")):
            v = hist_quantile(lat["edges"], lat["counts"], q)
            summary[key] = float(v) * dl if np.isfinite(v) else None
        ring = np.asarray(self._latency_ring, np.float64)
        summary["latency_ring_n"] = int(ring.size)
        for q, key in ((50, "latency_p50_s_exact"),
                       (99, "latency_p99_s_exact")):
            summary[key] = (float(np.percentile(ring, q)) if ring.size
                            else None)
        summary["tokens_served"] = int(self.tokens_served)
        self._extra_summary(summary)
        host["summary"] = summary
        self.transfers["telemetry_pulls"] += 1
        host["transfers"] = dict(self.transfers)
        if history is not None:
            from repro_torch.obs.history import history_manifest
            metrics = {k: v for k, v in summary.items()
                       if isinstance(v, (int, float))
                       and not isinstance(v, bool)}
            history.append(
                "serve", name, metrics,
                manifest=history_manifest(
                    config_signature=self.env.cfg.static_signature(),
                    use_pallas=(self.device.type == "cuda"
                                if self.agent_def is not None else None),
                    backend=self.device.type),
                transfers=dict(self.transfers))
        return host

    def make_request(self, prompt_len: int = 8, max_new: int = 8) -> Request:
        """Synthetic request for arrival-driven serving."""
        toks = self._req_rng.integers(0, self.cfg.vocab, prompt_len)
        return Request(tokens=toks.astype(np.int32),
                       deadline_s=self.env.cfg.deadline_s, max_new=max_new)


# ============================================================== sync engine
class EdgeServingEngine(_ServingCore):
    """The synchronous slot loop: one ``serve_slot`` call per MEC slot,
    with one decode step per exit (``make_serve_step(cfg, exit_layer=e)``)."""

    def __init__(self, cfg: ArchConfig, replicas: list[Replica], **kw):
        kw.setdefault("init_model", True)
        super().__init__(cfg, replicas, **kw)
        self._steps = {
            e: make_serve_step(cfg, exit_layer=e) for e in cfg.exit_layers
        } if self.model is not None else {}

    # ------------------------------------------------------------- decoding
    def _decode(self, requests: list[Request], exit_layer: int) -> list:
        """Greedy-decode a batch at the given exit depth.

        The padded prompt matrix goes up in **one** host->device copy,
        every position's input is a device-side select between the next
        prompt column and the token just generated (teacher-forcing while
        inside each prompt), and the generated tokens come back in **one**
        device->host copy at the end; ``transfers`` counts both. A batch
        that needs more positions than ``cache_len`` decodes over the
        wrapped cache (``apply_decode`` writes at ``pos % cache_len`` and
        attends every row), as the reference does.
        """
        dev = self.device
        b = len(requests)
        prompts = [np.asarray(r.tokens, np.int64) for r in requests]
        lens = np.array([len(p) for p in prompts], np.int64)
        total = int(lens.max()) + max(r.max_new for r in requests)
        cache = self.model.init_cache(self.cfg, b, self.cache_len,
                                      device=dev)
        mat = np.zeros((b, total), np.int64)
        for i, p in enumerate(prompts):
            mat[i, : len(p)] = p
        prompt_mat = torch.from_numpy(mat).to(dev)   # the one h2d copy
        lens_d = torch.from_numpy(lens).to(dev)
        self.transfers["decode_h2d"] += 1
        step = self._steps[exit_layer]
        cur = prompt_mat[:, 0]
        toks = []
        for pos in range(total):
            logits, cache = step(self.params, cache, cur,
                                 torch.full((b,), pos, dtype=torch.int64,
                                            device=dev))
            nxt = torch.argmax(logits, -1)
            toks.append(nxt)
            if pos + 1 < total:
                cur = torch.where(pos + 1 < lens_d,
                                  prompt_mat[:, pos + 1], nxt)
        gen = torch.stack(toks, dim=1).cpu().numpy()  # the one d2h copy
        self.transfers["decode_d2h"] += 1
        # request i's outputs are the argmaxes at positions
        # len(p)-1 .. len(p)-1+max_new-1
        return [[int(t) for t in
                 gen[i, lens[i] - 1: lens[i] - 1 + r.max_new]]
                for i, r in enumerate(requests)]

    # -------------------------------------------------------------- serving
    def serve_slot(self, requests: Optional[list[Request]] = None, *,
                   decode: bool = False):
        """Schedule one slot of requests; optionally run real decoding.

        With ``requests=None`` the slot's load is arrival-driven: the
        workload generator's ``active`` mask (Poisson/MMPP per
        ``MECConfig.workload``) decides which batch slots carry a request,
        each synthesized by ``make_request`` (the generated requests come
        back under ``info["requests"]``). Returns (assignments, info) with
        one ``(replica, exit_layer)`` per request.
        """
        active = None
        slot_ids: Optional[list] = None
        if requests is not None:
            if len(requests) > self.batch_slots:
                raise ValueError(f"{len(requests)} requests for "
                                 f"{self.batch_slots} batch slots")
            slot_ids = list(range(len(requests)))
            if self.env.cfg.workload != "iid":
                # explicit requests ARE the arrivals: align the simulated
                # mask so metrics/assignments describe the real requests
                active = np.zeros((self.batch_slots,), np.float32)
                active[: len(requests)] = 1.0
        tasks, decision, result = self._price_slot(active)
        act_mask = tasks.active.cpu().numpy() > 0.5
        if requests is None:
            slot_ids = [int(i) for i in np.flatnonzero(act_mask)]
            requests = [self.make_request() for _ in slot_ids]
        # exact per-request latencies for the last-K ring (finished
        # requests only; inf = unreachable link is a miss, not a time)
        tt = result.t_total.cpu().numpy().astype(np.float64)
        self._latency_ring.extend(tt[act_mask & np.isfinite(tt)].tolist())

        assignments = [self._assignment(decision, slot) for slot in slot_ids]
        self.tokens_served += sum(r.max_new for r in requests)
        texts = None
        if decode:
            by_exit = {}
            for i, (_, e) in enumerate(assignments):
                by_exit.setdefault(e, []).append(i)
            texts = [None] * len(requests)
            for e, idxs in by_exit.items():
                outs = self._decode([requests[i] for i in idxs], e)
                for i, o in zip(idxs, outs):
                    texts[i] = o
        return assignments, {"reward": float(result.reward),
                             "n_requests": len(requests),
                             "requests": requests,
                             "texts": texts}


# ===================================================== pure scheduler core
class RunningReq(NamedTuple):
    """One batch slot's occupant, from admission to release.

    ``hold`` is the number of decode steps the request still occupies
    its slot (filled after the pricing decision); ``latency_s`` is the
    realized MEC service latency (inf = unreachable link, NaN before the
    decision); ``replica``/``exit_layer`` record the assignment;
    ``variant`` tags which A/B agent variant priced it (empty without a
    pool).
    """
    entry: QueueEntry
    admitted_s: float
    hold: int = 0
    latency_s: float = float("nan")
    replica: str = ""
    exit_layer: int = -1
    variant: str = ""


class BatchState(NamedTuple):
    """Fixed-capacity batch occupancy: one ``RunningReq`` or None per
    slot. Capacity is structural (the tuple length), so occupancy can
    never exceed it by construction."""
    slots: Tuple[Optional[RunningReq], ...]


class SchedEvents(NamedTuple):
    """What one pure scheduler tick decided."""
    expired: Tuple[QueueEntry, ...]            # dropped past-deadline
    admitted: Tuple[Tuple[int, QueueEntry], ...]  # (slot, entry) pairs


def batch_init(capacity: int) -> BatchState:
    if capacity < 1:
        raise ValueError(f"batch needs >= 1 slot, got {capacity}")
    return BatchState(slots=(None,) * capacity)


def batch_occupancy(batch: BatchState) -> int:
    return sum(1 for s in batch.slots if s is not None)


def sched_tick(queue: QueueState, batch: BatchState, now: float):
    """The pure admit/expire step: a function of (queue, batch, clock).

    Expires every pending request whose deadline has passed, then admits
    the best (priority, seq)-ordered schedulable requests into the
    lowest free slots. No device work, no wall clock, no hidden state.
    Returns (queue', batch', SchedEvents).
    """
    queue, expired = queue_expire(queue, now)
    free = [i for i, s in enumerate(batch.slots) if s is None]
    queue, entries = queue_pop(queue, len(free), now)
    slots = list(batch.slots)
    admitted = []
    for slot, entry in zip(free, entries):
        slots[slot] = RunningReq(entry=entry, admitted_s=now)
        admitted.append((slot, entry))
    return (queue, BatchState(slots=tuple(slots)),
            SchedEvents(expired=tuple(e for e in expired),
                        admitted=tuple(admitted)))


def sched_evict(queue: QueueState, batch: BatchState,
                slot_ids: Iterable[int]):
    """Preempt running slots back into the queue (pure).

    Evicted entries keep their original submission seq, so the next
    ``sched_tick`` re-admits them in exactly the order they originally
    held. Returns (queue', batch', evicted entries).
    """
    slots = list(batch.slots)
    evicted = []
    for i in sorted(set(slot_ids)):
        running = slots[i]
        if running is None:
            continue
        evicted.append(running.entry)
        slots[i] = None
    queue = queue_requeue(queue, evicted)
    return queue, BatchState(slots=tuple(slots)), tuple(evicted)


def batch_release(batch: BatchState):
    """Advance every occupied slot by one decode step (pure).

    Decrements holds; slots whose hold reaches zero release their
    request (it finished decoding). Returns
    (batch', released (slot, RunningReq) pairs).
    """
    slots = list(batch.slots)
    released = []
    for i, running in enumerate(slots):
        if running is None:
            continue
        hold = running.hold - 1
        if hold <= 0:
            released.append((i, running))
            slots[i] = None
        else:
            slots[i] = running._replace(hold=hold)
    return BatchState(slots=tuple(slots)), tuple(released)


# ================================================================ A/B pool
class AgentPool:
    """Live A/B over hot-swappable agent variants (round-robin).

    Each engine step checks one variant out (``set_agent_state``), runs
    it, and checks the updated state back in: variants keep learning
    independently while serving interleaved traffic, and per-variant
    served/hit counters make the comparison readable. Deterministic: the
    schedule is a pure function of the step index.
    """

    def __init__(self, variants: dict):
        if not variants:
            raise ValueError("AgentPool needs at least one variant")
        self.variants = dict(variants)
        self._order = tuple(self.variants)
        self.stats = {name: {"steps": 0, "served": 0, "hits": 0}
                      for name in self._order}

    def pick(self, step_idx: int) -> str:
        return self._order[step_idx % len(self._order)]

    def record(self, variant: str, *, served: int, hits: int) -> None:
        st = self.stats[variant]
        st["served"] += served
        st["hits"] += hits


# ============================================================= async engine
class ContinuousServingEngine(_ServingCore):
    """Async, continuously-batched serving on the shared world model.

    Requests enter via ``submit`` (e.g. a ``serve.loadgen`` trace) into
    the deadline-aware queue; every ``step`` is one decode step: the
    pure scheduler core admits into free slots and expires dead pending
    requests, one batched GRLE actor pass prices the whole batch, the
    MEC world model realizes latencies, and finished slots release for
    the next step's admissions.

    ``hold`` picks the slot-occupancy model: ``"slot"`` (default)
    releases a request after its decision step, the semantics of the
    synchronous ``serve_slot``, which makes the two engines
    decision-equivalent on a shared trace; ``"latency"`` holds each slot
    for ceil(latency / slot_s) steps, modeling multi-step decode
    occupancy with continuous backfill.

    Driven by an explicit ``clock`` (default ``VirtualClock``): the
    engine advances it by ``slot_s`` per step, so the whole loop is a
    deterministic function of (seed, trace). Counter law, kept exactly:
    ``admitted == served + expired + in_flight``.
    """

    def __init__(self, cfg: ArchConfig, replicas: list[Replica], *,
                 batch_slots: int = 32, clock=None, hold: str = "slot",
                 **kw):
        if hold not in ("slot", "latency"):
            raise ValueError(f"unknown hold policy {hold!r}")
        kw.setdefault("init_model", False)
        kw.setdefault("workload", "mmpp")
        super().__init__(cfg, replicas, batch_slots=batch_slots, **kw)
        self.clock = clock if clock is not None else VirtualClock()
        self.hold = hold
        self.queue = queue_init()
        self.batch = batch_init(batch_slots)
        self.pool: Optional[AgentPool] = None
        # exact host-side request accounting (ints — the balance law is
        # asserted exactly); telemetry mirrors these on the device
        self.counts = {"admitted": 0, "served": 0, "expired": 0, "hits": 0}
        self._step_idx = 0
        self._tel_admit_delta = 0      # submits not yet folded on-device

    def _make_telemetry(self):
        return serve_telemetry(self.env.N, self.env.L, device=self.device)

    # ------------------------------------------------------------ occupancy
    @property
    def in_flight(self) -> int:
        """Requests inside the system: pending + occupying batch slots."""
        return queue_depth(self.queue) + batch_occupancy(self.batch)

    def set_agent_pool(self, pool: Optional[AgentPool]) -> None:
        """Attach (or detach with None) a live A/B variant pool."""
        if pool is not None and self.agent_def is None:
            raise ValueError("engine has no scheduler agent to A/B")
        self.pool = pool

    # -------------------------------------------------------------- intake
    def submit(self, requests: Iterable[ServeRequest]) -> int:
        """Accept requests into the queue; returns how many."""
        reqs = list(requests)
        self.queue = queue_push(self.queue, reqs)
        self.counts["admitted"] += len(reqs)
        self._tel_admit_delta += len(reqs)
        return len(reqs)

    # ---------------------------------------------------------------- step
    def _hold_steps(self, latency_s: float) -> int:
        if self.hold == "slot" or not math.isfinite(latency_s):
            return 1
        return max(1, int(math.ceil(latency_s / self.env.cfg.slot_s)))

    def step(self) -> dict:
        """One decode step; returns a JSON-safe report of what happened.

        Order inside the step: (1) pure scheduler tick — expire dead
        pending requests, admit into free slots; (2) one batched pricing
        decision over the occupancy mask (newly admitted slots are the
        active ones; held slots keep decoding and are inactive); (3)
        realized latencies fill the admitted slots' holds/assignments;
        (4) holds advance and finished slots release as served; (5) the
        clock advances one ``slot_s``.
        """
        now = self.clock.now()
        variant = ""
        if self.pool is not None:
            variant = self.pool.pick(self._step_idx)
            self.set_agent_state(self.pool.variants[variant])
            self.pool.stats[variant]["steps"] += 1
        self.queue, self.batch, events = sched_tick(self.queue, self.batch,
                                                    now)
        self.counts["expired"] += len(events.expired)

        active = np.zeros((self.batch_slots,), np.float32)
        for slot, _ in events.admitted:
            active[slot] = 1.0
        _, decision, result = self._price_slot(active)
        t_total = result.t_total.cpu().numpy().astype(np.float64)

        # fill the admitted slots: assignment, realized latency, hold
        slots = list(self.batch.slots)
        assignments = []
        for slot, entry in events.admitted:
            replica, exit_layer = self._assignment(decision, slot)
            latency = float(t_total[slot])
            slots[slot] = slots[slot]._replace(
                hold=self._hold_steps(latency), latency_s=latency,
                replica=replica, exit_layer=exit_layer, variant=variant)
            assignments.append({"rid": entry.req.rid, "slot": slot,
                                "replica": replica, "exit": exit_layer})
        self.batch = BatchState(slots=tuple(slots))

        self.batch, released = batch_release(self.batch)
        served = []
        for slot, running in released:
            req = running.entry.req
            # queue wait + realized service latency, against the absolute
            # deadline the request arrived with
            total = ((running.admitted_s - req.arrival_s)
                     + running.latency_s)
            hit = (math.isfinite(total)
                   and req.arrival_s + total <= req.deadline_s)
            self.counts["served"] += 1
            self.counts["hits"] += int(hit)
            self.tokens_served += req.max_new
            if math.isfinite(total):
                self._latency_ring.append(float(total))
            if self.pool is not None and running.variant:
                self.pool.record(running.variant, served=1, hits=int(hit))
            served.append({"rid": req.rid, "slot": slot, "hit": bool(hit),
                           "latency_s": (round(total, 9)
                                         if math.isfinite(total) else None),
                           "replica": running.replica,
                           "exit": running.exit_layer})
        if self.pool is not None:
            self.pool.variants[variant] = self.agent_state

        depth = queue_depth(self.queue)
        # device mirror of the host counts: "admitted" is requests
        # accepted into the system (submits since the last step), so the
        # admitted == served + expired + in-flight law reads identically
        # from either view
        self.telemetry = serve_telemetry_update(
            self.telemetry, self._tel_admit_delta, len(served),
            len(events.expired), depth)
        self._tel_admit_delta = 0
        report = {
            "step": self._step_idx,
            "now": round(now, 9),
            "admitted": [e.req.rid for _, e in events.admitted],
            "expired": [e.req.rid for e in events.expired],
            "assignments": assignments,
            "served": served,
            "queue_depth": depth,
            "occupancy": batch_occupancy(self.batch),
            "variant": variant or None,
        }
        self._step_idx += 1
        self.clock.advance(self.env.cfg.slot_s)
        return report

    # ----------------------------------------------------------------- run
    def run(self, trace: Iterable[ServeRequest], *,
            max_steps: Optional[int] = None, on_step=None) -> list:
        """Drive the engine over an arrival trace until drained.

        Requests are submitted when the clock reaches their
        ``arrival_s``; the loop steps until every request is served or
        expired (or ``max_steps``). ``on_step(engine, report)`` runs
        after each step; hot-swap hooks (``set_agent_state``,
        ``set_scenario_params``) are safe mid-trace. Returns the list of
        step reports (JSON-safe, byte-identical across replays under a
        ``VirtualClock``).
        """
        pending = sorted(trace, key=lambda r: (r.arrival_s, r.rid))
        i, n = 0, len(pending)
        reports = []
        while True:
            now = self.clock.now()
            while i < n and pending[i].arrival_s <= now:
                j = i
                while j < n and pending[j].arrival_s <= now:
                    j += 1
                self.submit(pending[i:j])
                i = j
            if i >= n and self.in_flight == 0:
                break
            if max_steps is not None and len(reports) >= max_steps:
                break
            report = self.step()
            reports.append(report)
            if on_step is not None:
                on_step(self, report)
        return reports

    # ------------------------------------------------------------ snapshot
    def _extra_summary(self, summary: dict) -> None:
        qd = telemetry_host(self.telemetry)["hists"]["queue_depth"]
        for q, key in ((0.5, "queue_depth_p50"), (0.99, "queue_depth_p99")):
            v = hist_quantile(qd["edges"], qd["counts"], q)
            summary[key] = float(v) if np.isfinite(v) else None
        served = self.counts["served"]
        summary.update(
            requests_admitted=self.counts["admitted"],
            requests_served=served,
            requests_expired=self.counts["expired"],
            requests_in_flight=self.in_flight,
            deadline_hit_rate_exact=(self.counts["hits"] / served
                                     if served else 0.0),
            steps=self._step_idx,
        )
