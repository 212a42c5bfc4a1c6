"""Dynamic MEC simulator — Eqs (1)–(11) of the paper, in PyTorch.

Counterpart of ``repro/mec/env.py``. Where the reference ``vmap``s one
network's physics over fleets and candidates, every method here takes
leading batch axes written out: state and task leaves carry ``batch``
(``()`` for one network, ``(B,)`` for B fleets), ``evaluate`` scores a
``batch + (S, M)`` decision tensor in one call, and the FCFS recursion
(Eqs 6–7) is a Python loop over the M sorted queue positions with every
op batched over ``batch + (S,)`` — never a loop over candidates or fleets.

Scenario knobs (``sp``) are shared by every network, or carry the
leading fleet axes of the state (one scenario per fleet, where the
reference ``vmap``s ``sp`` with ``in_axes=0``): every knob is indexed from
its last axis and given unit axes to broadcast (``_knob``).

Arithmetic follows the reference op for op (reciprocal-multiplies where
it has them, ``(k-1)τ`` in float32, ``lexsort`` as two stable sorts), so
on the same inputs the two agree to float32 rounding.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.mec.config import MECConfig, ScenarioParams


class MECState(NamedTuple):
    """Persistent queue state across slots (leaves carry ``batch``)."""
    dev_free: torch.Tensor   # [..., M] time instant each device's uplink is free
    es_free: torch.Tensor    # [..., N] time instant each ES is free
    slot: torch.Tensor       # [...] int32


class SlotTasks(NamedTuple):
    """One slot's task draw (estimated + realized views)."""
    size_bits: torch.Tensor      # [..., M]
    deadline_s: torch.Tensor     # [..., M]
    rate_true: torch.Tensor      # [..., M, N] bps
    rate_est: torch.Tensor       # [..., M, N] bps (±csi_error)
    capacity: torch.Tensor       # [..., N] available fraction (observed)
    cmp_true: torch.Tensor       # [..., N, L] realized per-exit seconds
    cmp_est: torch.Tensor        # [..., N, L] estimated per-exit seconds
    connect: torch.Tensor        # [..., M, N] 1.0 if link up
    active: torch.Tensor         # [..., M] 1.0 if the device has a task


class SlotResult(NamedTuple):
    reward: torch.Tensor        # [...] Q(G_k, x_k)
    t_total: torch.Tensor       # [..., M] completion time (Eq 8)
    success: torch.Tensor       # [..., M] bool, t_total <= deadline (Eq 11)
    accuracy: torch.Tensor      # [..., M] φ of the chosen exit
    t_com: torch.Tensor         # [..., M]
    t_wait: torch.Tensor        # [..., M]
    t_cmp: torch.Tensor         # [..., M]


def _scale(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """Uniforms in [0, 1) mapped onto [lo, hi)."""
    return lo + (hi - lo) * u


def _knob(x: torch.Tensor, n_trailing: int) -> torch.Tensor:
    """A ``ScenarioParams`` value (a shared one, or one with fleet axes in
    front) with ``n_trailing`` unit axes appended, so it broadcasts
    against the fleet axes followed by ``n_trailing`` axes of one
    network's."""
    return x.reshape(tuple(x.shape) + (1,) * n_trailing)


class SlotUniforms(NamedTuple):
    """The raw uniforms in [0, 1) behind ``assemble_slot``'s four draws
    (the injection seam: the tests feed the reference's here)."""
    size: torch.Tensor       # [..., M]
    csi: torch.Tensor        # [..., M, N]
    jitter: torch.Tensor     # [..., N, L]
    connect: torch.Tensor    # [..., M, N]


def assemble_slot(sp: ScenarioParams, m: int, *, rate_true: torch.Tensor,
                  capacity: torch.Tensor, active: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[SlotUniforms] = None) -> SlotTasks:
    """Finish a slot draw from given rates/capacity/active mask.

    Task sizes, CSI-error estimates, inference jitter and connectivity
    (with the never-lose-every-link fallback), for the leading batch axes
    of ``rate_true`` ([..., M, N]): from the uniforms ``draws`` when
    given, else drawn from ``generator`` in that order.
    """
    n, l = sp.exit_times_s.shape[-2:]
    batch = rate_true.shape[:-2]
    dev = rate_true.device
    if draws is None:
        draws = SlotUniforms(*(torch.rand(batch + shape, generator=generator,
                                       device=dev)
                            for shape in ((m,), (m, n), (n, l), (m, n))))
    size_bits = _scale(draws.size, _knob(sp.task_kb[..., 0], 1),
                       _knob(sp.task_kb[..., 1], 1)) * 8e3  # KB -> bits
    csi = _knob(sp.csi_error, 2)
    eps = _scale(draws.csi, -csi, csi)
    rate_est = rate_true * (1.0 + eps)
    jitter = _knob(sp.inference_jitter, 2)
    jit = _scale(draws.jitter, -jitter, jitter)
    cmp_base = sp.exit_times_s / capacity[..., :, None]
    cmp_true = cmp_base * (1.0 + jit)
    connect = (draws.connect >= _knob(sp.connectivity_drop, 2)).to(
        torch.float32)
    # never let a device lose every link
    has_link = connect.sum(-1, keepdim=True) > 0
    connect = torch.where(has_link, connect, torch.ones_like(connect))
    deadline = _knob(sp.deadline_s, 1).expand(batch + (m,)).clone()
    return SlotTasks(size_bits, deadline, rate_true, rate_est, capacity,
                     cmp_true, cmp_base, connect, active)


def _at_candidates(x: torch.Tensor, n_trailing: int) -> torch.Tensor:
    """Insert the candidate axis S in front of ``x``'s last
    ``n_trailing`` axes, so per-network leaves broadcast against
    ``batch + (S, ...)``."""
    return x.unsqueeze(x.dim() - n_trailing)


class MECEnv:
    """Stateless-core environment; state is threaded explicitly.

    ``device=None`` means the card; pass ``device="cpu"`` for the plain
    path.
    """

    def __init__(self, cfg: MECConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.M, self.N, self.L = cfg.n_devices, cfg.n_servers, cfg.n_exits
        self.params: ScenarioParams = cfg.scenario_params(self.device)
        self.exit_acc = self.params.exit_acc

    def _sp(self, sp: Optional[ScenarioParams]) -> ScenarioParams:
        """``sp``, or this env's own knobs for None."""
        return self.params if sp is None else sp

    # ------------------------------------------------------------------ state
    def reset(self, batch: Tuple[int, ...] = ()) -> MECState:
        dev = self.device
        return MECState(
            dev_free=torch.zeros(batch + (self.M,), device=dev),
            es_free=torch.zeros(batch + (self.N,), device=dev),
            slot=torch.zeros(batch, dtype=torch.int32, device=dev),
        )

    # ------------------------------------------------------------- task draws
    def sample_slot(self, generator: Optional[torch.Generator],
                    batch: Tuple[int, ...] = (),
                    sp: Optional[ScenarioParams] = None, *,
                    draws=None) -> SlotTasks:
        """One slot's iid task draw (paper §VI-A) for ``batch`` networks,
        knobs from ``sp`` (None: this env's own; shared, or with ``batch``
        in front).

        The uniforms come from ``generator`` (on this env's device): the
        rates' [*batch, M, N], the capacities' [*batch, N], then
        ``assemble_slot``'s; or ``draws`` gives them as (rate, capacity,
        ``SlotUniforms``). They follow the reference's distributions, not
        its threefry bits.
        """
        sp, dev = self._sp(sp), self.device
        if draws is None:
            draws = (torch.rand(batch + (self.M, self.N), generator=generator,
                                device=dev),
                     torch.rand(batch + (self.N,), generator=generator,
                                device=dev), None)
        u_rate, u_cap, slot = draws
        batch = tuple(u_cap.shape[:-1])
        rate_true = _scale(u_rate, _knob(sp.rate_mbps[..., 0], 2),
                           _knob(sp.rate_mbps[..., 1], 2)) * 1e6
        capacity = _scale(u_cap, _knob(sp.capacity_range[..., 0], 1),
                          _knob(sp.capacity_range[..., 1], 1))
        return assemble_slot(sp, self.M, rate_true=rate_true,
                             capacity=capacity,
                             active=torch.ones(batch + (self.M,), device=dev),
                             generator=generator, draws=slot)

    # ------------------------------------------------------------ core physics
    def _simulate(self, state: MECState, tasks: SlotTasks,
                  decision: torch.Tensor, sp: ScenarioParams, *,
                  realized: bool):
        """One slot's queueing physics for decisions ``batch + (S, M)``
        in [0, N*L). Returns SlotResult (leaves ``batch + (S, ...)``) and
        the end-of-slot (dev_free, es_free)."""
        cfg, L = self.cfg, self.L
        decision = decision.long()
        n_idx = decision // L                                    # [..., S, M]
        l_idx = decision % L
        rate = _at_candidates(tasks.rate_true if realized else tasks.rate_est, 2)
        cmp_tab = (tasks.cmp_true if realized else tasks.cmp_est).flatten(-2)
        cmp_tab = _at_candidates(cmp_tab, 1)                     # [..., 1, N*L]
        size_bits = _at_candidates(tasks.size_bits, 1)
        deadline = _at_candidates(tasks.deadline_s, 1)
        active = _at_candidates(tasks.active, 1)
        connect = _at_candidates(tasks.connect, 2)
        dev_free = _at_candidates(state.dev_free, 1)

        gen_time = (state.slot.to(torch.float32) * cfg.slot_s)[..., None, None]
        r_sel = torch.take_along_dim(rate, n_idx[..., None], -1)[..., 0]
        t_com = size_bits / torch.clamp_min(r_sel, 1.0)          # Eq (1)
        # Eq (6): device transmits sequentially; new task starts after the
        # previous transmission and not before its own generation instant.
        start_tx = torch.maximum(dev_free, gen_time)
        arrival = start_tx + t_com
        t_cmp = torch.take_along_dim(cmp_tab, decision, -1)      # Eq (4)

        # Inactive devices (dynamic-M scenarios) occupy no resources.
        act = active > 0.5
        arrival_eff = torch.where(act, arrival, math.inf)
        t_cmp_eff = torch.where(act, t_cmp, 0.0)

        # Eqs (6)-(7): per-ES FCFS. lexsort((arrival, server)) as two
        # stable sorts (secondary key first), ties broken by device index.
        by_arrival = torch.sort(arrival_eff, dim=-1, stable=True).indices
        by_server = torch.sort(n_idx.gather(-1, by_arrival), dim=-1,
                               stable=True).indices
        order = by_arrival.gather(-1, by_server)
        srv_sorted = n_idx.gather(-1, order)
        arr_sorted = arrival_eff.gather(-1, order)
        cmp_sorted = t_cmp_eff.gather(-1, order)

        busy = _at_candidates(state.es_free, 1).expand(
            srv_sorted.shape[:-1] + (self.N,)).clone()           # [..., S, N]
        starts = []
        for i in range(self.M):
            srv = srv_sorted[..., i:i + 1]
            arr = arr_sorted[..., i:i + 1]
            free = busy.gather(-1, srv)
            start = torch.maximum(arr, free)
            done = torch.where(torch.isinf(arr), free, start + cmp_sorted[..., i:i + 1])
            busy.scatter_(-1, srv, done)
            starts.append(start)
        start_sorted = torch.cat(starts, dim=-1)
        inv = torch.empty_like(order).scatter_(
            -1, order, torch.arange(self.M, device=order.device).expand_as(order))
        start_srv = start_sorted.gather(-1, inv)
        t_wait = torch.where(act, start_srv - arrival, 0.0)       # Eq (7)
        t_total = t_com + t_wait + t_cmp                          # Eq (8)

        acc = sp.exit_acc                                         # [..., L]
        acc = acc.reshape(tuple(acc.shape[:-1])
                          + (1,) * (l_idx.dim() - acc.dim()) + (L,))
        phi = acc.expand(l_idx.shape[:-1] + (L,)).gather(-1, l_idx)  # Eq (5)
        # links that are down make the task infeasible
        link = torch.take_along_dim(connect, n_idx[..., None], -1)[..., 0]
        t_total = torch.where(link > 0.5, t_total, math.inf)

        # reciprocal-multiply (not /), as the reference spells it; the
        # logistic as 1 / (1 + exp(-z)): on the CPU torch.sigmoid rounds
        # differently in its vectorized loop and its scalar tail, so a
        # fleet's reward would hang on its place in the batch (a slice of
        # the fleets, the fleet-sharded episode, must see the same bits)
        z = 5.0 * t_total * (1.0 / deadline)
        psi = 1.0 - 1.0 / (1.0 + torch.exp(-z))
        psi = torch.where(torch.isinf(t_total), 0.0, psi)
        reward = torch.where(act, phi * psi, 0.0).sum(-1)         # Eq (9)
        success = act & (t_total <= deadline)                     # Eq (11)

        new_dev_free = torch.where(act & (link > 0.5), arrival, dev_free)
        result = SlotResult(reward, t_total, success, phi, t_com, t_wait, t_cmp)
        return result, (new_dev_free, busy)

    # ------------------------------------------------------------- public API
    def evaluate(self, state: MECState, tasks: SlotTasks,
                 decisions: torch.Tensor,
                 sp: Optional[ScenarioParams] = None) -> torch.Tensor:
        """Reward Q for candidate decisions ``batch + (S, M)`` (Eq 15
        critic) from the *estimated* quantities -> ``batch + (S,)``."""
        res, _ = self._simulate(state, tasks, decisions, self._sp(sp),
                                realized=False)
        return res.reward

    def step(self, state: MECState, tasks: SlotTasks, decision: torch.Tensor,
             sp: Optional[ScenarioParams] = None):
        """Realize decisions ``batch + (M,)``; returns (new_state,
        SlotResult)."""
        res, (dev_free, es_free) = self._simulate(
            state, tasks, decision.unsqueeze(-2), self._sp(sp), realized=True)
        result = SlotResult(res.reward.squeeze(-1),
                            *(x.squeeze(-2) for x in res[1:]))
        new_state = MECState(dev_free=dev_free.squeeze(-2),
                             es_free=es_free.squeeze(-2),
                             slot=state.slot + 1)
        return new_state, result

    # ------------------------------------------------------------ observation
    def observe(self, state: MECState, tasks: SlotTasks,
                sp: Optional[ScenarioParams] = None) -> dict:
        """Feature views used by the agents (normalized, estimate-side).

        Returns dict with:
          device  [..., M, 6] — task size, deadline, mean/best rate, tx
                                backlog, active
          option  [..., N*L, 4] — est compute time, accuracy, ES backlog,
                                  capacity
          edge_rate [..., M, N] — normalized rate estimate per link
          connect [..., M, N]
        """
        cfg, sp = self.cfg, self._sp(sp)
        batch = state.slot.shape
        gen_time = (state.slot.to(torch.float32) * cfg.slot_s)[..., None]
        inv_dl = 1.0 / _knob(sp.deadline_s, 1)
        d_norm = tasks.size_bits * (1.0 / (_knob(sp.task_kb[..., 1], 1)
                                           * 8e3))
        dl_norm = tasks.deadline_s / _knob(sp.deadline_s, 1)
        r_norm = tasks.rate_est * (1.0 / (_knob(sp.rate_mbps[..., 1], 2)
                                          * 1e6))
        r_norm = r_norm * tasks.connect
        # log-compress queue backlogs: under overload they grow to many
        # multiples of the deadline and would otherwise saturate the GCN
        backlog_dev = torch.log1p(
            torch.clamp_min(state.dev_free - gen_time, 0.0) * inv_dl)
        device = torch.stack(
            [d_norm, dl_norm, r_norm.mean(-1), r_norm.amax(-1), backlog_dev,
             tasks.active], dim=-1)

        nl = (self.N, self.L)
        cmp_norm = tasks.cmp_est * inv_dl[..., None]              # [..., N, L]
        backlog_es = torch.log1p(
            torch.clamp_min(state.es_free - gen_time, 0.0) * inv_dl)
        option = torch.stack(
            [cmp_norm,
             sp.exit_acc.unsqueeze(-2).expand(batch + nl),
             backlog_es[..., None].expand(batch + nl),
             tasks.capacity[..., None].expand(batch + nl)],
            dim=-1).reshape(batch + (self.N * self.L, 4))
        return {"device": device, "option": option,
                "edge_rate": r_norm, "connect": tasks.connect}


    # ----------------------------------------------------------------- oracle
    def _options(self, early_exit: bool) -> torch.Tensor:
        options = torch.arange(self.N * self.L, device=self.device)
        if not early_exit:
            options = options[options % self.L == self.L - 1]
        return options

    def greedy_decision(self, state: MECState, tasks: SlotTasks, *,
                        sweeps: int = 2, early_exit: bool = True,
                        sp: Optional[ScenarioParams] = None) -> torch.Tensor:
        """Sequential-greedy + local-search oracle (the Fig-4
        normalization x'_k), for the leading batch axes of ``state``.

        Every device starts at the first allowed option; then ``sweeps``
        coordinate-ascent sweeps re-optimize one device at a time against
        the current joint decision by the critic (``evaluate``, first
        maximum on ties). ``sp`` as in ``evaluate`` (the reference has
        none: its env's own knobs).
        """
        options = self._options(early_exit).to(torch.int32)
        batch = state.slot.shape
        decision = options[0].expand(batch + (self.M,)).clone()
        k = options.shape[0]
        for _ in range(sweeps):
            for m in range(self.M):
                cands = decision[..., None, :].repeat(
                    (1,) * len(batch) + (k, 1))
                cands[..., m] = options
                q = self.evaluate(state, tasks, cands, sp)    # [..., K]
                best = torch.argmax(q, dim=-1)
                decision = torch.take_along_dim(
                    cands, best[..., None, None], -2)[..., 0, :]
        return decision

    def exhaustive_decision(self, state: MECState, tasks: SlotTasks, *,
                            early_exit: bool = True) -> torch.Tensor:
        """True exhaustive search over every joint decision of one network
        (options^M candidates, scored 4096 at a time) — only feasible for
        tiny M (tests)."""
        chunk = 4096
        options = self._options(early_exit).to(torch.int32)
        cands = torch.cartesian_prod(*([options] * self.M)).reshape(
            -1, self.M)
        q = torch.cat([self.evaluate(state, tasks, cands[i:i + chunk])
                       for i in range(0, cands.shape[0], chunk)])
        return cands[torch.argmax(q)]
