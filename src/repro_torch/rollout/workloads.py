"""Stochastic workload generators: the paper's ``iid`` draws and the
``poisson``/``mmpp`` arrival processes.

Counterpart of ``repro/rollout/workloads.py``. The generator state is
explicit data (``WorkloadState``) and every draw comes from the caller's
``torch.Generator``:

    gen = make_workload(env)
    wl  = gen.init(generator)
    wl, tasks = gen.sample(wl, generator)      # one slot

Three arrival processes, selected by ``MECConfig.workload``:

* ``iid``     — ``MECEnv.sample_slot``: every device active, fresh uniform
  rates and capacity each slot; the state is not read.
* ``poisson`` — Bernoulli thinning: each member device generates a task
  with probability ``arrival_rate`` per slot.
* ``mmpp``    — two-state Markov-modulated Poisson process: a calm/burst
  mode switches with ``mmpp_switch`` and sets the per-device arrival
  probability to one of ``mmpp_rates``.

On top of ``poisson``/``mmpp``: device churn (members leave/join w.p.
``churn_prob`` a slot) and AR(1) rates and capacity (coefficient
``ar1_rho``, variance matched to the iid uniform draw, clipped to the
configured ranges). Every knob is read from a ``ScenarioParams`` (``sp``;
None: the env's own; shared, or with the state's batch axes in front,
one scenario per fleet), and churn and AR(1) are branch-free, as in the
reference. Leaves are one network's axes with any leading batch axes.

Every raw draw sits behind a seam: ``init`` and ``sample`` take the
uniforms in [0, 1) they would draw (``InitDraws``, ``WorkloadDraws``), so
the tests can feed the reference's. A draw ``u`` stands for the
reference's ``uniform(key)``; where the reference draws a uniform and a
normal from one key (``_ar1``), both come from the one ``u`` here, as in
``jax.random.normal`` (``sqrt(2) erfinv`` of the same bits mapped to
(-1, 1)).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.mec.config import ScenarioParams
from repro_torch.mec.env import (MECEnv, SlotUniforms, _knob, _scale,
                                 assemble_slot)

KINDS = ("iid", "poisson", "mmpp")
# the lower end of ``jax.random.normal``'s uniform: nextafter(-1, 0) in f32
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


class WorkloadState(NamedTuple):
    """Generator state threaded through slots (one network's axes, with
    any leading batch axes)."""
    rate_true: torch.Tensor   # [..., M, N] bps, AR(1)-correlated when ar1_rho > 0
    capacity: torch.Tensor    # [..., N] available ES fraction
    member: torch.Tensor      # [..., M] 1.0 while the device belongs to the fleet
    burst: torch.Tensor       # [...] int32, MMPP mode (0 = calm, 1 = burst)


class InitDraws(NamedTuple):
    """The uniforms of ``init``."""
    rate: torch.Tensor        # [..., M, N]
    capacity: torch.Tensor    # [..., N]


class WorkloadDraws(NamedTuple):
    """The uniforms of one ``sample`` (``iid``: rate, capacity and slot
    only)."""
    burst: Optional[torch.Tensor]   # [...] MMPP flip (unread for poisson)
    arrive: Optional[torch.Tensor]  # [..., M] arrival Bernoullis
    churn: Optional[torch.Tensor]   # [..., M] churn Bernoullis
    rate: torch.Tensor        # [..., M, N] AR(1) uniform and normal
    capacity: torch.Tensor    # [..., N] AR(1) uniform and normal
    slot: SlotUniforms        # assemble_slot's size, CSI, jitter, links


def _ar1(u, prev, *, lo, hi, mu, noise_scale, rho):
    """Mean-reverting AR(1) step clipped to [lo, hi], branch-free.

    ``mu`` is the stationary mean and ``noise_scale`` the innovation std
    (see ``ScenarioParams``). The fresh uniform and the normal noise both
    come from ``u``; ``rho > 0`` selects the AR(1) step, so rho=0 keeps
    the fresh uniform draw.
    """
    fresh = _scale(u, lo, hi)
    v = torch.clamp_min(u * (1.0 - _NORMAL_LO) + _NORMAL_LO, _NORMAL_LO)
    noise = math.sqrt(2.0) * torch.special.erfinv(v) * noise_scale
    stepped = torch.clamp(mu + rho * (prev - mu) + noise, lo, hi)
    return torch.where(rho > 0, stepped, fresh)


class WorkloadGen:
    """Arrival/channel process for one ``MECEnv`` (see module docstring)."""

    def __init__(self, env: MECEnv):
        if env.cfg.workload not in KINDS:
            raise ValueError(f"unknown workload {env.cfg.workload!r}")
        self.env = env
        self.cfg = env.cfg
        self.kind = env.cfg.workload

    # ------------------------------------------------------------------ init
    def init(self, generator: Optional[torch.Generator] = None,
             sp: Optional[ScenarioParams] = None, *,
             batch: Tuple[int, ...] = (),
             draws: Optional[InitDraws] = None) -> WorkloadState:
        """Stationary initial state for ``batch`` networks: uniform rates
        and capacity over ``sp``'s ranges, every device a member, calm."""
        env = self.env
        sp = env._sp(sp)
        dev = env.device
        m, n = env.M, env.N
        if draws is None:
            draws = InitDraws(
                torch.rand(batch + (m, n), generator=generator, device=dev),
                torch.rand(batch + (n,), generator=generator, device=dev))
        batch = tuple(draws.capacity.shape[:-1])
        return WorkloadState(
            rate_true=_scale(draws.rate, _knob(sp.rate_mbps[..., 0], 2),
                             _knob(sp.rate_mbps[..., 1], 2)) * 1e6,
            capacity=_scale(draws.capacity,
                            _knob(sp.capacity_range[..., 0], 1),
                            _knob(sp.capacity_range[..., 1], 1)),
            member=torch.ones(batch + (m,), device=dev),
            burst=torch.zeros(batch, dtype=torch.int32, device=dev))

    # ---------------------------------------------------------------- sample
    def draws(self, generator: torch.Generator,
              batch: Tuple[int, ...]) -> WorkloadDraws:
        """One ``sample``'s uniforms from ``generator`` for ``batch``
        networks, in the order ``sample`` draws them itself: for ``iid``
        ``env.sample_slot``'s (``burst``, ``arrive`` and ``churn`` None),
        else ``burst`` (``mmpp`` only), then field order. Drawn for every
        network and sliced, they are what a slice of the networks draws
        (the fleet-sharded episode)."""
        env, dev = self.env, self.env.device
        m, n, l = env.M, env.N, env.L

        def u(shape):
            return torch.rand(batch + shape, generator=generator, device=dev)

        if self.kind == "iid":
            rate, capacity = u((m, n)), u((n,))
            return WorkloadDraws(None, None, None, rate, capacity,
                                 SlotUniforms(u((m,)), u((m, n)), u((n, l)),
                                              u((m, n))))
        burst = (u(()) if self.kind == "mmpp"
                 else torch.zeros(batch, device=dev))
        return WorkloadDraws(burst, u((m,)), u((m,)), u((m, n)), u((n,)),
                             SlotUniforms(u((m,)), u((m, n)), u((n, l)),
                                          u((m, n))))

    def sample(self, state: Optional[WorkloadState],
               generator: Optional[torch.Generator] = None,
               sp: Optional[ScenarioParams] = None, *,
               batch: Optional[Tuple[int, ...]] = None,
               draws: Optional[WorkloadDraws] = None):
        """Draw one slot -> (new state, SlotTasks).

        ``iid`` returns ``state`` unchanged beside ``env.sample_slot`` for
        ``batch`` networks (default: the state's batch axes, or one
        network). The others advance ``state``. The uniforms are ``draws``
        (``draws()``'s layout) or, without them, drawn from ``generator``.
        """
        env = self.env
        if self.kind == "iid":
            if batch is None:
                batch = () if state is None else tuple(state.burst.shape)
            return state, env.sample_slot(
                generator, batch, sp, draws=None if draws is None else
                (draws.rate, draws.capacity, draws.slot))
        sp = env._sp(sp)
        if draws is None:
            draws = self.draws(generator, tuple(state.burst.shape))

        # --- arrival process -> active mask
        if self.kind == "poisson":
            burst = state.burst
            p_arr = _knob(torch.clamp(sp.arrival_rate, 0.0, 1.0), 1)
        else:  # mmpp
            u = draws.burst
            flip = torch.where(state.burst == 0, u < sp.mmpp_switch[..., 0],
                               u < sp.mmpp_switch[..., 1])
            burst = torch.where(flip, 1 - state.burst, state.burst)
            p_arr = torch.where(burst == 0, sp.mmpp_rates[..., 0],
                                sp.mmpp_rates[..., 1])[..., None]
        arrive = draws.arrive < p_arr

        # --- device churn (churn_prob=0 never toggles)
        toggle = draws.churn < _knob(torch.clamp(sp.churn_prob, 0.0, 1.0), 1)
        member = torch.where(toggle, 1.0 - state.member, state.member)
        active = arrive.to(torch.float32) * member

        # --- time-correlated channel/capacity (AR(1) when ar1_rho > 0,
        # else fresh uniform as in sample_slot)
        rate_true = _ar1(draws.rate, state.rate_true,
                         lo=_knob(sp.rate_bps[..., 0], 2),
                         hi=_knob(sp.rate_bps[..., 1], 2),
                         mu=_knob(sp.ar1_mu_rate, 2),
                         noise_scale=_knob(sp.ar1_noise_rate, 2),
                         rho=_knob(sp.ar1_rho, 2))
        capacity = _ar1(draws.capacity, state.capacity,
                        lo=_knob(sp.capacity_range[..., 0], 1),
                        hi=_knob(sp.capacity_range[..., 1], 1),
                        mu=_knob(sp.ar1_mu_cap, 1),
                        noise_scale=_knob(sp.ar1_noise_cap, 1),
                        rho=_knob(sp.ar1_rho, 1))

        new_state = WorkloadState(rate_true=rate_true, capacity=capacity,
                                  member=member, burst=burst)
        tasks = assemble_slot(sp, env.M, rate_true=rate_true,
                              capacity=capacity, active=active,
                              draws=draws.slot)
        return new_state, tasks

    # ---------------------------------------------------------------- trace
    def arrival_trace(self, state: WorkloadState,
                      generator: torch.Generator, n_slots: int,
                      sp: Optional[ScenarioParams] = None):
        """Roll the arrival process forward -> (state, active [T, ..., M]):
        ``sample`` slot by slot, keeping each slot's active mask (the
        serving load generator's source of arrivals)."""
        rows = []
        for _ in range(n_slots):
            state, tasks = self.sample(state, generator, sp)
            rows.append(tasks.active)
        return state, torch.stack(rows)


def make_workload(env: MECEnv) -> WorkloadGen:
    """Generator for ``env.cfg.workload`` (see SCENARIOS ``dyn_*``)."""
    return WorkloadGen(env)
