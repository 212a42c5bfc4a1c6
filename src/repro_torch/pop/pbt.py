"""Population-based training exploit/explore as surgery on stacked leaves.

Counterpart of ``repro/pop/pbt.py``. PBT (Jaderberg et al. 2017)
periodically replaces the worst members of a population with copies of
the best, then perturbs the copies' hyperparameters. A ``Population`` holds
its members on a leading axis and its hyperparameters as data, so the
step is one ``index_select`` per leaf plus a few ``where``s:

* rank members by score (higher = better; a stable sort, so ties break by
  member index and the surgery is deterministic in its inputs);
* the bottom ``frac`` of members each copy a distinct member from the top
  ``frac`` (best winner overwrites worst loser): params, optimizer state,
  replay, *and* hyperparameters;
* only the copied members' hyperparameters are perturbed: lr multiplied or
  divided by ``lr_factor`` (a fair coin per member), additive uniform
  jitter on ``explore_gain``/``exit_tau``, all clipped back into the
  search box.

The coin and the two jitters come from the caller's generator, or are
injected (``draws=``: the tests feed the reference's, since torch cannot
reproduce threefry). Same generator state => identical surgery, which is
what makes a checkpointed PBT run resume bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.pop.population import (GAIN_RANGE, LR_RANGE, TAU_RANGE,
                                        MemberHypers, Population,
                                        gather_members)


@dataclasses.dataclass(frozen=True)
class PBTConfig:
    """Static knobs of the exploit/explore step."""
    frac: float = 0.25          # fraction replaced (and copied from)
    lr_factor: float = 1.25     # multiplicative lr perturbation
    gain_jitter: float = 0.25   # +- uniform jitter on explore_gain
    tau_jitter: float = 0.05    # +- uniform jitter on exit_tau
    lr_range: Tuple[float, float] = LR_RANGE
    gain_range: Tuple[float, float] = GAIN_RANGE
    tau_range: Tuple[float, float] = TAU_RANGE

    def n_exploit(self, n_members: int) -> int:
        """How many members are replaced (static, >= 1)."""
        return max(1, int(round(n_members * self.frac)))


class PBTStats(NamedTuple):
    """Device-resident record of one exploit/explore step."""
    src: torch.Tensor     # [P] int32: member each slot was copied from
                          #   (identity for survivors)
    copied: torch.Tensor  # [P] float32: 1.0 where the member was replaced
    ranks: torch.Tensor   # [P] int32: pre-surgery rank (0 = best)


class PBTDraws(NamedTuple):
    """One step's random draws, [P] each: the lr coin (True = up) and the
    jitters added to ``explore_gain`` and ``exit_tau`` (already scaled to
    +-``gain_jitter``/``tau_jitter``)."""
    up: torch.Tensor
    gain: torch.Tensor
    tau: torch.Tensor


def pbt_draws(generator: torch.Generator, n: int,
              cfg: PBTConfig = PBTConfig()) -> PBTDraws:
    """The coin and jitters of one step from ``generator``."""
    def u():
        return torch.rand((n,), generator=generator, device=generator.device)

    def jitter(width):
        return -width + u() * (2.0 * width)

    up = u() < 0.5
    return PBTDraws(up=up, gain=jitter(cfg.gain_jitter),
                    tau=jitter(cfg.tau_jitter))


def pbt_update(pop: Population, scores: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               cfg: PBTConfig = PBTConfig(), *,
               draws: Optional[PBTDraws] = None):
    """One exploit/explore step; returns ``(new pop, PBTStats)``.

    ``scores`` is the [P] per-member fitness (higher is better —
    ``metrics["avg_reward"]`` from the generation that just ran). The
    generation counter advances by one. The draws come from ``generator``
    (``pbt_draws``) unless injected.
    """
    n = scores.shape[0]
    k = cfg.n_exploit(n)
    dev = scores.device
    # stable ascending argsort: losers first, ties broken by index
    order = torch.argsort(scores.to(torch.float32), stable=True)
    losers, winners = order[:k], order[n - k:]
    arange = torch.arange(n, dtype=torch.int32, device=dev)
    # best winner (last of `winners`) overwrites worst loser (first of
    # `losers`)
    src = arange.clone()
    src[losers] = winners.flip(0).to(torch.int32)
    copied = torch.zeros((n,), dtype=torch.float32, device=dev)
    copied[losers] = 1.0
    ranks = torch.zeros((n,), dtype=torch.int32, device=dev)
    ranks[order.flip(0)] = arange

    index = src.to(torch.int64)
    agents = gather_members(pop.agents, index)
    hyp = gather_members(pop.hypers, index)

    if draws is None:
        draws = pbt_draws(generator, n, cfg)
    up = draws.up.to(device=dev, dtype=torch.bool)
    factor = torch.where(up, torch.tensor(cfg.lr_factor, device=dev),
                         torch.tensor(1.0 / cfg.lr_factor, device=dev))
    lr = hyp.lr * factor
    gain = hyp.explore_gain + draws.gain.to(dev)
    tau = hyp.exit_tau + draws.tau.to(dev)
    sel = copied > 0.5
    hyp = MemberHypers(
        lr=torch.where(sel, torch.clamp(lr, *cfg.lr_range), hyp.lr),
        explore_gain=torch.where(sel, torch.clamp(gain, *cfg.gain_range),
                                 hyp.explore_gain),
        exit_tau=torch.where(sel, torch.clamp(tau, *cfg.tau_range),
                             hyp.exit_tau),
    )
    new = Population(agents=agents, hypers=hyp,
                     generation=pop.generation + 1)
    return new, PBTStats(src=src, copied=copied, ranks=ranks)
