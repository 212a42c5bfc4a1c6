"""Auto-curriculum over a ``ScenarioSpace``: sample where it hurts.

Counterpart of ``repro/pop/curriculum.py``. The space between two corner
scenarios (``mec.scenarios.ScenarioSpace``) is carved into R equal
*regions* along the lo -> hi interpolation axis t in [0, 1]. Each
generation:

* ``resample`` draws one region per member — softmax over ``-score/T``
  so low-scoring (hard) regions are drawn more often — then a uniform
  offset inside the region, and materializes the member's
  ``ScenarioParams`` with ``interpolate_params``;
* ``update`` folds the generation's per-member rewards back into the
  visited regions' score EMAs (first visit seeds the EMA directly).

``uniform=True`` ignores scores and draws regions uniformly — the
domain-randomized control arm, sharing every other code path.

The region draw is ``torch.multinomial`` over the softmax, the offsets
``torch.rand``, both from the caller's generator; torch cannot reproduce
``jax.random.categorical``, so both are injectable (``region=``,
``offset=``), the seam the tests feed with the reference's draws.
``CurriculumState`` is a two-leaf tuple ([R] scores + visit counts) and
checkpoints alongside the ``Population``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.mec.config import ScenarioParams
from repro_torch.mec.scenarios import interpolate_params


class CurriculumState(NamedTuple):
    """Per-region difficulty estimates (all [R] float32)."""
    score: torch.Tensor   # EMA of member avg_reward per region
    visits: torch.Tensor  # total member-episodes run in the region


@dataclasses.dataclass(frozen=True)
class Curriculum:
    """A difficulty-driven sampler over one scenario interpolation axis.

    ``lo``/``hi`` are the corner ``ScenarioParams`` (from
    ``scenario_space``: same shapes, one compiled episode); its state and
    draws live on their device.
    """
    lo: ScenarioParams
    hi: ScenarioParams
    n_regions: int = 8
    temperature: float = 0.3   # softmax temperature over -score
    ema: float = 0.7           # score EMA retention per visited generation
    uniform: bool = False      # True = domain-randomized control arm

    @property
    def device(self) -> torch.device:
        return self.lo.task_kb.device

    def init_state(self) -> CurriculumState:
        def z():
            return torch.zeros((self.n_regions,), dtype=torch.float32,
                               device=self.device)
        return CurriculumState(score=z(), visits=z())

    def resample(self, state: CurriculumState,
                 generator: Optional[torch.Generator], n_members: int, *,
                 region: Optional[torch.Tensor] = None,
                 offset: Optional[torch.Tensor] = None):
        """Draw one scenario per member; returns ``(region [P] int32, sps
        [P]-leading ScenarioParams)``. The DR arm (``uniform=True``) uses
        flat logits but the identical draw structure, so both arms consume
        randomness the same way. ``region``/``offset`` ([P] ints in [0, R),
        [P] uniforms in [0, 1)) replace the draws."""
        dev = self.device
        if region is None:
            logits = (torch.zeros((self.n_regions,), dtype=torch.float32,
                                  device=dev) if self.uniform
                      else -state.score / self.temperature)
            region = torch.multinomial(torch.softmax(logits, dim=0),
                                       n_members, replacement=True,
                                       generator=generator)
        if offset is None:
            offset = torch.rand((n_members,), generator=generator,
                                device=dev)
        region = torch.as_tensor(region, device=dev).to(torch.int32)
        offset = torch.as_tensor(offset, dtype=torch.float32, device=dev)
        t = (region.to(torch.float32) + offset) / float(self.n_regions)
        each = [interpolate_params(self.lo, self.hi, ti) for ti in t]
        return region, ScenarioParams(*(torch.stack(xs)
                                        for xs in zip(*each)))

    def update(self, state: CurriculumState, region: torch.Tensor,
               scores: torch.Tensor) -> CurriculumState:
        """Fold one generation's [P] member scores into the region EMAs.

        Unvisited regions keep their score; a region's first-ever visit
        takes the batch mean directly (no stale-zero blending).
        """
        dev = self.device
        region = torch.as_tensor(region, device=dev)
        onehot = (region[:, None] == torch.arange(self.n_regions, device=dev)
                  [None, :]).to(torch.float32)
        counts = onehot.sum(dim=0)                               # [R]
        mean = ((scores.to(torch.float32)[:, None] * onehot).sum(dim=0)
                / torch.clamp_min(counts, 1.0))
        visited = counts > 0
        first = state.visits == 0
        blended = torch.where(first, mean,
                              self.ema * state.score
                              + (1.0 - self.ema) * mean)
        return CurriculumState(
            score=torch.where(visited, blended, state.score),
            visits=state.visits + counts,
        )
