"""Named experiment scenarios — one per paper figure (§VI-D) — and
continuous *scenario spaces* over them.

Counterpart of ``repro/mec/scenarios.py``:

* ``scenario_params(name, ...)`` — a named scenario's knobs as tensors;
* ``interpolate_params(a, b, t)`` — convex blends between two scenarios
  (derived AR(1) moments recomputed, never interpolated);
* ``ScenarioSpace`` / ``scenario_space(...)`` — a box spanned by two
  corner scenarios, with ``sample``/``sample_batch`` for
  domain-randomized fleets: pass a ``sample_batch(generator, B)`` draw to
  ``RolloutDriver(..., per_fleet_scenarios=True)`` and every fleet runs
  under its own dynamics in one episode;
* space-draw names ``space:<lo>:<hi>:<draw>:<seed>``, ``resolve_scenario``
  and ``expand_grid`` for sweep grids.

The draws come from a ``torch.Generator`` (or are injected as uniforms),
not from threefry: the reference's ``fold_in(PRNGKey(seed), draw)`` for a
space name becomes a CPU generator seeded from ``(seed, draw)``, so a
name means one scenario on every device, but not the reference's.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.mec.config import (PRIMITIVE_FIELDS, MECConfig,
                                    ScenarioParams, derive_params)


def make_scenario(name: str, *, n_devices: int = 14, slot_ms: float = 30.0,
                  early_exit: bool = True, **overrides) -> MECConfig:
    base = dict(n_devices=n_devices, slot_s=slot_ms * 1e-3, early_exit=early_exit)
    base.update(SCENARIOS[name])
    base.update(overrides)
    return MECConfig(**base)


# Fig 5: ideal ESs. Fig 6: stochastic capacity 25..100%. Fig 7: + ±25%
# inference-time jitter. Fig 8: + ±20% CSI error.
SCENARIOS = {
    "fig5_baseline": dict(),
    "fig6_capacity": dict(capacity_range=(0.25, 1.0)),
    "fig7_jitter": dict(capacity_range=(0.25, 1.0), inference_jitter=0.25),
    "fig8_csi": dict(capacity_range=(0.25, 1.0), inference_jitter=0.25,
                     csi_error=0.20),
    # extra (beyond-paper) stressor: dynamic topology
    "dyn_topology": dict(capacity_range=(0.25, 1.0), inference_jitter=0.25,
                         csi_error=0.20, connectivity_drop=0.15),
    "dyn_poisson": dict(capacity_range=(0.25, 1.0), workload="poisson",
                        arrival_rate=0.7),
    "dyn_bursty": dict(capacity_range=(0.25, 1.0), workload="mmpp",
                       mmpp_rates=(0.2, 0.95), mmpp_switch=(0.05, 0.2)),
    "dyn_churn": dict(capacity_range=(0.25, 1.0), workload="poisson",
                      arrival_rate=0.8, churn_prob=0.02),
    "dyn_markov_channel": dict(capacity_range=(0.25, 1.0), workload="poisson",
                               arrival_rate=0.9, ar1_rho=0.9,
                               inference_jitter=0.25, csi_error=0.20),
}

# Scenario families, in paper order — handy for sweep specs.
PAPER_FIGURES = ("fig5_baseline", "fig6_capacity", "fig7_jitter", "fig8_csi")
DYNAMIC_SCENARIOS = tuple(n for n in SCENARIOS if n.startswith("dyn_"))


def scenario_grid(names=None, device_counts=(6, 8, 10, 12, 14),
                  slot_lengths_ms=(10.0, 30.0)):
    """The benchmark sweep used by Figs 5-8."""
    names = names or list(SCENARIOS)
    for name in names:
        for m in device_counts:
            for tau in slot_lengths_ms:
                yield name, m, tau


# --------------------------------------------------------- scenario spaces
def scenario_params(name: str, *, device=None, **kwargs) -> ScenarioParams:
    """A named scenario's numeric knobs as float32 tensors on ``device``
    (the card unless asked otherwise); ``kwargs`` go to
    ``make_scenario``."""
    return make_scenario(name, **kwargs).scenario_params(
        resolve_device(device))


def interpolate_params(a: ScenarioParams, b: ScenarioParams,
                       t) -> ScenarioParams:
    """Convex blend ``(1-t)*a + t*b`` over primitive knobs. Derived fields
    are recomputed from the blended primitives; exit tables interpolate
    linearly (both ends must share [N, L] shape)."""
    t = torch.as_tensor(t, dtype=torch.float32, device=a.task_kb.device)
    prim = {k: (1.0 - t) * getattr(a, k) + t * getattr(b, k)
            for k in PRIMITIVE_FIELDS}
    return derive_params(prim,
                         (1.0 - t) * a.exit_times_s + t * b.exit_times_s,
                         (1.0 - t) * a.exit_acc + t * b.exit_acc)


@dataclasses.dataclass(frozen=True)
class ScenarioSpace:
    """A box in scenario-knob space spanned by two corner pytrees.

    ``sample`` draws every primitive knob independently and uniformly
    between the corners (structure — exit tables — comes from ``lo``);
    ``sample_batch`` stacks B independent draws along a leading fleet
    axis. The uniforms come from the caller's generator, one per element
    of each primitive field in ``PRIMITIVE_FIELDS`` order, or are given
    (``uniforms``: field -> tensor of the field's shape, with the batch
    axis in front for ``sample_batch``) — the seam the tests feed with
    the reference's draws.
    """
    lo: ScenarioParams
    hi: ScenarioParams

    # (lo, hi) interval knobs: drawn element-wise then sorted, so corners
    # with disjoint intervals can never yield an inverted range
    _INTERVAL_FIELDS = ("task_kb", "rate_mbps", "capacity_range")

    def _uniforms(self, generator: torch.Generator, batch) -> dict:
        return {f: torch.rand(batch + tuple(getattr(self.lo, f).shape),
                              generator=generator, device=generator.device)
                for f in PRIMITIVE_FIELDS}

    def _draw(self, u: dict) -> ScenarioParams:
        prim = {}
        for field in PRIMITIVE_FIELDS:
            lo, hi = getattr(self.lo, field), getattr(self.hi, field)
            v = lo + torch.as_tensor(u[field], dtype=torch.float32,
                                     device=lo.device) * (hi - lo)
            prim[field] = (torch.sort(v, dim=-1).values
                           if field in self._INTERVAL_FIELDS else v)
        lead = tuple(prim["task_kb"].shape[:-1])     # the batch axes

        def tile(x):
            return x.expand(lead + tuple(x.shape)).clone()

        return derive_params(prim, tile(self.lo.exit_times_s),
                             tile(self.lo.exit_acc))

    def sample(self, generator: Optional[torch.Generator] = None, *,
               uniforms: Optional[dict] = None) -> ScenarioParams:
        """One uniform draw from the box -> unbatched ``ScenarioParams``."""
        return self._draw(uniforms if uniforms is not None
                          else self._uniforms(generator, ()))

    def sample_batch(self, generator: Optional[torch.Generator] = None,
                     n: Optional[int] = None, *,
                     uniforms: Optional[dict] = None) -> ScenarioParams:
        """[n]-leading stack of independent draws, drawn one after the
        other (draw i is the i-th ``sample`` from ``generator``), or from
        ``uniforms`` with a leading [n] on every field."""
        if uniforms is None:
            draws = [self.sample(generator) for _ in range(n)]
            return ScenarioParams(*(torch.stack(xs) for xs in zip(*draws)))
        return self._draw(uniforms)


def scenario_space(lo: str = "fig5_baseline", hi: str = "fig8_csi", *,
                   device=None, **kwargs) -> ScenarioSpace:
    """Space spanned by two *named* scenarios (same structural shape), on
    ``device`` (the card unless asked otherwise); ``kwargs`` go to
    ``make_scenario`` for both corners. Example::

        space = scenario_space("fig5_baseline", "fig8_csi", n_devices=8)
        sp = space.sample_batch(generator, n_fleets)   # [B]-leading
        driver = RolloutDriver(adef, n_fleets, per_fleet_scenarios=True)
        carry, trace = driver.run(seed, n_slots, sp=sp)
    """
    a = make_scenario(lo, **kwargs)
    b = make_scenario(hi, **kwargs)
    if a.static_signature() != b.static_signature():
        raise ValueError(
            f"corner scenarios differ structurally: {a.static_signature()}"
            f" vs {b.static_signature()}; a space needs one compiled shape")
    dev = resolve_device(device)
    return ScenarioSpace(lo=a.scenario_params(dev), hi=b.scenario_params(dev))


# ------------------------------------------------- space-draw scenarios
# A sweep-grid column can be one *draw* from a ScenarioSpace instead of a
# named scenario, addressed by "space:<lo>:<hi>:<draw>:<seed>", so sweep
# cells stay plain hashable tuples.
SPACE_PREFIX = "space:"


def space_scenario_name(lo: str, hi: str, draw: int,
                        space_seed: int = 0) -> str:
    """The canonical name of one deterministic draw from the (lo, hi)
    scenario space."""
    return f"{SPACE_PREFIX}{lo}:{hi}:{int(draw)}:{int(space_seed)}"


def is_space_scenario(name: str) -> bool:
    return isinstance(name, str) and name.startswith(SPACE_PREFIX)


def parse_space_scenario(name: str):
    """``space:<lo>:<hi>:<draw>:<seed>`` -> (lo, hi, draw, seed).

    Corners must be named scenarios; draw/seed must be ints. Raises
    ``ValueError`` on anything else.
    """
    parts = name.split(":")
    if len(parts) != 5 or parts[0] != "space":
        raise ValueError(
            f"malformed space scenario {name!r}; expected "
            f"'space:<lo>:<hi>:<draw>:<seed>'")
    _, lo, hi, draw, seed = parts
    for corner in (lo, hi):
        if corner not in SCENARIOS:
            raise ValueError(f"space corner {corner!r} not in "
                             f"{sorted(SCENARIOS)}")
    try:
        draw_i, seed_i = int(draw), int(seed)
    except ValueError:
        raise ValueError(f"space draw/seed must be ints in {name!r}")
    return lo, hi, draw_i, seed_i


def space_generator(seed: int, draw: int) -> torch.Generator:
    """The CPU generator of draw ``draw`` under ``seed``: seeded from the
    pair alone, so a draw does not depend on how many others there are."""
    state = np.random.SeedSequence([int(seed), int(draw)]).generate_state(2)
    return torch.Generator().manual_seed(
        (int(state[0]) | int(state[1]) << 32) & (2 ** 63 - 1))


def resolve_scenario(name: str, *, device=None, **kwargs):
    """Name -> ``(MECConfig, Optional[ScenarioParams])``.

    Named scenarios resolve to their config and ``None`` (the env's own
    params apply). Space names resolve to the *lo corner's* config plus
    the draw's sampled knobs on ``device``: one ``sample`` from
    ``space_generator(seed, draw)``. ``kwargs`` go to ``make_scenario``.
    """
    if not is_space_scenario(name):
        return make_scenario(name, **kwargs), None
    lo, hi, draw, seed = parse_space_scenario(name)
    space = scenario_space(lo, hi, device="cpu", **kwargs)
    sp = space.sample(space_generator(seed, draw))
    dev = resolve_device(device)
    return make_scenario(lo, **kwargs), ScenarioParams(
        *(x.to(dev) for x in sp))


def expand_grid(names=None, **axes):
    """Cartesian expansion of scenario names with config-override axes:
    every (name, override-combination) pair as ``(name, overrides_dict)``
    in deterministic order, e.g.

        expand_grid(PAPER_FIGURES, n_devices=(6, 14))
          -> ("fig5_baseline", {"n_devices": 6}), ...
    """
    names = list(names) if names is not None else list(SCENARIOS)
    keys = sorted(axes)
    value_lists = [list(axes[k]) for k in keys]
    for name in names:
        for combo in itertools.product(*value_lists):
            yield name, dict(zip(keys, combo))
