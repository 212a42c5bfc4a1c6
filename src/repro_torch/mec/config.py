"""MEC network configuration (paper §VI-A defaults).

Counterpart of ``repro/mec/config.py``: ``MECConfig`` is the static shape
of a network instance, ``ScenarioParams`` every numeric knob as float32
tensors on one device. Leaves may carry leading fleet axes (one scenario
per fleet, ``RolloutDriver(per_fleet_scenarios=True)``); every consumer
indexes a leaf's own axes from the end.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.mec.profiles import exit_profile_gpu


class ScenarioParams(NamedTuple):
    """Every numeric scenario knob as float32 tensors.

    Units are explicit in field names: ``*_kb`` kilobytes, ``*_mbps``
    megabits/s, ``*_bps`` bits/s, ``*_s`` seconds; probabilities and
    fractions are unitless in [0, 1]. The ``ar1_*``/``rate_bps`` tail is
    derived data, computed in float64 and rounded to float32 once, as the
    reference does.
    """
    task_kb: torch.Tensor            # [2] task size (lo, hi) in KB
    rate_mbps: torch.Tensor          # [2] uplink rate (lo, hi) in Mbps
    capacity_range: torch.Tensor     # [2] ES available fraction (lo, hi)
    inference_jitter: torch.Tensor   # scalar, ±fraction of t_cmp
    csi_error: torch.Tensor          # scalar, ±fraction rate-estimate error
    connectivity_drop: torch.Tensor  # scalar, P(device-ES link down)
    deadline_s: torch.Tensor         # scalar, per-task deadline (seconds)
    arrival_rate: torch.Tensor       # scalar, per-device P(task/slot), poisson
    mmpp_rates: torch.Tensor         # [2] (calm, burst) arrival prob
    mmpp_switch: torch.Tensor        # [2] (P(calm->burst), P(burst->calm))
    churn_prob: torch.Tensor         # scalar, per-slot P(join/leave)
    ar1_rho: torch.Tensor            # scalar, AR(1) autocorrelation
    exit_times_s: torch.Tensor       # [N, L] nominal per-exit seconds
    exit_acc: torch.Tensor           # [L] per-exit accuracy
    rate_bps: torch.Tensor           # [2] rate clip bounds in bits/s
    ar1_mu_rate: torch.Tensor        # scalar, AR(1) mean of rate (bps)
    ar1_noise_rate: torch.Tensor     # scalar, innovation std of rate
    ar1_mu_cap: torch.Tensor         # scalar, AR(1) mean of capacity
    ar1_noise_cap: torch.Tensor      # scalar, innovation std of capacity


# Fields a scenario sampler may vary freely; everything after these in the
# NamedTuple is either structural (exit tables) or derived.
PRIMITIVE_FIELDS = (
    "task_kb", "rate_mbps", "capacity_range", "inference_jitter",
    "csi_error", "connectivity_drop", "deadline_s", "arrival_rate",
    "mmpp_rates", "mmpp_switch", "churn_prob", "ar1_rho",
)


def derive_params(primitives: dict, exit_times_s, exit_acc) -> ScenarioParams:
    """Finish a ``ScenarioParams`` from primitive knobs, in float32.

    For sampled or interpolated scenarios (``ScenarioSpace.sample``,
    ``interpolate_params``): the AR(1) moments and bit-rate bounds are
    recomputed from the primitives, never interpolated. Leaves may carry
    leading batch axes; the device is the first primitive's.
    """
    dev = torch.as_tensor(primitives[PRIMITIVE_FIELDS[0]]).device

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    p = {k: f32(primitives[k]) for k in PRIMITIVE_FIELDS}
    rate_bps = p["rate_mbps"] * f32(1e6)
    cap = p["capacity_range"]
    rho = p["ar1_rho"]
    sqrt12 = f32(np.float32(np.sqrt(12.0)))
    c = torch.sqrt(torch.clamp_min(1.0 - rho * rho, 0.0))
    return ScenarioParams(
        **p,
        exit_times_s=f32(exit_times_s),
        exit_acc=f32(exit_acc),
        rate_bps=rate_bps,
        ar1_mu_rate=0.5 * (rate_bps[..., 0] + rate_bps[..., 1]),
        ar1_noise_rate=(rate_bps[..., 1] - rate_bps[..., 0]) / sqrt12 * c,
        ar1_mu_cap=0.5 * (cap[..., 0] + cap[..., 1]),
        ar1_noise_cap=(cap[..., 1] - cap[..., 0]) / sqrt12 * c,
    )


@dataclasses.dataclass(frozen=True)
class MECConfig:
    """Static description of one MEC network instance.

    Defaults reproduce §VI-A: 14 IoT devices, 2 ESs (RTX 2080TI + GTX
    1080TI), deadline 30 ms, task size 50–100 KB, uplink 20–100 Mbps,
    slot length τ = 30 ms, five candidate VGG-16 exits (Table I).
    """

    n_devices: int = 14
    n_servers: int = 2
    exit_times_s: Tuple[Tuple[float, ...], ...] = None  # type: ignore[assignment]
    exit_accuracy: Tuple[float, ...] = None             # type: ignore[assignment]
    slot_s: float = 30e-3                # τ
    deadline_s: float = 30e-3            # δ
    task_kbytes: Tuple[float, float] = (50.0, 100.0)
    rate_mbps: Tuple[float, float] = (20.0, 100.0)
    capacity_range: Tuple[float, float] = (1.0, 1.0)
    inference_jitter: float = 0.0
    csi_error: float = 0.0
    connectivity_drop: float = 0.0
    early_exit: bool = True
    workload: str = "iid"                # "iid" | "poisson" | "mmpp"
    arrival_rate: float = 1.0
    mmpp_rates: Tuple[float, float] = (0.25, 0.95)
    mmpp_switch: Tuple[float, float] = (0.08, 0.25)
    churn_prob: float = 0.0
    ar1_rho: float = 0.0

    def __post_init__(self):
        if self.exit_times_s is None:
            times, acc = exit_profile_gpu()
            times = times[: self.n_servers]
            if times.shape[0] < self.n_servers:
                # replicate profile cyclically for N > 2 what-if scenarios
                reps = int(np.ceil(self.n_servers / times.shape[0]))
                times = np.tile(times, (reps, 1))[: self.n_servers]
            object.__setattr__(self, "exit_times_s",
                               tuple(map(tuple, times.tolist())))
            object.__setattr__(self, "exit_accuracy", tuple(acc.tolist()))

    @property
    def n_exits(self) -> int:
        return len(self.exit_accuracy)

    @property
    def n_options(self) -> int:
        """Per-device action arity: one (server, exit) pair."""
        return self.n_servers * self.n_exits

    def exit_times(self) -> np.ndarray:
        return np.asarray(self.exit_times_s, dtype=np.float32)

    def accuracies(self) -> np.ndarray:
        return np.asarray(self.exit_accuracy, dtype=np.float32)

    def static_signature(self) -> tuple:
        """Everything that shapes the program (not its numbers)."""
        return (self.n_devices, self.n_servers, self.n_exits,
                self.workload, self.early_exit, self.slot_s)

    def scenario_params(self, device) -> ScenarioParams:
        """This config's numeric knobs as float32 tensors on ``device``.

        Derived fields are computed in float64 and rounded to float32
        once, with the AR(1) noise terms rounded separately and multiplied
        in float32 — the reference's arithmetic, bit for bit.
        """
        def f32(v):
            return torch.tensor(np.asarray(v, np.float64), dtype=torch.float32,
                                device=device)

        def t32(v):
            return torch.tensor(np.asarray(v, np.float32), device=device)

        r_lo, r_hi = self.rate_mbps
        c_lo, c_hi = self.capacity_range
        rho = float(self.ar1_rho)
        c = np.float32(np.sqrt(max(1.0 - rho ** 2, 0.0)))
        return ScenarioParams(
            task_kb=f32(self.task_kbytes),
            rate_mbps=f32(self.rate_mbps),
            capacity_range=f32(self.capacity_range),
            inference_jitter=f32(self.inference_jitter),
            csi_error=f32(self.csi_error),
            connectivity_drop=f32(self.connectivity_drop),
            deadline_s=f32(self.deadline_s),
            arrival_rate=f32(min(max(float(self.arrival_rate), 0.0), 1.0)),
            mmpp_rates=f32(self.mmpp_rates),
            mmpp_switch=f32(self.mmpp_switch),
            churn_prob=f32(self.churn_prob),
            ar1_rho=f32(rho),
            exit_times_s=t32(self.exit_times()),
            exit_acc=t32(self.accuracies()),
            rate_bps=f32((r_lo * 1e6, r_hi * 1e6)),
            ar1_mu_rate=f32(0.5 * (r_lo * 1e6 + r_hi * 1e6)),
            ar1_noise_rate=t32(
                np.float32((r_hi * 1e6 - r_lo * 1e6) / np.sqrt(12.0)) * c),
            ar1_mu_cap=f32(0.5 * (c_lo + c_hi)),
            ar1_noise_cap=t32(np.float32((c_hi - c_lo) / np.sqrt(12.0)) * c),
        )
