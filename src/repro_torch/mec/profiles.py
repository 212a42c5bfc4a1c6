"""Early-exit accuracy/latency profiles: the paper's Table I and analytic
ones for VGG-16 and decoder LMs.

Counterpart of ``repro/mec/profiles.py``. ``exit_profile_roofline`` (the
reference's ``exit_profile_tpu_v5e``, renamed) and ``llm_exit_profile``
model the edge server by its roofline figures, keyword arguments
``peak_flops``/``hbm_bw`` whose defaults are the NVIDIA H100 SXM's
published ones (dense bf16 FLOP/s, HBM bytes/s), so with default
arguments the exit table is this card's; pass another accelerator's
figures to model it.
"""
from __future__ import annotations

import numpy as np

# Paper Table I — candidate early-exits of VGG-16.
# columns: exit number (in the 17-exit enumeration), accuracy,
#          inference ms on RTX 2080TI, inference ms on GTX 1080TI.
VGG16_TABLE_I = {
    "exit_no": np.array([1, 3, 4, 7, 17]),
    "accuracy": np.array([0.800, 0.850, 0.885, 0.905, 0.935]),
    "ms_rtx2080ti": np.array([0.36, 0.46, 0.54, 0.71, 1.26]),
    "ms_gtx1080ti": np.array([0.73, 0.89, 1.06, 1.40, 2.42]),
}

# Indices (into the 17-exit enumeration) of the five candidate exits.
CANDIDATE_EXITS = (1, 3, 4, 7, 17)


def exit_profile_gpu():
    """(exit_times_s [N=2, L=5], exit_acc [L=5]) — the paper's two ESs."""
    times_ms = np.stack(
        [VGG16_TABLE_I["ms_rtx2080ti"], VGG16_TABLE_I["ms_gtx1080ti"]])
    return times_ms * 1e-3, VGG16_TABLE_I["accuracy"].copy()


# NVIDIA H100 SXM, published: dense bf16 tensor-core FLOP/s, HBM3 bytes/s.
H100_PEAK_BF16_FLOPS = 989e12
H100_HBM_BW = 3.35e12
# fixed per-step overhead of a decode step, seconds (the reference's)
STEP_OVERHEAD_S = 50e-6

# VGG-16 (CIFAR-10, 32x32 input) cumulative GFLOPs up to each of the five
# candidate exits (conv MACs*2 + classifier), batch 1.
_VGG16_CUM_GFLOPS = np.array([0.0049, 0.0769, 0.1147, 0.2314, 0.6280])
_VGG16_CUM_MBYTES = np.array([0.35, 1.6, 2.4, 5.1, 30.0])  # weights+acts touched


def exit_profile_roofline(derate: float = 0.15, *,
                          peak_flops: float = H100_PEAK_BF16_FLOPS,
                          hbm_bw: float = H100_HBM_BW):
    """Roofline latency of each VGG-16 candidate exit on one accelerator of
    ``peak_flops`` FLOP/s and ``hbm_bw`` bytes/s.

    ``derate`` models the achievable fraction of peak for small conv
    batches. Latency = max(compute term, memory term) + the fixed
    ``STEP_OVERHEAD_S``. Returns (times_s [1, 5], accuracy [5]: Table I's).
    """
    t_comp = _VGG16_CUM_GFLOPS * 1e9 / (peak_flops * derate)
    t_mem = _VGG16_CUM_MBYTES * 1e6 / hbm_bw
    times = np.maximum(t_comp, t_mem) + STEP_OVERHEAD_S
    return times[None, :], VGG16_TABLE_I["accuracy"].copy()


def llm_exit_profile(n_layers: int, d_model: int, d_ff: int, vocab: int,
                     exits: tuple, *, n_chips: int = 1,
                     seq_len: int = 1, kv_len: int = 4096,
                     quality_floor: float = 0.72, quality_ceil: float = 0.95,
                     peak_flops: float = H100_PEAK_BF16_FLOPS,
                     hbm_bw: float = H100_HBM_BW):
    """Analytic early-exit profile for a decoder-only transformer.

    * latency(exit) from the decode-step roofline of a replica with
      ``peak_flops`` FLOP/s and ``hbm_bw`` bytes/s per card (bf16 weights
      and K/V up to that layer, plus the LM head), the larger of the
      memory and compute terms plus ``STEP_OVERHEAD_S`` a step;
    * quality(exit) from the log-depth early-exit scaling of the
      multi-exit literature (deeper exits saturate, as in the paper's
      Fig. 3).

    Returns (times_s [1, len(exits)], quality [len(exits)]).
    """
    exits = np.asarray(exits)
    per_layer_params = 4 * d_model * d_model + 3 * d_model * d_ff
    bytes_per_layer = 2.0 * per_layer_params            # bf16 weights
    kv_bytes_per_layer = 2 * 2.0 * kv_len * d_model     # K and V, bf16 (MHA upper bound)
    head_bytes = 2.0 * d_model * vocab
    cum_bytes = exits * (bytes_per_layer + kv_bytes_per_layer) + head_bytes
    t_mem = cum_bytes / (hbm_bw * n_chips)
    cum_flops = seq_len * 2.0 * (exits * per_layer_params + d_model * vocab)
    t_comp = cum_flops / (peak_flops * n_chips)
    times = np.maximum(t_mem, t_comp) + STEP_OVERHEAD_S
    # saturating quality curve in depth (the paper's Fig 3 shape)
    frac = np.log1p(exits) / np.log1p(n_layers)
    quality = quality_floor + (quality_ceil - quality_floor) * frac
    return times[None, :], quality
