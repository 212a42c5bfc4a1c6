"""Early-exit accuracy/latency profile: the paper's Table I.

Counterpart of ``repro/mec/profiles.py`` (Table I part only; the analytic
roofline profiles there rest on TPU constants and are not ported).
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
