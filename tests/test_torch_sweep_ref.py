"""The port's sweep rows against the reference's ``sweep.run_cell``.

For each cell the reference's initial params (``adef.init(cell_keys(cell)
[0])``, carried across with ``core/bridge.py``) and the draws of its run
key (tasks or the workload's raw uniforms, exploration candidates,
minibatch rows; ``tools/make_torch_port_golden.py::sweep_cell_reference``)
go into the port's ``run_cell`` seams. Cells here: fig5_baseline with
all four methods and dyn_bursty (mmpp) with GRLE and DROOE
(``tests/test_torch_sweep_ref_csi.py``: fig8_csi with all four), seeds 0
and 1, at M=3, T=30, ring 16, minibatch 4, a train step every 5 slots.
``tasks`` and ``train_steps`` must be equal and the §VI-D metrics and the
last loss within ``ROW_RTOL``. DROO's critic meets exact ties (symmetric
assignments whose Q differs by summation order), so a DROO cell is held
in full where the reference's replay on the draws records no near-tie,
and otherwise on the port driver's trace against that replay up to its
first recorded near-tie (the rule of ``tests/test_torch_rollout.py::
first_flip``), where the reference's own driver and replay may part.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import agent_state_from_params
from repro_torch.mec import MECEnv
from repro_torch.sweep import SweepSpec
from repro_torch.sweep.runner import _cell_def, _resolve_cell, _run_cell

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import make_torch_port_golden as golden_tool  # noqa: E402

sys.path.pop(0)
torch.set_num_threads(1)

ROW_RTOL = 1e-5     # relative, the §VI-D metrics and final_loss
TRACE_TOL = 1e-5    # reward and q_est on the trace, relative
NEAR_TIE = 1e-5     # a recorded critic or actor margin this small is a tie
ROW_KEYS = ("avg_accuracy", "ssp", "deadline_miss", "throughput_tps",
            "avg_reward", "final_loss")
SIZE = dict(seeds=(0, 1), n_devices=3, n_slots=30, replay_capacity=16,
            batch_size=4, train_every=5)
CELLS = (SweepSpec(scenarios=("fig5_baseline",), **SIZE).expand()
         + SweepSpec(scenarios=("dyn_bursty",), methods=("grle", "drooe"),
                     **SIZE).expand())


def assert_rows_agree(row, want, label):
    assert row["tasks"] == want["tasks"], label
    assert row["train_steps"] == want["train_steps"] > 0, label
    for k in ROW_KEYS:
        np.testing.assert_allclose(row[k], want[k], rtol=ROW_RTOL, atol=0,
                                   err_msg=f"{label}: {k}")


def hold_cell(cell):
    """The port's ``run_cell`` on the reference's params and draws against
    the reference's ``run_cell`` (DROO: under the near-tie rule)."""
    from repro.sweep import run_cell as reference_run_cell

    droo = cell.method == "droo"
    data = golden_tool.sweep_cell_reference(cell, replay=droo)
    cfg, _ = _resolve_cell(cell, torch.device("cpu"))
    env = MECEnv(cfg, device="cpu")
    state = agent_state_from_params(
        _cell_def(cell, env), golden_tool.tree_of(data, "init_params"),
        data["exit_mask"])
    row, _, trace = _run_cell(cell, device="cpu", agent_state=state,
                              draws=golden_tool.port_slot_draws(data))
    want = reference_run_cell(cell)
    assert (row["scenario"], row["method"], row["seed"], row["cell"]) == (
        want["scenario"], want["method"], want["seed"], want["cell"])
    ties = np.flatnonzero(np.minimum(data["q_margin"], data["xhat_margin"])
                          .min(-1) <= NEAR_TIE) if droo else ()
    if not len(ties):
        assert_rows_agree(row, want, cell.label())
        return
    cut = slice(0, int(ties[0]))
    np.testing.assert_array_equal(trace.decisions.numpy()[cut],
                                  data["replay/decisions"][cut])
    np.testing.assert_allclose(trace.reward.numpy()[cut],
                               data["replay/reward"][cut], rtol=TRACE_TOL,
                               atol=1e-7)
    np.testing.assert_allclose(trace.q_est.numpy()[cut],
                               data["replay/q_est"][cut], rtol=TRACE_TOL)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c.label())
def test_row_equals_reference_run_cell(cell):
    hold_cell(cell)
