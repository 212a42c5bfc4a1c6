"""The port's sweep rows against the reference's ``sweep.run_cell`` on
fig8_csi (Fig 8: capacity, inference jitter and CSI error), all four
methods, seeds 0 and 1, by ``tests/test_torch_sweep_ref.py::hold_cell``
(same sizes and tolerances; DROO under the near-tie rule)."""
import pytest

from repro_torch.sweep import SweepSpec
from test_torch_sweep_ref import SIZE, hold_cell

CELLS = SweepSpec(scenarios=("fig8_csi",), **SIZE).expand()


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c.label())
def test_row_equals_reference_run_cell(cell):
    hold_cell(cell)
