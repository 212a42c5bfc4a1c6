"""Resumable on-disk result store, keyed by cell hash.

Counterpart of ``repro/sweep/store.py``. One JSON file per cell under the
store root. ``cell_hash`` covers every run-affecting field of the cell,
so a hash hit is a guarantee that the stored numbers are the ones this
sweep would produce — on the same backend. The hashes are the
reference's, so a reference row and a port row of one cell share a file
name; and a CPU row is not a CUDA row. Every row the port writes carries
its ``backend`` (``"torch-cuda"`` or ``"torch-cpu"``) and ``device_name``,
and ``load(cell, backend=...)`` refuses a file of another backend (or of
none: the reference's), naming the store. Finished cells are never
rewritten (``save`` refuses to clobber), which makes a killed-then-resumed
sweep reuse them byte-identically.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch.sweep.spec import Cell


class ForeignRowError(ValueError):
    """A stored row that another backend (or the reference) wrote."""


class SweepStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path(self, cell: Cell) -> str:
        return os.path.join(self.root, f"{cell.cell_hash}.json")

    def has(self, cell: Cell) -> bool:
        return os.path.exists(self.path(cell))

    def load(self, cell: Cell, *, backend: Optional[str] = None) -> dict:
        """The stored row; with ``backend``, raise ``ForeignRowError``
        unless the row says it was written by that backend."""
        with open(self.path(cell)) as f:
            row = json.load(f)
        if backend is not None and row.get("backend") != backend:
            raise ForeignRowError(
                f"sweep store {self.root!r}: {os.path.basename(self.path(cell))}"
                f" ({cell.label()}) was written by backend "
                f"{row.get('backend')!r}, not {backend!r}; this sweep never "
                f"reuses another backend's rows: pass another store")
        return row

    def save(self, cell: Cell, row: dict) -> str:
        """Write a cell's row; existing results are left untouched."""
        path = self.path(cell)
        if os.path.exists(path):
            return path
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(row, f, sort_keys=True, indent=1)
        os.replace(tmp, path)   # atomic: a killed sweep leaves no torn file
        return path

    def completed(self) -> int:
        return len([p for p in os.listdir(self.root)
                    if p.endswith(".json")])
