"""Meshes of the LM partition rules and the dry run.

Counterpart of ``repro/launch/mesh.py``. ``make_host_mesh`` is the
reference's ``("data", "model")`` mesh of shape (devices, 1) over what the
host has: a ``DeviceMesh`` over the process group's ranks (one per card),
or a shape-only (1, 1) without a group. ``make_production_mesh`` has the
reference's axis names and shape (16×16 for one pod, 2×16×16 for two) as a
``ShapeMesh``: the partition rules and the dry run read a mesh's shape
only, and there is no 256-card group to build a ``DeviceMesh`` over. The
reference's TPU constants (peak FLOP/s, HBM and ICI rates of a v5e chip)
are not ported.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch.distributed as dist


class ShapeMesh:
    """A mesh's axis names and sizes, without devices: the parts of a
    ``DeviceMesh``'s interface the partition rules read (``shape``,
    ``mesh_dim_names``, ``size()``)."""

    def __init__(self, shape: Tuple[int, ...], names: Tuple[str, ...]):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} and names {names}")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(names)

    def size(self) -> int:
        return math.prod(self.shape)

    def __repr__(self) -> str:
        return "ShapeMesh(" + ", ".join(
            f"{n}={s}" for n, s in zip(self.mesh_dim_names, self.shape)) + ")"


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The reference's production mesh, shape only: ("data", "model")
    16×16, or ("pod", "data", "model") 2×16×16."""
    if multi_pod:
        return ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    return ShapeMesh((16, 16), ("data", "model"))


def make_host_mesh():
    """("data", "model") of shape (ranks, 1): a ``DeviceMesh`` over the
    process group (NCCL: the cards; gloo: CPU processes), or a shape-only
    (1, 1) without one."""
    if not (dist.is_available() and dist.is_initialized()):
        return ShapeMesh((1, 1), ("data", "model"))
    from torch.distributed.device_mesh import init_device_mesh
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))
