"""Meshes of the LM partition rules and the dry run.

Counterpart of ``repro/launch/mesh.py``. ``make_host_mesh`` is the
reference's ``("data", "model")`` mesh of shape (devices, 1) over what the
host has: a ``DeviceMesh`` over the process group's ranks (one per card),
or a shape-only (1, 1) without a group. ``make_production_mesh`` has the
reference's axis names and shape (16×16 for one pod, 2×16×16 for two) as a
``ShapeMesh``, for the static bytes (``launch/specs.py``), which read a
mesh's shape only. ``production_device_mesh`` is the same mesh as a real
``DeviceMesh``, over a fake process group of 256 or 512 ranks seen from
rank 0 (``fake_device_mesh``: PyTorch's ``fake`` backend, whose
collectives move nothing), on which the dry run runs the partitioned
steps on fake tensors: DTensor's sharding propagation, the collectives it
issues and each device's local shapes are those of a real group of that
size. The reference's TPU constants (peak FLOP/s, HBM and ICI rates of a
v5e chip) are not ported.
"""
from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch.distributed as dist


# the reference's production meshes: (shape, axis names)
PRODUCTION = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


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
    return ShapeMesh(*PRODUCTION["multi" if multi_pod else "single"])


@contextlib.contextmanager
def fake_device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` (axes ``names``, device type "cpu")
    over a fake process group of ``prod(shape)`` ranks, this process rank
    0: the context's value. Refuses to run beside a real group, and
    destroys the fake one on leaving, so that a later gloo or NCCL group in
    the same process is not taken over."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: the "
                           "fake mesh needs the process to itself")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", tuple(shape),
                               mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


def production_device_mesh(*, multi_pod: bool = False):
    """The reference's production mesh as a ``DeviceMesh`` over a fake
    group (``fake_device_mesh``): ("data", "model") 16×16, or ("pod",
    "data", "model") 2×16×16. A context manager."""
    return fake_device_mesh(*PRODUCTION["multi" if multi_pod else "single"])


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
