"""The fleet/cell/member batch axis over the cards.

Counterpart of ``repro/sharding/fleet.py``, whose 1-D ``jax.sharding.Mesh``
splits a sweep's cells, a population's members or a driver's fleets over
the local devices. Here the mesh is a 1-D ``torch.distributed.device_mesh.
DeviceMesh`` named ``("fleet",)`` over the ranks of a process group, one
process per card (``torchrun --nproc-per-node N``; ``init_from_env`` joins
the group torchrun describes), and the reference's shardings become what
each rank holds: ``P("fleet")`` a contiguous slice of the leading axis
(``shard_leading_axis``; ``gather_leading`` puts the slices back together
in rank order), ``P()`` the same tree on every rank (``replicate``, a
broadcast from rank 0). The collectives run over NCCL on the card and over
gloo on the CPU; every one of them packs the tree's tensors into one byte
buffer, so a tree costs one collective whatever its leaves.

With one rank ``fleet_mesh()`` is None, the reference's single-device
answer, and every helper is the identity for it. Without a process group
the port uses one card even where more are visible: ``mesh_note`` says so,
and how to run on N.
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.nn.pytree import tree_refill, tree_tensors

FLEET_AXIS = "fleet"
# the kernels of the fleet/cell/member paths (the GRLE actor)
ACTOR_KERNELS = ("gcn_agg", "edge_score")


def group_up() -> bool:
    """Whether this process belongs to an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def init_from_env(device: torch.device) -> bool:
    """Join the process group that ``torchrun``'s environment describes
    (``WORLD_SIZE`` > 1) unless one is up: NCCL on ``cuda:LOCAL_RANK``
    (made the current device), gloo on the CPU. On the card the node's
    local rank 0 builds the actor kernels first and the others wait for it
    at a barrier, so no two ranks run ``nvcc`` at once. Returns whether this
    call started the group (its caller then ends it: ``leave``)."""
    if group_up() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device("cuda", local))
        if local == 0:
            from repro_torch.kernels import _build
            _build.build_all(ACTOR_KERNELS)
        dist.barrier()
    else:
        dist.init_process_group("gloo")
    return True


def leave(started: bool) -> None:
    """End the process group ``init_from_env`` started (``started``)."""
    if started and group_up():
        dist.destroy_process_group()


def fleet_mesh(n_devices: Optional[int] = None):
    """1-D ``DeviceMesh`` named ``("fleet",)`` over every rank of the
    process group, or ``None`` with one rank (or no group and
    ``n_devices`` None or 1). Asking for more devices than the group has
    ranks raises, and so does asking for fewer than all but one: the mesh
    is never quietly smaller than asked for."""
    world = dist.get_world_size() if group_up() else 1
    n = world if n_devices is None else int(n_devices)
    if n > world:
        hint = ("" if group_up() else
                "; start one process per card: torchrun --nproc-per-node "
                f"{n} ...")
        raise ValueError(f"a fleet mesh over {n} devices, but the process "
                         f"group has {world} rank(s){hint}")
    if n <= 1:
        return None
    if n != world:
        raise ValueError(f"a fleet mesh spans every rank of the group: "
                         f"{n} devices asked for, {world} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (world,), mesh_dim_names=(FLEET_AXIS,))


def mesh_size(mesh) -> int:
    """Devices of the mesh: 1 for ``None``."""
    return 1 if mesh is None else mesh.size()


def mesh_note(mesh, axis: str, command: str) -> str:
    """The launchers' line: the reference's "<axis> axis over N devices",
    or "single device" with how to run on N cards (and, where more are
    visible, that one of them is in use)."""
    if mesh is not None:
        return f"{axis} axis over {mesh.size()} devices"
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    busy = f", one of {seen} visible cards in use" if seen > 1 else ""
    return (f"single device{busy} (on N cards: torchrun --nproc-per-node N "
            f"-m repro_torch.launch {command} ...)")


def pad_to_devices(n_items: int, mesh) -> int:
    """Smallest count >= n_items divisible by the mesh's device count:
    ``n_items`` itself without a mesh."""
    if mesh is None:
        return n_items
    d = mesh.size()
    return ((n_items + d - 1) // d) * d


def local_slice(n_items: int, mesh) -> slice:
    """This rank's contiguous block of a leading axis of ``n_items`` laid
    out as ``P("fleet")``; ``n_items`` must divide the device count."""
    d = mesh_size(mesh)
    if n_items % d:
        raise ValueError(f"leading axis {n_items} not divisible by {d} "
                         f"devices (pad it with pad_to_devices)")
    k = n_items // d
    r = 0 if mesh is None else mesh.get_local_rank()
    return slice(r * k, (r + 1) * k)


def shard_leading_axis(tree, mesh):
    """This rank's slice of every tensor's leading axis (``P("fleet")``);
    leading dims must divide the device count (use ``pad_to_devices``).
    ``mesh=None`` returns ``tree`` untouched."""
    if mesh is None:
        return tree
    return tree_refill(tree, (x[local_slice(x.shape[0], mesh)]
                              for x in tree_tensors(tree)))


# ----------------------------------------------------------- byte packing
def pack_rows(tensors: List[torch.Tensor]) -> torch.Tensor:
    """Tensors with one leading length n -> uint8 [n, bytes of a row of
    each, side by side] (``unpack_rows`` is the inverse)."""
    return torch.cat([x.contiguous().reshape(x.shape[0], -1)
                      .view(torch.uint8) for x in tensors], dim=1)


def unpack_rows(buf: torch.Tensor, like: List[torch.Tensor]
                ) -> List[torch.Tensor]:
    """uint8 [n', bytes] -> tensors of ``like``'s dtypes and trailing
    shapes with leading length n' (``like`` is what was packed)."""
    out, at, n = [], 0, buf.shape[0]
    for x in like:
        width = x[0].numel() * x.element_size()
        col = buf[:, at:at + width].contiguous()
        out.append(col.view(x.dtype).reshape((n,) + tuple(x.shape[1:])))
        at += width
    return out


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    # ``all_gather_single`` is the newer name of ``all_gather_into_tensor``
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def gather_rows(recv: torch.Tensor, send: torch.Tensor, mesh) -> None:
    """All-gather a packed [n, bytes] buffer into ``recv`` [world*n,
    bytes]: rank r's rows at r*n.., so rows come in the leading axis'
    order."""
    _all_gather(recv, send, mesh.get_group())


def gather_leading(tree, mesh):
    """The inverse of ``shard_leading_axis``: every tensor's slices from
    all ranks joined along the leading axis in rank order, on every rank
    (one all-gather of the packed tree; the tensors must share their
    leading length). ``mesh=None`` returns ``tree`` untouched."""
    if mesh is None:
        return tree
    xs = tree_tensors(tree)
    if not xs:
        return tree
    if len({x.shape[0] for x in xs}) != 1:
        raise ValueError("gather_leading: the tensors' leading lengths "
                         f"differ: {sorted({x.shape[0] for x in xs})}")
    send = pack_rows(xs)
    recv = send.new_empty((mesh.size() * send.shape[0], send.shape[1]))
    gather_rows(recv, send, mesh)
    return tree_refill(tree, iter(unpack_rows(recv, xs)))


def replicate(tree, mesh):
    """Every tensor as rank 0 of the mesh holds it, on every rank (one
    broadcast of the packed tree: ``P()``). ``mesh=None`` returns ``tree``
    untouched."""
    if mesh is None:
        return tree
    xs = tree_tensors(tree)
    if not xs:
        return tree
    flat = torch.cat([x.contiguous().reshape(-1).view(torch.uint8)
                      for x in xs])
    group = mesh.get_group()
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    out, at = [], 0
    for x in xs:
        n = x.numel() * x.element_size()
        out.append(flat[at:at + n].clone().view(x.dtype).reshape(x.shape))
        at += n
    return tree_refill(tree, iter(out))


def gather_objects(items: list, mesh) -> list:
    """Each rank's list of picklable ``items`` (host rows, say), joined in
    rank order on every rank; the lists may differ in length."""
    if mesh is None:
        return list(items)
    out = [None] * mesh.size()
    dist.all_gather_object(out, list(items), group=mesh.get_group())
    return [x for part in out for x in part]


def is_lead(mesh) -> bool:
    """Whether this rank writes the run's files: rank 0 of the mesh, or
    the only process."""
    return mesh is None or mesh.get_local_rank() == 0
