"""Optimization toggles of the partitioned LM configs, from ``REPRO_OPT``,
and the block-boundary activation constraint.

Counterpart of ``repro/sharding/runtime.py``. Each beyond-paper
optimization of the reference's partitioned runs is named in the
comma-separated ``REPRO_OPT``, so that the baseline and the optimized
specs are one environment switch apart. The port reads them where the
reference does:

  no_fsdp_infer   ``launch/specs.py::params_struct``: inference (prefill and
                  decode) param specs drop the FSDP ``data`` axis, so the
                  weights are split over ``model`` only.
  seqshard_cache  ``partition.py::cache_pspecs``: a GQA cache whose KV
                  heads do not divide the ``model`` axis splits its
                  sequence dim over ``model`` instead of ``head_dim``.
  seq_parallel    ``launch/dryrun.py`` sets ``default_seq_parallel_spec``
                  as the activation spec (train and prefill, where the
                  sequence divides ``model``): the activations are
                  constrained to a sequence split at every block boundary.
  no_remat        ``launch/dryrun.py``: the config's ``remat`` off.

``constrain_activations`` is the reference's ``with_sharding_constraint``
at the block boundaries (``models/blocks.py``, ``models/lm.py``): on a
DTensor a ``redistribute`` to the activation spec's placements (with no
spec set, to the batch's data-parallel split), on a plain tensor
nothing.

The rest are the partitioned steps' repairs: where DTensor's sharding
propagation has no rule for an operation on the placements it meets
(a reshape whose split does not tile, a matmul over a strided split, a
gather along a split dim), the model calls one of these, which
redistributes explicitly to what XLA's partitioner does there, or runs
the operation per device through ``local_map``. Each is the plain
operation on a plain tensor.
"""
from __future__ import annotations

import os

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


def opts() -> set:
    """The toggles named in ``REPRO_OPT``."""
    return set(filter(None, os.environ.get("REPRO_OPT", "").split(",")))


def enabled(name: str) -> bool:
    return name in opts()


# The block-boundary activation spec ([B, S, D]), set by the launcher when
# seq_parallel is on; None: no constraint.
_ACTIVATION_SPEC = None


def set_activation_spec(spec) -> None:
    global _ACTIVATION_SPEC
    _ACTIVATION_SPEC = spec


def constrain_activations(x):
    """``x`` [B, S, D] on a DTensor redistributed to the activation spec,
    or with none set to the batch's data-parallel split (``PSpec(batch
    axes, None, None)``, the layout XLA gives the residual stream of the
    reference's tensor-parallel blocks; left to itself DTensor keeps
    whatever its last reduction chose, a sequence split after a
    reduce-scatter that the next matmul then gathers whole); on a plain
    tensor ``x`` itself."""
    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.partition import (PSpec, _batch_axes,
                                                to_placements)
    spec = _ACTIVATION_SPEC
    if spec is None:
        spec = PSpec(_batch_axes(x.device_mesh, x.shape[0]),
                     *([None] * (x.dim() - 1)))
    pl = to_placements(spec, x.device_mesh)
    return x if list(x.placements) == pl else x.redistribute(
        x.device_mesh, pl)


def default_seq_parallel_spec(mesh):
    """Batch over (pod, data), sequence over ``model``: Megatron-style
    sequence parallelism at the block boundaries."""
    from repro_torch.sharding.partition import PSpec, axis_sizes

    baxes = tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))
    b = baxes if len(baxes) > 1 else baxes[0]
    return PSpec(b, "model", None)


# ------------------------------------------------ partitioned-step repairs
def whole_dim(x, dim: int):
    """``x`` with no mesh axis splitting ``dim`` (those axes gathered; the
    others keep their splits), on a DTensor; ``x`` itself on a plain
    tensor."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.dim()
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def split_heads(x, shape):
    """``x.reshape(shape)``, the last dim split into (heads, head_dim):
    on a DTensor whose last dim is split over more devices than divide
    the heads (GQA's 8 KV heads over a 16-wide ``model`` axis, RWKV-6's
    five mixes of ``5 d`` columns), that dim is gathered first, as XLA
    reshards an operand whose split does not tile the reshape; the
    gradient coming back has its head_dim gathered where split."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    if not _heads_tiled(x, shape[-2]):
        x = whole_dim(x, -1)
    y = x.reshape(shape)
    if y.requires_grad:
        # merging a gradient split on head_dim back would give a strided
        # split (``flat_rows``)
        y.register_hook(lambda g: whole_dim(g, -1))
    return y


def _heads_tiled(x, heads: int):
    """Whether ``x``'s last dim is split over a number of devices that
    divides ``heads``."""
    ways, last = 1, x.dim() - 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == last:
            ways *= x.device_mesh.size(i)
    return heads % ways == 0


def merge_heads(x, shape):
    """``x.reshape(shape)``, x's (heads, head_dim) merged into its last
    dim. On a DTensor the gradient coming back, which the next matmul's
    backward may split over more devices than divide the heads, has that
    dim gathered before it is split into heads again (``split_heads``'s
    rule, for the backward)."""
    y = x.reshape(shape)
    if isinstance(y, DTensor) and y.requires_grad:
        heads = x.shape[-2]
        y.register_hook(lambda g: g if _heads_tiled(g, heads)
                        else whole_dim(g, -1))
    return y


def flat_rows(x):
    """``x`` [..., K] (a DTensor) ready for a matmul, which flattens its
    leading dims into rows: a split of an inner leading dim (the sequence
    of [B, S, K], which DTensor chooses after a reduce-scatter) is
    gathered, as XLA's partitioner all-gathers a sequence-parallel
    activation before a column-parallel matmul; so is a strided split
    (``_StridedShard``, the layout DTensor gives a dim flattened from
    split dims), and partial sums are reduced. A leading dim split with
    another would flatten into a strided split, which DTensor's matmul
    rule does not take (it reaches one from a partial input too)."""
    if not isinstance(x, DTensor):
        return x
    last = x.dim() - 1
    pl = [p if p.is_replicate() or (type(p) is Shard and p.dim in (0, last))
          else Replicate() for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def take_last(x, index):
    """``x[..., index[...]]``: x [..., V], index [...] (int64) -> [...].
    On a DTensor split over its last dim (the vocab-parallel LM head's
    logits) each device picks the entries inside its block of V and
    zeros elsewhere, and the result is a partial sum over those axes:
    the masked local gather and all-reduce of vocab-parallel CE, which is
    what XLA does for a gather along a sharded dim."""
    index = index.long()
    if not isinstance(x, DTensor):
        return torch.gather(x, -1, index[..., None])[..., 0]
    mesh, last = x.device_mesh, x.dim() - 1
    x_pl, i_pl, o_pl, vocab_axes = [], [], [], []
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == last:
            x_pl.append(p)
            i_pl.append(Replicate())
            o_pl.append(Partial())
            vocab_axes.append(i)
        elif isinstance(p, Shard):
            x_pl.append(p)
            i_pl.append(p)
            o_pl.append(p)
        else:
            x_pl.append(Replicate())
            i_pl.append(Replicate())
            o_pl.append(Replicate())

    def local(x, index):
        block = 0
        for i in vocab_axes:
            block = block * mesh.size(i) + mesh.get_local_rank(i)
        n = x.shape[-1]
        at = index - block * n
        inside = (at >= 0) & (at < n)
        got = torch.gather(x, -1, at.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(inside, got, torch.zeros_like(got))

    if not isinstance(index, DTensor):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    return local_map(local, out_placements=(tuple(o_pl),),
                     in_placements=(tuple(x_pl), tuple(i_pl)),
                     device_mesh=mesh, redistribute_inputs=True)(x, index)


def heads_parallel(fn, xs, head_dims, out_head_dims, batched=None):
    """``fn(*xs)`` per device on DTensors: each tensor of ``xs`` (None
    allowed) split over the data axes on its batch dim 0 (where
    ``batched``, default every tensor, says it has one) where the first
    has it so, and over ``model`` on its heads dim (``head_dims``, None
    for a tensor without heads) where every heads dim divides it, else
    whole; the outputs placed alike by ``out_head_dims`` (all batched).
    The gradient of a tensor without a batch dim (a per-head parameter)
    is a partial sum over the axes the batch is split on. Per-head work
    (``ssm_scan``, RWKV-6's and Mamba-2's decode step, the plain
    attention ``sdpa``) is local to a head and a sequence, as XLA
    partitions it; a plain call runs ``fn(*xs)``."""
    first = next((x for x in xs if isinstance(x, DTensor)), None)
    if first is None:
        return fn(*xs)
    batched = batched or (True,) * len(xs)
    mesh = first.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    m = names.index("model") if "model" in names else None
    split = m is not None and all(
        x.shape[d] % mesh.size(m) == 0
        for x, d in zip(xs, head_dims) if x is not None and d is not None)

    def placements(head_dim, batch):
        out = []
        for i, p in enumerate(first.placements):
            if i == m:
                out.append(Shard(head_dim) if split and head_dim is not None
                           else Replicate())
            elif batch and isinstance(p, Shard) and p.dim == 0:
                out.append(Shard(0))
            else:
                out.append(Replicate())
        return tuple(out)

    given = [i for i, x in enumerate(xs) if x is not None]
    live = [xs[i] if isinstance(xs[i], DTensor) else DTensor.from_local(
        xs[i], mesh, [Replicate()] * mesh.ndim, run_check=False)
        for i in given]
    in_pl = tuple(placements(head_dims[i], batched[i]) for i in given)
    grad_pl = tuple(pl if batched[i] else tuple(
        Partial() if isinstance(p, Shard) and p.dim == 0 and j != m else q
        for j, (p, q) in enumerate(zip(first.placements, pl)))
        for i, pl in zip(given, in_pl))

    def local(*ts):
        full = [None] * len(xs)
        for i, t in zip(given, ts):
            full[i] = t
        return fn(*full)

    return local_map(local, out_placements=tuple(placements(d, True)
                                                 for d in out_head_dims),
                     in_placements=in_pl, in_grad_placements=grad_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*live)


def lookup(table, ids):
    """``table[ids]``: table [V, D], ids [...] -> [..., D]. On a DTensor
    table split over its rows (the vocab-parallel embedding) each device
    looks up the ids inside its block of rows and zeros the others, and
    the result is a partial sum over those axes (a masked local gather and
    an all-reduce, as XLA partitions a gather from a split operand); the
    ids keep their batch split, the table's other splits (FSDP's
    columns) are gathered. The backward is the plain lookup's on each
    device's block."""
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    t_pl, i_pl, o_pl, g_pl, vocab_axes = [], [], [], [], []
    for i, (tp, ip) in enumerate(zip(table.placements, ids.placements)):
        if isinstance(tp, Shard) and tp.dim == 0:
            vocab_axes.append(i)
            t_pl.append(Shard(0))
            i_pl.append(Replicate())
            o_pl.append(Partial())
            g_pl.append(Shard(0))
        elif isinstance(ip, Shard) and ip.dim == 0:
            t_pl.append(Replicate())
            i_pl.append(Shard(0))
            o_pl.append(Shard(0))
            g_pl.append(Partial())
        else:
            t_pl.append(Replicate())
            i_pl.append(Replicate())
            o_pl.append(Replicate())
            g_pl.append(Replicate())

    def local(table, ids):
        block = 0
        for i in vocab_axes:
            block = block * mesh.size(i) + mesh.get_local_rank(i)
        n = table.shape[0]
        at = ids - block * n
        inside = ((at >= 0) & (at < n))[..., None]
        rows = table[at.clamp(0, n - 1)]
        return torch.where(inside, rows, torch.zeros_like(rows))

    return local_map(local, out_placements=(tuple(o_pl),),
                     in_placements=(tuple(t_pl), tuple(i_pl)),
                     in_grad_placements=(tuple(g_pl), tuple(i_pl)),
                     device_mesh=mesh, redistribute_inputs=True)(table, ids)
