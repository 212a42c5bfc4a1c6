"""What one step costs: the analytic FLOPs / HBM-bytes model of every
architecture × input shape, and the per-device accounting of a
partitioned step (counterpart of ``repro/launch/analysis.py``).

``flops_bytes_model`` gives the global FLOPs and HBM bytes of one step of
the shape's mode, ``_param_count`` the parameter counts it rests on and
``_cache_bytes`` the decode cache's bytes; pure arithmetic over
``ArchConfig`` and ``ShapeSpec``, the same operations in the same order as
the reference's, so the numbers are equal.

``partitioned_cost`` is the counterpart of the reference's reading of a
compiled partitioned program (``cost_analysis``, ``memory_analysis`` and
the HLO walkers ``parse_collectives``/``collective_bytes_nested``): it
runs a step on DTensors once and counts, per device,

* ``flops`` and ``bytes_accessed``: ``obs/cost.py``'s rules
  (``torch.utils.flop_counter``'s formulas, each hand-written kernel by
  ``kernels/cost.py``, each operation's inputs and outputs) on each
  device's local operations, which DTensor runs on local shapes;
* ``collectives``: per kind (all-gather, all-reduce, reduce-scatter,
  all-to-all, collective-permute) the ``count`` of the functional
  collectives DTensor issues, their ``bytes`` (the result's bytes on one
  device, as the reference counts an HLO collective's result type) and
  ``wire_bytes`` (``bytes`` times the reference's ring factor
  ``_WIRE_FACTOR``). On a "cpu" mesh (gloo, or the dry run's fake
  group) DTensor turns a Shard(i) -> Shard(j) all-to-all into an
  all-gather and a chunk; it is counted as the one all-to-all a NCCL
  mesh issues, with the all-to-all's result bytes;
* ``argument_size_in_bytes`` and ``output_size_in_bytes``: the local
  bytes of the step's arguments and results; ``temp_size_in_bytes``: the
  peak of the bytes live on the device while the step ran
  (``torch.distributed._tools.mem_tracker.MemTracker``, which tracks the
  local tensors under fake tensors too) less the argument bytes.
"""
from __future__ import annotations

import contextlib

from torch.distributed.tensor import DTensor

from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.obs.cost import _CostCounter, _nbytes, _on_meta, _tensor_list

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# wire-traffic factor per output byte (ring algorithms, large-n limit), the
# reference's (repro/launch/dryrun.py)
_WIRE_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
# functional collective (op name without the overload) -> kind
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "all_gather_into_tensor_out": "all-gather",
          "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all",
          "shard_dim_alltoall": "all-to-all"}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


# other collectives of those namespaces, counted under their own names
_OTHER = ("broadcast", "scatter", "gather", "reduce", "send", "recv",
          "isend", "irecv", "all_")


def collective_kind(func):
    """The kind of a functional collective op (``_KINDS``), its own name
    for another collective of those namespaces (``_OTHER``), None for any
    other op (``wait_tensor``, autograd wrappers, DTensor's helpers)."""
    if getattr(func, "namespace", None) not in _NAMESPACES:
        return None
    name = func._opname
    if name in _KINDS:
        return _KINDS[name]
    return name if name.startswith(_OTHER) else None


def _is_wait(func) -> bool:
    """A functional collective's wait: it moves nothing of its own."""
    return (getattr(func, "namespace", None) in _NAMESPACES
            and func._opname == "wait_tensor")


class StepCounter(_CostCounter):
    """``obs.cost``'s counter (which lets DTensor run first and counts its
    local operations), plus the collectives by kind."""

    def __init__(self):
        super().__init__()
        self.collectives = {}

    def count(self, kind: str, out) -> None:
        rec = self.collectives.setdefault(
            kind, {"count": 0, "bytes": 0, "wire_bytes": 0.0})
        nbytes = _nbytes(out)
        rec["count"] += 1
        rec["bytes"] += nbytes
        rec["wire_bytes"] += nbytes * _WIRE_FACTOR.get(kind, 1.0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_wait(func):
            return func(*args, **(kwargs or {}))
        kind = collective_kind(func)
        if kind is None:
            return super().__torch_dispatch__(func, types, args, kwargs)
        out = func(*args, **(kwargs or {}))
        if not self._paused and not _on_meta(out):
            self.count(kind, out)
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    def all_to_all(self, run, *args):
        """DTensor's Shard(i) -> Shard(j) ``run(*args)`` as one
        all-to-all, whatever the mesh's backend issues for it."""
        self._paused += 1
        try:
            out = run(*args)
        finally:
            self._paused -= 1
        if not self._paused:
            self.count("all-to-all", out)
            self.bytes += _nbytes(args[0]) + _nbytes(out)
        return out


@contextlib.contextmanager
def _all_to_all_as_one(counter):
    """DTensor's all-to-all helper counted by ``counter`` as one all-to-all
    (on a "cpu" mesh DTensor issues an all-gather and a chunk for it)."""
    from torch.distributed.tensor import placement_types

    orig = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = (
        lambda *a: counter.all_to_all(orig, *a))
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


@contextlib.contextmanager
def _propagation_unseen():
    """DTensor's shape inference out of sight of the dispatch modes: its
    sharding propagation runs each new operation once on tensors of the
    global shapes (fake ones under the dry run's fake mode), which no
    device computes or holds."""
    from torch.utils._python_dispatch import _disable_current_modes

    prop = DTensor._op_dispatcher.sharding_propagator
    name = next(n for n in ("_propagate_tensor_meta_non_cached",
                            "_propagate_tensor_meta") if hasattr(prop, n))
    orig = getattr(prop, name)

    def unseen(*args, **kwargs):
        with _disable_current_modes():
            return orig(*args, **kwargs)

    setattr(prop, name, unseen)
    try:
        yield
    finally:
        delattr(prop, name)


def _local_tensors(tree) -> list:
    """One device's shard of every tensor of ``tree`` (a DTensor's local
    tensor; a plain tensor whole)."""
    return [x.to_local() if isinstance(x, DTensor) else x
            for x in _tensor_list(tree)]


def local_nbytes(tree) -> int:
    return sum(x.nbytes for x in _local_tensors(tree))


def partitioned_cost(fn, *args, fake_mode=None):
    """Run ``fn(*args)`` once (under ``fake_mode``, a ``FakeTensorMode``,
    if given: the dry run's fake tensors) and count one device's
    ``flops``, ``bytes_accessed``, ``collectives``,
    ``argument_size_in_bytes``, ``output_size_in_bytes`` and
    ``temp_size_in_bytes`` (see the module docstring). Returns (that
    dict, ``fn``'s result)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.kernels import ops

    counter = StepCounter()
    tracker = MemTracker()
    tracker.track_external(*_local_tensors(args))
    arg_bytes = local_nbytes(args)
    ops._COST_COUNTERS.append(counter)
    try:
        with contextlib.ExitStack() as stack:
            if fake_mode is not None:
                stack.enter_context(fake_mode)
            stack.enter_context(tracker)
            stack.enter_context(_all_to_all_as_one(counter))
            stack.enter_context(_propagation_unseen())
            stack.enter_context(counter)
            out = fn(*args)
    finally:
        ops._COST_COUNTERS.remove(counter)
    peak = max((snap.get("Total", 0) for dev, snap
                in tracker.get_tracker_snapshot("peak").items()
                if dev.type != "meta"), default=0)
    colls = {k: counter.collectives[k] for k in COLLECTIVES
             if k in counter.collectives}
    colls.update({k: v for k, v in counter.collectives.items()
                  if k not in COLLECTIVES})
    return {"flops": float(counter.flops),
            "bytes_accessed": float(counter.bytes),
            "collectives": colls,
            "argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(local_nbytes(out)),
            "temp_size_in_bytes": int(max(peak - arg_bytes, 0))}, out


# --------------------------------------------------------------------------
# Analytic FLOPs / HBM-bytes model (global; divide by chips for per-device).
# --------------------------------------------------------------------------
def _param_count(cfg: ArchConfig) -> dict:
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    out = {"embed": V * d, "head": d * V}
    per_layer = 0.0
    if cfg.attn_kind == "gqa":
        hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        per_layer += d * h * hd + 2 * d * kvh * hd + h * hd * d
    elif cfg.attn_kind == "mla":
        r, dn, dr, dv = (cfg.kv_lora_rank, cfg.nope_head_dim,
                         cfg.rope_head_dim, cfg.v_head_dim)
        h = cfg.n_heads
        per_layer += d * h * (dn + dr) + d * r + d * dr \
            + r * h * (dn + dv) + h * dv * d
    if cfg.ssm_kind == "rwkv6":
        per_layer += 5 * d * d + 2 * d * f + d * d   # time-mix + channel-mix
    elif cfg.ssm_kind == "mamba2":
        di = cfg.ssm_expand * d
        per_layer += d * (2 * di + 2 * cfg.d_state + di // cfg.ssm_head_dim) \
            + di * d
    if cfg.is_moe:
        per_layer += d * cfg.n_experts \
            + cfg.n_experts * 3 * d * cfg.moe_d_ff \
            + cfg.n_shared_experts * 3 * d * cfg.moe_d_ff
        active_per_layer = per_layer - (cfg.n_experts - cfg.top_k) \
            * 3 * d * cfg.moe_d_ff
    elif cfg.ssm_kind == "none" or cfg.shared_attn_every:
        per_layer += 3 * d * f
        active_per_layer = per_layer
    else:
        active_per_layer = per_layer
    if cfg.ssm_kind != "none" and not cfg.is_moe and not cfg.shared_attn_every:
        active_per_layer = per_layer
    shared = 0.0
    if cfg.shared_attn_every:
        hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        shared = d * h * hd + 2 * d * kvh * hd + h * hd * d + 3 * d * f
    enc = 0.0
    if cfg.enc_layers:
        hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        enc = cfg.enc_layers * (d * h * hd + 2 * d * kvh * hd + h * hd * d
                                + 3 * d * f)
    out.update(per_layer=per_layer, active_per_layer=active_per_layer,
               shared=shared, enc=enc)
    out["total"] = (out["embed"] + out["head"] + L * per_layer + shared + enc)
    out["active"] = (out["embed"] + out["head"] + L * active_per_layer
                     + shared + enc)
    return out


def flops_bytes_model(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Global FLOPs and HBM bytes for one step of the given mode."""
    p = _param_count(cfg)
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    L = cfg.n_layers
    bpe = 2.0                                   # bf16

    if shape.mode in ("train", "prefill"):
        T = B * S
        flops = 2.0 * T * p["active"]           # matmul fwd
        # attention math (causal avg S/2), windowed if set
        if cfg.attn_kind in ("gqa", "mla"):
            hd = (cfg.nope_head_dim + cfg.rope_head_dim
                  if cfg.attn_kind == "mla" else cfg.head_dim)
            dv = cfg.v_head_dim if cfg.attn_kind == "mla" else cfg.head_dim
            span = min(S / 2, cfg.window or S)
            n_attn = L if not cfg.shared_attn_every else (
                L // cfg.shared_attn_every)
            flops += 2.0 * T * span * cfg.n_heads * (hd + dv) * n_attn
        if cfg.enc_layers:
            F = cfg.n_audio_frames
            flops += 2.0 * B * F * F * cfg.n_heads * cfg.head_dim \
                * 2 * cfg.enc_layers                        # enc self-attn
            flops += 2.0 * T * F * cfg.n_heads * cfg.head_dim * 2 * L  # cross
        if cfg.ssm_kind != "none":
            dk = cfg.d_state if cfg.ssm_kind == "mamba2" else cfg.ssm_head_dim
            dvs = cfg.ssm_head_dim
            heads = ((cfg.ssm_expand * d) // cfg.ssm_head_dim
                     if cfg.ssm_kind == "mamba2" else d // cfg.ssm_head_dim)
            C = cfg.ssm_chunk
            # intra-chunk [C,C] matmuls + state update/read
            flops += L * (B * S) * heads * (2 * C * (dk + dvs)
                                            + 4 * dk * dvs)
        # extra exits: head matmul per exit
        flops += 2.0 * T * d * cfg.vocab * max(len(cfg.exit_layers) - 1, 0)
        act_bytes = L * T * d * bpe
        if shape.mode == "train":
            flops *= 4.0                        # fwd + bwd(2x) + remat refwd
            bytes_ = (3 * p["total"] * bpe      # weights fwd+refwd+bwd reads
                      + p["total"] * bpe        # grads write
                      + 3 * p["total"] * 8.0    # adam m,v f32 read+write
                      + 6 * act_bytes)          # save + reload + grads
        else:
            bytes_ = p["total"] * bpe + 4 * act_bytes \
                + (2 * p["per_layer"] and 0.0)
            # prefill also writes the KV cache:
            bytes_ += _cache_bytes(cfg, B, S)
        return {"flops": flops, "bytes": bytes_, "model_flops":
                (6.0 if shape.mode == "train" else 2.0) * p["active"] * T}

    # decode: one token per sequence
    T = B
    flops = 2.0 * T * p["active"]
    cache_b = _cache_bytes(cfg, B, S)
    if cfg.attn_kind in ("gqa", "mla"):
        span = min(S, cfg.window or S)
        hd = (cfg.kv_lora_rank + cfg.rope_head_dim
              if cfg.attn_kind == "mla" else cfg.head_dim)
        n_attn = L if not cfg.shared_attn_every else (
            L // cfg.shared_attn_every)
        flops += 2.0 * T * span * cfg.n_heads * hd * 2 * n_attn
    if cfg.ssm_kind != "none":
        dk = cfg.d_state if cfg.ssm_kind == "mamba2" else cfg.ssm_head_dim
        heads = ((cfg.ssm_expand * d) // cfg.ssm_head_dim
                 if cfg.ssm_kind == "mamba2" else d // cfg.ssm_head_dim)
        flops += L * T * heads * 4 * dk * cfg.ssm_head_dim
    bytes_ = p["active"] * bpe + cache_b   # weights + full cache read
    return {"flops": flops, "bytes": bytes_,
            "model_flops": 2.0 * p["active"] * T}


def _cache_bytes(cfg: ArchConfig, B: int, S: int) -> float:
    bpe = 2.0
    span = min(S, cfg.window or S)
    if cfg.enc_layers:
        kv = cfg.n_layers * B * span * 2 * cfg.n_kv_heads * cfg.head_dim
        kv += B * cfg.n_audio_frames * cfg.d_model
        return kv * bpe
    if cfg.attn_kind == "mla":
        return cfg.n_layers * B * S * (cfg.kv_lora_rank
                                       + cfg.rope_head_dim) * bpe
    total = 0.0
    if cfg.attn_kind == "gqa" and not cfg.shared_attn_every:
        total += cfg.n_layers * B * span * 2 * cfg.n_kv_heads * cfg.head_dim
    if cfg.shared_attn_every:
        n_sh = len(range(cfg.shared_attn_every, cfg.n_layers + 1,
                         cfg.shared_attn_every))
        total += n_sh * B * S * 2 * cfg.n_kv_heads * cfg.head_dim
    if cfg.ssm_kind == "rwkv6":
        h = cfg.d_model // cfg.ssm_head_dim
        total += cfg.n_layers * B * h * cfg.ssm_head_dim ** 2 * 2  # f32
    elif cfg.ssm_kind == "mamba2":
        di = cfg.ssm_expand * cfg.d_model
        h = di // cfg.ssm_head_dim
        total += cfg.n_layers * B * h * cfg.d_state * cfg.ssm_head_dim * 2
    return total * bpe
