"""The dry run: every (arch × input shape) built on the meta device, on
one card or per device of the reference's production meshes; on the
meshes each step also runs, partitioned, once.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
combination on a 16×16 (or 2×16×16) TPU mesh and reads XLA's analyses of
the compiled step. Here ``single`` and ``multi`` build that mesh as a
``DeviceMesh`` over a fake process group of 256 or 512 ranks
(``launch/mesh.py::production_device_mesh``), place the step's arguments
as DTensors of fake tensors under the partition rules
(``sharding/partition.py::fake_tree``: each device's shard, no memory)
and run the step (``train.steps``' train, prefill or serve step) once:
DTensor's sharding propagation, the collectives it issues and each
device's operations on its local shapes are those of a real group. Each
record holds

* ``arch``, ``shape``, ``mesh`` and ``devices``: ``card`` (1, the
  default), ``single`` (256) or ``multi`` (512);
* on ``single`` and ``multi``, ``opts``: the ``REPRO_OPT`` toggles in
  force (``sharding/runtime.py``: ``no_fsdp_infer`` drops the inference
  params' ``data`` split, ``seqshard_cache`` changes the caches' split,
  ``no_remat`` turns the config's remat off, ``seq_parallel`` sets the
  block-boundary sequence split for train and prefill where the
  sequence divides ``model``, the reference's condition);
* ``argument_size_in_bytes``: the step's arguments as ``launch/specs.py``
  lays them out on the meta device, per device: the params, plus the
  optimizer state for ``train``, plus the batch, plus the caches, tokens
  and positions for ``decode`` (the ring under ``arch_for_shape``'s
  window); on a mesh each device's shards under the partition rules;
* ``flops`` and ``bytes_accessed``: on ``card``,
  ``launch/analysis.py::flops_bytes_model``, global FLOPs and HBM bytes of
  one step; on a mesh, one device's, counted on the partitioned step's
  local operations (``analysis.partitioned_cost``: FlopCounter's formulas,
  the hand kernels by ``kernels/cost.py``, each operation's inputs and
  outputs);
* on a mesh, ``collectives`` and ``collectives_flat``: per kind the
  count, result bytes and wire bytes of the collectives DTensor issued.
  The reference has both because XLA's loop bodies (the layer scan)
  appear once in the HLO, and ``collectives`` multiplies them by their
  trip counts; the port's layers run as a Python loop, so every issued
  collective is counted once where it happens and the two are equal;
* on a mesh, ``output_size_in_bytes`` (the step's results, per device)
  and ``temp_size_in_bytes`` (the peak of the bytes live on a device
  while the step ran, less the arguments');
* ``ok`` and ``total_s``.

A failure (a sharding propagation DTensor has no rule for, say) is an
``ok: false`` record with its error, as the reference's sweep writes
one, and the sweep exits 1. The fake group is created and destroyed for
each combination in this process, so there is no per-combination
subprocess and no ``--timeout``. Records append to ``--out`` (resumable:
a combination with an ``ok`` record is not run again; ``--fresh`` starts
over).

    python -m repro_torch.launch dryrun --one llama3_2_1b long_500k
    python -m repro_torch.launch dryrun --one llama3_2_1b train_4k --mesh both
    python -m repro_torch.launch dryrun --sweep [--mesh card|single|multi|both]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

MESH = "card"
MESHES = ("card", "single", "multi")
DEVICES = {"card": 1, "single": 256, "multi": 512}


def run_one(arch: str, shape_name: str, mesh_kind: str = MESH) -> dict:
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import specs as S
    from repro_torch.launch.analysis import flops_bytes_model
    from repro_torch.launch.mesh import (make_production_mesh,
                                         production_device_mesh)
    from repro_torch.models.config import INPUT_SHAPES
    from repro_torch.sharding import runtime as R

    if mesh_kind not in MESHES:
        raise ValueError(f"mesh {mesh_kind!r}, not one of {MESHES}")
    t0 = time.perf_counter()
    shape = INPUT_SHAPES[shape_name]
    cfg = S.arch_for_shape(get_arch(arch), shape)
    if R.enabled("no_remat"):
        cfg = dataclasses.replace(cfg, remat=False)
    mesh = (None if mesh_kind == MESH
            else make_production_mesh(multi_pod=mesh_kind == "multi"))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "devices": DEVICES[mesh_kind]}
    if mesh is not None:
        rec["opts"] = sorted(R.opts())
    if shape.mode == "train":
        state, _, _ = S.train_state_struct(cfg, mesh)
        args = (state, S.batch_struct(cfg, shape, mesh))
    elif shape.mode == "prefill":
        args = (S.params_struct(cfg, mesh)[0],
                S.batch_struct(cfg, shape, mesh))
    else:
        args = (S.params_struct(cfg, mesh)[0],
                *S.decode_struct(cfg, shape, mesh))
    if mesh is None:
        cost = flops_bytes_model(cfg, shape)
        rec["flops"] = float(cost["flops"])
        rec["bytes_accessed"] = float(cost["bytes"])
    rec["argument_size_in_bytes"] = S.tree_nbytes(args)
    if mesh is not None:
        with production_device_mesh(multi_pod=mesh_kind == "multi") as dm:
            rec.update(partitioned_step(cfg, shape, dm))
    rec["ok"] = True
    rec["total_s"] = round(time.perf_counter() - t0, 2)
    return rec


def partitioned_step(cfg, shape, mesh) -> dict:
    """One step of ``shape``'s mode (``train.steps``' train, prefill or
    serve step) on ``mesh`` (a ``DeviceMesh``; the production meshes over
    a fake group, ``launch/mesh.py::production_device_mesh``), its
    arguments DTensors of fake tensors placed under the partition rules
    (``sharding/partition.py::fake_tree``), counted by
    ``analysis.partitioned_cost``: the record's ``flops``,
    ``bytes_accessed``, ``collectives_flat``, ``collectives``,
    ``output_size_in_bytes`` and ``temp_size_in_bytes``. Under
    ``seq_parallel`` the block-boundary activation spec is set where the
    reference sets it (train and prefill, the sequence dividing
    ``model``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import specs as S
    from repro_torch.launch.analysis import partitioned_cost
    from repro_torch.sharding import batch_pspecs, fake_tree
    from repro_torch.sharding import runtime as R
    from repro_torch.train.steps import (make_prefill_step, make_serve_step,
                                         make_train_step)

    fake = FakeTensorMode()
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if (R.enabled("seq_parallel") and shape.mode != "decode"
            and shape.seq_len % sizes["model"] == 0):
        R.set_activation_spec(R.default_seq_parallel_spec(mesh))

    def place(tree, specs):
        return fake_tree(tree, specs, mesh, fake)

    try:
        if shape.mode == "train":
            state, _, opt = S.train_state_struct(cfg)
            batch = S.batch_struct(cfg, shape)
            fn = make_train_step(cfg, opt)
            args = (place(state, S.train_state_specs(cfg, state, mesh)),
                    place(batch, batch_pspecs(batch, mesh)))
        elif shape.mode == "prefill":
            params, _ = S.params_struct(cfg)
            batch = S.batch_struct(cfg, shape)
            fn = make_prefill_step(cfg)
            args = (place(params, S.params_specs(cfg, mesh)),
                    place(batch, batch_pspecs(batch, mesh)))
        else:
            params, _ = S.params_struct(cfg)
            cache, tokens, pos = S.decode_struct(cfg, shape)
            fn = make_serve_step(cfg)
            args = (place(params, S.params_specs(cfg, mesh)),
                    place(cache, S.cache_specs(cfg, shape, mesh)),
                    *place((tokens, pos), batch_pspecs((tokens, pos),
                                                       mesh)))
        cost, _ = partitioned_cost(fn, *args, fake_mode=fake)
    finally:
        R.set_activation_spec(None)
    colls = cost.pop("collectives")
    cost.pop("argument_size_in_bytes")
    return {**cost, "collectives_flat": colls, "collectives": colls}


def combos(meshes=(MESH,)):
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.config import INPUT_SHAPES
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            for mesh in meshes:
                yield arch, shape, mesh


def sweep(out_path: str, fresh: bool, meshes=(MESH,)) -> int:
    """Run every combination without an ``ok`` record in ``out_path``,
    appending one record each (a failure as ``ok: false`` with its
    error); returns the number of failures."""
    done = set()
    if not fresh and os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r.get("mesh")))
    todo = [c for c in combos(meshes) if c not in done]
    print(f"[dryrun] {len(done)} done, {len(todo)} to go", flush=True)
    failures = 0
    for arch, shape, mesh in todo:
        try:
            rec = run_one(arch, shape, mesh)
            flops = (f", {rec['flops']:.4g} FLOPs" if "flops" in rec
                     else "")
            print(f"[dryrun] {arch} × {shape} × {mesh}: ok, "
                  f"{rec['argument_size_in_bytes']} argument bytes a "
                  f"device{flops}", flush=True)
        except Exception:  # noqa: BLE001 - recorded, the sweep goes on
            failures += 1
            err = traceback.format_exc()[-2000:]
            rec = {"arch": arch, "shape": shape, "mesh": mesh, "ok": False,
                   "error": err}
            print(f"[dryrun] {arch} × {shape} × {mesh}: FAILED: "
                  f"{err.strip().splitlines()[-1]}", flush=True)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch dryrun")
    ap.add_argument("--one", nargs=2, metavar=("ARCH", "SHAPE"))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--mesh", default=MESH, choices=MESHES + ("both",),
                    help="card (one card, the default), the reference's "
                         "single (16x16) or multi (2x16x16) mesh, or both "
                         "of those")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--fresh", action="store_true")
    args = ap.parse_args(argv)
    if not args.one and not args.sweep:
        ap.error("give --one ARCH SHAPE or --sweep")
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if args.one:
        for mesh in meshes:
            rec = run_one(*args.one, mesh)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps({k: rec[k] for k in
                              ("arch", "shape", "mesh", "devices", "flops",
                               "argument_size_in_bytes",
                               "temp_size_in_bytes") if k in rec}))
        return
    if sweep(args.out, args.fresh, meshes):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
