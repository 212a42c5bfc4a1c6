"""One-card dry run: every (arch × input shape) built on the meta device,
its static bytes and its analytic cost.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
combination on a 16×16 (or 2×16×16) TPU mesh and reads XLA's analyses of
the compiled step. One card has no mesh and nothing is compiled ahead, so
each record holds the reference's keys that keep a meaning here:

* ``arch``, ``shape``, ``mesh`` (``"card"``), ``devices`` (1);
* ``flops`` and ``bytes_accessed``: ``launch/analysis.py::
  flops_bytes_model``, global FLOPs and HBM bytes of one step (the
  reference reads them from the compiled HLO);
* ``argument_size_in_bytes``: the step's arguments as ``launch/specs.py``
  lays them out on the meta device: the params, plus the optimizer state
  for ``train``, plus the batch, plus the caches, tokens and positions for
  ``decode`` (the ring under ``arch_for_shape``'s window);
* ``ok`` and ``total_s``.

Activations and workspace are not counted (the reference's
``temp_size_in_bytes``, which XLA plans ahead and PyTorch does not), nor
are collectives (one card), and no roofline time is computed. Nothing is
allocated: a sweep of all 40 combinations runs in-process in seconds, so
there is no per-combination subprocess and no ``--timeout``; ``--one``
takes no mesh, and ``--mesh`` only ``card``. Records
append to ``--out`` (resumable: a combination with an ``ok`` record is
not run again; ``--fresh`` starts over).

    python -m repro_torch.launch dryrun --one llama3_2_1b long_500k
    python -m repro_torch.launch dryrun --sweep [--out results/dryrun.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

MESH = "card"


def run_one(arch: str, shape_name: str) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.launch import specs as S
    from repro_torch.launch.analysis import flops_bytes_model
    from repro_torch.models.config import INPUT_SHAPES

    t0 = time.perf_counter()
    shape = INPUT_SHAPES[shape_name]
    cfg = S.arch_for_shape(get_arch(arch), shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH, "devices": 1}
    if shape.mode == "train":
        state, _ = S.train_state_struct(cfg)
        args = (state, S.batch_struct(cfg, shape))
    elif shape.mode == "prefill":
        args = (S.params_struct(cfg), S.batch_struct(cfg, shape))
    else:
        args = (S.params_struct(cfg), *S.decode_struct(cfg, shape))
    cost = flops_bytes_model(cfg, shape)
    rec["flops"] = float(cost["flops"])
    rec["bytes_accessed"] = float(cost["bytes"])
    rec["argument_size_in_bytes"] = S.tree_nbytes(args)
    rec["ok"] = True
    rec["total_s"] = round(time.perf_counter() - t0, 2)
    return rec


def combos():
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.config import INPUT_SHAPES
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            yield arch, shape


def sweep(out_path: str, fresh: bool) -> int:
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
                if r.get("ok") and r.get("mesh") == MESH:
                    done.add((r["arch"], r["shape"]))
    todo = [c for c in combos() if c not in done]
    print(f"[dryrun] {len(done)} done, {len(todo)} to go", flush=True)
    failures = 0
    for arch, shape in todo:
        try:
            rec = run_one(arch, shape)
            print(f"[dryrun] {arch} × {shape} × {MESH}: ok, "
                  f"{rec['argument_size_in_bytes']} argument bytes, "
                  f"{rec['flops']:.4g} FLOPs", flush=True)
        except Exception:  # noqa: BLE001 - recorded, the sweep goes on
            failures += 1
            err = traceback.format_exc()[-2000:]
            rec = {"arch": arch, "shape": shape, "mesh": MESH, "ok": False,
                   "error": err}
            print(f"[dryrun] {arch} × {shape} × {MESH}: FAILED: "
                  f"{err.strip().splitlines()[-1]}", flush=True)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch dryrun")
    ap.add_argument("--one", nargs=2, metavar=("ARCH", "SHAPE"))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--mesh", default=MESH)
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--fresh", action="store_true")
    args = ap.parse_args(argv)
    if args.mesh != MESH:
        print(f"dryrun: the port runs on one card: --mesh {MESH} only (the "
              f"reference's TPU meshes single and multi are not ported), "
              f"got {args.mesh!r}", file=sys.stderr)
        raise SystemExit(2)
    if not args.one and not args.sweep:
        ap.error("give --one ARCH SHAPE or --sweep")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if args.one:
        rec = run_one(*args.one)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps({k: rec[k] for k in
                          ("arch", "shape", "mesh", "flops",
                           "argument_size_in_bytes")}))
        return
    if sweep(args.out, args.fresh):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
