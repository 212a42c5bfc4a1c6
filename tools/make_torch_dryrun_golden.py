"""Write ``tests/data/torch_dryrun_golden.json``: the reference's compiled,
partitioned steps of three reduced configs on a 2x2 ("data", "model")
mesh, as XLA's cost analysis counts them per device, for the port's dry
run accounting (``tests/test_torch_dryrun_mesh.py``) to be held against
without compiling a JAX partitioned step in the suite.

    PYTHONPATH=src python tools/make_torch_dryrun_golden.py

The tool runs the reference in a child process whose host platform has
four devices (``--xla_force_host_platform_device_count=4``), builds each
step as ``repro/launch/dryrun.py::run_one`` does (the reference's
``launch/specs.py`` structs with their shardings, ``make_train_step`` /
``make_prefill_step`` / ``make_serve_step``, ``jax.jit(...).lower(...)
.compile()``) on a 2x2 ``jax.sharding.Mesh`` of four host devices, and
keeps ``cost_analysis()``'s ``flops`` and ``bytes accessed`` and the
collectives of the compiled HLO (``repro/launch/analysis.py::
collective_bytes_nested``). The configs (``CONFIGS``: one layer, one CE
chunk and one scan chunk, so that no loop body is counted once for many
trips, XLA's cost analysis' blind spot) and the shapes (``SHAPES``) are
this module's, which the test imports.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH = os.path.join(ROOT, "tests", "data", "torch_dryrun_golden.json")
MESH = ((2, 2), ("data", "model"))
# arch -> the arguments of ``reduced`` beyond its defaults
# (one layer: the default exits are then (0, 1), the embedding's and the
# last layer's, so that every param takes part in the loss)
CONFIGS = {"llama3_2_1b": {"n_layers": 1},
           "rwkv6_7b": {"n_layers": 1, "ssm_chunk": 64},
           "deepseek_moe_16b": {"n_layers": 1}}
# name -> (seq_len, global_batch, mode)
SHAPES = {"train_s64": (64, 4, "train"), "prefill_s64": (64, 4, "prefill"),
          "decode_s64": (64, 4, "decode")}


def config(get_arch, arch: str):
    """``arch``'s golden config from a package's ``get_arch``."""
    return get_arch(arch).reduced(**CONFIGS[arch])


def _child() -> dict:
    import jax

    import numpy as np

    from repro.configs import get_arch
    from repro.launch import specs as S
    from repro.launch.analysis import collective_bytes_nested
    from repro.models.config import ShapeSpec
    from repro.train.steps import (make_prefill_step, make_serve_step,
                                   make_train_step)

    # a Mesh of Auto axes, whose shardings XLA propagates (jax.make_mesh's
    # default axes are Explicit in this JAX, under which the reference's
    # embedding gather does not resolve)
    mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:4]).reshape(MESH[0]), MESH[1])
    out = {}
    for arch in CONFIGS:
        cfg = config(get_arch, arch)
        for name, (s, b, mode) in SHAPES.items():
            shape = ShapeSpec(name, s, b, mode)
            with mesh:
                if mode == "train":
                    state, _, opt = S.train_state_struct(cfg, mesh)
                    fn, args = make_train_step(cfg, opt), (
                        state, S.batch_struct(cfg, shape, mesh))
                elif mode == "prefill":
                    params, _ = S.params_struct(cfg, mesh)
                    fn, args = make_prefill_step(cfg), (
                        params, S.batch_struct(cfg, shape, mesh))
                else:
                    params, _ = S.params_struct(cfg, mesh)
                    fn, args = make_serve_step(cfg), (
                        params, *S.decode_struct(cfg, shape, mesh))
                compiled = jax.jit(fn).lower(*args).compile()
            ca = compiled.cost_analysis()
            if isinstance(ca, (list, tuple)):
                ca = ca[0]
            out[f"{arch}/{name}"] = {
                "flops": float(ca["flops"]),
                "bytes_accessed": float(ca["bytes accessed"]),
                "collectives": collective_bytes_nested(compiled.as_text())}
    return out


def build() -> dict:
    """The golden records, computed in a child process with four host
    devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [os.path.join(ROOT, "src"), env.get("PYTHONPATH")]))
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--child"], env=env, capture_output=True, text=True,
                       check=False)
    if p.returncode:
        raise RuntimeError(f"the reference's child failed:\n{p.stderr}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def load(path: str = PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv == ["--child"]:
        print(json.dumps(_child()))
        return
    gold = {"mesh": MESH, "configs": CONFIGS, "shapes": SHAPES,
            "records": build()}
    with open(PATH, "w") as f:
        json.dump(gold, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {PATH}: {len(gold['records'])} records")


if __name__ == "__main__":
    main()
