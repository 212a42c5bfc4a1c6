"""The port's one-card launch tools against the JAX package: the analytic
FLOPs/bytes model (``launch/analysis.py``), ``describe`` and the four
shape-only trees of ``launch/specs.py`` (meta device) for every arch and
input shape; the dry run (``launch/dryrun.py``), the dispatcher
``python -m repro_torch.launch`` and ``RolloutDriver.run_sharded``. The
reference's spec functions run on a one-device host mesh (they only need a
mesh for their shardings, which the port has none of).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_arch as jax_get_arch
from repro.launch import analysis as jax_analysis
from repro.launch import specs as jax_specs
from repro.models.config import INPUT_SHAPES as JAX_SHAPES
from repro_torch.configs import get_arch
from repro_torch.core import agent_def
from repro_torch.launch import analysis, dryrun, specs
from repro_torch.launch.__main__ import COMMANDS
from repro_torch.launch.__main__ import main as launch_main
from repro_torch.mec import MECEnv, make_scenario
from repro_torch.models import INPUT_SHAPES
from repro_torch.nn.pytree import tree_tensors
from repro_torch.rollout import RolloutDriver

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-12
RECORD_KEYS = {"arch", "shape", "mesh", "devices", "flops", "bytes_accessed",
               "argument_size_in_bytes", "ok", "total_s"}


@pytest.fixture(scope="module")
def host_mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def cfgs(arch, shape):
    """(port cfg, JAX cfg) of ``arch`` under ``arch_for_shape``."""
    return (specs.arch_for_shape(get_arch(arch), INPUT_SHAPES[shape]),
            jax_specs.arch_for_shape(jax_get_arch(arch), JAX_SHAPES[shape]))


def assert_rel_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= REL * abs(w), (k, got[k], w)


def _key(entry) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(entry)


def jax_leaves(tree) -> dict:
    """{path: (shape, dtype name)} of a tree of ShapeDtypeStructs."""
    return {"/".join(_key(e) for e in path): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_leaves(tree) -> dict:
    out = {}
    for path, t in specs.leaves(tree):
        assert t.device.type == "meta", path
        out[path] = (tuple(t.shape), str(t.dtype).removeprefix("torch."))
    return out


# ------------------------------------------------------------ the FLOP model
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_flops_bytes_model_equals_reference(arch):
    """``_param_count``, ``flops_bytes_model`` and ``_cache_bytes`` at every
    input shape, under ``arch_for_shape`` as the dry run takes them and
    without it (the window changes the attention span and cache)."""
    for shape in INPUT_SHAPES:
        s, js = INPUT_SHAPES[shape], JAX_SHAPES[shape]
        for cfg, jcfg in (cfgs(arch, shape),
                          (get_arch(arch), jax_get_arch(arch))):
            assert_rel_equal(analysis._param_count(cfg),
                             jax_analysis._param_count(jcfg))
            assert_rel_equal(analysis.flops_bytes_model(cfg, s),
                             jax_analysis.flops_bytes_model(jcfg, js))
            got = analysis._cache_bytes(cfg, s.global_batch, s.seq_len)
            want = jax_analysis._cache_bytes(jcfg, js.global_batch,
                                             js.seq_len)
            assert abs(got - want) <= REL * abs(want), shape


# ------------------------------------------------------------ meta trees
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_describe_and_meta_trees_equal_reference(arch, host_mesh):
    """``describe`` exactly; the params, the train state, and per shape the
    batch and (decode) the cache, tokens and positions path by path in
    shape and dtype, against the eval_shape trees of the reference's specs;
    every port leaf on the meta device."""
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    assert specs.describe(cfg) == jax_specs.describe(jcfg)
    want, _ = jax_specs.params_struct(jcfg, host_mesh)
    assert port_leaves(specs.params_struct(cfg)) == jax_leaves(want)
    want, _, _ = jax_specs.train_state_struct(jcfg, host_mesh)
    state, _ = specs.train_state_struct(cfg)
    assert port_leaves(state) == jax_leaves(want)
    for shape in INPUT_SHAPES:
        cfg, jcfg = cfgs(arch, shape)
        s, js = INPUT_SHAPES[shape], JAX_SHAPES[shape]
        assert port_leaves(specs.batch_struct(cfg, s)) == jax_leaves(
            jax_specs.batch_struct(jcfg, js, host_mesh))
        if s.is_decode:
            assert port_leaves(specs.decode_struct(cfg, s)) == jax_leaves(
                jax_specs.decode_struct(jcfg, js, host_mesh))


def test_long_500k_cache_is_the_ring():
    cfg, _ = cfgs("llama3_2_1b", "long_500k")
    cache, tokens, pos = specs.decode_struct(cfg, INPUT_SHAPES["long_500k"])
    assert cache["layers"].k.shape == (16, 1, 8192, 8, 64)
    assert specs.tree_nbytes(cache) == 268_435_456
    assert tokens.dtype == pos.dtype == torch.int32


# --------------------------------------------------------------- dry run
def test_dryrun_one_writes_one_record(tmp_path, capsys):
    out = tmp_path / "d.jsonl"
    dryrun.main(["--one", "llama3_2_1b", "long_500k", "--out", str(out)])
    lines = out.read_text().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == RECORD_KEYS
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["devices"],
            rec["ok"]) == ("llama3_2_1b", "long_500k", "card", 1, True)
    cfg, jcfg = cfgs("llama3_2_1b", "long_500k")
    want = jax_analysis.flops_bytes_model(jcfg, JAX_SHAPES["long_500k"])
    assert rec["flops"] == want["flops"]
    assert rec["bytes_accessed"] == want["bytes"]
    params = jax_specs.describe(jcfg)["params"]
    # bf16 params, the 8192-row ring, int32 tokens and positions
    assert rec["argument_size_in_bytes"] == 2 * params + 268_435_456 + 8
    assert json.loads(capsys.readouterr().out)["mesh"] == "card"


@pytest.mark.parametrize("argv", [
    ["--sweep", "--mesh", "pod"],
    ["--sweep", "--mesh", "16x16"],
    ["--one", "llama3_2_1b", "long_500k", "--mesh", "tpu_v5e"],
])
def test_dryrun_refuses_a_mesh(argv, tmp_path, capsys):
    """A mesh other than card, single, multi (or both) is refused before
    anything is written; single and multi are the reference's meshes
    (tests/test_torch_sharding.py)."""
    with pytest.raises(SystemExit) as exc:
        dryrun.main(argv + ["--out", str(tmp_path / "d.jsonl")])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err
    assert not (tmp_path / "d.jsonl").exists()


def test_dryrun_sweep_through_the_dispatcher(tmp_path):
    """``python -m repro_torch.launch dryrun --sweep``: 40 ok records;
    a rerun runs nothing."""
    out = tmp_path / "sweep.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch", "dryrun", "--sweep",
           "--out", str(out)]
    for said in ("0 done, 40 to go", "40 done, 0 to go"):
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                           env=env, cwd=tmp_path)
        assert p.returncode == 0, p.stderr
        assert said in p.stdout
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 40 and all(r["ok"] for r in recs)
    assert {(r["arch"], r["shape"]) for r in recs} == {
        (a, s) for a in ARCH_IDS for s in INPUT_SHAPES}


# ------------------------------------------------------------ dispatcher
def test_dispatcher_help_and_exit_codes(capsys):
    for argv, code in (([], 2), (["--help"], 0), (["-h"], 0),
                       (["nope"], 2)):
        with pytest.raises(SystemExit) as exc:
            launch_main(argv)
        assert exc.value.code == code, argv
    out = capsys.readouterr().out
    assert "unknown command 'nope'" in out
    for cmd in COMMANDS:
        assert cmd in out


@pytest.mark.parametrize("cmd", ["sweep", "pop", "serve", "serve-bench",
                                 "train", "dryrun", "profile", "history"])
def test_dispatcher_runs_each_command(cmd, capsys):
    """Each ported command reaches its own parser (its --help exits 0)."""
    with pytest.raises(SystemExit) as exc:
        launch_main([cmd, "--help"])
    assert exc.value.code == 0
    assert "usage:" in capsys.readouterr().out


# ----------------------------------------------------------- run_sharded
def test_run_sharded_is_the_scan_episode_on_one_card():
    env = MECEnv(make_scenario("fig5_baseline", n_devices=4), device="cpu")
    drv = RolloutDriver(agent_def("grle", env, device="cpu", hidden=(16, 8)),
                        4, train=True, replay_capacity=16, batch_size=4,
                        train_every=5, device="cpu")
    want = drv.run(3, 15, mode="scan")
    got = drv.run_sharded(3, 15, mesh=None)
    xs, ys = tree_tensors(got), tree_tensors(want)
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):      # bit for bit, NaN equal to NaN
        assert x.dtype == y.dtype and torch.equal(
            torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0))

    class Mesh3:
        """A fleet mesh of three devices (its size is all run_sharded
        reads before it refuses)."""

        @staticmethod
        def size():
            return 3

    # the reference's refusal: the fleets must divide the devices (the
    # sharded episode itself: tests/test_torch_sharded_rollout.py)
    with pytest.raises(ValueError, match="n_fleets=4 not divisible by 3 "
                                         "devices"):
        drv.run_sharded(3, 15, mesh=Mesh3())
