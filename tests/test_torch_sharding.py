"""The LM partition rules (PyTorch port) against the reference's, and their
DTensor placements.

``repro_torch.sharding.partition`` gives every parameter and cache leaf of
the ten architectures a spec, one entry per tensor dim, as
``repro.sharding.partition`` gives a ``PartitionSpec``: held leaf for leaf
on the reference's production meshes (16x16 and 2x16x16, shape only: the
rules read a mesh's axis sizes alone, so the reference's side gets a
stand-in with its ``shape``), on (4, 1) and (2, 2) host meshes, for the
params and for the caches at ``decode_32k`` and ``long_500k``, with
``REPRO_OPT`` unset and with ``seqshard_cache``. ``shard_shapes``' bytes
per device are held against the bytes the reference's specs give the same
trees, the dry run's ``single``/``multi`` records against both, and
``distribute_tree`` places a reduced Llama over a 2x2 gloo CPU mesh whose
``full_tensor()`` gives the input back bit for bit.
"""
from __future__ import annotations

import functools
import json
import math
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_rank_tasks as T
from repro.configs import ARCH_IDS
from repro.configs import get_arch as jax_get_arch
from repro.launch import specs as jax_specs
from repro.models.config import INPUT_SHAPES as JAX_SHAPES
from repro.models.lm import model_for as jax_model_for
from repro.sharding import partition as jax_partition
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import (ShapeMesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import INPUT_SHAPES
from repro_torch.models.lm import model_for
from repro_torch.nn.pytree import flatten_dict
from repro_torch.sharding import (PSpec, cache_pspecs, param_pspecs,
                                  shard_shapes, to_placements)
from repro_torch.sharding import runtime
from repro_torch.sharding.ranks import RankPool

MESHES = {
    "single": make_production_mesh(),
    "multi": make_production_mesh(multi_pod=True),
    "host_4x1": ShapeMesh((4, 1), ("data", "model")),
    "host_2x2": ShapeMesh((2, 2), ("data", "model")),
}
CACHE_SHAPES = ("decode_32k", "long_500k")


def ref_mesh(mesh):
    """The reference's view of a mesh: ``shape``, {axis: size}."""
    return types.SimpleNamespace(shape=dict(zip(mesh.mesh_dim_names,
                                                mesh.shape)))


def _key(entry) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(entry)


def jax_flat(tree, leaf=None) -> dict:
    """{path: leaf} of a JAX tree (specs: ``P`` leaves)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=None if leaf is None else
        (lambda x: isinstance(x, leaf)))
    return {"/".join(_key(e) for e in path): x for path, x in flat}


def port_flat(tree, prefix: str = "") -> dict:
    """{path: leaf} of a port tree of dicts and NamedTuples (specs:
    ``PSpec`` leaves)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(port_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@functools.lru_cache(maxsize=None)
def jax_params(arch: str):
    cfg = jax_get_arch(arch)
    return jax.eval_shape(
        lambda: jax_model_for(cfg).init(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def jax_cache(arch: str, shape: str):
    cfg = jax_specs.arch_for_shape(jax_get_arch(arch), JAX_SHAPES[shape])
    s = JAX_SHAPES[shape]
    return cfg, jax.eval_shape(lambda: jax_model_for(cfg).init_cache(
        cfg, s.global_batch, s.seq_len))


def port_cache(arch: str, shape: str):
    cfg = specs.arch_for_shape(get_arch(arch), INPUT_SHAPES[shape])
    s = INPUT_SHAPES[shape]
    return cfg, model_for(cfg).init_cache(cfg, s.global_batch, s.seq_len,
                                          device="meta")


def assert_same_specs(got: dict, want: dict) -> None:
    """Leaf for leaf: the port's per-dim tuple is the reference's spec."""
    assert sorted(got) == sorted(want)
    for path, spec in want.items():
        assert isinstance(got[path], PSpec), path
        assert tuple(got[path]) == tuple(spec), (path, got[path], spec)


def spec_bytes(shape, dtype_size: int, spec, sizes: dict) -> int:
    """One device's bytes of a tensor under a reference ``spec``."""
    n = 1
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= dim // math.prod(sizes[a] for a in names)
    return n * dtype_size


def ref_bytes(shapes: dict, jspecs: dict, sizes: dict) -> int:
    return sum(spec_bytes(x.shape, np.dtype(x.dtype).itemsize,
                          jspecs[path], sizes)
               for path, x in shapes.items())


def port_bytes(tree) -> int:
    return specs.tree_nbytes(tree)


# ------------------------------------------------------------- the rules
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch):
    """Every param leaf's spec on the four meshes, and the bytes a device
    holds under it (``shard_shapes``) against the reference's specs'."""
    cfg = get_arch(arch)
    params = specs.params_struct(cfg)
    shapes = jax_params(arch)
    jcfg = jax_get_arch(arch)
    for name, mesh in MESHES.items():
        want = jax_flat(jax_partition.param_pspecs(jcfg, shapes,
                                                   ref_mesh(mesh)), P)
        got = param_pspecs(cfg, params, mesh)
        assert_same_specs(port_flat(got), want)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        assert port_bytes(shard_shapes(params, got, mesh)) == ref_bytes(
            jax_flat(shapes), want, sizes), name


@pytest.mark.parametrize("opt", ["", "seqshard_cache"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, opt, monkeypatch):
    """Every cache leaf's spec at decode_32k and long_500k on the four
    meshes, with ``REPRO_OPT`` unset and with ``seqshard_cache``, and a
    device's bytes under them."""
    monkeypatch.setenv("REPRO_OPT", opt)
    for shape in CACHE_SHAPES:
        cfg, cache = port_cache(arch, shape)
        jcfg, jcache = jax_cache(arch, shape)
        seq = INPUT_SHAPES[shape].seq_len
        for name, mesh in MESHES.items():
            want = jax_flat(jax_partition.cache_pspecs(
                jcfg, jcache, ref_mesh(mesh), seq), P)
            got = cache_pspecs(cfg, cache, mesh, seq)
            assert_same_specs(port_flat(got), want)
            sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
            assert port_bytes(shard_shapes(cache, got, mesh)) == ref_bytes(
                jax_flat(jcache), want, sizes), (shape, name)


def test_seqshard_cache_moves_the_split():
    """Llama-3.2-1B's 8 KV heads do not divide the 16-way model axis: its
    decode cache splits head_dim there, and the sequence under
    ``seqshard_cache`` (read from ``REPRO_OPT`` at each call)."""
    cfg, cache = port_cache("llama3_2_1b", "decode_32k")
    mesh = MESHES["single"]
    seq = INPUT_SHAPES["decode_32k"].seq_len
    assert cache_pspecs(cfg, cache, mesh, seq)["layers"].k == PSpec(
        None, "data", None, None, "model")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_OPT", "no_remat,seqshard_cache")
        assert runtime.opts() == {"no_remat", "seqshard_cache"}
        assert runtime.enabled("seqshard_cache")
        assert cache_pspecs(cfg, cache, mesh, seq)["layers"].k == PSpec(
            None, "data", "model", None, None)


# ------------------------------------------------------------ meshes
def test_meshes_have_the_references_shapes():
    """The production meshes' axes and sizes (the reference's
    ``make_production_mesh``), and without a process group the host mesh
    is a shape-only (1, 1)."""
    single, multi = MESHES["single"], MESHES["multi"]
    assert (single.mesh_dim_names, single.shape, single.size()) == (
        ("data", "model"), (16, 16), 256)
    assert (multi.mesh_dim_names, multi.shape, multi.size()) == (
        ("pod", "data", "model"), (2, 16, 16), 512)
    host = make_host_mesh()
    assert (host.mesh_dim_names, host.shape) == (("data", "model"), (1, 1))
    with pytest.raises(ValueError):
        ShapeMesh((2, 2), ("data",))


def test_placements_of_a_spec():
    """``to_placements``: Shard(d) on each mesh dim a tensor dim names,
    Replicate() elsewhere; axes of one dim in mesh order; an axis the mesh
    lacks raises."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert to_placements(PSpec(None, "model"), mesh) == [
        Replicate(), Replicate(), Shard(1)]
    assert to_placements(PSpec(("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert to_placements(PSpec(), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="out of the mesh's order"):
        to_placements(PSpec(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        to_placements(PSpec("fleet"), mesh)


# --------------------------------------------------------------- dry run
@pytest.mark.parametrize("arch,shape", [
    ("llama3_2_1b", "train_4k"), ("deepseek_v2_236b", "decode_32k"),
    ("whisper_medium", "prefill_32k"), ("zamba2_2_7b", "long_500k")])
def test_dryrun_mesh_records(arch, shape, tmp_path, capsys, monkeypatch):
    """``dryrun --mesh both``: a ``single`` (256 devices) and a ``multi``
    (512) record, with the toggles in force and the per-device argument
    bytes: the reference's specs' bytes of the same arguments (params,
    optimizer state for train, batch, cache, tokens and positions), and no
    key that only a compiled XLA program gives."""
    monkeypatch.setenv("REPRO_OPT", "no_remat")
    out = tmp_path / "d.jsonl"
    dryrun.main(["--one", arch, shape, "--mesh", "both", "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["mesh"], r["devices"]) for r in recs] == [("single", 256),
                                                         ("multi", 512)]
    s = INPUT_SHAPES[shape]
    jcfg = jax_specs.arch_for_shape(jax_get_arch(arch), JAX_SHAPES[shape])
    for rec, mesh in zip(recs, (MESHES["single"], MESHES["multi"])):
        assert set(rec) == {"arch", "shape", "mesh", "devices", "opts",
                            "argument_size_in_bytes", "ok", "total_s"}
        assert rec["opts"] == ["no_remat"] and rec["ok"]
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        rm = ref_mesh(mesh)
        shapes = jax_params(arch)
        pspecs = jax_flat(jax_partition.param_pspecs(jcfg, shapes, rm), P)
        flat = jax_flat(shapes)
        want = ref_bytes(flat, pspecs, sizes)
        if s.mode == "train":       # Adam's mu and nu, and its step
            want += 2 * ref_bytes(flat, pspecs, sizes) + 2 * 4
        batch_ax = jax_partition._batch_axes(rm, s.global_batch)
        if s.mode == "decode":      # tokens and positions [B]
            want += 2 * spec_bytes((s.global_batch,), 4, P(batch_ax), sizes)
        else:                       # tokens (and labels) [B, S]
            want += (1 + (s.mode == "train")) * spec_bytes(
                (s.global_batch, s.seq_len), 4, P(batch_ax), sizes)
            if jcfg.enc_layers:
                want += spec_bytes((s.global_batch, jcfg.n_audio_frames,
                                    jcfg.d_model), 2, P(batch_ax), sizes)
        if s.mode == "decode":
            _, jcache = jax_cache(arch, shape)
            want += ref_bytes(jax_flat(jcache), jax_flat(
                jax_partition.cache_pspecs(jcfg, jcache, rm, s.seq_len), P),
                sizes)
        assert rec["argument_size_in_bytes"] == want, rec["mesh"]
    printed = [json.loads(line) for line in capsys.readouterr().out
               .splitlines()]
    assert [p["mesh"] for p in printed] == ["single", "multi"]


def test_params_struct_on_a_mesh_is_a_device_shard():
    """``params_struct(cfg, mesh)``: each leaf the local shape of its spec
    on the meta device; ``no_fsdp_infer`` drops the data split of an FSDP
    config's inference params."""
    cfg = get_arch("deepseek_moe_16b")
    mesh = MESHES["single"]
    whole = flatten_dict(specs.params_struct(cfg))
    local = flatten_dict(specs.params_struct(cfg, mesh))
    spec = flatten_dict(specs.params_specs(cfg, mesh))
    assert local.keys() == whole.keys()
    assert spec["embed/table"] == PSpec("model", "data")
    assert local["embed/table"].shape == (whole["embed/table"].shape[0] // 16,
                                          whole["embed/table"].shape[1] // 16)
    assert all(t.device.type == "meta" for t in local.values())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_OPT", "no_fsdp_infer")
        assert flatten_dict(specs.params_specs(cfg, mesh))[
            "embed/table"] == PSpec("model", None)


# ------------------------------------------------------------ placements
def test_distribute_tree_over_a_gloo_mesh(tmp_path):
    """A reduced Llama (FSDP on, so both axes split) placed by
    ``distribute_tree`` over a ("data", "model") 2x2 mesh of four gloo
    ranks: on every rank each DTensor's ``full_tensor()`` is the input bit
    for bit and its local shard has ``shard_shapes``' shape."""
    with RankPool(4, init_method=f"file://{tmp_path}/rdv") as pool:
        got = pool.run(T.distribute_llama, {"overrides": {"fsdp": True}})
    split = 0
    for rank in got:
        for path, (whole, local, want, spec) in rank.items():
            assert whole, path
            assert local == want, (path, local, want)
            split += any(e is not None for e in spec)
    assert split >= 4 * 8
