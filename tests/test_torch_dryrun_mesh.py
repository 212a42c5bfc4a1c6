"""The dry run on meshes (PyTorch port): the fake process group's
``DeviceMesh`` (``launch/mesh.py``), the per-device accounting of a
partitioned step (``launch/analysis.py::partitioned_cost``) and the
``single``/``multi`` records (``launch/dryrun.py``).

A hand-computable case on a fake 4-rank mesh (one sharded matmul, its
backward and one redistribute) fixes FLOPs, bytes, every collective's
count and bytes, and the argument and output bytes exactly. The golden
configs of ``tools/make_torch_dryrun_golden.py`` (reduced Llama, RWKV-6
and DeepSeek-MoE, one layer, train, prefill and decode at S = 64, B = 4)
run on a fake 2x2 mesh, and their per-device FLOPs lie within 0.4-2.5x
of the reference's compiled partitioned step's ``cost_analysis`` FLOPs on
a 2x2 mesh (``tests/data/torch_dryrun_golden.json``; the reference's own
gate between its analytic model and XLA, ``tests/test_analysis.py``),
with every record key; the same configs run on a fake 16x16 mesh.
"""
from __future__ import annotations

import json
import os
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import get_arch
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as flash_module
from repro_torch.launch import dryrun
from repro_torch.launch.analysis import COLLECTIVES, partitioned_cost
from repro_torch.launch.mesh import fake_device_mesh, production_device_mesh
from repro_torch.models.config import ShapeSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_dryrun_golden as golden_tool  # noqa: E402

sys.path.pop(0)

GOLDEN = golden_tool.load()
STEP_KEYS = {"flops", "bytes_accessed", "collectives", "collectives_flat",
             "output_size_in_bytes", "temp_size_in_bytes"}
FLOP_RATIO = (0.4, 2.5)


def fake_dtensor(mesh, fake, local_shape, placements, shape):
    with fake:
        local = torch.empty(local_shape)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def test_hand_computed_case():
    """x [16, 8] split in rows over 4 ranks, w [8, 4] replicated (float32):
    y = x @ w (local [4, 8] @ [8, 4]: 256 FLOPs), z = y gathered whole
    (one all-gather, result [16, 4]: 256 bytes), the gradient of z.sum()
    in w (local x^T [8, 4] @ dy [4, 4]: 256 FLOPs; a partial sum, left
    so). Bytes: each operation's inputs and outputs, views and metadata
    queries moving nothing: the matmul 128 + 128 + 64, the all-gather
    64 + 256, the sum 256 + 4, ``ones_like`` 4 + 4, the backward's split of
    dz into the rows' blocks (a view) and its copy 64 + 64, the backward
    matmul 128 + 64 + 128."""
    with fake_device_mesh((4,), ("data",)) as mesh:
        fake = FakeTensorMode()
        x = fake_dtensor(mesh, fake, (4, 8), [Shard(0)], (16, 8))
        w = fake_dtensor(mesh, fake, (8, 4), [Replicate()], (8, 4))

        def step(x, w):
            w = w.detach().requires_grad_()
            with torch.enable_grad():
                z = (x @ w).redistribute(mesh, [Replicate()])
                (g,) = torch.autograd.grad(z.sum(), [w])
            return g

        cost, g = partitioned_cost(step, x, w, fake_mode=fake)
    assert g.placements[0].is_partial()
    assert cost["flops"] == 256 + 256
    assert cost["bytes_accessed"] == ((128 + 128 + 64) + (64 + 256)
                                      + (256 + 4) + (4 + 4) + (64 + 64)
                                      + (128 + 64 + 128))
    assert cost["collectives"] == {
        "all-gather": {"count": 1, "bytes": 256, "wire_bytes": 256.0}}
    assert cost["argument_size_in_bytes"] == 128 + 128
    assert cost["output_size_in_bytes"] == 128
    # the whole z (256 bytes) was live beside the arguments
    assert 256 <= cost["temp_size_in_bytes"] < 4096


def test_shard_to_shard_counts_one_all_to_all():
    """Shard(0) -> Shard(1) of a [16, 4] float32 over 4 ranks: one
    all-to-all of the [16, 1] result (64 bytes), which a "cpu" mesh
    issues as an all-gather and a chunk; nothing else is counted."""
    with fake_device_mesh((4,), ("data",)) as mesh:
        fake = FakeTensorMode()
        y = fake_dtensor(mesh, fake, (4, 4), [Shard(0)], (16, 4))
        cost, out = partitioned_cost(
            lambda y: y.redistribute(mesh, [Shard(1)]), y, fake_mode=fake)
    assert out.placements == (Shard(1),)
    assert cost["collectives"] == {
        "all-to-all": {"count": 1, "bytes": 64, "wire_bytes": 64.0}}
    assert cost["flops"] == 0
    assert cost["bytes_accessed"] == 64 + 64


def test_fake_mesh_refuses_a_group_and_leaves_none():
    with fake_device_mesh((2, 2), ("data", "model")) as mesh:
        assert tuple(mesh.shape) == (2, 2)
        assert mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(RuntimeError, match="already initialized"):
            with fake_device_mesh((2,), ("data",)):
                pass
    assert not dist.is_initialized()
    with production_device_mesh(multi_pod=True) as mesh:
        assert tuple(mesh.shape) == (2, 16, 16)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert mesh.size() == 512
    assert not dist.is_initialized()


def test_a_dtensor_never_reaches_a_kernel_wrapper():
    """Only ``ops`` takes a DTensor (to each device's shard): a kernel's
    wrapper given one raises."""
    with fake_device_mesh((2,), ("data",)) as mesh:
        q = DTensor.from_local(torch.zeros(1, 4, 2, 32), mesh, [Shard(0)],
                               run_check=False)
        with pytest.raises(TypeError, match="DTensor"):
            _build.device_of(q)
        with pytest.raises(TypeError, match="DTensor"):
            flash_module.flash_attention(q, q, q)


def golden_records(mesh_shape, names):
    """The partitioned step's record of every golden config and shape on
    a fake mesh of ``mesh_shape``."""
    out = {}
    with fake_device_mesh(mesh_shape, names) as mesh:
        for arch in golden_tool.CONFIGS:
            cfg = golden_tool.config(get_arch, arch)
            for name, (s, b, mode) in golden_tool.SHAPES.items():
                out[f"{arch}/{name}"] = dryrun.partitioned_step(
                    cfg, ShapeSpec(name, s, b, mode), mesh)
    return out


@pytest.fixture(scope="module")
def on_2x2():
    torch.set_num_threads(1)
    return golden_records(*golden_tool.MESH)


@pytest.mark.parametrize("key", sorted(GOLDEN["records"]))
def test_flops_within_the_reference_gate(on_2x2, key):
    rec = on_2x2[key]
    assert set(rec) == STEP_KEYS
    ratio = rec["flops"] / GOLDEN["records"][key]["flops"]
    assert FLOP_RATIO[0] < ratio < FLOP_RATIO[1], (key, ratio)
    assert rec["collectives"] == rec["collectives_flat"]
    assert set(rec["collectives"]) <= set(COLLECTIVES)
    for kind, c in rec["collectives"].items():
        assert c["count"] >= 1 and c["bytes"] > 0
        assert c["wire_bytes"] == c["bytes"] * (2.0 if kind == "all-reduce"
                                                else 1.0)
    assert rec["bytes_accessed"] > 0 and rec["output_size_in_bytes"] > 0
    assert rec["temp_size_in_bytes"] >= 0


def test_golden_configs_run_on_16x16():
    """The reduced configs on the production mesh's shape: batch 4 and 4
    heads divide neither axis, so the rules leave those dims whole."""
    recs = golden_records((16, 16), ("data", "model"))
    assert sorted(recs) == sorted(GOLDEN["records"])
    for key, rec in recs.items():
        assert set(rec) == STEP_KEYS and rec["flops"] > 0, key


def test_golden_file_matches_its_tool():
    assert GOLDEN["configs"] == json.loads(json.dumps(golden_tool.CONFIGS))
    assert GOLDEN["shapes"] == json.loads(json.dumps(golden_tool.SHAPES))
    assert GOLDEN["mesh"] == json.loads(json.dumps(golden_tool.MESH))


def test_dryrun_one_mesh_both_llama(tmp_path, capsys):
    """``dryrun --one llama3_2_1b decode_32k --mesh both``: a 256- and a
    512-device record, each with the partitioned step's keys."""
    out = tmp_path / "d.jsonl"
    dryrun.main(["--one", "llama3_2_1b", "decode_32k", "--mesh", "both",
                 "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["mesh"], r["devices"], r["ok"]) for r in recs] == [
        ("single", 256, True), ("multi", 512, True)]
    for r in recs:
        assert STEP_KEYS | {"argument_size_in_bytes"} <= set(r)
        assert r["flops"] > 0 and r["collectives"]
    # half the batch a device on two pods: half the step's FLOPs
    assert recs[1]["flops"] == pytest.approx(recs[0]["flops"] / 2, rel=1e-2)
    capsys.readouterr()
