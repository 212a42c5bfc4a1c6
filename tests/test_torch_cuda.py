"""repro_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import agent_def
from repro_torch.kernels import edge_score as edge_mod
from repro_torch.kernels import gcn_agg as gcn_mod
from repro_torch.kernels import ops, ref
from repro_torch.mec import MECEnv, make_scenario
from repro_torch.rollout import RolloutDriver

pytestmark = pytest.mark.cuda

# f32, the tolerance of tests/test_kernels.py's actor-path kernels
TOL = dict(rtol=1e-5, atol=1e-5)
# (M, O, Fs, Fn, H) of the four gcn_agg launches of one actor forward
SLICE_GCN = [(14, 10, 7, 4, 128), (10, 14, 4, 7, 128),
             (14, 10, 128, 128, 64), (10, 14, 128, 128, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def arrays(seed, *shapes, uniform=()):
    """Uniform [0, 1) for the positions in ``uniform`` (adjacency, edge
    feature), else normal scaled by 1/sqrt(leading dim) as the actor's
    initializer scales weights. Unit-variance weights at widths 64..128
    put outputs near 100, where float32 summation order alone moves them
    by more than 1e-5 absolute."""
    rng = np.random.default_rng(seed)
    return tuple((rng.uniform(size=s) if i in uniform
                  else rng.normal(size=s) / np.sqrt(s[0] if len(s) == 2 else 1))
                 .astype(np.float32) for i, s in enumerate(shapes))


def on(device, *xs):
    return tuple(torch.tensor(x, device=device) for x in xs)


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("m,o,fs,fn,h", SLICE_GCN)
def test_gcn_agg_kernel_matches_plain(cuda, b, m, o, fs, fn, h):
    adj, *rest = on(cuda, *arrays(b + h, (b, m, o), (b, m, fs), (b, o, fn),
                                  (fs, h), (fn, h), (h,), uniform=(0,)))
    if m < o:   # the option side reads a transposed view, as core/gcn.py does
        adj = adj.transpose(-1, -2).contiguous().transpose(-1, -2)
    before = gcn_mod.launches
    got = gcn_mod.gcn_agg(adj, *rest)
    torch.cuda.synchronize()
    assert gcn_mod.launches == before + 1
    want = ref.gcn_agg_ref(adj, *rest)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.parametrize("b", [1, 64])
def test_edge_score_kernel_matches_plain(cuda, b):
    m, o, h, e = 14, 10, 64, 64
    args = on(cuda, *arrays(b, (b, m, h), (b, o, h), (b, m, o), (h, e), (e,),
                            (h, e), (e,), (e,), (1,), uniform=(2,)))
    before = edge_mod.launches
    got = edge_mod.edge_score(*args)
    torch.cuda.synchronize()
    assert edge_mod.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               ref.edge_score_ref(*args).cpu().numpy(), **TOL)


def test_wrappers_refuse_what_the_kernel_cannot_take(cuda):
    args = on(cuda, *arrays(0, (2, 4, 3), (2, 4, 5), (2, 3, 6), (5, 8),
                            (6, 8), (8,)))
    with pytest.raises(TypeError, match="float32"):
        gcn_mod.gcn_agg(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        gcn_mod.gcn_agg(args[0], args[1].transpose(0, 1).contiguous()
                        .transpose(0, 1), *args[2:])
    big = on(cuda, *arrays(0, (1, 64, 64), (1, 64, 256), (1, 64, 256),
                           (256, 8), (256, 8), (8,)))
    with pytest.raises(ValueError, match="shared memory"):
        gcn_mod.gcn_agg(*big)


def test_driver_launches_each_kernel_per_slot(cuda):
    env = MECEnv(make_scenario("fig5_baseline"), device=cuda)
    drv = RolloutDriver(agent_def("grle", env, device=cuda), 8, device=cuda)
    ops.reset_launch_counts()
    _, trace = drv.run(0, 3)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"gcn_agg": 12, "edge_score": 3}
    assert trace.decisions.shape == (3, 8, env.M)
    assert bool(torch.isfinite(trace.reward).all())
