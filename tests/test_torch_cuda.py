"""repro_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import AgentDef, agent_def
from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import edge_score as edge_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import gcn_agg as gcn_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as ssm_mod
from repro_torch.mec import MECEnv, make_scenario
from repro_torch.models import DecoderLM
from repro_torch.nn.pytree import flatten_dict, unflatten_dict
from repro_torch.obs import hist_add, hist_init
from repro_torch.rollout import RolloutDriver, SlotDraws
from repro_torch.train import make_prefill_step, make_serve_step

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


# B: a live scheduler, the smoke's fleets, a sweep, and a B that is not a
# multiple of the graphs packed per block (a ragged last block)
ACTOR_BATCHES = [1, 64, 1000, 1024]


def gcn_inputs(device, b, m, o, fs, fn, h, seed):
    adj, *rest = on(device, *arrays(seed, (b, m, o), (b, m, fs), (b, o, fn),
                                    (fs, h), (fn, h), (h,), uniform=(0,)))
    if m < o:   # the option side reads a transposed view, as core/gcn.py does
        adj = adj.transpose(-1, -2).contiguous().transpose(-1, -2)
    return adj, *rest


def check_gcn_agg(adj, *rest):
    before = gcn_mod.launches
    got = gcn_mod.gcn_agg(adj, *rest)
    torch.cuda.synchronize()
    assert gcn_mod.launches == before + 1
    want = ref.gcn_agg_ref(adj, *rest)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.parametrize("b", ACTOR_BATCHES)
@pytest.mark.parametrize("m,o,fs,fn,h", SLICE_GCN)
def test_gcn_agg_kernel_matches_plain(cuda, b, m, o, fs, fn, h):
    check_gcn_agg(*gcn_inputs(cuda, b, m, o, fs, fn, h, b + h))


@pytest.mark.parametrize("b", [1, 1023])
@pytest.mark.parametrize("m,o,fs,fn,h", SLICE_GCN)
def test_gcn_agg_kernel_zero_adjacency_rows(cuda, b, m, o, fs, fn, h):
    """Rows with no link (inactive devices, dropped links) aggregate to 0:
    the first row of the first graph and every row of the last graph, which
    sits at the tail of the last block."""
    adj, *rest = gcn_inputs(cuda, b, m, o, fs, fn, h, 7)
    adj[0, 0] = 0.0
    adj[-1] = 0.0
    check_gcn_agg(adj, *rest)


@pytest.mark.parametrize("b", [3, 200])
def test_gcn_agg_kernel_at_a_runtime_width(cuda, b):
    """Fs = 9, Fn = 5, H = 48: the kernel's runtime-K instance, 4-byte
    copies of the 36-byte rows, one graph (B = 3) or several (B = 200) a
    block."""
    check_gcn_agg(*gcn_inputs(cuda, b, 5, 6, 9, 5, 48, b))


@pytest.mark.parametrize("b", ACTOR_BATCHES)
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


def test_edge_score_kernel_at_a_runtime_width(cuda):
    """H = 9, E = 11: the runtime instance, with padded rows."""
    b, m, o, h, e = 150, 5, 6, 9, 11
    args = on(cuda, *arrays(3, (b, m, h), (b, o, h), (b, m, o), (h, e), (e,),
                            (h, e), (e,), (e,), (1,), uniform=(2,)))
    np.testing.assert_allclose(edge_mod.edge_score(*args).cpu().numpy(),
                               ref.edge_score_ref(*args).cpu().numpy(), **TOL)


@pytest.mark.parametrize("b", [64, 1024])
def test_actor_kernel_info_matches_the_wrappers_layout(cuda, b):
    """The shared memory the kernels lay out is what the wrappers check
    against the limit, and at B = 1024 two blocks of layer 2 and of
    edge_score share an SM."""
    for m, o, fs, fn, h in SLICE_GCN:
        info = gcn_mod.kernel_info(b, m, o, fs, fn, h, cuda)
        assert info["smem_bytes"] == gcn_mod.smem_bytes(
            m, o, fs, fn, info["rows"], info["cols"], info["k_split"],
            info["stages"])
        assert info["blocks_per_sm"] >= (2 if b == 1024 else 1)
    info = edge_mod.kernel_info(b, 14, 10, 64, 64, cuda)
    assert info["smem_bytes"] == edge_mod.smem_bytes(14, 10, 64, 64,
                                                     info["graphs"])
    assert info["blocks_per_sm"] >= (2 if b == 1024 else 1)


def test_wrappers_refuse_what_the_kernel_cannot_take(cuda):
    args = on(cuda, *arrays(0, (2, 4, 3), (2, 4, 5), (2, 3, 6), (5, 8),
                            (6, 8), (8,)))
    with pytest.raises(TypeError, match="float32"):
        gcn_mod.gcn_agg(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        gcn_mod.gcn_agg(args[0], args[1].transpose(0, 1).contiguous()
                        .transpose(0, 1), *args[2:])
    # a 64-row tile of K = 8192 takes 2 MB of shared memory in A alone
    big = on(cuda, *arrays(0, (1, 64, 1), (1, 64, 4096), (1, 1, 4096),
                           (4096, 8), (4096, 8), (8,)))
    with pytest.raises(ValueError, match="shared memory"):
        gcn_mod.gcn_agg(*big)
    # W_src and W_dst are staged whole: 2 x 512 x 516 floats
    e_big = on(cuda, *arrays(0, (1, 2, 512), (1, 2, 512), (1, 2, 2),
                             (512, 512), (512,), (512, 512), (512,), (512,),
                             (1,)))
    with pytest.raises(ValueError, match="shared memory"):
        edge_mod.edge_score(*e_big)


def test_driver_launches_each_kernel_per_slot(cuda):
    env = MECEnv(make_scenario("fig5_baseline"), device=cuda)
    drv = RolloutDriver(agent_def("grle", env, device=cuda), 8, train=False,
                        device=cuda)
    ops.reset_launch_counts()
    _, trace = drv.run(0, 3, mode="loop")
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"gcn_agg": 12, "edge_score": 3,
                                   "flash_attention": 0,
                                   "decode_attention": 0, "ssm_scan": 0}
    assert trace.decisions.shape == (3, 8, env.M)
    assert bool(torch.isfinite(trace.reward).all())


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("shape", SLICE_GCN + ["edge"])
def test_actor_grads_match_autograd_of_plain(cuda, b, shape):
    """The kernels' forward with the hand-written backward against
    PyTorch's autograd of the plain versions, every input, at the actor's
    widths (the option side through a transposed adjacency view);
    tests/test_kernels.py's gradient tolerance."""
    if shape == "edge":
        args = on(cuda, *arrays(7, (b, 14, 64), (b, 10, 64), (b, 14, 10),
                                (64, 64), (64,), (64, 64), (64,), (64,),
                                (1,), uniform=(2,)))
        op, plain = ops.edge_score, ref.edge_score_ref
    else:
        args = gcn_inputs(cuda, b, *shape, seed=7)
        op, plain = ops.gcn_agg, ref.gcn_agg_ref
    xs = [a.detach().clone().requires_grad_() for a in args]
    if not args[0].is_contiguous():
        xs[0] = args[0].detach().transpose(-1, -2).clone() \
            .requires_grad_().transpose(-1, -2)
    ys = [a.detach().clone().requires_grad_() for a in args]
    out = op(*xs)
    cot = torch.randn(out.shape, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(0))
    got = torch.autograd.grad((out * cot).sum(), xs)
    want = torch.autograd.grad((plain(*ys) * cot).sum(), ys)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=2e-4, atol=1e-4, err_msg=f"input {i}")


def test_training_driver_launches(cuda):
    """train=True: every slot's forward plus every train step's, 4 + 1
    launches each; the losses finite; the decision path builds no graph."""
    env = MECEnv(make_scenario("fig5_baseline"), device=cuda)
    drv = RolloutDriver(agent_def("grle", env, device=cuda), 8, train=True,
                        replay_capacity=16, batch_size=16, train_every=2,
                        device=cuda)
    ops.reset_launch_counts()
    carry, trace = drv.run(0, 6, mode="loop")
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"gcn_agg": 36, "edge_score": 9,
                                   "flash_attention": 0,
                                   "decode_attention": 0, "ssm_scan": 0}
    loss = trace.loss.cpu().numpy()
    assert np.isnan(loss[0::2]).all() and np.isfinite(loss[1::2]).all()
    assert int(carry.agent_state.loss_count) == 3
    assert not any(p.requires_grad for layer in carry.agent_state.params
                   .values() for p in layer.values())


# ------------------------------------------------------- compiled episode
@pytest.mark.parametrize("inject_take", [False, True])
def test_scan_equals_loop_on_injected_draws(cuda, inject_take):
    """B=4 at full width, training every 2 slots on a 16-entry ring, with
    telemetry: tasks and exploration candidates injected, minibatch rows
    injected or drawn from the driver's generator (registered with the
    graphs). The captured episode makes the loop's decisions and rewards
    and folds the same telemetry; a second scan run replays the graphs."""
    env = MECEnv(make_scenario("fig5_baseline"), device=cuda)
    adef = agent_def("grle", env, device=cuda)
    b, t = 4, 12
    drv = RolloutDriver(adef, b, train=True, replay_capacity=16,
                        batch_size=8, train_every=2, telemetry=True,
                        device=cuda)
    tasks = env.sample_slot(torch.Generator(cuda).manual_seed(3), (t, b))
    rng = np.random.default_rng(0)
    rand = torch.tensor(rng.integers(0, env.N * env.L,
                                     (t, b, adef.n_random, env.M)),
                        device=cuda)
    take = None
    if inject_take:
        sizes = [min(b * s, 16) for s in range(2, t + 1, 2)]
        take = torch.tensor(np.stack([rng.permutation(z)[:8]
                                      for z in sizes]), device=cuda)
    draws = SlotDraws(tasks, rand, take)
    state = adef.init(torch.Generator(cuda).manual_seed(0))
    runs = [drv.run(5, t, mode=mode, agent_state=state, draws=draws)
            for mode in ("loop", "scan", "scan")]
    (c0, t0), rest = runs[0], runs[1:]
    assert np.isfinite(t0.loss.cpu().numpy()[1::2]).all()
    for c, tr in rest:
        for f in ("decisions", "reward", "success", "active"):
            assert torch.equal(getattr(tr, f), getattr(t0, f)), f
        np.testing.assert_allclose(tr.loss.cpu().numpy(),
                                   t0.loss.cpu().numpy(), rtol=1e-5)
        for k, p in flatten_dict(c.params).items():
            np.testing.assert_allclose(p.cpu().numpy(),
                                       flatten_dict(c0.params)[k].cpu()
                                       .numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        for name, h in c.telemetry.hists.items():
            assert torch.equal(h.counts, c0.telemetry.hists[name].counts)
        assert c.agent_state.host_step == c0.agent_state.host_step == t
        assert int(c.agent_state.opt_state["step"]) == t // 2


def test_scan_raises_on_a_host_sync_in_the_slot(cuda, monkeypatch):
    """A host sync planted in the slot body: the scan's warm-up under the
    sync debug mode refuses it, and nothing runs uncaptured instead."""
    env = MECEnv(make_scenario("fig5_baseline"), device=cuda)
    drv = RolloutDriver(agent_def("grle", env, device=cuda), 2, train=False,
                        device=cuda)
    real = AgentDef.decide_with

    def syncing(self, *args, **kw):
        out = real(self, *args, **kw)
        float(out[1].sum())                 # reads the device on the host
        return out

    monkeypatch.setattr(AgentDef, "decide_with", syncing)
    with pytest.raises(RuntimeError, match="synchroniz"):
        drv.run(0, 3, mode="scan")
    assert torch.cuda.get_sync_debug_mode() == 0
    _, trace = drv.run(0, 3, mode="loop")
    assert trace.decisions.shape == (3, 2, env.M)


def test_scan_captures_while_dropped_graphs_await_collection(cuda):
    """Graphs that only the cyclic collector can free (drivers a caller
    left in a reference cycle) do not break the next capture, even with
    the collector set to run at every allocation: CUDA forbids destroying
    a graph while a stream captures."""
    env = MECEnv(make_scenario("fig5_baseline"), device=cuda)
    adef = agent_def("grle", env, device=cuda)
    for seed in range(2):
        dropped = RolloutDriver(adef, 2, train=False, device=cuda)
        dropped.run(seed, 2, mode="scan")
        dropped.cycle = dropped
    del dropped
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        _, trace = RolloutDriver(adef, 2, train=False, device=cuda).run(
            0, 3, mode="scan")
    finally:
        gc.set_threshold(*threshold)
    assert trace.decisions.shape == (3, 2, env.M)


@pytest.mark.parametrize("method", ["grle", "drooe"])
def test_scan_dynamic_per_fleet_equals_loop(cuda, method):
    """A poisson workload with one sampled scenario per fleet and training
    on: scan (CUDA graphs) equals the loop bit for bit on one seed; a
    swapped ``sp`` of the same shapes replays the same graphs and again
    equals its loop; the MLP actor launches no actor kernel."""
    from repro_torch.mec import ScenarioParams, scenario_space
    env = MECEnv(make_scenario("dyn_churn", n_devices=6), device=cuda)
    drv = RolloutDriver(agent_def(method, env, device=cuda), 8, train=True,
                        replay_capacity=32, batch_size=8, train_every=5,
                        per_fleet_scenarios=True, device=cuda)
    space = scenario_space("dyn_churn", "dyn_markov_channel", n_devices=6,
                           device=cuda)
    sp = space.sample_batch(torch.Generator(cuda).manual_seed(0), 8)
    sp2 = ScenarioParams(*(x.flip(0) for x in sp))

    def same(a, b):
        return all(torch.equal(torch.nan_to_num(x, nan=7.0),
                               torch.nan_to_num(y, nan=7.0))
                   for x, y in zip(a[1], b[1]))

    ops.reset_launch_counts()
    loop = drv.run(3, 20, mode="loop", sp=sp)
    counts = ops.launch_counts()
    assert (counts["gcn_agg"] > 0) == (method == "grle")
    scan = drv.run(3, 20, sp=sp)
    episode = drv._episode
    assert same(loop, scan)
    scan2 = drv.run(3, 20, sp=sp2)
    assert drv._episode is episode
    assert same(drv.run(3, 20, mode="loop", sp=sp2), scan2)
    assert int(scan[0].agent_state.loss_count) == 4


def test_sweep_pack_replays_one_capture_per_pack(cuda):
    """A mixed iid pack (two named scenarios, one space draw) and a
    poisson pack, GRLE/GRL and DROOE/DROO, on the card: one episode built
    and two graphs captured per pack, every cell's row equal to
    ``run_cell``'s (its own driver and capture) bit for bit."""
    from repro_torch.obs import CompileTracker
    from repro_torch.sweep import SweepSpec, pack_cells, run_cell, run_sweep
    spec = SweepSpec(scenarios=("fig5_baseline", "fig8_csi",
                                "space:fig5_baseline:fig8_csi:0:0",
                                "dyn_poisson", "dyn_churn"),
                     seeds=(0,), n_devices=6, n_slots=30, replay_capacity=16,
                     batch_size=4, train_every=5)
    with CompileTracker() as ct:
        rows = run_sweep(spec, telemetry=True, device=cuda,
                         log=lambda *_: None)
    packs = pack_cells(spec.expand())
    assert {k: (v["episodes"], v["graphs"])
            for k, v in ct.by_label().items()} == {
        p.label(): (1, 2) for p in packs}
    for cell, row in zip(spec.expand(), rows):
        assert row["backend"] == "torch-cuda"
        assert run_cell(cell, telemetry=True, device=cuda) == row, \
            cell.label()


def test_population_driver_replays_one_capture(cuda):
    """Two PBT generations of four GRLE members with distinct hypers, and
    an evaluation, on the card: one episode built and two graphs captured
    for the training driver, one and one for the evaluation driver; a
    generation's scan run equals its loop run bit for bit."""
    from repro_torch.mec.scenarios import scenario_space
    from repro_torch.obs import CompileTracker
    from repro_torch.pop import Curriculum, PopulationTrainer
    from repro_torch.nn.pytree import tree_tensors

    env = MECEnv(make_scenario("fig5_baseline", n_devices=6), device=cuda)
    space = scenario_space(n_devices=6, device=cuda)
    with CompileTracker() as ct:
        tr = PopulationTrainer(
            agent_def("grle", env, device=cuda),
            Curriculum(space.lo, space.hi, n_regions=4), n_members=4,
            n_slots=20, replay_capacity=16, batch_size=4, train_every=5)
        ts, _ = tr.train(tr.init_state(), 2)
        tr.evaluate(ts.pop, 7, space.lo)
    assert {k: (v["episodes"], v["graphs"])
            for k, v in ct.by_label().items()} == {
        "pop_episode": (1, 2), "pop_eval": (1, 1)}
    _, sps = tr.curriculum.resample(ts.cur, None, 4,
                                    region=torch.arange(4),
                                    offset=torch.full((4,), 0.5))
    runs = [tr.driver.run_generation(ts.pop, 3, sps, mode=mode)
            for mode in ("scan", "loop")]
    xs, ys = tree_tensors(runs[0]), tree_tensors(runs[1])
    assert len(xs) == len(ys) and all(
        bool(((x == y) | (x.isnan() & y.isnan())).all())
        for x, y in zip(xs, ys))


def test_hist_add_sends_nan_and_inf_where_the_reference_does(cuda):
    """On the card too: -inf underflows, +inf and NaN overflow."""
    h = hist_init([0.0, 1.0, 2.0, 3.0], device=cuda)
    v = torch.tensor([np.nan, np.inf, -np.inf, 1.0, 3.0], device=cuda)
    assert hist_add(h, v).counts.tolist() == [1.0, 0.0, 1.0, 0.0, 3.0]


# ---------------------------------------------------------------- attention
# tests/test_kernels.py's attention tolerances
ATTN_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# (B, S, H, KVH, d, window): tests/test_kernels.py's grid, a ragged S, and
# Llama-3.2-1B's prefill shape at B=1; S = 200 (a 64-row tile cut at 8
# rows) at every head dim, and windows at d = 64, 80 and 128; d = 80 is
# StableLM-3B's and Zamba2's shared block's head
FLASH_SHAPES = [(1, 128, 2, 2, 32, None), (2, 128, 4, 2, 64, None),
                (1, 256, 8, 2, 32, 64), (2, 64, 4, 1, 128, None),
                (2, 100, 4, 2, 64, 48), (1, 2048, 32, 8, 64, None),
                (2, 200, 4, 2, 32, None), (1, 200, 8, 2, 64, 64),
                (1, 200, 4, 1, 128, None), (1, 384, 4, 2, 128, 64),
                (2, 200, 4, 2, 80, None), (1, 256, 4, 4, 80, 64)]
# (B, S, H, KVH, d) without the causal mask: Whisper's encoder (S = 1500
# frames, cut to 300 here) and a head of 80
NON_CAUSAL_SHAPES = [(2, 300, 4, 4, 64), (1, 200, 4, 2, 80),
                     (1, 1500, 16, 16, 64)]
# (B, H, KVH, d, S): tests/test_kernels.py's grid, Llama-3.2-1B's decode,
# heads of 80 (Zamba2's shared block: 32 over 32) and Whisper's
# cross-attention over 1500 frames
DECODE_SHAPES = [(2, 4, 2, 32, 256), (3, 8, 2, 64, 512), (1, 2, 2, 128, 128),
                 (8, 32, 8, 64, 256), (64, 32, 8, 64, 4096),
                 (3, 8, 2, 80, 300), (8, 32, 32, 80, 256),
                 (8, 16, 16, 64, 1500)]


# bf16 flash_attention against ref.flash_attention_bf16_emulation, beyond
# the output's bf16 rounding (flash_emu_err), as chip_smoke.py holds it (see
# there for the limit)
FLASH_EMU_TOL = 1e-3


def flash_emu_err(got, emu):
    """The error beyond the bf16 rounding of the output (half an ulp,
    <= 2^-8 |emu|), over 1 + the largest |emu| of its row (query, head)."""
    g, e = got.float(), emu.float()
    excess = ((g - e).abs() - 2.0 ** -8 * e.abs()).clamp(min=0)
    return float((excess.amax(-1) / (1 + e.abs().amax(-1))).max())


def normal(device, dtype, *shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.tensor(x, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kvh,d,win", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, s, h, kvh, d,
                                              win):
    q = normal(cuda, dtype, b, s, h, d, seed=1)
    k = normal(cuda, dtype, b, s, kvh, d, seed=2)
    v = normal(cuda, dtype, b, s, kvh, d, seed=3)
    before = flash_mod.launches
    got = flash_mod.flash_attention(q, k, v, window=win)
    torch.cuda.synchronize()
    assert flash_mod.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, window=win)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **ATTN_TOL[dtype])
    if dtype == torch.bfloat16:     # and at the precision of its arithmetic
        emu = ref.flash_attention_bf16_emulation(q, k, v, window=win)
        assert flash_emu_err(got, emu) <= FLASH_EMU_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kvh,d", NON_CAUSAL_SHAPES)
def test_flash_attention_non_causal_matches_plain(cuda, dtype, b, s, h, kvh,
                                                  d):
    q = normal(cuda, dtype, b, s, h, d, seed=1)
    k = normal(cuda, dtype, b, s, kvh, d, seed=2)
    v = normal(cuda, dtype, b, s, kvh, d, seed=3)
    got = flash_mod.flash_attention(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **ATTN_TOL[dtype])
    if dtype == torch.bfloat16:
        emu = ref.flash_attention_bf16_emulation(q, k, v, causal=False)
        assert flash_emu_err(got, emu) <= FLASH_EMU_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,d,s", DECODE_SHAPES)
def test_decode_attention_kernel_matches_plain(cuda, dtype, b, h, kvh, d, s):
    q = normal(cuda, dtype, b, h, d, seed=1)
    k = normal(cuda, dtype, b, s, kvh, d, seed=2)
    v = normal(cuda, dtype, b, s, kvh, d, seed=3)
    lens = np.random.default_rng(4).integers(1, s + 1, size=b)
    for lengths in (lens, np.full(b, s)):
        lengths = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        before = decode_mod.launches
        got = decode_mod.decode_attention(q, k, v, lengths)
        torch.cuda.synchronize()
        assert decode_mod.launches == before + 1
        want = ref.decode_attention_ref(q, k, v, lengths)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_strided_views_of_a_fused_projection(cuda,
                                                                  dtype):
    """q, k, v as head slices of one [B, S, H + 2 KVH, d] projection (row
    stride (H + 2 KVH) d), S not a multiple of the 64-row tile."""
    b, s, h, kvh, d = 2, 200, 8, 2, 64
    qkv = normal(cuda, dtype, b, s, h + 2 * kvh, d, seed=7)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kvh], qkv[:, :, h + kvh:]
    assert not q.is_contiguous()
    for win in (None, 48):
        got = flash_mod.flash_attention(q, k, v, window=win)
        want = ref.flash_attention_ref(q, k, v, window=win)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   **ATTN_TOL[dtype])
        if dtype == torch.bfloat16:
            emu = ref.flash_attention_bf16_emulation(q, k, v, window=win)
            assert flash_emu_err(got, emu) <= FLASH_EMU_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", range(1, decode_mod.MAX_SPLITS + 1))
def test_decode_attention_kernel_at_every_split_count(cuda, dtype, splits):
    """Llama-3.2-1B's B=1 decode against 4096 rows with the split count
    forced, lengths random and full; then lengths 0, 1, > S and short ones
    that leave splits empty, held against the split-KV plain version; a
    sequence of length 0 gets the mean of its V rows, as from the
    reference."""
    q = normal(cuda, dtype, 1, 32, 64, seed=1)
    k = normal(cuda, dtype, 1, 4096, 8, 64, seed=2)
    v = normal(cuda, dtype, 1, 4096, 8, 64, seed=3)
    for n in (1234, 4096):
        lengths = torch.tensor([n], dtype=torch.int32, device=cuda)
        before = decode_mod.launches
        got = decode_mod.decode_attention(q, k, v, lengths, splits=splits)
        torch.cuda.synchronize()
        assert decode_mod.launches == before + 1
        want = ref.decode_attention_ref(q, k, v, lengths)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   **ATTN_TOL[dtype])
    q = normal(cuda, dtype, 5, 8, 32, seed=4)
    k = normal(cuda, dtype, 5, 300, 2, 32, seed=5)
    v = normal(cuda, dtype, 5, 300, 2, 32, seed=6)
    lengths = torch.tensor([0, 1, 305, 3, 299], dtype=torch.int32,
                           device=cuda)
    got = decode_mod.decode_attention(q, k, v, lengths, splits=splits)
    want = ref.decode_attention_split_ref(q, k, v, lengths, splits)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **ATTN_TOL[dtype])
    np.testing.assert_allclose(got[0].float().cpu().numpy(),
                               v[0].float().mean(0).repeat_interleave(
                                   4, dim=0).cpu().numpy(),
                               **ATTN_TOL[dtype])


@pytest.mark.parametrize("splits", [None, 1, 3, 8])
def test_decode_attention_reads_a_strided_cache_layer(cuda, splits):
    """A layer's slice of the stacked [L, B, S, KVH, d] cache, and a query
    with a non-unit batch stride, as the model passes them; with the
    split count chosen by the wrapper and forced to one, a few and many."""
    cache = normal(cuda, torch.bfloat16, 3, 2, 128, 2, 64, seed=5)
    q = normal(cuda, torch.bfloat16, 2, 1, 4, 64, seed=6)[:, 0]
    lengths = torch.tensor([5, 128], dtype=torch.int32, device=cuda)
    got = decode_mod.decode_attention(q, cache[1], cache[2], lengths,
                                      splits=splits)
    want = ref.decode_attention_ref(q, cache[1], cache[2], lengths)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **ATTN_TOL[torch.bfloat16])


@pytest.mark.parametrize("op", ["flash_attention", "decode_attention"])
def test_attention_wrappers_refuse_what_the_kernel_cannot_take(cuda, op):
    fn = getattr(ops, op)
    decode = op == "decode_attention"
    qshape = (1, 4, 64) if decode else (1, 64, 4, 64)
    q = normal(cuda, torch.float32, *qshape)
    k = normal(cuda, torch.float32, 1, 64, 2, 64)
    extra = ((torch.full((1,), 64, dtype=torch.int32, device=cuda),)
             if decode else ())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn(q.double(), k.double(), k.double(), *extra)
    with pytest.raises(TypeError, match="share a dtype"):
        fn(q, k.bfloat16(), k.bfloat16(), *extra)
    with pytest.raises(ValueError, match="several devices"):
        fn(q, k.cpu(), k, *extra)
    q3 = normal(cuda, torch.float32, *qshape[:-2], 3, 64)
    with pytest.raises(ValueError, match="do not split"):
        fn(q3, k, k, *extra)
    q48 = normal(cuda, torch.float32, *qshape[:-1], 48)
    k48 = normal(cuda, torch.float32, 1, 64, 2, 48)
    with pytest.raises(ValueError, match="head_dim 48"):
        fn(q48, k48, k48, *extra)
    if decode:
        with pytest.raises(TypeError, match="int32"):
            fn(q, k, k, extra[0].long())
        # 512 (or 16) query heads on one kv head are more than the kernel's
        # group of at most 8: it refuses the launch at any split count, and
        # the next launch of a group that fits is not affected
        q512 = normal(cuda, torch.float32, 1, 512, 64)
        with pytest.raises(RuntimeError, match="launch failed"):
            fn(q512, k[:, :, :1], k[:, :, :1], *extra)
        q16 = normal(cuda, torch.float32, 1, 16, 64)
        for splits in (1, 4):
            with pytest.raises(RuntimeError, match="launch failed"):
                decode_mod.decode_attention(q16, k[:, :, :1], k[:, :, :1],
                                            *extra, splits=splits)
        with pytest.raises(ValueError, match="splits"):
            decode_mod.decode_attention(q, k, k, *extra, splits=9)
        got = fn(q, k, k, *extra)
        torch.cuda.synchronize()
        np.testing.assert_allclose(
            got.cpu().numpy(), ref.decode_attention_ref(q, k, k, *extra)
            .cpu().numpy(), **ATTN_TOL[torch.float32])


def test_lm_launch_counts(cuda):
    """A full-depth prefill of a 16-layer config launches flash_attention
    16 times; one serve_step at exit e launches decode_attention e times."""
    cfg = get_arch("llama3_2_1b").reduced(n_layers=16, n_kv_heads=2)
    params = DecoderLM.init(torch.Generator(device=cuda).manual_seed(0), cfg,
                            device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 24), device=cuda)
    ops.reset_launch_counts()
    logits, cache = make_prefill_step(cfg)(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 16
    assert ops.launch_counts()["decode_attention"] == 0
    assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(logits).all())
    for e in cfg.exit_layers:
        ops.reset_launch_counts()
        c = DecoderLM.init_cache(cfg, 2, 32, device=cuda)
        lg, _ = make_serve_step(cfg, exit_layer=e)(
            params, c, toks[:, 0], torch.zeros(2, dtype=torch.int64,
                                               device=cuda))
        torch.cuda.synchronize()
        assert ops.launch_counts() == {"gcn_agg": 0, "edge_score": 0,
                                       "flash_attention": 0,
                                       "decode_attention": e, "ssm_scan": 0}
        assert not c["layers"].k[e:].any()


@pytest.mark.parametrize("s", [0, 20, 40])
def test_window_decode_on_the_card_matches_the_cpu(cuda, s):
    """Reduced Llama (f32) under a window of 32: a prefill of ``s`` tokens
    (none: an empty ring), then serve_step through position 63 across the
    ring's wrap, on the card (both kernels) against the same on the CPU
    (their plain versions, which tests/test_torch_window.py holds against
    the reference's dense attention): logits and the ring within 1e-4;
    flash launches one a layer, decode_attention one a layer a step."""
    cfg = get_arch("llama3_2_1b").reduced(n_kv_heads=2, window=32)
    n = 64
    toks = torch.randint(0, cfg.vocab, (2, n),
                         generator=torch.Generator().manual_seed(1))
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        params = DecoderLM.init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        params = unflatten_dict({k: v.to(dev) for k, v in
                                 flatten_dict(params).items()})
        t = toks.to(dev)
        ops.reset_launch_counts()
        if s:
            _, cache, _ = DecoderLM.prefill(params, cfg, t[:, :s])
        else:
            cache = DecoderLM.init_cache(cfg, 2, 1 << 20, device=dev)
        step = make_serve_step(cfg)
        out = [step(params, cache, t[:, p],
                    torch.full((2,), p, dtype=torch.int64, device=dev))[0]
               for p in range(s, n)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert ops.launch_counts()["flash_attention"] == (
                cfg.n_layers if s else 0)
            assert ops.launch_counts()["decode_attention"] == \
                cfg.n_layers * (n - s)
        runs[dev.type] = (torch.stack(out).cpu(), cache["layers"].k.cpu())
    assert runs["cpu"][1].shape[2] == 32
    for got, want in zip(runs["cuda"], runs["cpu"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)


# --------------------------------------------------------------- ssm_scan
# tests/test_kernels.py's ssm tolerances and grid (B, T, H, dk, dv, chunk),
# a chunk below 16 rows, and RWKV-6-7B's head width at one sequence
SSM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
SSM_SHAPES = [(2, 64, 2, 8, 16, 16), (1, 128, 4, 16, 16, 32),
              (2, 32, 1, 64, 32, 32), (1, 24, 2, 32, 8, 8),
              (1, 512, 4, 64, 64, 128)]


def ssm_args(device, dtype, b, t, h, dk, dv, *, rwkv, slow, seed=0):
    """q, k, v unit normal in ``dtype``; log_w = -exp(0.5 N - 5 if slow
    else 0.5 N); bonus u and (if slow) a nonzero initial state, float32."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0, shift=0.0):
        x = scale * rng.standard_normal(shape) + shift
        return torch.tensor(x.astype(np.float32), device=device)

    q = f32(b, t, h, dk).to(dtype)
    k = f32(b, t, h, dk).to(dtype)
    v = f32(b, t, h, dv).to(dtype)
    log_w = -torch.exp(f32(b, t, h, dk, scale=0.5, shift=-5.0 if slow else 0))
    u = f32(h, dk, scale=0.2) if rwkv else None
    s0 = f32(b, h, dk, dv) if slow else None
    return q, k, v, log_w, u, s0


def assert_scan_close(got, want, tol, *, state=False):
    """|got - want| within ``tol`` times 1 + the largest |want| of the same
    (sequence, head), for y [B,T,H,dv] or a state [B,H,dk,dv]: the float32
    rounding of a recurrence's output scales with the sums it adds, and
    over hundreds of slow-decay steps |y| reaches the hundreds."""
    got, want = got.float(), want.float()
    scale = 1 + want.abs().amax(dim=(2, 3) if state else (1, 3),
                                keepdim=True)
    err = float(((got - want).abs() / scale).max())
    assert err <= tol, f"error {err} of 1 + max |value| above {tol}"


@pytest.mark.parametrize("slow", [False, True])
@pytest.mark.parametrize("rwkv", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,dk,dv,chunk", SSM_SHAPES)
def test_ssm_scan_kernel_matches_plain(cuda, b, t, h, dk, dv, chunk, dtype,
                                       rwkv, slow):
    q, k, v, w, u, s0 = ssm_args(cuda, dtype, b, t, h, dk, dv, rwkv=rwkv,
                                 slow=slow)
    before = ssm_mod.launches
    y, s = ssm_mod.ssm_scan(q, k, v, w, u, chunk=chunk, initial_state=s0)
    torch.cuda.synchronize()
    assert ssm_mod.launches == before + 1
    assert y.dtype == dtype and s.dtype == torch.float32
    want_y, want_s = ref.ssm_scan_ref(q, k, v, w, bonus_u=u, initial_state=s0)
    assert_scan_close(y, want_y, SSM_TOL[dtype])
    assert_scan_close(s, want_s, SSM_TOL[torch.float32], state=True)
    if dtype == torch.bfloat16:
        assert_emulated(y, s, q, k, v, w, u, s0, chunk)


def assert_emulated(y, s, q, k, v, w, u, s0, chunk):
    """The bf16 kernel against its own arithmetic in plain PyTorch, within
    the limits of ref.SSM_EMU_TOL (y, beyond its output rounding) and
    ref.SSM_EMU_STATE_TOL (the state)."""
    emu_y, emu_s = ref.ssm_scan_bf16_emulation(q, k, v, w, bonus_u=u,
                                               chunk=chunk, initial_state=s0)
    err_y = ref.ssm_emu_err(y, emu_y)
    err_s = ref.ssm_emu_err(s, emu_s, state=True)
    assert err_y <= ref.SSM_EMU_TOL, f"y {err_y} beyond its emulation"
    assert err_s <= ref.SSM_EMU_STATE_TOL, f"state {err_s} beyond emulation"


def test_ssm_scan_bf16_fits_two_blocks_per_sm(cuda):
    """RWKV-6-7B's head (dk = dv = 64) at chunk 128: the bf16 kernel's
    shared memory lets two blocks share an SM, the f32 kernel's one."""
    bf = ssm_mod.kernel_info(64, 64, 128, torch.bfloat16)
    f32 = ssm_mod.kernel_info(64, 64, 128, torch.float32)
    assert bf["smem_bytes"] <= 113 * 1024 and bf["blocks_per_sm"] == 2
    assert f32["smem_bytes"] > bf["smem_bytes"] and f32["blocks_per_sm"] == 1


def test_ssm_scan_reads_strided_inputs(cuda):
    """q/k/v/log_w as slices of wider rows (non-unit head and time
    strides), as a fused projection would hand them over."""
    b, t, h, d = 2, 64, 4, 32
    q, k, v, w, u, s0 = ssm_args(cuda, torch.bfloat16, b, t, h, 2 * d,
                                 2 * d, rwkv=True, slow=True)
    args = [x[..., :d] for x in (q, k, v, w)]
    assert not args[0].is_contiguous()
    s0 = s0[:, :, :d, :d].contiguous()
    y, s = ssm_mod.ssm_scan(*args, u[:, :d].contiguous(), chunk=32,
                            initial_state=s0)
    want_y, want_s = ref.ssm_scan_ref(*args, bonus_u=u[:, :d],
                                      initial_state=s0)
    assert_scan_close(y, want_y, SSM_TOL[torch.bfloat16])
    assert_scan_close(s, want_s, SSM_TOL[torch.float32], state=True)
    assert_emulated(y, s, *args, u[:, :d].contiguous(), s0, 32)
    # rows that do not start on 16 bytes are refused, not misread
    with pytest.raises(ValueError, match="16-byte"):
        ssm_mod.ssm_scan(*(x[..., 1:d + 1] for x in (q, k, v, w)),
                         u[:, :d].contiguous(), chunk=32)


def test_ssm_scan_refuses_what_the_kernel_cannot_take(cuda):
    q, k, v, w, u, _ = ssm_args(cuda, torch.float32, 1, 256, 2, 64, 64,
                                rwkv=True, slow=False)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.ssm_scan(q.double(), k.double(), v.double(), w, u, chunk=128)
    with pytest.raises(TypeError, match="share a dtype"):
        ops.ssm_scan(q, k.bfloat16(), v, w, u, chunk=128)
    with pytest.raises(TypeError, match="log_w"):
        ops.ssm_scan(q, k, v, w.bfloat16(), u, chunk=128)
    with pytest.raises(ValueError, match="several devices"):
        ops.ssm_scan(q, k, v, w.cpu(), u, chunk=128)
    q48, w48 = q[..., :48], w[..., :48]
    with pytest.raises(ValueError, match="dk 48"):
        ops.ssm_scan(q48, q48, v, w48, u[:, :48].contiguous(), chunk=128)
    # a 256-row chunk at dk = dv = 64 needs more shared memory than a block
    # has: the kernel refuses the launch, and the next launch is unaffected
    before = ssm_mod.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.ssm_scan(q, k, v, w, u, chunk=256)
    assert ssm_mod.launches == before
    y, s = ops.ssm_scan(q, k, v, w, u, chunk=128)
    torch.cuda.synchronize()
    want_y, want_s = ref.ssm_scan_ref(q, k, v, w, bonus_u=u)
    assert_scan_close(y, want_y, SSM_TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rwkv", [False, True])
def test_ssm_function_is_the_kernel_with_the_chunked_backward(cuda, rwkv,
                                                              dtype):
    """``ops.ssm_scan`` on inputs that require grad: one kernel launch, y
    and the final state the kernel's bit for bit; the gradients of
    <y, dy> + <S, dS> (the chunked plain VJP) within 1e-4 of each leaf's
    max |g| of autograd through the sequential plain version in float32
    on the same inputs and cotangents, beyond a bf16 gradient's own
    rounding; that gate rejects the sequential version's gradients with
    one chunk's decays perturbed."""
    b, t, h, dk, dv, chunk = 2, 64, 2, 16, 16, 32
    xs = ssm_args(cuda, dtype, b, t, h, dk, dv, rwkv=rwkv, slow=True)
    rng = np.random.default_rng(9)
    dy = torch.tensor(rng.standard_normal((b, t, h, dv)).astype(np.float32),
                      device=cuda).to(dtype).float()
    ds = torch.tensor(rng.standard_normal((b, h, dk, dv)).astype(np.float32),
                      device=cuda)

    def grads(fn, inputs):
        leaves = [None if x is None else x.clone().requires_grad_()
                  for x in inputs]
        y, s = fn(*leaves)
        loss = (y.float() * dy).sum() + (s * ds).sum()
        return y, s, torch.autograd.grad(
            loss, [x for x in leaves if x is not None])

    before = ssm_mod.launches
    y, s, got = grads(lambda q, k, v, w, u, s0: ops.ssm_scan(
        q, k, v, w, u, chunk=chunk, initial_state=s0), xs)
    torch.cuda.synchronize()
    assert ssm_mod.launches == before + 1
    ky, ks = ssm_mod.ssm_scan(*xs[:5], chunk=chunk, initial_state=xs[5])
    assert torch.equal(y, ky) and torch.equal(s, ks)
    f32 = [None if x is None else x.float() for x in xs]

    def seq(q, k, v, w, u, s0):
        return ref.ssm_scan_ref(q, k, v, w, bonus_u=u, initial_state=s0)

    _, _, want = grads(seq, f32)
    wrong_w = f32[3].clone()
    wrong_w[:, chunk:] *= 1.05
    _, _, wrong = grads(seq, f32[:3] + [wrong_w] + f32[4:])

    def excess(gs, ws):
        out = 0.0
        for g, w in zip(gs, ws):
            rnd = 2.0 ** -8 * w.abs() if g.dtype == torch.bfloat16 else 0.0
            err = ((g.float() - w).abs() - rnd).clamp(min=0)
            out = max(out, float(err.max()) / float(w.abs().max()))
        return out

    assert [g.dtype for g in got] == [x.dtype for x in xs if x is not None]
    assert excess(got, want) <= 1e-4
    assert excess(got, wrong) > 1e-4


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_2_7b"])
def test_ssm_train_step_launches_and_matches_the_cpu(cuda, arch):
    """A reduced RWKV-6 / Zamba2 (f32, remat, 8-row chunks) on the card: a
    train step launches ``ssm_scan`` twice a layer (the forward and its
    recompute) and flash once a shared-block application; the loss and
    every gradient are the CPU route's (the plain forward, the same VJP):
    1e-5 relative and 1e-4 of each leaf's max |g|."""
    from repro_torch.core.bridge import lm_params_from_numpy, lm_params_numpy
    from repro_torch.models.lm import n_shared_applications
    from repro_torch.optim import adamw
    from repro_torch.train.steps import (make_loss_fn, make_train_state,
                                         make_train_step)

    cfg = get_arch(arch).reduced(remat=True, ssm_chunk=8)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 33))
    out = {}
    for dev in (torch.device("cpu"), cuda):
        params = lm_params_from_numpy(lm_params_numpy(cfg, 0), cfg, dev)
        batch = {"tokens": torch.tensor(toks[:, :-1], device=dev),
                 "labels": torch.tensor(toks[:, 1:], device=dev)}
        flat = {k: v.detach().clone().requires_grad_()
                for k, v in flatten_dict(params).items()}
        loss, _ = make_loss_fn(cfg)(unflatten_dict(flat), batch)
        grads = torch.autograd.grad(loss, list(flat.values()))
        state, opt = make_train_state(cfg, None, adamw(1e-5), params=params)
        ops.reset_launch_counts()
        _, metrics = make_train_step(cfg, opt)(state, batch)
        torch.cuda.synchronize()
        out[dev.type] = (float(loss), dict(zip(flat, grads)),
                         ops.launch_counts(), float(metrics["loss"]))
    assert out["cpu"][2]["ssm_scan"] == 0
    assert out["cuda"][2]["ssm_scan"] == 2 * cfg.n_layers
    assert out["cuda"][2]["flash_attention"] == n_shared_applications(cfg)
    for i in (0, 3):
        np.testing.assert_allclose(out["cuda"][i], out["cpu"][i], rtol=1e-5)
    for k, g in out["cuda"][1].items():
        want = out["cpu"][1][k].numpy()
        err = float(np.abs(g.cpu().numpy() - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), k


def test_rwkv_launch_counts(cuda):
    """A prefill of a 4-layer RWKV-6 launches ssm_scan 4 times and no
    attention kernel; a serve_step launches no kernel at any exit and
    leaves the state past the exit untouched."""
    cfg = get_arch("rwkv6_7b").reduced(n_layers=4, dtype="bfloat16")
    params = DecoderLM.init(torch.Generator(device=cuda).manual_seed(0), cfg,
                            device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 64), device=cuda)
    ops.reset_launch_counts()
    logits, cache = make_prefill_step(cfg)(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"gcn_agg": 0, "edge_score": 0,
                                   "flash_attention": 0,
                                   "decode_attention": 0, "ssm_scan": 4}
    assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(logits).all())
    for e in cfg.exit_layers:
        ops.reset_launch_counts()
        c = DecoderLM.init_cache(cfg, 2, 64, device=cuda)
        lg, _ = make_serve_step(cfg, exit_layer=e)(
            params, c, toks[:, 0], torch.zeros(2, dtype=torch.int64,
                                               device=cuda))
        torch.cuda.synchronize()
        assert sum(ops.launch_counts().values()) == 0
        assert bool(torch.isfinite(lg).all())
        assert c["layers"].wkv[:e].any() and not c["layers"].wkv[e:].any()


# ------------------------------------------------------------- training
FLASH_FN_SHAPES = [(2, 64, 4, 2, 64, True, None),
                   (2, 96, 4, 4, 32, True, 24),
                   (1, 80, 4, 4, 64, False, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kvh,d,causal,win", FLASH_FN_SHAPES)
def test_flash_function_is_the_kernel_with_the_plain_backward(
        cuda, dtype, b, s, h, kvh, d, causal, win):
    """``ops.flash_attention`` on inputs that require grad: one kernel
    launch, its output the kernel's bit for bit, and q/k/v gradients
    within ATTN_TOL of autograd through the plain version; a backward
    without the softmax scale falls outside that tolerance."""
    q = normal(cuda, dtype, b, s, h, d, seed=1)
    k = normal(cuda, dtype, b, s, kvh, d, seed=2)
    v = normal(cuda, dtype, b, s, kvh, d, seed=3)
    dout = normal(cuda, dtype, b, s, h, d, seed=4)

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, causal=causal, window=win)
        return out, torch.autograd.grad(out, leaves, dout)

    before = flash_mod.launches
    out, got = grads(ops.flash_attention)
    torch.cuda.synchronize()
    assert flash_mod.launches == before + 1
    assert torch.equal(out, flash_mod.flash_attention(q, k, v, causal=causal,
                                                      window=win))
    _, want = grads(ref.flash_attention_ref)
    _, wrong = grads(lambda q_, k_, v_, **kw: ref.flash_attention_ref(
        q_ * d ** 0.5, k_, v_, **kw))
    tol = ATTN_TOL[dtype]
    for g, w, x in zip(got, want, wrong):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), **tol)
    assert any(not np.allclose(x.float().cpu().numpy(),
                               w.float().cpu().numpy(), **tol)
               for x, w in zip(wrong, want))


@pytest.mark.parametrize("remat", [False, True])
def test_lm_train_step_launches_and_matches_the_cpu(cuda, remat):
    """A reduced Llama train step (f32, exits (1, 2)) on the card: one
    flash launch per layer, two under remat (the recomputed forward), and
    the same loss and params as the CPU's plain route."""
    from repro_torch.core.bridge import lm_params_from_numpy, lm_params_numpy
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_state, make_train_step

    cfg = get_arch("llama3_2_1b").reduced(exit_layers=(1, 2), remat=remat)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 33))
    out = {}
    for dev in (torch.device("cpu"), cuda):
        params = lm_params_from_numpy(lm_params_numpy(cfg, 0), cfg, dev)
        state, opt = make_train_state(cfg, None, adamw(1e-5), params=params)
        batch = {"tokens": torch.tensor(toks[:, :-1], device=dev),
                 "labels": torch.tensor(toks[:, 1:], device=dev)}
        before = flash_mod.launches
        state, metrics = make_train_step(cfg, opt)(state, batch)
        torch.cuda.synchronize()
        out[dev.type] = (state, metrics, flash_mod.launches - before)
    assert out["cpu"][2] == 0
    assert out["cuda"][2] == cfg.n_layers * (2 if remat else 1)
    np.testing.assert_allclose(float(out["cuda"][1]["loss"]),
                               float(out["cpu"][1]["loss"]), rtol=1e-5)
    cpu = flatten_dict(out["cpu"][0].params)
    for k, x in flatten_dict(out["cuda"][0].params).items():
        np.testing.assert_allclose(x.cpu().numpy(), cpu[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (1, "VALID"), (2, "VALID")])
def test_conv2d_float32_on_the_card_runs_without_tf32(cuda, stride, padding):
    """Conv2D in float32 on the card against float64 on the CPU: within
    float32 rounding even with cuDNN's TF32 switched on globally, which
    the layer turns off for its own convolutions (and restores)."""
    from repro_torch.nn import Conv2D

    x, w, bias = arrays(5, (4, 17, 17, 64), (3, 3, 64, 128), (128,))
    want = Conv2D.apply({"w": torch.tensor(w).double(),
                         "b": torch.tensor(bias).double()},
                        torch.tensor(x).double(), stride=(stride, stride),
                        padding=padding)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = Conv2D.apply({"w": torch.tensor(w, device=cuda),
                            "b": torch.tensor(bias, device=cuda)},
                           torch.tensor(x, device=cuda),
                           stride=(stride, stride), padding=padding)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    scale = 1.0 + float(want.abs().max())
    err = float((got.double().cpu() - want).abs().max())
    assert err <= 1e-5 * scale, err
