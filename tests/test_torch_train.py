"""The port's training slice against the JAX package: the actor kernels'
gradients, Adam, the replay ring, the Eq-16 loss, a train step, the train
gate, a ``train=True`` episode and the checkpoint format.

Random draws cannot be shared bit for bit (threefry against torch's
generators), so the reference's exploration candidates and replay rows
are rebuilt from its key schedule and injected
(``tools/make_torch_port_golden.py``). ``tests/data/
torch_port_train_golden.npz`` carries one such episode to the GPU machine,
where JAX is not installed; a test here keeps it current.
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.core import devreplay as jax_replay
from repro.core.graph import build_graph as jax_build_graph
from repro.core.policy import agent_def as jax_agent_def
from repro.kernels import ops as jax_ops
from repro.mec import MECEnv as JaxEnv
from repro.mec import make_scenario as jax_scenario
from repro.optim import adam as jax_adam
from repro.optim.optimizers import apply_updates as jax_apply_updates
from repro.rollout import RolloutDriver as JaxDriver
from repro.rollout.metrics import metrics_finalize as jax_metrics_finalize
from repro.train import checkpoint as jax_ckpt
from repro_torch.core import (MECGraph, agent_def, agent_state_from_numpy,
                              agent_state_from_params, replay_add,
                              replay_init, replay_sample)
from repro_torch.core.devreplay import replay_indices
from repro_torch.kernels import ops, ref
from repro_torch.mec import MECEnv, SlotTasks, make_scenario
from repro_torch.nn.pytree import flatten_dict
from repro_torch.optim import adam, apply_updates, scale_updates
from repro_torch.rollout import RolloutDriver, SlotDraws
from repro_torch.train import (restore_agent_state, restore_checkpoint,
                               save_agent_state)
from repro_torch.train._msgpack import packb, unpackb
from repro_torch.train.checkpoint import _encode_tree, read_payload

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import make_torch_port_golden as golden_tool  # noqa: E402

sys.path.pop(0)
torch.set_num_threads(1)

# tests/test_kernels.py's tolerance for the actor kernels' gradients
GRAD_TOL = dict(rtol=2e-4, atol=1e-4)
# tests/test_policy.py::test_driver_matches_host_step's for trained params
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5
SMALL_KW = dict(buffer_size=32, batch_size=12, train_every=5)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t_tree(tree):
    return jax.tree_util.tree_map(lambda x: torch.tensor(np.asarray(x)),
                                  tree)


def assert_tree_close(got: dict, want: dict, **tol):
    got, want = flatten_dict(got), flatten_dict(np_tree(want))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        np.testing.assert_allclose(
            g.detach().numpy() if isinstance(g, torch.Tensor) else g, w,
            err_msg=k, **tol)


# ------------------------------------------------------- the autograd ops
def gcn_args(seed, b, m, o, fs=7, fn=4, h=16, dtype=np.float32):
    """tests/test_kernels.py's gcn_agg shapes, drawn with numpy."""
    rng = np.random.default_rng(seed)
    adj = rng.uniform(size=(b, m, o)) * (rng.uniform(size=(b, m, o)) > 0.3)
    return tuple(a.astype(dtype) for a in (
        adj, rng.normal(size=(b, m, fs)), rng.normal(size=(b, o, fn)),
        rng.normal(size=(fs, h)), rng.normal(size=(fn, h)),
        rng.normal(size=(h,))))


def edge_args(seed, b, m, o, h=9, e=11, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(a.astype(dtype) for a in (
        rng.normal(size=(b, m, h)), rng.normal(size=(b, o, h)),
        rng.uniform(size=(b, m, o)), rng.normal(size=(h, e)),
        rng.normal(size=(e,)), rng.normal(size=(h, e)),
        rng.normal(size=(e,)), rng.normal(size=(e,)), rng.normal(size=(1,))))


def torch_grads(fn, args):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    (fn(*ts) ** 2).sum().backward()
    return [t.grad.numpy() for t in ts]


def jax_grads(fn, args):
    return jax.grad(lambda a: jnp.sum(fn(*a) ** 2))(
        tuple(jnp.asarray(a) for a in args))


@pytest.mark.parametrize("op", ["gcn_agg", "edge_score"])
@pytest.mark.parametrize("b,m,o", [(1, 5, 6), (64, 14, 12)])
def test_op_grads_match_jax(op, b, m, o):
    """Every input's gradient of sum(out^2) against ``jax.grad`` through
    the reference's hand-written VJP (its CPU path)."""
    args = (gcn_args if op == "gcn_agg" else edge_args)(0, b, m, o)
    got = torch_grads(getattr(ops, op), args)
    want = jax_grads(getattr(jax_ops, op), args)
    assert len(got) == len(want) == len(args)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"input {i}",
                                   **GRAD_TOL)


@pytest.mark.parametrize("op", ["gcn_agg", "edge_score"])
def test_op_gradcheck_float64(op):
    """Finite differences in float64 against the hand-written backward."""
    args = (gcn_args(1, 2, 3, 4, fs=3, fn=2, h=5, dtype=np.float64)
            if op == "gcn_agg" else
            edge_args(1, 2, 3, 4, h=3, e=5, dtype=np.float64))
    ts = tuple(torch.tensor(a, requires_grad=True) for a in args)
    assert torch.autograd.gradcheck(getattr(ops, op), ts, eps=1e-6,
                                    atol=1e-6, rtol=1e-5)


def test_gcn_agg_grads_through_a_transposed_adjacency():
    """The option side passes ``adj`` as a transposed view
    (``core/gcn.py``): the forward saves that view, not a copy, and the
    gradients match JAX's on the materialized transpose."""
    adj, hs, hn, ws, wn, bias = gcn_args(2, 8, 5, 6)
    base = torch.tensor(np.ascontiguousarray(adj.transpose(0, 2, 1)),
                        requires_grad=True)                   # [B, O, M]
    ts = [torch.tensor(a, requires_grad=True) for a in (hs, hn, ws, wn,
                                                         bias)]
    adj_t = base.transpose(-1, -2)                            # [B, M, O]
    out = ops.gcn_agg(adj_t, *ts)
    saved = out.grad_fn.saved_tensors[0]
    assert not saved.is_contiguous()
    assert saved.data_ptr() == base.data_ptr()
    (out ** 2).sum().backward()
    want = jax_grads(jax_ops.gcn_agg, (adj, hs, hn, ws, wn, bias))
    np.testing.assert_allclose(base.grad.numpy().transpose(0, 2, 1),
                               np.asarray(want[0]), **GRAD_TOL)
    for t, w in zip(ts, want[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)


def test_ops_skip_the_gradients_nobody_wants(monkeypatch):
    """Only the weights require grad (the replay's adjacency and features
    do not): the backward is told so, and returns None for the rest."""
    seen = []

    def spy(*args, needs):
        seen.append(tuple(needs))
        return bwd(*args, needs=needs)

    bwd = ref.gcn_agg_bwd
    monkeypatch.setattr(ref, "gcn_agg_bwd", spy)
    args = [torch.tensor(a) for a in gcn_args(3, 4, 5, 6)]
    for a in args[3:]:
        a.requires_grad_(True)
    out = ops.gcn_agg(*args)
    grads = torch.autograd.grad(out.sum(), args[3:])
    assert seen == [(False, False, False, True, True, True)]
    assert all(g is not None for g in grads)
    dadj, dhs, dhn, *_ = bwd(torch.ones_like(out), *args[:5], out,
                             needs=seen[0])
    assert dadj is None and dhs is None and dhn is None


# ------------------------------------------------------------------ adam
@pytest.mark.parametrize("lr", [None, 4e-4])
def test_adam_matches_reference(lr):
    """5 steps on random grads: updates (rescaled by lr / 1e-3 as
    ``train_step`` does), moments, step and params."""
    rng = np.random.default_rng(4)
    params = {"a": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                    "b": rng.normal(size=(3,)).astype(np.float32)},
              "c": {"w": rng.normal(size=(2, 4)).astype(np.float32)}}
    j_opt, t_opt = jax_adam(1e-3), adam(1e-3)
    j_params, t_params = jax.tree_util.tree_map(jnp.asarray, params), \
        t_tree(params)
    j_st, t_st = j_opt.init(j_params), t_opt.init(t_params)
    for _ in range(5):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.normal(size=x.shape) * 10.0 **
                       rng.integers(-6, 1)).astype(np.float32), params)
        j_up, j_st = j_opt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                  j_st, j_params)
        t_up, t_st = t_opt.update(t_tree(grads), t_st, t_params)
        if lr is not None:
            j_up = jax.tree_util.tree_map(lambda u: u * (lr / 1e-3), j_up)
            t_up = scale_updates(t_up, lr / 1e-3)
        j_params = jax_apply_updates(j_params, j_up)
        t_params = apply_updates(t_params, t_up)
        assert int(t_st["step"]) == int(j_st["step"])
        assert t_st["step"].dtype == torch.int32
        assert_tree_close(t_up, j_up, rtol=1e-6, atol=1e-12)
        assert_tree_close(t_st["mu"], j_st["mu"], rtol=1e-6, atol=0)
        assert_tree_close(t_st["nu"], j_st["nu"], rtol=1e-6, atol=0)
        assert_tree_close(t_params, j_params, rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------- replay
@functools.lru_cache(maxsize=None)
def graph_pool(m):
    """256 graphs of fresh fig5_baseline slots with M devices (numpy
    leaves [256, ...]) and random decisions, made once."""
    env = JaxEnv(jax_scenario("fig5_baseline", n_devices=m))
    state = env.reset()

    @jax.jit
    def graphs(keys):
        return jax.vmap(lambda k: jax_build_graph(
            env.observe(state, env.sample_slot(k)), env.N, env.L))(keys)

    g = np_tree(graphs(jax.random.split(jax.random.PRNGKey(m), 256)))
    dec = np.random.default_rng(m).integers(0, env.N * env.L,
                                            size=(256, m), dtype=np.int32)
    return g, dec


def jax_graphs(env, start, n):
    """n graphs (leaves [n, ...]) and decisions of ``graph_pool(env.M)``,
    from row ``start`` on."""
    g, dec = graph_pool(env.M)
    return (jax.tree_util.tree_map(lambda x: jnp.asarray(x[start:start + n]),
                                   g), jnp.asarray(dec[start:start + n]))


def port_graph(g):
    return MECGraph(*(torch.tensor(np.asarray(x)) for x in g))


def jax_take(ring, key, batch):
    """The reference's sampled rows, read off a copy of ``ring`` whose
    decisions hold their own index."""
    index = jnp.broadcast_to(jnp.arange(ring.capacity, dtype=jnp.int32)[:, None],
                             ring.decisions.shape)
    _, rows = jax_replay.replay_sample(ring._replace(decisions=index), key,
                                       batch)
    return np.asarray(rows[:, 0])


@pytest.mark.parametrize("adds,batch", [((3, 3, 3, 3), 5),   # wraps at 8
                                        ((2, 1), 6),         # size < batch
                                        ((8,), 8)])
def test_replay_matches_reference(adds, batch):
    jenv = JaxEnv(jax_scenario("fig5_baseline", n_devices=4))
    j_ring = jax_replay.replay_init(8, jax.tree_util.tree_map(
        lambda x: x[0], jax_graphs(jenv, 0, 1)[0]), jenv.M)
    t_ring = replay_init(8, MECGraph(*(x.shape[1:] for x in
                                       jax_graphs(jenv, 0, 1)[0])), jenv.M,
                         device="cpu")
    for i, n in enumerate(adds):
        g, dec = jax_graphs(jenv, 10 * (i + 1), n)
        j_ring = jax_replay.replay_add(j_ring, g, dec)
        t_ring = replay_add(t_ring, port_graph(g), torch.tensor(
            np.asarray(dec)))
    for f in j_ring._fields:
        np.testing.assert_array_equal(getattr(t_ring, f).numpy(),
                                      np.asarray(getattr(j_ring, f)),
                                      err_msg=f)
    assert t_ring.host_size == int(j_ring.size)
    key = jax.random.PRNGKey(7)
    take = jax_take(j_ring, key, batch)
    j_g, j_dec = jax_replay.replay_sample(j_ring, key, batch)
    t_g, t_dec = replay_sample(t_ring, batch, take=torch.tensor(take))
    np.testing.assert_array_equal(t_dec.numpy(), np.asarray(j_dec))
    for a, b in zip(t_g, j_g):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_replay_rules_on_the_ports_generator():
    """Without replacement over the filled rows; while size < batch, the
    first ``size`` rows a permutation of the stored entries and the rest
    re-draws from them; over capacity refused, as in the reference."""
    shapes = MECGraph((3, 7), (4, 4), (3, 4), (3, 4))
    ring = replay_init(10, shapes, 3, device="cpu")
    gen = torch.Generator().manual_seed(0)

    def add(r, n):
        g = MECGraph(*(torch.ones((n,) + s) for s in shapes))
        return replay_add(r, g, torch.zeros((n, 3), dtype=torch.int32))

    small = add(ring, 3)
    for _ in range(20):
        take = replay_indices(small, 6, gen)
        assert sorted(take[:3].tolist()) == [0, 1, 2]
        assert take[3:].max() < 3
    full = add(add(small, 5), 4)                              # wrapped
    assert full.host_size == 10 and int(full.ptr) == 2
    for _ in range(20):
        take = replay_indices(full, 8, gen)
        assert len(set(take.tolist())) == 8 and take.max() < 10
    with pytest.raises(ValueError, match="exceeds replay capacity"):
        add(ring, 11)
    g, dec = jax_graphs(JaxEnv(jax_scenario("fig5_baseline", n_devices=3)),
                        0, 11)
    j_ring = jax_replay.replay_init(10, jax.tree_util.tree_map(
        lambda x: x[0], g), 3)
    with pytest.raises(ValueError, match="exceeds replay capacity"):
        jax_replay.replay_add(j_ring, g, dec)
    with pytest.raises(ValueError, match="generator or take"):
        replay_sample(full, 4)


# ------------------------------------------------------- loss, train step
@pytest.fixture(scope="module")
def defs():
    jenv = JaxEnv(jax_scenario("fig5_baseline"))
    env = MECEnv(make_scenario("fig5_baseline"), device="cpu")
    return (jax_agent_def("grle", jenv), agent_def("grle", env, device="cpu"),
            golden_tool.load())


def test_loss_and_grads_match_reference(defs):
    """Eq 16 on a 64-graph minibatch with trained params: the loss and
    every param's gradient against ``jax.value_and_grad``."""
    jdef, pdef, golden = defs
    g, dec = jax_graphs(jdef.env, 3, 64)
    mask = golden["exit_mask"]
    want_loss, want_grads = jax.jit(jax.value_and_grad(jdef.loss))(
        jax.tree_util.tree_map(jnp.asarray, golden["params"]), g, dec,
        jnp.asarray(mask))
    params = t_tree(golden["params"])
    leaves = [p.requires_grad_() for p in flatten_dict(params).values()]
    loss = pdef.loss(params, port_graph(g), torch.tensor(np.asarray(dec)),
                     torch.tensor(mask))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = flatten_dict(np_tree(want_grads))
    for (k, w), gr in zip(flatten_dict(params).items(), grads):
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(gr.numpy(), want[k], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=k)


jax_replay_add = jax.jit(jax_replay.replay_add)


def filled_jax_state(jdef, golden, n_slots, seed=5):
    """A reference state with trained params and ``n_slots`` of 4 fleets'
    pairs in its ring (the size at a driver's n-th slot)."""
    st = jdef.init(jax.random.PRNGKey(seed))._replace(
        params=jax.tree_util.tree_map(jnp.asarray, golden["params"]),
        exit_mask=jnp.asarray(golden["exit_mask"]))
    for i in range(n_slots):
        g, dec = jax_graphs(jdef.env, (4 * i) % 252, 4)
        st = st._replace(replay=jax_replay_add(st.replay, g, dec),
                         step=st.step + 1)
    return st


@pytest.mark.parametrize("n_slots,lr", [(20, None), (40, 3e-4)])
def test_train_step_matches_reference(defs, n_slots, lr):
    """One Eq-16 + Adam step on the reference's minibatch rows: loss,
    params, Adam moments and step, loss stats; twice, so that the second
    step starts from nonzero moments."""
    jdef, pdef, golden = defs
    j_st = filled_jax_state(jdef, golden, n_slots)
    t_st = agent_state_from_numpy(np_tree(j_st), "cpu")
    train_step = jax.jit(jdef.train_step)
    for _ in range(2):
        take = jax_take(j_st.replay, jax.random.split(j_st.key)[1],
                        jdef.batch_size)
        j_st, j_loss = train_step(j_st, lr)
        t_st, t_loss = pdef.train_step(t_st, lr, take=torch.tensor(take))
        np.testing.assert_allclose(float(t_loss), float(j_loss),
                                   rtol=LOSS_RTOL)
        assert_tree_close(t_st.params, j_st.params, **PARAM_TOL)
        assert_tree_close(t_st.opt_state["mu"], j_st.opt_state["mu"],
                          **PARAM_TOL)
        assert_tree_close(t_st.opt_state["nu"], j_st.opt_state["nu"],
                          rtol=1e-4, atol=1e-12)
    assert int(t_st.opt_state["step"]) == int(j_st.opt_state["step"]) == 2
    assert int(t_st.loss_count) == int(j_st.loss_count) == 2
    np.testing.assert_allclose(float(t_st.loss_sum), float(j_st.loss_sum),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(t_st.last_loss), float(j_st.last_loss),
                               rtol=LOSS_RTOL)


# -------------------------------------------------------------- the gate
def small_env(m=3):
    return MECEnv(make_scenario("fig5_baseline", n_devices=m), device="cpu")


def drive_host(adef, env, seed, n_slots):
    """A self-contained host loop on ``AgentDef.step`` with one generator
    drawn as the driver draws it (init, then per slot tasks, exploration,
    minibatch rows)."""
    gen = torch.Generator().manual_seed(seed)
    state = adef.episode_state(adef.init(gen))
    mec = env.reset()
    decisions, losses = [], []
    for _ in range(n_slots):
        tasks = env.sample_slot(gen)
        state, dec, aux = adef.step(state, mec, tasks, generator=gen)
        mec, _ = env.step(mec, tasks, dec)
        decisions.append(dec.numpy())
        losses.append(float(aux.loss))
    return state, np.stack(decisions), np.asarray(losses)


class TestTrainGating:
    """Mirror of tests/test_policy.py::TestTrainGating: train every
    ``train_every`` slots, and only once the ring holds a full minibatch."""

    def test_host_waits_for_full_minibatch(self):
        env = small_env()
        adef = agent_def("grle", env, device="cpu", **SMALL_KW)
        _, _, losses = drive_host(adef, env, 0, 30)
        trained = np.flatnonzero(np.isfinite(losses)) + 1
        # due at multiples of 5, but slots 5 and 10 hold < 12 entries
        np.testing.assert_array_equal(trained, [15, 20, 25, 30])

    def test_state_loss_stats_track_training(self):
        env = small_env()
        adef = agent_def("grle", env, device="cpu", **SMALL_KW)
        state, _, losses = drive_host(adef, env, 1, 25)
        finite = losses[np.isfinite(losses)]
        assert int(state.loss_count) == len(finite) > 0
        assert state.host_step == int(state.step) == 25
        assert state.replay.host_size == int(state.replay.size) == 25
        np.testing.assert_allclose(float(state.loss_sum), finite.sum(),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(state.last_loss), finite[-1],
                                   rtol=1e-6)

    def test_driver_matches_host_step(self):
        """The host ``AgentDef.step`` loop reproduces the B=1 driver
        episode on one generator: decisions bitwise, losses and params to
        float32 rounding."""
        env = small_env(4)
        adef = agent_def("grle", env, device="cpu", **SMALL_KW)
        drv = RolloutDriver(adef, 1, train=True, device="cpu")
        final, trace = drv.run(13, 30, mode="loop")
        state, decisions, losses = drive_host(adef, env, 13, 30)
        np.testing.assert_array_equal(trace.decisions[:, 0].numpy(),
                                      decisions)
        np.testing.assert_allclose(trace.loss.numpy(), losses, rtol=1e-5)
        assert final.agent_state.host_step == state.host_step == 30
        assert_tree_close(state.params, final.agent_state.params,
                          **PARAM_TOL)


# ------------------------------------------------------------- episodes
@pytest.fixture(scope="module")
def train_golden():
    with np.load(golden_tool.TRAIN_GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_train_golden_file_is_current(train_golden):
    """Rebuilding the training golden run with the JAX package gives the
    stored file: integers exactly, floats to 1e-6 (XLA's CPU code may
    round differently on another CPU model)."""
    data = golden_tool.build_train(int(train_golden["seed"]))
    assert set(data) == set(train_golden)
    for k, v in data.items():
        want = train_golden[k]
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(v, want, rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v, want, err_msg=k)


def port_episode(name, data, n_fleets, mode="loop", **overrides):
    env = MECEnv(make_scenario(name), device="cpu")
    drv = RolloutDriver(agent_def("grle", env, device="cpu"), n_fleets,
                        train=True, device="cpu", **overrides)
    st = agent_state_from_params(drv.adef, golden_tool.tree_of(
        data, "init_params"), data["exit_mask"])
    draws = SlotDraws(
        SlotTasks(*(torch.tensor(data[f"tasks/{f}"])
                    for f in SlotTasks._fields)),
        torch.tensor(data["rand_cands"].astype(np.int64)),
        torch.tensor(data["replay_take"]))
    carry, trace = drv.run(0, data["rand_cands"].shape[0], mode=mode,
                           agent_state=st, draws=draws)
    return drv, carry, trace


def check_episode(drv, carry, trace, data):
    bad = np.argwhere((trace.decisions.numpy()
                       != data["trace/decisions"]).any(-1))
    assert bad.size == 0, "decisions differ at " + "; ".join(
        f"slot {t} fleet {b}: q margin {data['q_margin'][t, b]:.3g}, "
        f"x_hat margin {data['xhat_margin'][t, b]:.3g}" for t, b in bad)
    loss, want = trace.loss.numpy(), data["trace/loss"]
    np.testing.assert_array_equal(np.isnan(loss), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(loss[ok], want[ok], rtol=LOSS_RTOL)
    np.testing.assert_allclose(trace.q_est.numpy(), data["trace/q_est"],
                               rtol=1e-5)
    fin = carry.agent_state
    for name, tree in (("params", fin.params),
                       ("mu", fin.opt_state["mu"]),
                       ("nu", fin.opt_state["nu"])):
        want_tree = golden_tool.tree_of(data, f"final/{name}")
        assert_tree_close(tree, want_tree,
                          **(PARAM_TOL if name != "nu"
                             else dict(rtol=1e-4, atol=1e-12)))
    assert int(fin.opt_state["step"]) == int(data["final/opt_step"])
    m = drv.metrics(carry)
    assert m["train_steps"] == float(data["metrics/train_steps"]) == ok.sum()
    np.testing.assert_allclose(m["final_loss"], want[ok][-1],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["ssp"], float(data["metrics/ssp"]),
                               rtol=1e-6)


def test_port_trains_as_the_golden_episode(train_golden):
    """fig5_baseline at full width, B=4, T=64, 5 train steps: the same
    decisions, losses, final params and Adam moments as the JAX driver."""
    assert train_golden["train_slots"].tolist() == [20, 30, 40, 50, 60]
    check_episode(*port_episode(str(train_golden["scenario"]),
                                train_golden, 4), train_golden)


def test_port_trains_as_a_live_jax_episode():
    """fig8_csi (capacity, jitter and CSI error), B=4, T=30, with the
    driver's overrides (ring 32, minibatch 12, a step every 5 slots: the
    ring wraps at slot 8 and trains at 5..30): a live JAX run against the
    port on its draws and minibatch rows."""
    kw = dict(replay_capacity=32, batch_size=12, train_every=5)
    jdef = jax_agent_def("grle", JaxEnv(jax_scenario("fig8_csi")))
    drv = JaxDriver(jdef, n_fleets=4, train=True, **kw)
    seed, n_slots = 9, 30
    carry, trace = drv.run(jax.random.PRNGKey(seed), n_slots, mode="loop")
    k_init, k_episode = golden_tool.episode_keys(seed)
    slots = golden_tool.train_slots(drv.adef, 4, n_slots)
    assert slots == [5, 10, 15, 20, 25, 30]
    tasks, rand = golden_tool.driver_draws(drv.adef, np.asarray(
        jdef.exit_mask()), seed, 4, n_slots)
    data = {"exit_mask": np.asarray(jdef.exit_mask()), "rand_cands": rand,
            "replay_take": golden_tool.train_takes(
                drv.adef, k_episode, [min(4 * s, 32) for s in slots]),
            "final/opt_step": np.asarray(carry.agent_state.opt_state["step"]),
            "q_margin": np.full(rand.shape[:2], np.nan),
            "xhat_margin": np.full(rand.shape[:2], np.nan)}
    trees = {"init_params": jdef.init(k_init).params,
             "final/params": carry.agent_state.params,
             "final/mu": carry.agent_state.opt_state["mu"],
             "final/nu": carry.agent_state.opt_state["nu"]}
    for prefix, tree in trees.items():
        for path, x in flatten_dict(np_tree(tree)).items():
            data[f"{prefix}/{path}"] = x
    data.update({f"tasks/{k}": v for k, v in tasks.items()})
    data.update({f"trace/{k}": np.asarray(v)
                 for k, v in trace._asdict().items()})
    metrics = jax_metrics_finalize(
        carry.metrics, slot_s=jdef.env.cfg.slot_s, n_fleets=4)
    data.update({f"metrics/{k}": np.asarray(v) for k, v in metrics.items()})
    check_episode(*port_episode("fig8_csi", data, 4, **kw), data)


def test_scan_trains_as_the_golden_episode(train_golden):
    """The golden training episode through ``mode="scan"``: the same
    decisions, losses, final params and Adam moments as the JAX driver."""
    check_episode(*port_episode(str(train_golden["scenario"]),
                                train_golden, 4, mode="scan"), train_golden)


def test_telemetry_matches_a_live_jax_scan_episode():
    """fig8_csi, B=2, T=30, ring 32, minibatch 8, a step every 5 slots: the
    JAX driver's ``telemetry=True, mode="scan"`` episode replayed in the
    port on its draws and minibatch rows: the same decisions, counters
    within 1e-5 relative, histogram counts exactly, the loss EMA within
    1e-5."""
    kw = dict(replay_capacity=32, batch_size=8, train_every=5)
    jdef = jax_agent_def("grle", JaxEnv(jax_scenario("fig8_csi")))
    jdrv = JaxDriver(jdef, n_fleets=2, train=True, telemetry=True, **kw)
    seed, n_slots = 9, 30
    j_carry, j_trace = jdrv.run(jax.random.PRNGKey(seed), n_slots,
                                mode="scan")
    k_init, k_episode = golden_tool.episode_keys(seed)
    slots = golden_tool.train_slots(jdrv.adef, 2, n_slots)
    assert slots == [5, 10, 15, 20, 25, 30]
    exit_mask = np.asarray(jdef.exit_mask())
    tasks, rand = golden_tool.driver_draws(jdrv.adef, exit_mask, seed, 2,
                                           n_slots)
    takes = golden_tool.train_takes(jdrv.adef, k_episode,
                                    [min(2 * s, 32) for s in slots])
    env = MECEnv(make_scenario("fig8_csi"), device="cpu")
    drv = RolloutDriver(agent_def("grle", env, device="cpu"), 2, train=True,
                        telemetry=True, device="cpu", **kw)
    st = agent_state_from_params(drv.adef, np_tree(jdef.init(k_init).params),
                                 exit_mask)
    draws = SlotDraws(
        SlotTasks(*(torch.tensor(tasks[f]) for f in SlotTasks._fields)),
        torch.tensor(rand.astype(np.int64)), torch.tensor(takes))
    carry, trace = drv.run(0, n_slots, mode="scan", agent_state=st,
                           draws=draws)
    np.testing.assert_array_equal(trace.decisions.numpy(),
                                  np.asarray(j_trace.decisions))
    got, want = carry.telemetry, j_carry.telemetry
    # (a jitted pytree's dicts come back with sorted keys)
    assert sorted(got.counters) == sorted(want.counters)
    for k, v in want.counters.items():
        np.testing.assert_allclose(float(got.counters[k]), float(v),
                                   rtol=1e-5, err_msg=k)
    for k, h in want.hists.items():
        np.testing.assert_array_equal(got.hists[k].counts.numpy(),
                                      np.asarray(h.counts), err_msg=k)
    np.testing.assert_allclose(float(got.loss_ema), float(want.loss_ema),
                               rtol=1e-5)
    assert float(got.counters["train_steps"]) == 6


def replay_indices_before(replay, batch_size, generator):
    """``replay_indices`` as it was before it read the device ``size``: the
    filled region from the host mirror ``host_size``."""
    cap, size = replay.capacity, replay.host_size
    scores = torch.rand((cap,), generator=generator)
    scores = torch.where(torch.arange(cap) < size, scores, torch.inf)
    take = torch.sort(scores, stable=True).indices[:batch_size]
    if size >= batch_size:
        return take
    fill = torch.randint(0, max(size, 1), (batch_size,), generator=generator)
    return torch.where(torch.arange(batch_size) < size, take, fill)


@pytest.mark.parametrize("adds,batch", [((3,), 6), ((3, 3, 3, 3), 5),
                                        ((8,), 8), ((2, 1), 6), ((4, 4), 3)])
def test_replay_indices_read_the_device_size(adds, batch):
    """The indices drawn are the ones drawn before the mask read the
    device ``size``; and with a full minibatch stored, a stale host mirror
    (what a captured train step holds) samples the same filled region."""
    shapes = MECGraph((3, 7), (4, 4), (3, 4), (3, 4))
    ring = replay_init(10, shapes, 3, device="cpu")
    for n in adds:
        ring = replay_add(ring, MECGraph(*(torch.ones((n,) + sh)
                                           for sh in shapes)),
                          torch.zeros((n, 3), dtype=torch.int32))
    assert ring.host_size == int(ring.size)
    for seed in range(4):
        got = replay_indices(ring, batch, torch.Generator().manual_seed(seed))
        want = replay_indices_before(ring, batch,
                                     torch.Generator().manual_seed(seed))
        assert torch.equal(got, want), seed
        if ring.host_size >= batch:
            stale = ring._replace(host_size=ring.capacity)
            assert torch.equal(replay_indices(
                stale, batch, torch.Generator().manual_seed(seed)), want)


# ------------------------------------------------------------ checkpoint
@pytest.fixture(scope="module")
def trained_jax_state(defs):
    jdef, _, golden = defs
    st = filled_jax_state(jdef, golden, 20)
    st, _ = jax.jit(jdef.train_step)(st)
    return jdef, st


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_reference_checkpoint_restores_into_the_port(
        trained_jax_state, defs, tmp_path, monkeypatch, codec):
    jdef, st = trained_jax_state
    if codec == "zlib":
        monkeypatch.setattr(jax_ckpt, "zstandard", None)
    elif jax_ckpt.zstandard is None:
        pytest.skip("zstandard is not installed")
    path = str(tmp_path / "agent.ckpt")
    jax_ckpt.save_agent_state(path, st)
    with open(path, "rb") as f:
        assert (f.read(4) == b"\x28\xb5\x2f\xfd") == (codec == "zstd")
    got = restore_agent_state(path, defs[1], device="cpu")
    want = np_tree(st)
    assert_tree_close(got.params, want.params, rtol=0, atol=0)
    assert_tree_close(got.opt_state, want.opt_state, rtol=0, atol=0)
    for f in want.replay._fields:
        np.testing.assert_array_equal(getattr(got.replay, f).numpy(),
                                      getattr(want.replay, f), err_msg=f)
    for f in ("step", "exit_mask", "last_loss", "loss_sum", "loss_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == torch.tensor(getattr(want, f)).dtype
    assert got.host_step == int(want.step)
    assert got.replay.host_size == int(want.replay.size)
    # the pure-Python codec reads the file as msgpack does
    payload = read_payload(path)
    assert unpackb(payload) == msgpack.unpackb(payload)


def test_port_checkpoint_restores_in_the_reference(trained_jax_state, defs,
                                                   tmp_path):
    """A port-written file is the reference's format: its own reader
    restores it into a reference ``AgentState`` leaf for leaf; the bytes
    are msgpack's own encoding of the same map; the port reads it back."""
    jdef, st = trained_jax_state
    port = agent_state_from_numpy(np_tree(st), "cpu")
    path = str(tmp_path / "port.ckpt")
    save_agent_state(path, port)
    back = jax_ckpt.restore_agent_state(path, jdef)
    for (kp, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree_util.tree_leaves_with_path(st)):
        if "key" in jax.tree_util.keystr(kp):
            np.testing.assert_array_equal(np.asarray(a), [0, 0])
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=jax.tree_util.keystr(kp))
    payload = read_payload(path)
    flat = _encode_tree(jax_ckpt.restore_checkpoint(path, like=st))
    assert payload == packb(flat) == msgpack.packb(flat)
    assert list(restore_checkpoint(path)) == list(
        jax_ckpt._encode_tree(st))
    again = restore_agent_state(path, defs[1], device="cpu")
    assert_tree_close(again.params, port.params, rtol=0, atol=0)


def test_checkpoint_readers_refuse_what_they_cannot_read(
        trained_jax_state, defs, tmp_path, monkeypatch):
    jdef, st = trained_jax_state
    path = str(tmp_path / "agent.ckpt")
    jax_ckpt.save_agent_state(path, st)
    if jax_ckpt.zstandard is not None:
        with monkeypatch.context() as mp:
            mp.setitem(sys.modules, "zstandard", None)
            with pytest.raises(ImportError, match="agent.ckpt"):
                restore_agent_state(path, defs[1], device="cpu")
    other = agent_def("grle", MECEnv(make_scenario("fig5_baseline"),
                                     device="cpu"), device="cpu",
                      buffer_size=64)
    with pytest.raises(ValueError, match="ring"):
        restore_agent_state(path, other)
    bad = np_tree(st)._replace(step=np.int64(3))
    with pytest.raises(TypeError, match="step"):
        agent_state_from_numpy(bad, "cpu")
    bad = np_tree(st)
    bad = bad._replace(replay=bad.replay._replace(adj=bad.replay.adj[:, :3]))
    with pytest.raises(ValueError, match="replay/adj"):
        agent_state_from_numpy(bad, "cpu")
    with pytest.raises(ValueError, match="fields"):
        agent_state_from_numpy(np_tree(st)._asdict() | {"extra": 1}, "cpu")
