"""The port's population layer (``repro_torch.pop``) against the JAX
package's (``repro.pop``) on the CPU, mirroring ``tests/test_pop.py``.

Torch cannot reproduce threefry, so every comparison with the reference
runs on its draws fed through the port's seams: the hyperparameter
uniforms (``sample_hypers(uniforms=)``), PBT's coin and jitters
(``pbt_update(draws=)``), the curriculum's regions and offsets
(``Curriculum.resample(region=, offset=)``). Exact: ``default_hypers``,
exit masks, ``n_exploit`` and PBT's ranks, sources, copy flags and
gathered agents (ties included); within 1e-6: sampled and perturbed
hypers, the curriculum's scenarios and score EMAs. Checkpoints go both
ways exactly. Runs on the port's own generators are held to themselves:
a resumed run equals the uninterrupted one bit for bit, and
``hypers=None`` equals the def's own hypers as data bit for bit.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import agent_def as jax_agent_def
from repro.mec.env import MECEnv as JaxMECEnv
from repro.mec.scenarios import make_scenario as jax_make_scenario
from repro.mec.scenarios import scenario_space as jax_scenario_space
from repro import pop as jpop
from repro_torch.core import agent_def
from repro_torch.mec import MECEnv, make_scenario
from repro_torch.mec.scenarios import scenario_space
from repro_torch.pop import (Curriculum, MemberHypers, PBTConfig,
                             PopulationTrainer, default_hypers,
                             exit_mask_from_tau, init_population, pbt_update,
                             sample_hypers)
from repro_torch.nn.pytree import tree_tensors
from repro_torch.pop.pbt import PBTDraws
from repro_torch.pop.population import gather_members, member_state
from repro_torch.rollout import RolloutDriver
from repro_torch.train import restore_population, save_population

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)

HYPER_TOL = 1e-6     # sampled and perturbed hypers, curriculum, relative
TINY = dict(buffer_size=16, batch_size=4, train_every=4)


def tiny_adef(method="grle", **kw):
    env = MECEnv(make_scenario("fig5_baseline", n_devices=3), device="cpu")
    return agent_def(method, env, device="cpu", **dict(TINY, **kw))


def jax_tiny_adef(method="grle", **kw):
    cfg = jax_make_scenario("fig5_baseline", n_devices=3)
    return jax_agent_def(method, JaxMECEnv(cfg), **dict(TINY, **kw))


def tiny_space():
    return scenario_space("fig5_baseline", "fig8_csi", n_devices=3,
                          device="cpu")


def tiny_trainer(adef=None, **kw):
    space = tiny_space()
    base = dict(n_members=4, n_slots=6, pbt_every=1)
    base.update(kw)
    return PopulationTrainer(adef or tiny_adef(),
                             Curriculum(space.lo, space.hi, n_regions=4),
                             **base)


def same_leaves(a, b) -> bool:
    """Every tensor equal bit for bit (NaN equal to NaN)."""
    xs, ys = tree_tensors(a), tree_tensors(b)
    return len(xs) == len(ys) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and bool(((x == y) | (x.isnan() & y.isnan())).all())
        for x, y in zip(xs, ys))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


# --------------------------------------------------------------- population
def test_surface_matches_reference():
    import repro_torch.pop as ppop
    assert ppop.__all__ == jpop.__all__
    assert all(hasattr(ppop, n) for n in ppop.__all__)


class TestPopulation:
    def test_default_hypers_exact(self):
        got = default_hypers(tiny_adef(), 5)
        want = jpop.default_hypers(jax_tiny_adef(), 5)
        for f in MemberHypers._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
            assert getattr(got, f).dtype == torch.float32

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_sample_hypers_on_reference_uniforms(self, seed):
        key = jax.random.PRNGKey(seed)
        want = jpop.sample_hypers(key, 16)
        u = [np.array(jax.random.uniform(k, (16,)))
             for k in jax.random.split(key, 3)]
        got = sample_hypers(None, 16, uniforms=u, device="cpu")
        for f in MemberHypers._fields:
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=HYPER_TOL, err_msg=f)

    def test_sampled_hypers_inside_search_box(self):
        from repro_torch.pop.population import (GAIN_RANGE, LR_RANGE,
                                                TAU_RANGE)
        assert (LR_RANGE, GAIN_RANGE, TAU_RANGE) == (
            jpop.population.LR_RANGE, jpop.population.GAIN_RANGE,
            jpop.population.TAU_RANGE)
        hyp = sample_hypers(torch.Generator().manual_seed(2), 64)
        for x, (lo, hi) in zip(hyp, (LR_RANGE, GAIN_RANGE, TAU_RANGE)):
            assert float(x.min()) >= lo * (1 - 1e-6)
            assert float(x.max()) <= hi * (1 + 1e-6)

    @pytest.mark.parametrize("method", ["grle", "grl"])
    @pytest.mark.parametrize("tau", [0.0, 0.3, 0.55, 0.71, 0.9, 1.1])
    def test_exit_mask_from_tau_exact(self, method, tau):
        got = exit_mask_from_tau(tiny_adef(method), torch.tensor(tau))
        want = jpop.exit_mask_from_tau(jax_tiny_adef(method), tau)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_exit_mask_high_tau_keeps_only_final_exit(self):
        adef = tiny_adef()
        env = adef.env
        mask = exit_mask_from_tau(adef, 1.1).reshape(env.N, env.L)
        base = adef.exit_mask().reshape(env.N, env.L)
        assert float(mask[:, :-1].abs().sum()) == 0.0
        assert torch.equal(mask[:, -1], base[:, -1])

    def test_init_stacks_member_axis(self):
        pop = init_population(tiny_adef(), 0, 5)
        for leaf in tree_tensors(pop.agents):
            assert leaf.shape[0] == 5
        assert int(pop.generation) == 0 and pop.generation.dtype == \
            torch.int32
        assert pop.hypers.lr.shape == (5,)

    def test_growing_population_keeps_existing_members(self):
        adef = tiny_adef()
        small = init_population(adef, 1, 3)
        large = init_population(adef, 1, 6)
        head = gather_members(large.agents, torch.arange(3))
        assert same_leaves(small.agents, head)


# ---------------------------------------------------------------------- pbt
def reference_pop(n, seed=0):
    jdef = jax_tiny_adef()
    key = jax.random.PRNGKey(seed)
    return jpop.init_population(
        jdef, key, n, jpop.sample_hypers(jax.random.fold_in(key, 1), n))


def port_pop(jp):
    from repro_torch.core.bridge import population_from_numpy
    return population_from_numpy(np_tree(jp._asdict()), "cpu")


def reference_pbt_draws(key, n, cfg):
    k_coin, k_gain, k_tau = jax.random.split(key, 3)
    return PBTDraws(
        t(jax.random.bernoulli(k_coin, 0.5, (n,))),
        t(jax.random.uniform(k_gain, (n,), jnp.float32, -cfg.gain_jitter,
                             cfg.gain_jitter)),
        t(jax.random.uniform(k_tau, (n,), jnp.float32, -cfg.tau_jitter,
                             cfg.tau_jitter)))


class TestPBT:
    @pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 16, 17])
    @pytest.mark.parametrize("frac", [0.1, 0.25, 0.5])
    def test_n_exploit_exact(self, n, frac):
        assert PBTConfig(frac=frac).n_exploit(n) == \
            jpop.PBTConfig(frac=frac).n_exploit(n)

    @pytest.mark.parametrize("scores,frac", [
        ([0.4, 0.9, 0.1, 0.5], 0.25),
        ([0.3, 0.3, 0.3, 0.3], 0.25),                 # every score tied
        ([0.5, 0.1, 0.5, 0.1, 0.9, 0.1], 0.5),       # ties at both ends
        ([2.0, -1.0, 0.0, 2.0, 7.0, -1.0, 0.5, 3.0], 0.25),
    ])
    def test_surgery_matches_reference(self, scores, frac):
        n = len(scores)
        cfg_j, cfg_p = jpop.PBTConfig(frac=frac), PBTConfig(frac=frac)
        jp = reference_pop(n, seed=n)
        key = jax.random.PRNGKey(7)
        jnew, jstats = jpop.pbt_update(jp, jnp.asarray(scores, jnp.float32),
                                       key, cfg_j)
        pp = port_pop(jp)
        pnew, pstats = pbt_update(pp, torch.tensor(scores), None, cfg_p,
                                  draws=reference_pbt_draws(key, n, cfg_j))
        for f in ("src", "copied", "ranks"):
            got, want = getattr(pstats, f).numpy(), np.asarray(
                getattr(jstats, f))
            np.testing.assert_array_equal(got, want, err_msg=f)
            assert got.dtype == want.dtype
        # the gathered agents: the reference's leaf for leaf
        assert same_leaves(pnew.agents, port_pop(jnew).agents)
        for f in MemberHypers._fields:
            np.testing.assert_allclose(getattr(pnew.hypers, f).numpy(),
                                       np.asarray(getattr(jnew.hypers, f)),
                                       rtol=HYPER_TOL, err_msg=f)
        assert int(pnew.generation) == int(jnew.generation) == 1

    def test_same_generator_same_surgery(self):
        pop = port_pop(reference_pop(4))
        scores = torch.tensor([0.3, 0.9, 0.1, 0.5])
        a, sa = pbt_update(pop, scores, torch.Generator().manual_seed(7))
        b, sb = pbt_update(pop, scores, torch.Generator().manual_seed(7))
        assert same_leaves(a, b) and same_leaves(sa, sb)
        c, _ = pbt_update(pop, scores, torch.Generator().manual_seed(8))
        assert not same_leaves(a.hypers, c.hypers)

    def test_survivors_keep_state_and_hypers(self):
        pop = port_pop(reference_pop(4))
        new, stats = pbt_update(pop, torch.tensor([0.4, 0.9, 0.1, 0.5]),
                                torch.Generator().manual_seed(0))
        for i in np.flatnonzero(stats.copied.numpy() < 0.5):
            assert same_leaves(member_state(new.agents, int(i)),
                               member_state(pop.agents, int(i)))
            assert same_leaves([x[i] for x in new.hypers],
                               [x[i] for x in pop.hypers])

    def test_perturbed_hypers_stay_in_box(self):
        cfg = PBTConfig(frac=0.5)
        pop = port_pop(reference_pop(8, seed=3))
        new, _ = pbt_update(pop, torch.arange(8.0),
                            torch.Generator().manual_seed(5), cfg)
        hyp = new.hypers
        assert float(hyp.lr.min()) >= cfg.lr_range[0] * (1 - 1e-6)
        assert float(hyp.lr.max()) <= cfg.lr_range[1] * (1 + 1e-6)
        assert float(hyp.explore_gain.min()) >= cfg.gain_range[0]
        assert float(hyp.exit_tau.max()) <= cfg.tau_range[1] * (1 + 1e-6)


# --------------------------------------------------------------- curriculum
def curricula(**kw):
    space = tiny_space()
    js = jax_scenario_space("fig5_baseline", "fig8_csi", n_devices=3)
    return (Curriculum(space.lo, space.hi, **kw),
            jpop.Curriculum(js.lo, js.hi, **kw))


def reference_resample_draws(cur, state, key, n):
    """The reference's region and offset draws of ``resample``."""
    k_region, k_offset = jax.random.split(key)
    region, _ = cur.resample(state, key, n)
    return np.array(region), np.array(jax.random.uniform(k_offset, (n,)))


class TestCurriculum:
    @pytest.mark.parametrize("uniform", [False, True])
    def test_three_generations_match_reference(self, uniform):
        """resample on the reference's draws, update on per-member scores:
        first visits, unvisited regions and blends, three generations."""
        pc, jc = curricula(n_regions=4, uniform=uniform)
        ps, js = pc.init_state(), jc.init_state()
        rng = np.random.default_rng(int(uniform))
        unvisited = False
        for g in range(3):
            key = jax.random.PRNGKey(10 + g)
            region, offset = reference_resample_draws(jc, js, key, 3)
            jr, jsps = jc.resample(js, key, 3)
            pr, psps = pc.resample(ps, None, 3, region=region, offset=offset)
            np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
            for f, x in psps._asdict().items():
                np.testing.assert_allclose(
                    x.numpy(), np.asarray(getattr(jsps, f)),
                    rtol=HYPER_TOL, atol=1e-12, err_msg=f)
            scores = rng.uniform(0.2, 0.9, size=3).astype(np.float32)
            js = jc.update(js, jr, jnp.asarray(scores))
            ps = pc.update(ps, pr, torch.tensor(scores))
            np.testing.assert_allclose(ps.score.numpy(),
                                       np.asarray(js.score),
                                       rtol=HYPER_TOL)
            np.testing.assert_array_equal(ps.visits.numpy(),
                                          np.asarray(js.visits))
            unvisited |= bool((ps.visits.numpy() == 0).any())
        assert unvisited and (ps.visits.numpy() > 1).any()

    def test_update_first_visit_seeds_ema(self):
        pc, _ = curricula(n_regions=3, ema=0.7)
        st = pc.update(pc.init_state(), torch.tensor([0, 0, 1]),
                       torch.tensor([1.0, 2.0, 3.0]))
        np.testing.assert_allclose(st.score.numpy(), [1.5, 3.0, 0.0])
        np.testing.assert_allclose(st.visits.numpy(), [2.0, 1.0, 0.0])
        st = pc.update(st, torch.tensor([0]), torch.tensor([3.0]))
        np.testing.assert_allclose(st.score.numpy()[0],
                                   0.7 * 1.5 + 0.3 * 3.0, rtol=1e-6)

    def test_dr_arm_ignores_scores(self):
        pc, _ = curricula(n_regions=4, uniform=True)
        easy = pc.init_state()._replace(score=torch.tensor([9.0, 0, 0, 9]),
                                        visits=torch.ones(4))
        ra, _ = pc.resample(pc.init_state(), torch.Generator().manual_seed(4),
                            16)
        rb, _ = pc.resample(easy, torch.Generator().manual_seed(4), 16)
        assert torch.equal(ra, rb)

    def test_hard_regions_oversampled(self):
        pc, _ = curricula(n_regions=4, temperature=0.3)
        st = pc.init_state()._replace(score=torch.tensor([0.1, 10, 10, 10]),
                                      visits=torch.ones(4))
        region, _ = pc.resample(st, torch.Generator().manual_seed(0), 64)
        assert int(region.max()) == 0


# -------------------------------------------------- driver + hypers-as-data
@pytest.mark.parametrize("mode", ["loop", "scan"])
def test_default_hypers_equal_hypers_none_bit_for_bit(mode):
    """Gain 0 and lr = the def's, as data, are exact no-ops: the episode
    equals ``hypers=None`` bit for bit (decisions, losses, params)."""
    adef = tiny_adef()
    state = adef.init(torch.Generator().manual_seed(3))
    hyp = MemberHypers(*(x[0] for x in default_hypers(adef, 1)))
    a = RolloutDriver(adef, 2, device="cpu").run(5, 12, mode=mode,
                                                 agent_state=state)
    b = RolloutDriver(adef, 2, device="cpu").run(5, 12, mode=mode,
                                                 agent_state=state,
                                                 hypers=hyp)
    assert int(a[0].agent_state.loss_count) > 0
    assert same_leaves(a, b)


def test_hypers_take_effect_and_scan_equals_loop():
    """A gain and an lr of their own change the run; scan equals loop bit
    for bit with them, and another member's hypers replay the episode."""
    adef = tiny_adef()
    state = adef.init(torch.Generator().manual_seed(3))
    hyp = MemberHypers(torch.tensor(3e-3), torch.tensor(1.5),
                       torch.tensor(0.0))
    drv = RolloutDriver(adef, 2, device="cpu")
    base = drv.run(5, 12, agent_state=state)
    scan = drv.run(5, 12, agent_state=state, hypers=hyp)
    loop = drv.run(5, 12, mode="loop", agent_state=state, hypers=hyp)
    assert same_leaves(scan, loop)
    assert not same_leaves(base[0].agent_state.params,
                           scan[0].agent_state.params)
    episode = drv._episode
    drv.run(5, 12, agent_state=state, hypers=MemberHypers(
        torch.tensor(1e-3), torch.tensor(0.2), torch.tensor(0.1)))
    assert drv._episode is episode and drv.episodes_built == 2


# ------------------------------------------------------------- checkpoints
def test_checkpoint_port_to_reference_exact(tmp_path):
    tr = tiny_trainer()
    ts, _ = tr.train(tr.init_state(), 1)
    path = str(tmp_path / "pop.ckpt")
    save_population(path, ts)
    from repro.train import restore_population as jax_restore
    jtr = jpop.PopulationTrainer(jax_tiny_adef(), curricula(n_regions=4)[1],
                                 n_members=4, n_slots=6, mesh=None)
    got = jax_restore(path, like=jtr.init_state())
    np.testing.assert_array_equal(np.asarray(got.pop.agents.key), 0)
    from repro_torch.core.bridge import population_from_numpy
    back = population_from_numpy(np_tree(got.pop._asdict()), "cpu")
    assert same_leaves(back, ts.pop)
    np.testing.assert_array_equal(ts.cur.score.numpy(),
                                  np.asarray(got.cur.score))
    assert int(got.pop.generation) == 1


def test_checkpoint_reference_to_port_exact(tmp_path):
    from repro.train import save_population as jax_save
    jtr = jpop.PopulationTrainer(jax_tiny_adef(), curricula(n_regions=4)[1],
                                 n_members=3, n_slots=6, mesh=None)
    jts, _ = jtr.train(jtr.init_state(), 1)
    path = str(tmp_path / "ref.ckpt")
    jax_save(path, jts)
    tr = tiny_trainer(n_members=3)
    got = restore_population(path, like=tr.init_state())
    from repro_torch.core.bridge import population_from_numpy
    want = population_from_numpy(np_tree(jts.pop._asdict()), "cpu")
    assert same_leaves(got.pop, want)
    np.testing.assert_array_equal(got.cur.visits.numpy(),
                                  np.asarray(jts.cur.visits))
    assert got.pop.agents.host_step == 6
    assert got.pop.agents.replay.host_size == int(jts.pop.agents.replay
                                                  .size[0])
    # a population alone too
    jax_save(path, jts.pop)
    alone = restore_population(path, like=tr.init_state().pop)
    assert same_leaves(alone, want)
    with pytest.raises(ValueError, match="members"):
        restore_population(path, like=tiny_trainer(n_members=4)
                           .init_state().pop)


# ------------------------------------------------------------ trainer/resume
def test_mid_pbt_checkpoint_resume_bit_exact(tmp_path):
    """2 generations + checkpoint + 2 more in a fresh trainer == 4
    uninterrupted generations, every leaf bit for bit."""
    straight = tiny_trainer()
    ts_straight, _ = straight.train(straight.init_state(), 4)
    first = tiny_trainer()
    ts, _ = first.train(first.init_state(), 2)
    path = str(tmp_path / "pop.ckpt")
    save_population(path, ts)
    resumed_tr = tiny_trainer()
    ts_resumed = restore_population(path, like=resumed_tr.init_state())
    assert int(ts_resumed.pop.generation) == 2
    ts_resumed, _ = resumed_tr.train(ts_resumed, 2)
    assert same_leaves(ts_straight, ts_resumed)


def test_reports_telemetry_and_history(tmp_path):
    from repro_torch.obs.history import HistoryStore
    from repro_torch.obs.telemetry import telemetry_host
    store = HistoryStore(str(tmp_path / "hist"))
    tr = tiny_trainer(telemetry=True, history=store, history_name="pop_t")
    _, reports = tr.train(tr.init_state(), 2)
    assert [r["generation"] for r in reports] == [0, 1]
    assert reports[0]["arm"] == "curriculum"
    assert set(reports[0]) == {"generation", "arm", "best_member",
                               "region_visits", "metrics"}
    assert set(reports[0]["metrics"]) == {
        "mean_reward", "best_reward", "worst_reward", "mean_ssp",
        "mean_accuracy", "exploits"}
    host = telemetry_host(tr.telemetry)
    assert host["counters"]["generations"] == 2.0
    assert host["counters"]["pbt_rounds"] == 2.0
    recs = [r for r in store.records() if r["kind"] == "pop"]
    assert [r["name"] for r in recs] == ["pop_t", "pop_t"]
    assert recs[1]["metrics"] == reports[1]["metrics"]
    assert tr.tracked_programs()["pop_episode"].episodes_built == 1


def test_pop_cli_runs_and_resumes_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.pop --device cpu`` trains, saves,
    evaluates; a rerun with the same checkpoint resumes at its
    generation."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ckpt = str(tmp_path / "pop.ckpt")
    cmd = [sys.executable, "-m", "repro_torch.launch.pop", "--device", "cpu",
           "--members", "4", "--generations", "1", "--slots", "6",
           "--devices", "3", "--replay", "16", "--batch", "4",
           "--train-every", "5", "--checkpoint", ckpt,
           "--history", str(tmp_path / "hist")]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env=env, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    assert "[pop] gen   0:" in p.stdout and os.path.exists(ckpt)
    assert p.stdout.count("[pop] eval t=") == 3
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env=env, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    assert "resumed" in p.stdout and "[pop] gen   1:" in p.stdout
