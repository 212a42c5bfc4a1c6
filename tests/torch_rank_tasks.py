"""What the ranks of the sharding tests run (``repro_torch.sharding.ranks.
RankPool``): module-level functions, importable in a spawned process
without JAX. Each builds its run from plain arguments, runs it on the
process group's ``fleet`` mesh (``sharded=False``: unsharded, in the
calling process) and returns numpy arrays and host values, which the
tests compare with the unsharded run's in the parent.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import agent_def, agent_state_from_params
from repro_torch.mec import MECEnv, SlotTasks, make_scenario
from repro_torch.nn.pytree import tree_tensors
from repro_torch.rollout import RolloutDriver, SlotDraws
from repro_torch.sharding import fleet_mesh

SMALL = dict(hidden=(16, 8))
TRAIN = dict(replay_capacity=16, batch_size=4, train_every=5)


def arrays(tree) -> list:
    """Every tensor of a tree as a numpy array, in ``tree_tensors`` order."""
    return [x.detach().cpu().numpy() for x in tree_tensors(tree)]


def _mesh(sharded: bool):
    mesh = fleet_mesh() if sharded else None
    if sharded and mesh is None:
        raise RuntimeError("no fleet mesh: the task needs a process group "
                           "of more than one rank")
    return mesh


# ------------------------------------------------------------ the driver
def _per_fleet_sp(env, n_fleets: int):
    """A domain-randomized [B]-leading ``sp``: fig5 -> fig8 knobs mixed
    per fleet by a fixed ramp."""
    from repro_torch.mec.scenarios import interpolate_params, scenario_space
    space = scenario_space("fig5_baseline", "fig8_csi",
                           n_devices=env.M, device="cpu")
    rows = [interpolate_params(space.lo, space.hi, t)
            for t in np.linspace(0.0, 1.0, n_fleets)]
    return type(rows[0])(*(torch.stack(xs) for xs in zip(*rows)))


def driver_episode(spec: dict, sharded: bool = True) -> dict:
    """``run_sharded`` of a small GRLE driver (``spec``: scenario, M, B,
    T, mode, seed, telemetry, per_fleet) -> carry, trace and metrics."""
    env = MECEnv(make_scenario(spec["scenario"], n_devices=spec["M"]),
                 device="cpu")
    drv = RolloutDriver(agent_def("grle", env, device="cpu", **SMALL),
                        spec["B"], train=True, device="cpu",
                        telemetry=spec.get("telemetry", False),
                        per_fleet_scenarios=spec.get("per_fleet", False),
                        **TRAIN)
    sp = _per_fleet_sp(env, spec["B"]) if spec.get("per_fleet") else None
    carry, trace = drv.run_sharded(spec["seed"], spec["T"],
                                   mesh=_mesh(sharded), sp=sp,
                                   mode=spec.get("mode", "scan"))
    return {"carry": arrays(carry), "trace": arrays(trace),
            "ring": arrays(carry.agent_state.replay),
            "params": arrays(carry.agent_state.params),
            "metrics": drv.metrics(carry),
            "host": (carry.agent_state.host_step,
                     carry.agent_state.replay.host_size)}


def _tree_of(data: dict, prefix: str) -> dict:
    tree = {}
    for k in data:
        if k.startswith(prefix + "/"):
            *heads, name = k[len(prefix) + 1:].split("/")
            node = tree
            for h in heads:
                node = node.setdefault(h, {})
            node[name] = data[k]
    return tree


def golden_episode(data: dict, mode: str = "scan",
                   sharded: bool = True) -> dict:
    """The JAX training golden (fig5_baseline at full width, B=4, T=64,
    its tasks, candidates and minibatch rows injected) through
    ``run_sharded`` -> trace, final state and metrics."""
    env = MECEnv(make_scenario(str(data["scenario"])), device="cpu")
    drv = RolloutDriver(agent_def("grle", env, device="cpu"), 4,
                        train=True, device="cpu")
    st = agent_state_from_params(drv.adef, _tree_of(data, "init_params"),
                                 data["exit_mask"])
    draws = SlotDraws(
        SlotTasks(*(torch.tensor(data[f"tasks/{f}"])
                    for f in SlotTasks._fields)),
        torch.tensor(data["rand_cands"].astype(np.int64)),
        torch.tensor(data["replay_take"]))
    carry, trace = drv.run_sharded(0, data["rand_cands"].shape[0],
                                   mesh=_mesh(sharded), agent_state=st,
                                   draws=draws, mode=mode)
    fin = carry.agent_state
    return {"trace": {k: v.numpy() for k, v in trace._asdict().items()},
            "params": {k: {n: x.numpy() for n, x in v.items()}
                       for k, v in fin.params.items()},
            "mu": {k: {n: x.numpy() for n, x in v.items()}
                   for k, v in fin.opt_state["mu"].items()},
            "nu": {k: {n: x.numpy() for n, x in v.items()}
                   for k, v in fin.opt_state["nu"].items()},
            "opt_step": int(fin.opt_state["step"]),
            "metrics": drv.metrics(carry)}


# ------------------------------------------------------------ population
def pop_generation(spec: dict, sharded: bool = True) -> dict:
    """One PBT generation (and an evaluation) of a small population
    (``spec``: P, M, slots, seed) -> report, agents and metrics."""
    from repro_torch.mec.scenarios import (interpolate_params,
                                           scenario_space)
    from repro_torch.pop import Curriculum, PBTConfig, PopulationTrainer

    env = MECEnv(make_scenario("fig5_baseline", n_devices=spec["M"]),
                 device="cpu")
    adef = agent_def("grle", env, device="cpu", buffer_size=16,
                     batch_size=4, train_every=5, **SMALL)
    space = scenario_space("fig5_baseline", "fig6_capacity",
                           n_devices=spec["M"], device="cpu")
    tr = PopulationTrainer(adef, Curriculum(space.lo, space.hi, n_regions=3),
                           n_members=spec["P"], n_fleets=2,
                           n_slots=spec["slots"], pbt=PBTConfig(frac=0.25),
                           seed=spec["seed"], mesh=_mesh(sharded),
                           telemetry=True)
    ts, report, det = tr.generation(tr.init_state(), detail=True)
    evals = tr.evaluate(ts.pop, (spec["seed"], 9),
                        interpolate_params(space.lo, space.hi, 0.9))
    return {"report": report, "agents": arrays(ts.pop.agents),
            "hypers": arrays(ts.pop.hypers), "cur": arrays(ts.cur),
            "metrics": {k: v.numpy() for k, v in det.metrics.items()},
            "traces": [arrays(t) for t in det.traces],
            "telemetry": arrays(tr.telemetry),
            "evals": {k: v.numpy() for k, v in evals.items()}}


def _generation_draws(gold: dict, g: int, n_members: int):
    """Generation g's draws as the population golden stores them."""
    from repro_torch.pop.pbt import PBTDraws
    from repro_torch.pop.trainer import GenerationDraws

    def t(key, dtype=None):
        return torch.tensor(np.asarray(gold[f"gen{g}/{key}"]), dtype=dtype)

    members = [SlotDraws(
        SlotTasks(*(t(f"m{i}/tasks/{f}") for f in SlotTasks._fields)), None,
        t(f"m{i}/replay_take", torch.int64), gumbel=t(f"m{i}/gumbel"))
        for i in range(n_members)]
    return GenerationDraws(
        region=t("region"), offset=t("offset"), members=members,
        pbt=PBTDraws(*(t(f"pbt/{k}") for k in ("up", "gain", "tau"))))


def pop_golden(gold: dict, cfg: dict, history: str,
               sharded: bool = True) -> dict:
    """The JAX population golden (``cfg``: its config; GRLE, P members
    with sampled hypers, every draw injected) through
    ``PopulationTrainer`` on this rank's mesh, from the stored initial
    params and hypers, history records into ``history`` -> each
    generation's report, member traces, [P] metrics, PBT stats, hypers and
    curriculum state, and the final params and telemetry."""
    from repro_torch.mec.scenarios import scenario_space
    from repro_torch.nn.pytree import flatten_dict
    from repro_torch.obs.history import HistoryStore
    from repro_torch.obs.telemetry import telemetry_host
    from repro_torch.pop import Curriculum, MemberHypers, PopulationTrainer

    c = cfg
    env = MECEnv(make_scenario(c["space"][0], n_devices=c["n_devices"]),
                 device="cpu")
    space = scenario_space(*c["space"], n_devices=c["n_devices"],
                           device="cpu")
    tr = PopulationTrainer(
        agent_def(c["method"], env, device="cpu"),
        Curriculum(space.lo, space.hi, n_regions=c["regions"]),
        n_members=c["members"], n_fleets=c["fleets"], n_slots=c["slots"],
        seed=c["seed"], mesh=_mesh(sharded), replay_capacity=c["replay"],
        batch_size=c["batch"], train_every=c["train_every"],
        telemetry=True, history=HistoryStore(history), history_name="pop")
    ts = tr.init_state()
    init = _tree_of(gold, "init/params")
    params = {layer: {leaf: torch.tensor(init[layer][leaf])
                      for leaf in leaves}
              for layer, leaves in ts.pop.agents.params.items()}
    hyp = MemberHypers(*(torch.tensor(gold[f"init/hypers/{f}"])
                         for f in MemberHypers._fields))
    ts = ts._replace(pop=ts.pop._replace(
        agents=ts.pop.agents._replace(params=params), hypers=hyp))
    gens = []
    for g in range(c["generations"]):
        ts, report, det = tr.generation(
            ts, draws=_generation_draws(gold, g, c["members"]), detail=True)
        gens.append({
            "report": report,
            "traces": [{k: v.numpy() for k, v in t._asdict().items()}
                       for t in det.traces],
            "metrics": {k: v.numpy() for k, v in det.metrics.items()},
            "stats": {k: getattr(det.stats, k).numpy()
                      for k in ("src", "copied", "ranks")},
            "hypers": {f: getattr(ts.pop.hypers, f).numpy()
                       for f in MemberHypers._fields},
            "score": ts.cur.score.numpy(), "visits": ts.cur.visits.numpy()})
    return {"gens": gens, "generation": int(ts.pop.generation),
            "params": {k: v.numpy() for k, v in
                       flatten_dict(ts.pop.agents.params).items()},
            "telemetry": telemetry_host(tr.telemetry)}


def population_of(spec: dict, n: int):
    """A generation of ``n`` members (the env's own knobs) on this rank's
    mesh -> the error it raises, or None."""
    from repro_torch.pop import PopulationDriver, init_population
    env = MECEnv(make_scenario("fig5_baseline", n_devices=spec["M"]),
                 device="cpu")
    adef = agent_def("grle", env, device="cpu", **SMALL)
    drv = PopulationDriver(adef, n_slots=3, mesh=_mesh(True))
    pop = init_population(adef, 0, n)
    try:
        drv.run_generation(pop, 0, type(env.params)(
            *(torch.stack([x] * n) for x in env.params)))
    except ValueError as e:
        return str(e)
    return None


# ----------------------------------------------------------------- sweep
def sweep_spec(n_seeds: int):
    from repro_torch.sweep import SweepSpec
    return SweepSpec.from_names(
        "fig5_baseline", "grle", n_seeds, n_devices=4, n_slots=12,
        n_fleets=2, replay_capacity=16, batch_size=4, train_every=5)


def sweep_pack(n_seeds: int, sharded: bool = True) -> list:
    """``run_pack`` of the one pack of ``n_seeds`` fig5 GRLE cells ->
    its rows (every rank's, in cell order)."""
    from repro_torch.sweep import pack_cells, run_pack
    (pack,) = pack_cells(sweep_spec(n_seeds).expand())
    return run_pack(pack, mesh=_mesh(sharded), device="cpu")


def sweep_launcher(argv: list) -> dict:
    """``python -m repro_torch.launch sweep`` in this rank (the pool's
    group stands in for torchrun's) -> its report."""
    from repro_torch.launch.sweep import main
    return main(argv)


# ----------------------------------------------------------------- misc
def errors(n_fleets: int) -> dict:
    """The reference's refusals on this rank's mesh."""
    out = {}
    mesh = _mesh(True)
    env = MECEnv(make_scenario("fig5_baseline", n_devices=4), device="cpu")
    drv = RolloutDriver(agent_def("grle", env, device="cpu", **SMALL),
                        n_fleets, train=True, device="cpu", **TRAIN)
    try:
        drv.run_sharded(0, 3, mesh=mesh)
    except ValueError as e:
        out["fleets"] = str(e)
    for n in (mesh.size() + 1, mesh.size() - 1):
        try:
            fleet_mesh(n)
            out[n] = None
        except ValueError as e:
            out[n] = str(e)
    return out


def tree_round_trip(seed: int) -> dict:
    """``shard_leading_axis`` -> ``gather_leading`` and ``replicate`` of a
    mixed-dtype tree drawn from ``seed`` (rank 0's draw for replicate)."""
    from repro_torch.sharding import (gather_leading, replicate,
                                      shard_leading_axis)
    import torch.distributed as dist
    mesh = _mesh(True)
    gen = torch.Generator().manual_seed(seed)
    world = mesh.size()
    tree = {"f": torch.rand((2 * world, 3, 5), generator=gen),
            "i": torch.randint(-9, 9, (2 * world, 7), generator=gen,
                               dtype=torch.int32),
            "b": torch.rand((2 * world,), generator=gen) > 0.5,
            "h": torch.rand((2 * world, 2), generator=gen,
                            dtype=torch.float64)}
    mine = shard_leading_axis(tree, mesh)
    back = gather_leading(mine, mesh)
    mixed = {"x": torch.full((3,), float(dist.get_rank())),
             "n": torch.tensor(dist.get_rank(), dtype=torch.int32)}
    return {"tree": {k: v.numpy() for k, v in tree.items()},
            "mine": {k: v.numpy() for k, v in mine.items()},
            "back": {k: v.numpy() for k, v in back.items()},
            "replicated": {k: v.numpy()
                           for k, v in replicate(mixed, mesh).items()}}


def distribute_llama(spec: dict) -> dict:
    """A reduced Llama's params (``lm_params_numpy``) through
    ``distribute_tree`` on a ("data", "model") 2x2 gloo mesh: whether
    every ``full_tensor()`` is the input bit for bit, and every local
    shape against ``shard_shapes``."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.core.bridge import lm_params_from_numpy, lm_params_numpy
    from repro_torch.nn.pytree import flatten_dict
    from repro_torch.sharding import (distribute_tree, param_pspecs,
                                      shard_shapes)

    cfg = dataclasses.replace(get_arch("llama3_2_1b", reduced=True),
                              **spec.get("overrides", {}))
    params = lm_params_from_numpy(lm_params_numpy(cfg, 0), cfg,
                                  device="cpu")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    specs = param_pspecs(cfg, params, mesh)
    placed = distribute_tree(params, specs, mesh)
    shards = shard_shapes(params, specs, mesh)
    out = {}
    for path, x in flatten_dict(params).items():
        d = flatten_dict(placed)[path]
        out[path] = (bool(torch.equal(d.full_tensor(), x)),
                     tuple(d.to_local().shape),
                     tuple(flatten_dict(shards)[path].shape),
                     tuple(specs_entry for specs_entry
                           in flatten_dict(specs)[path]))
    return out
