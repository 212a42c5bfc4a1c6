"""Cost and memory attribution for the port's hot programs.

Counterpart of ``repro/obs/cost.py``. The reference asks XLA's cost
analysis of a compiled program; PyTorch runs eagerly, so ``program_cost``
runs the program once under a ``TorchDispatchMode`` that sees every
operation it dispatches and adds up:

* ``flops``: each operation's FLOPs by the formulas of
  ``torch.utils.flop_counter`` (``FlopCounterMode``'s registry: matrix
  products, convolutions, attention; elementwise operations count 0, as
  there), and each call of a hand-written kernel by its one formula in
  ``kernels/cost.py``, with the PyTorch operations inside it (its plain
  version's, on the CPU) not counted. So a program's FLOPs are the same on
  the CPU and on the card: they do not depend on what implements a kernel;
* ``bytes_accessed``: the unfused traffic, each dispatched operation's
  input tensors' bytes plus its outputs' (views excluded: they move
  nothing), with each hand-written kernel counted as one operation;
* ``argument_bytes``/``output_bytes``: the sizes of the program's argument
  and result tensors; ``temp_bytes``: the peak memory allocated on the card
  while it ran, above what was allocated before (None on the CPU);
  ``generated_code_bytes``: None (nothing is compiled).

The program must run eagerly: a CUDA-graph replay dispatches nothing, so
the builders drive their programs with ``mode="loop"``. The three builders
cost the hot programs the reference names:

* ``driver_step_cost``: one ``RolloutDriver`` slot body from a fresh carry
  (sample, actor, critic, env step; the ring is empty, so no train step);
* ``pack_program_cost``: a whole ``PackProgram`` (every cell's episode,
  train steps and their backward included);
* ``serve_decode_cost``: one serve decode step at the final exit.

Every number is deterministic per (code, shapes) and, for FLOPs, per
device type too; ``use_pallas=`` of the reference becomes ``device=``
(the port has no kernel switch).
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# The three standard hot programs, in reporting order.
HOT_PROGRAMS = ("driver_step", "sweep_pack", "serve_decode")


def _tensor_list(tree) -> list:
    """The tensors of a tree of tuples, lists, dicts and NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensor_list(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _tensor_list(v)]
    return []


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _tensor_list(tree))


class _CostCounter(TorchDispatchMode):
    """Counts every dispatched operation's FLOPs and bytes; while a
    hand-written kernel runs (``kernel``), only the kernel is counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self._paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused and not getattr(func, "is_view", False):
            count = flop_registry.get(func.overloadpacket)
            if count is not None:
                self.flops += int(count(*args, **kwargs, out_val=out))
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    def kernel(self, flops: int, fn, args, kwargs):
        """One call of a hand-written kernel, counted as one operation:
        ``flops`` from its formula, its arguments' and results' bytes."""
        self._paused += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._paused -= 1
        if not self._paused:
            self.flops += int(flops)
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def program_cost(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once, eagerly, and report its cost::

        {"flops": ..., "bytes_accessed": ..., "arithmetic_intensity": ...,
         "argument_bytes": ..., "output_bytes": ..., "temp_bytes": ...,
         "generated_code_bytes": None}

    the reference's keys (see the module docstring for what each counts);
    ``temp_bytes`` is None unless an argument lies on the card."""
    card = next((x.device for x in _tensor_list((args, kwargs))
                 if x.is_cuda), None)
    return _cost(fn, args, kwargs, card)


def _cost(fn, args, kwargs, card) -> dict:
    """``program_cost`` with the card whose peak memory to read (None: no
    ``temp_bytes``)."""
    from repro_torch.kernels import ops

    if card is not None:
        torch.cuda.synchronize(card)
        base = torch.cuda.memory_allocated(card)
        torch.cuda.reset_peak_memory_stats(card)
    counter = _CostCounter()
    ops._COST_COUNTERS.append(counter)
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        ops._COST_COUNTERS.remove(counter)
    temp = None
    if card is not None:
        torch.cuda.synchronize(card)
        temp = int(torch.cuda.max_memory_allocated(card) - base)
    flops, nbytes = float(counter.flops), float(counter.bytes)
    return {
        "flops": flops, "bytes_accessed": nbytes,
        "arithmetic_intensity": (round(flops / nbytes, 4)
                                 if flops and nbytes else None),
        "argument_bytes": _nbytes((args, kwargs)),
        "output_bytes": _nbytes(out), "temp_bytes": temp,
        "generated_code_bytes": None,
    }


# --------------------------------------------------------- program builders
def driver_step_cost(*, n_devices: int = 6, n_servers: int = 2,
                     n_fleets: int = 2, method: str = "grle",
                     device=None) -> dict:
    """Cost of one ``RolloutDriver`` slot body from a fresh carry (the
    reference's scan step program; ``n_servers`` as there, the scenario's
    own N)."""
    from repro_torch.core.policy import agent_def
    from repro_torch.mec.env import MECEnv
    from repro_torch.mec.scenarios import make_scenario
    from repro_torch.rollout.driver import RolloutDriver

    env = MECEnv(make_scenario("fig5_baseline", n_devices=n_devices),
                 device=device)
    adef = agent_def(method, env, buffer_size=32, batch_size=8,
                     train_every=5, device=env.device)
    drv = RolloutDriver(adef, n_fleets=n_fleets, device=env.device)
    gen = torch.Generator(device=env.device).manual_seed(0)
    carry = drv.init_carry(gen)
    no_loss = torch.full((), torch.nan, device=env.device)
    cost = program_cost(
        lambda c: drv._slot(c, gen, None, None, None, None, no_loss, None),
        carry)
    cost["derived"] = (f"slot body: {method} M={n_devices} N={n_servers} "
                       f"B={n_fleets} fleets, train gated")
    return cost


def pack_program_cost(*, n_devices: int = 6, n_slots: int = 20,
                      seeds: int = 2, device=None) -> dict:
    """Cost of one ``PackProgram`` (a gcn-family pack: grle, grl x
    ``seeds``), its cells' episodes in loop mode."""
    from repro_torch.sweep import SweepSpec, pack_cells
    from repro_torch.sweep.runner import PackProgram

    spec = SweepSpec.from_names("fig5_baseline", "grle,grl", seeds,
                                n_devices=n_devices, n_slots=n_slots,
                                replay_capacity=16, batch_size=4,
                                train_every=5)
    (pack,) = pack_cells(spec.expand())
    prog = PackProgram(pack, device=device, mode="loop")
    cost = _cost(prog.run, (), {},
                 prog.device if prog.device.type == "cuda" else None)
    cost["derived"] = (f"pack episode: {len(pack.cells)} cells "
                       f"(grle,grl x {seeds} seeds) M={n_devices} "
                       f"T={n_slots}")
    return cost


def serve_decode_cost(*, arch: str = "qwen1_5_0_5b", batch: int = 2,
                      cache_len: int = 64, device=None) -> dict:
    """Cost of one serve decode step (final exit, reduced config, random
    weights from seed 0)."""
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models.lm import model_for
    from repro_torch.train.steps import make_serve_step

    dev = resolve_device(device)
    cfg = get_arch(arch, reduced=True)
    model = model_for(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    cache = model.init_cache(cfg, batch, cache_len, device=dev)
    step = make_serve_step(cfg, exit_layer=cfg.exit_layers[-1])
    tokens = torch.zeros((batch,), dtype=torch.int64, device=dev)
    pos = torch.zeros((batch,), dtype=torch.int64, device=dev)
    cost = program_cost(step, params, cache, tokens, pos)
    cost["derived"] = (f"decode step: {arch} (reduced) b={batch} "
                       f"cache={cache_len} exit={cfg.exit_layers[-1]}")
    return cost


def hot_program_costs(quick: bool = True, *, device=None) -> dict:
    """The three standard programs' costs, keyed by ``HOT_PROGRAMS`` name.

    ``quick=False`` uses paper-scale shapes for the MEC programs (M=14,
    T=100).
    """
    if quick:
        return {
            "driver_step": driver_step_cost(device=device),
            "sweep_pack": pack_program_cost(device=device),
            "serve_decode": serve_decode_cost(device=device),
        }
    return {
        "driver_step": driver_step_cost(n_devices=14, n_fleets=4,
                                        device=device),
        "sweep_pack": pack_program_cost(n_devices=14, n_slots=100, seeds=4,
                                        device=device),
        "serve_decode": serve_decode_cost(batch=4, cache_len=256,
                                          device=device),
    }
