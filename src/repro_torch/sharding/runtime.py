"""Optimization toggles of the partitioned LM configs, from ``REPRO_OPT``.

Counterpart of ``repro/sharding/runtime.py``. Each beyond-paper
optimization of the reference's partitioned runs is named in the
comma-separated ``REPRO_OPT``, so that the baseline and the optimized
specs are one environment switch apart. The port reads them where the
reference does:

  no_fsdp_infer   ``launch/specs.py::params_struct``: inference (prefill and
                  decode) param specs drop the FSDP ``data`` axis, so the
                  weights are split over ``model`` only.
  seqshard_cache  ``partition.py::cache_pspecs``: a GQA cache whose KV
                  heads do not divide the ``model`` axis splits its
                  sequence dim over ``model`` instead of ``head_dim``.
  seq_parallel    ``launch/dryrun.py``: recorded under ``opts``; the
                  reference's effect, activations constrained to a
                  sequence split at every block boundary, exists only in
                  XLA's partitioner (below).
  no_remat        ``launch/dryrun.py``: the config's ``remat`` off.

The reference's ``set_activation_spec``/``constrain_activations`` are not
ported: their effect is a ``with_sharding_constraint`` that only XLA's
SPMD partitioner reads, and the port runs no partitioned LM step (nor does
the reference outside a compile).
"""
from __future__ import annotations

import os


def opts() -> set:
    """The toggles named in ``REPRO_OPT``."""
    return set(filter(None, os.environ.get("REPRO_OPT", "").split(",")))


def enabled(name: str) -> bool:
    return name in opts()
