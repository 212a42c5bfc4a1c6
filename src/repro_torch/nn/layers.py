"""Core layers as (init, apply) namespaces over dict params.

Counterpart of ``repro/nn/layers.py`` (``Linear`` only). Params keep the
reference's functional layout ``{"w": [in, out], "b": [out]}`` — not
``torch.nn.Linear``'s ``[out, in]`` — so a JAX param tree maps over 1:1.
"""
from __future__ import annotations

import torch

from repro_torch.nn.initializers import xavier_uniform, zeros_init


class Linear:
    @staticmethod
    def init(generator: torch.Generator, in_dim: int, out_dim: int, *,
             device, use_bias: bool = True, init=xavier_uniform,
             dtype=torch.float32):
        p = {"w": init(generator, (in_dim, out_dim), device=device,
                       dtype=dtype)}
        if use_bias:
            p["b"] = zeros_init(generator, (out_dim,), device=device,
                                dtype=dtype)
        return p

    @staticmethod
    def apply(params, x):
        y = x @ params["w"]
        if "b" in params:
            y = y + params["b"]
        return y
