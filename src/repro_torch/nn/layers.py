"""Core layers as (init, apply) namespaces over dict params.

Counterpart of ``repro/nn/layers.py`` (``Linear``, ``Embedding``,
``RMSNorm``). Params keep the reference's functional layout
``{"w": [in, out], "b": [out]}`` — not ``torch.nn.Linear``'s
``[out, in]`` — so a JAX param tree maps over 1:1.
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


class Embedding:
    """``{"table": [vocab, dim]}``; ``DecoderLM.init`` draws it."""

    @staticmethod
    def apply(params, ids):
        return params["table"][ids]


class RMSNorm:
    """``{"scale": [dim]}``; ``DecoderLM.init`` draws it."""

    @staticmethod
    def apply(params, x, *, eps: float = 1e-6):
        """x * rsqrt(mean(x^2) + eps) * scale, in float32, cast back to
        x's dtype."""
        xf = x.float()
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
        return y.to(x.dtype)
