"""Core layers as (init, apply) namespaces over dict params.

Counterpart of ``repro/nn/layers.py`` (``Linear``, ``Embedding``,
``RMSNorm``, ``MLP``). Params keep the reference's functional layout
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


class MLP:
    """Two-layer MLP ``{"fc1", "fc2"}``, each a ``Linear``; the activation
    (relu by default) sits between the two."""

    @staticmethod
    def init(generator: torch.Generator, in_dim: int, hidden: int,
             out_dim: int, *, device, use_bias: bool = True,
             dtype=torch.float32):
        return {
            "fc1": Linear.init(generator, in_dim, hidden, device=device,
                               use_bias=use_bias, dtype=dtype),
            "fc2": Linear.init(generator, hidden, out_dim, device=device,
                               use_bias=use_bias, dtype=dtype),
        }

    @staticmethod
    def apply(params, x, *, activation=torch.relu):
        h = activation(Linear.apply(params["fc1"], x))
        return Linear.apply(params["fc2"], h)
