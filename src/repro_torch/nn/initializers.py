"""Weight initializers drawing from an explicit ``torch.Generator``.

Counterpart of ``repro/nn/initializers.py`` (``normal_init``,
``xavier_uniform``, ``zeros_init``, ``ones_init``). Same distributions as
the reference, not its bits.
"""
from __future__ import annotations

import math

import torch


def normal_init(generator: torch.Generator, shape, *, device,
                scale: float = 0.02, dtype=torch.float32):
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def xavier_uniform(generator: torch.Generator, shape, *, device,
                   dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return (u * (2.0 * limit) - limit).to(dtype)


def zeros_init(generator, shape, *, device, dtype=torch.float32):
    del generator
    return torch.zeros(shape, device=device, dtype=dtype)


def ones_init(generator, shape, *, device, dtype=torch.float32):
    del generator
    return torch.ones(shape, device=device, dtype=dtype)


def _fans(shape):
    """fan_in/fan_out for dense [in, out] and conv [h, w, cin, cout] kernels."""
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive
