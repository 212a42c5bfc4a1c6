"""Weight initializers drawing from an explicit ``torch.Generator``.

Counterpart of ``repro/nn/initializers.py`` (``normal_init``,
``truncated_normal_init``, ``xavier_uniform``, ``he_normal``,
``zeros_init``, ``ones_init``). Same distributions as the reference, not
its bits.
"""
from __future__ import annotations

import math

import torch


def normal_init(generator: torch.Generator, shape, *, device,
                scale: float = 0.02, dtype=torch.float32):
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def truncated_normal_init(generator: torch.Generator, shape, *, device,
                          scale: float = 0.02, dtype=torch.float32):
    """N(0, 1) truncated to [-2, 2], rescaled to unit variance, times
    ``scale``."""
    x = torch.empty(shape, device=device, dtype=torch.float32)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * (scale / 0.87962566)).to(dtype)


def xavier_uniform(generator: torch.Generator, shape, *, device,
                   dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    # in place: the draw is the one float32 buffer a large matrix takes
    return u.mul_(2.0 * limit).sub_(limit).to(dtype)


def he_normal(generator: torch.Generator, shape, *, device,
              dtype=torch.float32):
    """N(0, 2 / fan_in): dense [in, out] and conv [h, w, cin, cout]
    kernels."""
    fan_in, _ = _fans(shape)
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * math.sqrt(2.0 / fan_in)).to(dtype)


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
