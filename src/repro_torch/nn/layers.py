"""Core layers as (init, apply) namespaces over dict params.

Counterpart of ``repro/nn/layers.py`` (``Linear``, ``Embedding``,
``LayerNorm``, ``RMSNorm``, ``Conv2D``, ``MLP``, ``Dropout``). Params keep
the reference's functional layout ``{"w": [in, out], "b": [out]}`` — not
``torch.nn.Linear``'s ``[out, in]`` — and ``Conv2D``'s HWIO kernels over
NHWC activations, so a JAX param tree maps over 1:1.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.nn.initializers import (he_normal, ones_init,
                                         xavier_uniform, zeros_init)


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


class LayerNorm:
    @staticmethod
    def init(generator: torch.Generator, dim: int, *, device,
             use_bias: bool = True, dtype=torch.float32):
        p = {"scale": ones_init(generator, (dim,), device=device,
                                dtype=dtype)}
        if use_bias:
            p["bias"] = zeros_init(generator, (dim,), device=device,
                                   dtype=dtype)
        return p

    @staticmethod
    def apply(params, x, *, eps: float = 1e-5):
        """(x - mean) * rsqrt(var + eps) * scale + bias over the last axis,
        in float32, cast back to x's dtype."""
        xf = x.float()
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"].float()
        if "bias" in params:
            y = y + params["bias"].float()
        return y.to(x.dtype)


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


@contextlib.contextmanager
def f32_convolutions():
    """cuDNN convolutions without TF32 inside the block, the previous
    setting restored after it. ``torch.backends.cudnn.allow_tf32`` is True
    by default (unlike matmul's), which would give a float32 convolution
    on the card ~1e-3 relative error against the reference's float32;
    ``Conv2D.apply`` runs under it, and so must a backward through its
    convolutions (autograd runs them after the forward's block has
    closed). Not ``cudnn.flags``: its defaults also reset cuDNN's
    enabled, benchmark and fp32-precision settings."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _same_padding(size: int, k: int, stride: int):
    """XLA's "SAME" padding of one spatial axis: (low, high), the odd
    pixel on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv2D:
    """NHWC conv with an HWIO kernel ``{"w": [kh, kw, cin, cout], "b":
    [cout]}``, as the reference keeps it. Inside, the activations are
    viewed as NCHW (an NHWC tensor is channels-last NCHW, no copy) and the
    kernel as OIHW for ``F.conv2d``; float32 runs without TF32
    (``f32_convolutions``)."""

    @staticmethod
    def init(generator: torch.Generator, in_ch: int, out_ch: int,
             kernel=(3, 3), *, device, use_bias: bool = True,
             dtype=torch.float32):
        p = {"w": he_normal(generator, (*kernel, in_ch, out_ch),
                            device=device, dtype=dtype)}
        if use_bias:
            p["b"] = zeros_init(generator, (out_ch,), device=device,
                                dtype=dtype)
        return p

    @staticmethod
    def apply(params, x, *, stride=(1, 1), padding="SAME"):
        """x [B, H, W, cin] -> [B, H', W', cout]; ``padding`` "SAME" (XLA's:
        output ceil(H / stride)) or "VALID"."""
        w = params["w"]
        kh, kw = w.shape[:2]
        xc = x.permute(0, 3, 1, 2)
        if padding == "SAME":
            ph = _same_padding(x.shape[1], kh, stride[0])
            pw = _same_padding(x.shape[2], kw, stride[1])
            if ph[0] == ph[1] and pw[0] == pw[1]:
                pad = (ph[0], pw[0])
            else:
                xc, pad = F.pad(xc, (*pw, *ph)), (0, 0)
        elif padding == "VALID":
            pad = (0, 0)
        else:
            raise ValueError(f"Conv2D: padding {padding!r}, expected 'SAME' "
                             f"or 'VALID'")
        with f32_convolutions():
            y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=tuple(stride),
                         padding=pad)
        y = y.permute(0, 2, 3, 1)
        if "b" in params:
            y = y + params["b"]
        return y


class Dropout:
    @staticmethod
    def apply(generator, x, rate: float, *, deterministic: bool, mask=None):
        """Inverted dropout: x / (1 - rate) where kept, 0 elsewhere. The
        keep mask is drawn from ``generator`` (uniform < 1 - rate), unless
        ``mask`` (bool, x's shape) injects it."""
        if deterministic or rate <= 0.0:
            return x
        keep = 1.0 - rate
        if mask is None:
            mask = torch.rand(x.shape, generator=generator,
                              device=x.device) < keep
        return torch.where(mask, x / keep, 0.0).to(x.dtype)
