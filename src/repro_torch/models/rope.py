"""Rotary position embeddings.

Counterpart of ``repro/models/rope.py``: the angles and the rotation are
computed in float32 and the result is cast back to the input's dtype.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10_000.0, *, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)                     # [head_dim // 2]


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)     # [hd/2]
    ang = positions[..., :, None].float() * inv      # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]            # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
