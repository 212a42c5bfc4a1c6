"""Feed-forward layers.

Counterpart of ``repro/models/ffn.py``: the SwiGLU ``DenseFFN``. The
mixture of experts (``MoEFFN``) is not ported yet and raises.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.nn import Linear


class DenseFFN:
    """SwiGLU MLP (llama-family)."""

    @staticmethod
    def param_shapes(d_model: int, d_ff: int) -> dict:
        return {"w1": {"w": (d_model, d_ff)}, "w3": {"w": (d_model, d_ff)},
                "w2": {"w": (d_ff, d_model)}}

    @staticmethod
    def apply(params, x):
        h = F.silu(Linear.apply(params["w1"], x)) * Linear.apply(params["w3"], x)
        return Linear.apply(params["w2"], h)


class MoEFFN:
    """Shared + routed-top-k mixture of experts: not ported yet."""

    @staticmethod
    def apply(params, cfg, x):
        raise NotImplementedError(
            "MoEFFN is not ported yet (deepseek_moe_16b, deepseek_v2_236b); "
            "repro_torch runs the dense families")
