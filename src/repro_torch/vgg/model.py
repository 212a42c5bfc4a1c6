"""Multi-exit VGG-16 (paper §VI-B, Fig 1/3).

Counterpart of ``repro/vgg/model.py``. The paper attaches a classifier
after each convolutional or pooling layer — 17 exit points with exit 17
being the main branch — then keeps the five *candidate* exits {1, 3, 4,
7, 17} (Table I). The reference's enumeration is kept: exits 1-16 after
stages 0-15 (every conv and pool up to the second conv of the last
block), the main branch (final pool + FC head) as exit 17. Params keep
the reference's tree (``stages/conv<i>`` HWIO kernels, ``exits/exit<j>``
and ``head`` linears), so a JAX param tree maps over 1:1.

``width_mult`` scales channel counts for small variants; the exit
topology is unchanged.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.nn import Conv2D, Linear

# 'c<out>' = 3x3 conv + relu, 'p' = 2x2 maxpool. Standard VGG-16.
VGG16_STAGES: Sequence[str] = (
    "c64", "c64", "p",
    "c128", "c128", "p",
    "c256", "c256", "c256", "p",
    "c512", "c512", "c512", "p",
    "c512", "c512", "c512", "p",
)
N_EXITS = 17
# the stages after which exits 1..16 attach; exit 17 is the head
_EXIT_AFTER = tuple(range(N_EXITS - 1))


def _width(spec: str, width_mult: float) -> int:
    return max(8, int(int(spec[1:]) * width_mult))


def _maxpool(x):
    """2x2 max pool, stride 2, VALID, of NHWC x."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class VGG16EE:
    @staticmethod
    def init(generator: torch.Generator, *, n_classes: int = 10,
             width_mult: float = 1.0, dtype=torch.float32, device=None):
        """He-normal conv kernels, Xavier-uniform classifiers, zero biases
        (the reference's distributions), on the card unless
        ``device="cpu"``."""
        device = resolve_device(device)
        params = {"stages": {}, "exits": {}, "head": None}
        in_ch = 3
        exit_idx = 0
        for i, spec in enumerate(VGG16_STAGES):
            if spec.startswith("c"):
                out_ch = _width(spec, width_mult)
                params["stages"][f"conv{i}"] = Conv2D.init(
                    generator, in_ch, out_ch, (3, 3), device=device,
                    dtype=dtype)
                in_ch = out_ch
            if i in _EXIT_AFTER:
                # light classifier: GAP -> linear
                params["exits"][f"exit{exit_idx + 1}"] = Linear.init(
                    generator, in_ch, n_classes, device=device, dtype=dtype)
                exit_idx += 1
        params["head"] = Linear.init(generator, in_ch, n_classes,
                                     device=device, dtype=dtype)
        return params

    @staticmethod
    def param_shapes(*, n_classes: int = 10, width_mult: float = 1.0
                     ) -> dict:
        """The param tree's names and shapes, as ``init`` builds it."""
        shapes = {"stages": {}, "exits": {}}
        in_ch = 3
        exit_idx = 0
        for i, spec in enumerate(VGG16_STAGES):
            if spec.startswith("c"):
                out_ch = _width(spec, width_mult)
                shapes["stages"][f"conv{i}"] = {"w": (3, 3, in_ch, out_ch),
                                                "b": (out_ch,)}
                in_ch = out_ch
            if i in _EXIT_AFTER:
                exit_idx += 1
                shapes["exits"][f"exit{exit_idx}"] = {
                    "w": (in_ch, n_classes), "b": (n_classes,)}
        shapes["head"] = {"w": (in_ch, n_classes), "b": (n_classes,)}
        return shapes

    @staticmethod
    def apply(params, images, *, up_to_exit: int = N_EXITS):
        """Forward pass returning logits of every exit <= up_to_exit.

        images: [B, 32, 32, 3]. Returns dict {exit_no: [B, n_classes]}.
        With ``up_to_exit < 17`` computation truncates after that exit's
        classifier — the early-exit latency saving the offloading
        simulator models.
        """
        x = images
        outs = {}
        exit_idx = 0
        for i, spec in enumerate(VGG16_STAGES):
            if spec.startswith("c"):
                x = torch.relu(Conv2D.apply(params["stages"][f"conv{i}"], x))
            else:
                x = _maxpool(x)
            if i in _EXIT_AFTER:
                exit_idx += 1
                if exit_idx <= up_to_exit:
                    gap = x.mean(dim=(1, 2))
                    outs[exit_idx] = Linear.apply(
                        params["exits"][f"exit{exit_idx}"], gap)
                if exit_idx >= up_to_exit:
                    return outs
        gap = x.mean(dim=(1, 2))
        outs[N_EXITS] = Linear.apply(params["head"], gap)
        return outs

    # ------------------------------------------------------------- analytics
    @staticmethod
    def exit_flops(width_mult: float = 1.0, image_hw: int = 32):
        """Cumulative forward GFLOPs up to each exit (batch 1; the convs
        only, as the reference counts them)."""
        hw = image_hw
        in_ch = 3
        cum = 0.0
        out = {}
        exit_idx = 0
        for i, spec in enumerate(VGG16_STAGES):
            if spec.startswith("c"):
                out_ch = _width(spec, width_mult)
                cum += 2.0 * 9 * in_ch * out_ch * hw * hw
                in_ch = out_ch
            else:
                hw = hw // 2
            if i in _EXIT_AFTER:
                exit_idx += 1
                out[exit_idx] = cum / 1e9
        out[N_EXITS] = cum / 1e9
        return out
