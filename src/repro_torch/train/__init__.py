"""LM inference steps (the training half of ``repro.train`` is not ported)."""
from repro_torch.train.steps import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
