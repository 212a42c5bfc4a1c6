"""Optimizers (PyTorch port): Adam, AdamW, SGD, gradient clipping and
learning-rate schedules."""
from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                          apply_updates, chain_clip,
                                          clip_by_global_norm, scale_updates,
                                          sgd)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         linear_warmup_cosine)

__all__ = ["Optimizer", "adam", "adamw", "apply_updates", "chain_clip",
           "clip_by_global_norm", "constant", "cosine_decay",
           "linear_warmup_cosine", "scale_updates", "sgd"]
