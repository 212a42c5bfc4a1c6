"""Optimizers (PyTorch port): Adam, as the GRLE actor trains."""
from repro_torch.optim.optimizers import (Optimizer, adam, apply_updates,
                                          scale_updates)

__all__ = ["Optimizer", "adam", "apply_updates", "scale_updates"]
