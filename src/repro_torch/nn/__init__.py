"""Functional layers over dict params (PyTorch port)."""
from repro_torch.nn.initializers import xavier_uniform, zeros_init
from repro_torch.nn.layers import Linear

__all__ = ["Linear", "xavier_uniform", "zeros_init"]
