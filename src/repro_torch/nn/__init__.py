"""Functional layers over dict params (PyTorch port)."""
from repro_torch.nn.initializers import (normal_init, ones_init,
                                         xavier_uniform, zeros_init)
from repro_torch.nn.layers import MLP, Embedding, Linear, RMSNorm

__all__ = ["Embedding", "Linear", "MLP", "RMSNorm", "normal_init", "ones_init",
           "xavier_uniform", "zeros_init"]
