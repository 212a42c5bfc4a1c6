"""Functional layers over dict params (PyTorch port)."""
from repro_torch.nn.initializers import (he_normal, normal_init, ones_init,
                                         truncated_normal_init,
                                         xavier_uniform, zeros_init)
from repro_torch.nn.layers import (MLP, Conv2D, Dropout, Embedding,
                                   LayerNorm, Linear, RMSNorm,
                                   f32_convolutions)
from repro_torch.nn.pytree import (flatten_dict, tree_bytes, tree_cast,
                                   tree_global_norm, tree_map_with_path,
                                   tree_size, tree_zeros_like,
                                   unflatten_dict)

__all__ = ["Conv2D", "Dropout", "Embedding", "LayerNorm", "Linear", "MLP",
           "RMSNorm", "f32_convolutions", "flatten_dict", "he_normal",
           "normal_init", "ones_init", "tree_bytes", "tree_cast",
           "tree_global_norm", "tree_map_with_path", "tree_size",
           "tree_zeros_like", "truncated_normal_init", "unflatten_dict",
           "xavier_uniform", "zeros_init"]
