"""Synthetic data pipelines (PyTorch port)."""
from repro_torch.data.synthetic import (SyntheticImages, TokenStream,
                                        synthetic_batch_iterator)

__all__ = ["SyntheticImages", "TokenStream", "synthetic_batch_iterator"]
