"""Llama-3.2-1B dense decoder [hf:meta-llama/Llama-3.2-1B]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, d_ff=8192, vocab=128256,
    attn_kind="gqa", n_heads=32, n_kv_heads=8, rope_theta=500_000.0,
)
