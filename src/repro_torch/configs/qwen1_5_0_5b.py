"""Qwen1.5-0.5B dense decoder with QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, d_ff=2816, vocab=151936,
    attn_kind="gqa", n_heads=16, n_kv_heads=16, qkv_bias=True,
)
