"""Zamba2-2.7B hybrid: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, d_ff=10240, vocab=32000,
    attn_kind="gqa", n_heads=32, n_kv_heads=32,   # the shared attn block
    ssm_kind="mamba2", d_state=64, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=128, shared_attn_every=6,
    fsdp=True,
)
