"""RWKV-6 (Finch) 7B — attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, d_ff=14336, vocab=65536,
    attn_kind="none", ssm_kind="rwkv6", ssm_head_dim=64, ssm_chunk=128,
    fsdp=True,
)
