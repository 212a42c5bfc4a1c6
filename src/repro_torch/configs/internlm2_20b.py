"""InternLM2-20B dense decoder with GQA [arXiv:2403.17297]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, d_ff=16384, vocab=92544,
    attn_kind="gqa", n_heads=48, n_kv_heads=8,
    fsdp=True,
)
