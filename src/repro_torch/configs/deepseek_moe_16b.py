"""DeepSeekMoE-16B: 2 shared + 64 routed top-6, fine-grained [arXiv:2401.06066]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, d_ff=1408, vocab=102400,
    attn_kind="gqa", n_heads=16, n_kv_heads=16,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    fsdp=True,
)
